"""Branch+fusion multimodal pipeline model (PyTorch port).

Port of ``repro.multimodal.model``.  Stage layout for an encoder branch of
``E`` stages and an LM chain of ``L`` stages (fusion first)::

    enc_0 -> enc_1 -> ... -> enc_{E-1} --\\
                                          +--> fusion -> lm_1 -> ... -> lm_{L-1}
    text frontend ------------------------/

* **encoder stages** (vision patches / audio frames): non-causal
  transformer layers at width ``d_enc`` over variable-length token
  sequences.  The attention and the norms run at the fixed inner length
  ``max(buckets)`` (pad inside, slice back) with the softmax max taken
  under no grad, as the reference computes them; the attention is plain
  float32 ``einsum`` (the reference computes it outside any Pallas
  kernel), the norms go through kernel K2.
* **text frontend**: token embedding + causal decoder layers at
  ``d_model`` (``models.layers``: K1 and K2).
* **fusion stage**: segment-pools the encoder branch's valid positions
  into ``fusion_slots`` tokens, projects ``d_enc -> d_model``, prepends
  them to the text hidden states, then runs causal LM layers over the
  fused sequence.  Its forward has two message predecessors (the DAG
  fan-in); its backward emits one input gradient per branch.
* **LM tail stages**: causal decoder layers; the last stage carries the
  LM head and the token cross-entropy over the text positions.

Dtypes follow the reference's promotion: the encoder's input embeddings
are float32, and a float32 activation meeting a bfloat16 weight computes
in float32 (JAX promotes both operands of a product).  So in a bfloat16
model the encoder, fusion and LM stages run in float32 with their
weights cast per use, and only the text stage runs in bfloat16;
gradients reach the weights in their own dtype.

Parameters are one ``nn.Module`` per stage, named one-to-one with the
reference's per-stage pytree (``layers.{i}.attn.wq`` is
``params[s]['layers'][i]['attn']['wq']``; see ``models/convert.py``), and
are initialised from an explicit ``torch.Generator`` per stage.
"""
from __future__ import annotations

import dataclasses
import types

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs import registry
from repro_torch.core.taskgraph import PipelineSpec, StageGraph
from repro_torch.data.lengths import VISION_SIGMA
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.build import make_generator
from repro_torch.models.common import ArchConfig
from repro_torch.models.layers import (
    DecoderLayer,
    attention_qkv,
    decoder_layer,
    dense_param,
    ffn_block,
    rmsnorm,
    zeros_param,
)

#: registered archs this subsystem knows how to lower onto the DAG
MULTIMODAL_ARCHS = {
    "qwen2-vl-2b": "vision",
    "seamless-m4t-large-v2": "audio",
}


@dataclasses.dataclass(frozen=True)
class MultimodalConfig:
    """Static description of one branch+fusion multimodal pipeline."""

    name: str
    modality: str            # "vision" | "audio"
    enc_stages: int          # encoder-branch stages (>= 1)
    lm_stages: int           # fusion + decoder-chain stages (>= 1)
    enc_layers_per_stage: int
    lm_layers_per_stage: int
    d_enc: int
    enc_heads: int
    d_model: int
    vocab_size: int
    text_seq: int
    fusion_slots: int        # pooled modality tokens entering the LM
    mean_enc_tokens: int     # mean encoder tokens per microbatch sample
    enc_sigma: float         # lognormal sigma of the per-mb length skew
    buckets: tuple[int, ...]  # padded encoder-length buckets (ascending)
    #: the LM-side ArchConfig the decoder layers are built from
    lm_cfg: ArchConfig = None  # type: ignore[assignment]

    def __post_init__(self) -> None:
        if self.enc_stages < 1 or self.lm_stages < 1:
            raise ValueError("need >= 1 encoder and >= 1 LM stage")
        if not self.buckets or list(self.buckets) != sorted(self.buckets):
            raise ValueError("buckets must be a non-empty ascending tuple")
        if self.fusion_slots < 1:
            raise ValueError("fusion_slots must be >= 1")

    @property
    def num_stages(self) -> int:
        return self.enc_stages + 1 + self.lm_stages

    @property
    def text_stage(self) -> int:
        return self.enc_stages

    @property
    def fusion_stage(self) -> int:
        return self.enc_stages + 1

    @property
    def fused_seq(self) -> int:
        return self.fusion_slots + self.text_seq

    @property
    def enc_cfg(self) -> ArchConfig:
        """Layer-shim config for the encoder width (GELU, no GQA)."""
        return dataclasses.replace(
            self.lm_cfg, d_model=self.d_enc, num_heads=self.enc_heads,
            num_kv_heads=self.enc_heads, head_dim=0,
            d_ff=max(4 * self.d_enc, 8), act="gelu", qkv_bias=False,
            mrope=False, layer_pattern=None)

    # ---- topology ----------------------------------------------------------
    def stage_graph(self) -> StageGraph:
        E, S = self.enc_stages, self.num_stages
        edges = [(s, s + 1) for s in range(E - 1)]          # encoder chain
        edges.append((E - 1, self.fusion_stage))            # branch fan-in
        edges.append((self.text_stage, self.fusion_stage))  # text fan-in
        edges += [(s, s + 1) for s in range(self.fusion_stage, S - 1)]
        return StageGraph(S, tuple(edges))

    def spec(self, num_microbatches: int,
             split_backward: bool = False) -> PipelineSpec:
        return PipelineSpec(self.num_stages, num_microbatches,
                            split_backward=split_backward,
                            graph=self.stage_graph())

    def roles(self) -> dict[str, tuple[int, ...]]:
        """Stage-id sets per role (consumed by chaos modality profiles)."""
        return {
            "encoder": tuple(range(self.enc_stages)),
            "text": (self.text_stage,),
            "fusion": (self.fusion_stage,),
            "decoder": tuple(range(self.fusion_stage, self.num_stages)),
        }

    def fanin_edges(self) -> tuple[tuple[int, int], ...]:
        return ((self.enc_stages - 1, self.fusion_stage),
                (self.text_stage, self.fusion_stage))

    def role_of(self, stage: int) -> str:
        if stage < self.enc_stages:
            return "encoder"
        if stage == self.text_stage:
            return "text"
        if stage == self.fusion_stage:
            return "fusion"
        return "lm"


def multimodal_config(
    arch: str,
    *,
    enc_stages: int = 2,
    lm_stages: int = 2,
    enc_layers_per_stage: int = 2,
    lm_layers_per_stage: int = 2,
    text_seq: int = 32,
    fusion_slots: int = 4,
    mean_enc_tokens: int = 24,
    buckets: tuple[int, ...] = (16, 32, 48),
    reduced: bool = True,
    num_layers: int | None = None,
) -> MultimodalConfig:
    """Lower a registered multimodal arch onto the branch+fusion pipeline."""
    if arch not in MULTIMODAL_ARCHS:
        raise ValueError(
            f"{arch!r} is not a multimodal arch; available: "
            f"{sorted(MULTIMODAL_ARCHS)}")
    modality = MULTIMODAL_ARCHS[arch]
    cfg = (registry.reduced_config(arch, num_layers=num_layers)
           if reduced else registry.get_arch(arch))
    # encoder width: half the LM width (rounded to a head multiple) — cheap
    # per-token relative to the decoder, like a ViT/conformer frontend
    enc_heads = max(1, cfg.num_heads // 2)
    d_enc = max(8 * enc_heads, (cfg.d_model // 2) // enc_heads * enc_heads)
    # audio frames arrive longer but less spread than dynamic-res images
    sigma = VISION_SIGMA if modality == "vision" else 0.4
    return MultimodalConfig(
        name=cfg.name,
        modality=modality,
        enc_stages=enc_stages,
        lm_stages=lm_stages,
        enc_layers_per_stage=enc_layers_per_stage,
        lm_layers_per_stage=lm_layers_per_stage,
        d_enc=d_enc,
        enc_heads=enc_heads,
        d_model=cfg.d_model,
        vocab_size=cfg.vocab_size,
        text_seq=text_seq,
        fusion_slots=fusion_slots,
        mean_enc_tokens=mean_enc_tokens,
        enc_sigma=sigma,
        buckets=tuple(sorted(buckets)),
        lm_cfg=cfg,
    )


# ---------------------------------------------------------------------------
# dtype promotion (the reference's float32 x bfloat16 products)
# ---------------------------------------------------------------------------
def _promoted(p: nn.Module, dtype: torch.dtype):
    """``p``'s parameters as ``dtype``, keeping its attribute paths (a
    namespace tree the layer functions read like the module).  The cast is
    differentiable: a weight's gradient arrives in its own dtype."""
    if all(t.dtype == dtype for t in p.parameters()):
        return p
    ns = types.SimpleNamespace()
    for name, t in p.named_parameters(recurse=False):
        setattr(ns, name, t.to(dtype))
    for name, child in p.named_children():
        setattr(ns, name, _promoted(child, dtype))
    return ns


def _mm(x, w):
    """``x @ w`` with both operands promoted to the wider dtype."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def _layer_input(x, p: nn.Module):
    """(x, p) promoted to their common dtype, as the reference's products
    promote them."""
    dt = torch.promote_types(x.dtype, next(p.parameters()).dtype)
    return x.to(dt), _promoted(p, dt)


# ---------------------------------------------------------------------------
# padding-invariant encoder attention (plain float32, as in the reference)
# ---------------------------------------------------------------------------
def masked_encoder_attention(p, x, length: int, cfg: ArchConfig, pad_to: int):
    """Non-causal self-attention over a variable-length padded sequence.

    x: [b, s, d_enc]; ``length``: the valid token count; ``pad_to``: the
    fixed inner length (>= s).  q, k and v are padded to ``pad_to``, the
    scores and both reductions along the key axis run at that length, and
    the result is sliced back to ``s``.
    """
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = attention_qkv(p, x, cfg)  # [b, s, h, hd] (bucket-sized)
    pad = (0, 0, 0, 0, 0, pad_to - s)
    qf = F.pad((q * hd**-0.5).float(), pad)
    kf = F.pad(k.float(), pad)
    vf = F.pad(v.float(), pad)
    valid = torch.arange(pad_to, device=x.device) < length
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf)      # [b, h, K, K]
    scores = torch.where(valid[None, None, None, :], scores, NEG_INF)
    with torch.no_grad():
        m = torch.amax(scores, dim=-1, keepdim=True)
    probs = torch.exp(scores - m) * valid[None, None, None, :]
    ones = torch.ones((pad_to,), dtype=torch.float32, device=x.device)
    denom = torch.einsum("bhqk,k->bhq", probs, ones)      # [b, h, K]
    num = torch.einsum("bhqk,bkhd->bqhd", probs, vf)
    out = num / denom.transpose(1, 2)[..., None]
    out = out[:, :s].to(x.dtype).reshape(b, s, -1)
    return out @ p.wo


def _fixed_len_rmsnorm(x, scale, eps: float, pad_to: int):
    """rmsnorm (K2) over rows padded to ``pad_to``, sliced back: its scale
    gradient sums over the same positions for every bucket."""
    s = x.shape[1]
    xp = F.pad(x, (0, 0, 0, pad_to - s))
    return rmsnorm(xp, scale, eps)[:, :s]


def encoder_layer(p, x, length: int, cfg: ArchConfig, pad_to: int):
    """Pre-norm encoder block: masked attention + FFN (GELU)."""
    h = _fixed_len_rmsnorm(x, p.ln1, cfg.norm_eps, pad_to)
    x = x + masked_encoder_attention(p.attn, h, length, cfg, pad_to)
    h = _fixed_len_rmsnorm(x, p.ln2, cfg.norm_eps, pad_to)
    return x + ffn_block(p.ffn, h, cfg.act)


def pool_weights(length: int, bucket: int, slots: int, device=None):
    """[slots, bucket] segment-mean pooling weights over valid positions
    (integer segment assignment, exact zeros at padding), float32."""
    pos = torch.arange(bucket, device=device)
    length = max(int(length), 1)
    seg = torch.clamp((pos * slots) // length, max=slots - 1)   # [bucket]
    valid = pos < length
    w = (seg[None, :] == torch.arange(slots, device=device)[:, None]) \
        & valid[None, :]
    w = w.float()
    count = torch.einsum("sk,k->s", w, torch.ones((bucket,), device=device))
    return w / torch.clamp(count, min=1.0)[:, None]


# ---------------------------------------------------------------------------
# the model: per-stage parameter modules + forward bodies
# ---------------------------------------------------------------------------
class MultimodalStage(nn.Module):
    """One stage's parameters: ``layers`` (encoder or decoder layers) and,
    by role, ``pos_embed`` (first encoder stage), ``embed`` (text stage),
    ``proj_w``/``proj_b`` (fusion stage), ``final_ln``/``head`` (last
    stage).  ``gen=None`` allocates without initialising (for loading)."""

    def __init__(self, cfg: MultimodalConfig, stage: int, gen, device):
        super().__init__()
        dtype = cfg.lm_cfg.dtype
        role = cfg.role_of(stage)
        if role == "encoder":
            if stage == 0:
                self.pos_embed = dense_param(
                    gen, (max(cfg.buckets), cfg.d_enc), dtype, device,
                    scale=0.02)
            layer_cfg, n = cfg.enc_cfg, cfg.enc_layers_per_stage
        elif role == "text":
            self.embed = dense_param(gen, (cfg.vocab_size, cfg.d_model),
                                     dtype, device, scale=0.02)
            layer_cfg, n = cfg.lm_cfg, cfg.lm_layers_per_stage
        else:  # fusion / lm
            if role == "fusion":
                self.proj_w = dense_param(gen, (cfg.d_enc, cfg.d_model),
                                          dtype, device)
                self.proj_b = zeros_param((cfg.d_model,), dtype, device)
            layer_cfg, n = cfg.lm_cfg, cfg.lm_layers_per_stage
        self.layers = nn.ModuleList(
            DecoderLayer(layer_cfg, gen, device) for _ in range(n))
        if stage == cfg.num_stages - 1:
            self.final_ln = zeros_param((cfg.d_model,), dtype, device)
            self.head = dense_param(gen, (cfg.vocab_size, cfg.d_model),
                                    dtype, device)


@dataclasses.dataclass
class MultimodalModel:
    cfg: MultimodalConfig

    # ---- params --------------------------------------------------------
    def init_stage_params(self, *, seed: int | None = 0,
                          device="cuda") -> list[MultimodalStage]:
        """One parameter module per pipeline stage (heterogeneous)."""
        return [MultimodalStage(
            self.cfg, s, None if seed is None
            else make_generator(seed, 2_000_000 + s, device), device)
            for s in range(self.cfg.num_stages)]

    def param_count(self) -> int:
        return sum(t.numel() for sp in self.init_stage_params(
            seed=None, device="meta") for t in sp.parameters())

    # ---- per-stage forward bodies ----------------------------------------
    def encoder_forward(self, stage: int, p: MultimodalStage, x, length: int):
        """x: [rows, bucket, d_enc]; length: the valid token count."""
        cfg = self.cfg
        if stage == 0:
            x = x + p.pos_embed[:x.shape[1]][None]
        for lp in p.layers:
            x, lp = _layer_input(x, lp)
            x = encoder_layer(lp, x, length, cfg.enc_cfg, max(cfg.buckets))
        return x

    def text_forward(self, p: MultimodalStage, tokens):
        """tokens: [rows, text_seq] -> [rows, text_seq, d_model]."""
        cfg = self.cfg
        x = p.embed[tokens]
        pos = torch.arange(cfg.text_seq, dtype=torch.int32,
                           device=tokens.device)[None].expand(tokens.shape)
        for lp in p.layers:
            x, lp = _layer_input(x, lp)
            x = decoder_layer(lp, x, pos, cfg.lm_cfg)
        return x

    def fusion_forward(self, p: MultimodalStage, x_enc, length: int, x_txt):
        """Pool + project the branch, prepend to text, run LM layers."""
        cfg = self.cfg
        pad_to = max(cfg.buckets)
        x_full = F.pad(x_enc.float(), (0, 0, 0, pad_to - x_enc.shape[1]))
        w = pool_weights(length, pad_to, cfg.fusion_slots, x_enc.device)
        pooled = torch.einsum("sk,bkd->bsd", w, x_full)
        pooled = pooled.to(x_enc.dtype)
        slots = _mm(pooled, p.proj_w) + p.proj_b
        x = torch.cat([slots, x_txt], dim=1)            # [rows, fused, d]
        return self._lm_layers(p, x)

    def lm_forward(self, p: MultimodalStage, x):
        return self._lm_layers(p, x)

    def _lm_layers(self, p: MultimodalStage, x):
        cfg = self.cfg
        pos = torch.arange(cfg.fused_seq, dtype=torch.int32,
                           device=x.device)[None].expand(x.shape[0],
                                                         cfg.fused_seq)
        for lp in p.layers:
            x, lp = _layer_input(x, lp)
            x = decoder_layer(lp, x, pos, cfg.lm_cfg)
        return x

    def loss_sum(self, p: MultimodalStage, y, labels):
        """Token cross-entropy (sum) over the text positions of ``y``."""
        cfg = self.cfg
        h = rmsnorm(y[:, cfg.fusion_slots:], p.final_ln, cfg.lm_cfg.norm_eps)
        logits = _mm(h, p.head.T).float()
        lse = torch.logsumexp(logits, dim=-1)
        pick = torch.gather(logits, -1,
                            labels.clamp_min(0)[..., None].long())[..., 0]
        w = (labels >= 0).float()
        return torch.sum((lse - pick) * w)


def multimodal_model(arch: str, **kw) -> MultimodalModel:
    return MultimodalModel(multimodal_config(arch, **kw))
