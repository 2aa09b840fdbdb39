"""Arch registry: ArchConfig -> ArchModel (dense slice of the port).

Port of ``repro.models.build``.  The layout is the reference's: layers
spread over stages by ``stage_layout``, per-slot ``type_ids`` (-1 =
disabled slot of an uneven stage) and the ``rows`` an executor consumes.
Parameters are ``nn.Module``s: one :class:`StageParams` per stage and one
:class:`IOParams`, named so that they map one-to-one onto the reference's
stacked pytree, e.g. ``slots.{i}.blk.attn.wq`` of stage ``s`` is
``stage_params['blk']['attn']['wq'][s, i]`` (see ``models/convert.py``).

The port runs the attention layer kinds (``attn``, ``attn_local``,
``attn_global``), Mamba-2 layers (``mamba``) and zamba2's shared attention
block (``io.shared_blk``, applied before every ``shared_attn_period``-th
layer), forward and decode; the enc-dec kinds (``enc``, ``dec``) at decode
only (``stage_decode``; the reference runs their forward only in its SPMD
executor).  The other kinds raise ``NotImplementedError`` naming the
ROADMAP slice they move with.

Decode caches are trees of nested dicts, one per stage, each leaf stacked
``[l_max, batch, ...]`` (the reference's ``[S, l_max, ...]`` tree holds one
per stage), and ``stage_decode`` updates them in place.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models.common import (
    ArchConfig,
    ShapeCell,
    global_layer_index,
    stage_layout,
)
from repro_torch.models.layers import (
    Attention,
    DecoderLayer,
    decode_attention_block,
    decoder_layer,
    decoder_layer_decode,
    dense_param,
    ffn_block,
    rmsnorm,
    zeros_param,
)
from repro_torch.models.ssm import (
    MambaLayer,
    init_mamba_cache,
    mamba_layer,
    mamba_layer_decode,
)

ATTN_KINDS = ("attn", "attn_local", "attn_global")
#: layer kind -> the ROADMAP queue-1 slice that ports it
LATER_SLICES = {
    "moe": "other families (MoE)",
    "dense": "other families (MoE)",
    "mlstm": "other families (xLSTM)",
    "slstm": "other families (xLSTM)",
}


def _not_ported(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not in the port yet: it moves with the {slice_name} "
        f"slice (ROADMAP.md queue 1)")


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (the decode cache trees)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def make_generator(seed: int, salt: int, device) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(seed * 1_000_003 + salt)
    return gen


class LayerSlot(nn.Module):
    """Union parameters of one layer slot over the arch's layer kinds (the
    reference's ``init_layer_params``): ``blk`` for the attention and
    enc-dec kinds, ``cross_ln`` and ``cross`` (cross-attention, no biases)
    for ``dec``, ``mamba`` for Mamba-2."""

    def __init__(self, cfg: ArchConfig, layer_types, gen, device):
        super().__init__()
        for kind in layer_types:
            if kind in LATER_SLICES:
                raise _not_ported(f"layer kind {kind!r}", LATER_SLICES[kind])
        if set(layer_types) & {*ATTN_KINDS, "enc", "dec"}:
            self.blk = DecoderLayer(cfg, gen, device)
        if "dec" in layer_types:
            self.cross_ln = zeros_param((cfg.d_model,), cfg.dtype, device)
            self.cross = Attention(cfg, gen, device, cross=True)
        if "mamba" in layer_types:
            self.mamba = MambaLayer(cfg, gen, device)


class StageParams(nn.Module):
    """One stage's ``l_max`` layer slots."""

    def __init__(self, model: "ArchModel", gen_for_slot, device):
        super().__init__()
        self.slots = nn.ModuleList(
            LayerSlot(model.cfg, model.layer_types, gen_for_slot(i), device)
            for i in range(model.l_max))


class IOParams(nn.Module):
    """Embedding, LM head, final norm and, for zamba2, the shared attention
    block (outside the stage stacking)."""

    def __init__(self, cfg: ArchConfig, gen, device):
        super().__init__()
        v = cfg.padded_vocab()
        self.embed = dense_param(gen, (v, cfg.d_model), cfg.dtype, device,
                                 scale=0.02)
        self.head = dense_param(gen, (v, cfg.d_model), cfg.dtype, device)
        self.final_ln = zeros_param((cfg.d_model,), cfg.dtype, device)
        if cfg.shared_attn_period:
            self.shared_blk = DecoderLayer(cfg, gen, device)


@dataclasses.dataclass
class ArchModel:
    cfg: ArchConfig
    num_stages: int
    counts: np.ndarray  # [S] true layers per stage
    l_max: int
    type_ids: np.ndarray  # [S, l_max] index into layer_types, -1 disabled
    shared_flags: np.ndarray  # [S, l_max] apply-shared-block-before-slot
    layer_types: tuple[str, ...]

    def rows(self, stage: int) -> dict[str, np.ndarray]:
        return {
            "type_id": np.maximum(self.type_ids[stage], 0),
            "enabled": (self.type_ids[stage] >= 0).astype(np.int32),
            "shared": self.shared_flags[stage].astype(np.int32),
        }

    # ------------------------------------------------------------------
    # params (``seed=None`` allocates without initialising, for loading)
    # ------------------------------------------------------------------
    def init_stage_params(self, stage: int, *, seed: int | None = 0,
                          device="cuda") -> StageParams:
        def gen_for_slot(i):
            if seed is None:
                return None
            return make_generator(seed, stage * 1000 + i, device)

        return StageParams(self, gen_for_slot, device)

    def init_io_params(self, *, seed: int | None = 0,
                       device="cuda") -> IOParams:
        gen = None if seed is None else make_generator(seed, 1_000_000, device)
        return IOParams(self.cfg, gen, device)

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def _window(self, kind: str) -> int:
        """Sliding window of an attention kind (0 = none)."""
        if kind == "attn":
            return self.cfg.sliding_window
        if kind == "attn_local":
            return self.cfg.sliding_window or 1024
        return 0

    def _branch(self, kind: str):
        cfg = self.cfg
        if kind == "mamba":
            return lambda slot, io, x, aux: mamba_layer(slot.mamba, x, cfg)
        if kind in ("enc", "dec"):
            raise NotImplementedError(
                f"the {kind!r} forward is not in the port: the reference "
                f"runs the enc-dec forward only in its SPMD executor "
                f"(pipeline/executor.py), which moves with the multi-device "
                f"slice (ROADMAP.md queue 1, item 18); its decode "
                f"(stage_decode) is ported")
        if kind not in ATTN_KINDS:
            raise _not_ported(f"layer kind {kind!r}", LATER_SLICES[kind])
        window = self._window(kind)

        def attn_like(slot: LayerSlot, io, x, aux):
            return decoder_layer(slot.blk, x, aux["positions"], cfg,
                                 window=window, mrope_pos=aux.get("mrope"))

        return attn_like

    def stage_forward(self, stage_params: StageParams, io: IOParams, x, aux,
                      rows, remat: bool = True):
        """Apply this stage's enabled layer slots.

        Under autograd each slot is checkpointed (``remat``): the backward
        keeps one activation per slot and recomputes the slot's internals,
        the reference's ``jax.checkpoint`` per slot.  A slot flagged
        ``shared`` applies ``io.shared_blk`` before its own layer, inside
        the same checkpoint.
        """
        for i, slot in enumerate(stage_params.slots):
            if not rows["enabled"][i]:
                continue
            fn = self._branch(self.layer_types[int(rows["type_id"][i])])
            if self.cfg.shared_attn_period and rows["shared"][i]:
                fn = functools.partial(self._shared_then, fn)
            if remat and torch.is_grad_enabled():
                x = checkpoint(fn, slot, io, x, aux, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = fn(slot, io, x, aux)
        return x

    def _shared_then(self, fn, slot, io: IOParams, x, aux):
        x = decoder_layer(io.shared_blk, x, aux["positions"], self.cfg)
        return fn(slot, io, x, aux)

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def init_layer_cache(self, batch: int, seq: int, enc_len: int = 0, *,
                         device="cuda") -> dict:
        """Union cache of one layer slot (the reference's): ``k``/``v`` for
        the attention kinds, ``dec`` and the shared block, ``xk``/``xv``
        (the encoder's keys and values) when the arch has ``dec``,
        ``mamba``'s (conv, ssm) pair."""
        cfg = self.cfg
        types = set(self.layer_types)
        shape = (batch, seq, cfg.num_kv_heads, cfg.resolved_head_dim)
        xshape = (batch, enc_len) + shape[2:]
        c: dict = {}
        if types & {*ATTN_KINDS, "dec"} or cfg.shared_attn_period:
            c["k"] = torch.zeros(shape, dtype=cfg.dtype, device=device)
            c["v"] = torch.zeros(shape, dtype=cfg.dtype, device=device)
        if "dec" in types:
            c["xk"] = torch.zeros(xshape, dtype=cfg.dtype, device=device)
            c["xv"] = torch.zeros(xshape, dtype=cfg.dtype, device=device)
        if "mamba" in types:
            c["mamba"] = init_mamba_cache(batch, cfg, device=device)
        return c

    def init_stage_cache(self, batch: int, seq: int, enc_len: int = 0, *,
                         device="cuda") -> dict:
        """One stage's cache: each leaf of ``init_layer_cache`` stacked
        ``[l_max, ...]``, zeros."""
        one = self.init_layer_cache(batch, seq, enc_len, device="meta")
        return tree_map(lambda t: torch.zeros(
            (self.l_max,) + tuple(t.shape), dtype=t.dtype, device=device), one)

    def _decode_branch(self, kind: str):
        """fn(slot, io, x [b, 1, d], cache, pos, aux) -> y; ``cache`` is the
        slot's cache tree, updated in place."""
        cfg = self.cfg
        if kind in ATTN_KINDS:
            window = self._window(kind)

            def attn_like(slot: LayerSlot, io, x, cache, pos, aux):
                return decoder_layer_decode(
                    slot.blk, x, cache, pos, cfg, window=window,
                    axis_name=aux.get("sp_axis"))[0]

            return attn_like
        if kind == "enc":
            # encoder layers are inert at decode time (context pre-filled)
            return lambda slot, io, x, cache, pos, aux: x
        if kind == "dec":

            def dec_fn(slot: LayerSlot, io, x, cache, pos, aux):
                h = rmsnorm(x, slot.blk.ln1, cfg.norm_eps)
                x = x + decode_attention_block(slot.blk.attn, h, cache, pos,
                                               cfg)[0]
                # cross attention against the encoder's keys and values:
                # kernel K3, over all enc_len of them
                h = rmsnorm(x, slot.cross_ln, cfg.norm_eps)
                b = x.shape[0]
                q = (h @ slot.cross.wq).reshape(b, 1, cfg.num_heads,
                                                cfg.resolved_head_dim)
                o = ops.decode_attention(q, cache["xk"], cache["xv"],
                                         cache["xk"].shape[1])
                x = x + o.reshape(b, 1, -1) @ slot.cross.wo
                h = rmsnorm(x, slot.blk.ln2, cfg.norm_eps)
                return x + ffn_block(slot.blk.ffn, h, cfg.act)

            return dec_fn
        if kind == "mamba":
            return lambda slot, io, x, cache, pos, aux: mamba_layer_decode(
                slot.mamba, x, cache["mamba"], cfg)[0]
        raise _not_ported(f"layer kind {kind!r}", LATER_SLICES[kind])

    def stage_decode(self, stage_params: StageParams, io: IOParams, x,
                     stage_cache: dict, pos: int, aux: dict, rows):
        """One token through this stage's enabled slots.

        x: [b, 1, d]; stage_cache: leaves [l_max, b, ...] (a view of the
        batch rows being decoded); pos: the current position.  The caches
        are updated in place, a disabled slot's left as it is (the
        reference's ``where(en, new, old)``).  Returns ``(x, stage_cache)``.
        A slot flagged ``shared`` first applies ``io.shared_blk``, whose KV
        cache rides in the slot's ``k``/``v``.
        """
        branches = {k: self._decode_branch(k) for k in self.layer_types}
        for i, slot in enumerate(stage_params.slots):
            if not rows["enabled"][i]:
                continue
            cache = tree_map(lambda c: c[i], stage_cache)
            if self.cfg.shared_attn_period and rows["shared"][i]:
                x = decoder_layer_decode(io.shared_blk, x, cache, pos,
                                         self.cfg)[0]
            x = branches[self.layer_types[int(rows["type_id"][i])]](
                slot, io, x, cache, pos, aux)
        return x, stage_cache

    # ------------------------------------------------------------------
    # embedding / head
    # ------------------------------------------------------------------
    def embed(self, io: IOParams, batch: dict):
        if self.cfg.embed_input:
            return batch["embeds"].to(self.cfg.dtype)
        return io.embed[batch["tokens"]]

    def head_logits(self, io: IOParams, x):
        h = rmsnorm(x, io.final_ln, self.cfg.norm_eps)
        return h @ io.head.T

    def reference_forward(self, stage_params, io: IOParams, batch: dict,
                          aux: dict):
        """Single-device forward through every stage (tests)."""
        x = self.embed(io, batch)
        for s in range(self.num_stages):
            x = self.stage_forward(stage_params[s], io, x, aux, self.rows(s))
        return self.head_logits(io, x)

    # ------------------------------------------------------------------
    # analytic accounting
    # ------------------------------------------------------------------
    def model_flops(self, cell: ShapeCell) -> dict[str, float]:
        """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE), N excl. embed,
        plus the attention context FLOPs (not in 6ND) of every attention
        layer and shared-block application."""
        cfg = self.cfg
        tokens = (cell.seq_len * cell.global_batch if cell.step == "train"
                  else cell.global_batch)
        n_active = cfg.active_param_count() + cfg.padded_vocab() * cfg.d_model
        n_total = (cfg.param_count(include_embed=False)
                   + cfg.padded_vocab() * cfg.d_model)
        mult = 6 if cell.step == "train" else 2
        attn_layers = sum(
            1 for k in cfg.pattern
            if k in ("attn", "attn_global", "moe", "dense", "dec", "enc")
        ) + (int(np.count_nonzero(self.shared_flags))
             if cfg.shared_attn_period else 0)
        local_layers = sum(1 for k in cfg.pattern if k == "attn_local")
        hq, hd = cfg.num_heads, cfg.resolved_head_dim
        local_ctx = cfg.sliding_window or 1024
        if cell.step == "train":
            ctx = cell.seq_len / 2
            attn_flops = mult * cell.global_batch * cell.seq_len * (
                attn_layers * ctx + local_layers * min(local_ctx, ctx)
            ) * 2 * hq * hd
        else:
            ctx = cell.seq_len
            attn_flops = mult * cell.global_batch * (
                attn_layers * ctx + local_layers * min(local_ctx, ctx)
            ) * 2 * hq * hd
        return {
            "model_flops": mult * n_active * tokens + attn_flops,
            "model_flops_total_params": mult * n_total * tokens + attn_flops,
            "tokens": tokens,
            "n_active": n_active,
            "n_total": n_total,
        }


def build(cfg: ArchConfig, num_stages: int = 16) -> ArchModel:
    counts, l_max = stage_layout(cfg.num_layers, num_stages)
    gli = global_layer_index(counts)  # [S, l_max], -1 disabled
    pattern = cfg.pattern
    types = cfg.layer_types()
    type_ids = np.full((num_stages, l_max), -1, dtype=np.int64)
    shared = np.zeros((num_stages, l_max), dtype=np.int64)
    for s in range(num_stages):
        for i in range(l_max):
            g = gli[s, i]
            if g >= 0:
                type_ids[s, i] = types.index(pattern[g])
                if cfg.shared_attn_period and g % cfg.shared_attn_period == 0:
                    shared[s, i] = 1
    return ArchModel(
        cfg=cfg,
        num_stages=num_stages,
        counts=counts,
        l_max=l_max,
        type_ids=type_ids,
        shared_flags=shared,
        layer_types=types,
    )
