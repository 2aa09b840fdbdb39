"""The decoder family: a pre-norm decoder, dense or with routed experts.

RMSNorm ``x * rsqrt(mean(x^2) + eps) * (1 + scale)``, rotary positions on
split halves (M-RoPE where the configuration names its ``mrope_section``:
each section of the frequencies turned by its own axis of positions; a
text-only stub gives every axis ``0..s-1``), causal softmax attention with
query, key and value biases where the configuration has ``qkv_bias``, and
either a feed-forward block (GELU in its tanh form, or SwiGLU) or, in a
MoE layer, routed experts with static capacity plus shared experts; a
final RMSNorm, an untied LM head and the mean token cross-entropy.  Its
input is the ``embed`` row of each token or, for a configuration with
``embed_input``, the embeddings a frontend supplies.  A MoE configuration
has ``first_dense`` leading ``dense`` layers, then ``moe`` layers; any
other has ``attn`` layers.

The MoE layer is the configuration's: softmax over the top-k router logits
of each token; an expert takes at most ``C = int(T * top_k / experts *
capacity_factor)`` of the ``T`` tokens of one microbatch, in the order of
(token, choice), and a token past that is dropped from that expert.

The family's interface (:mod:`rrfp_bench.families`): :func:`pattern`,
:func:`layer_leaves`, :class:`Reference`, :func:`per_microbatch`,
:func:`model_flops`, :func:`attention_calls`, :func:`check_program`,
:func:`small`.  The parameter accounting of :func:`model_flops` is a
frozen copy of ``ArchModel.model_flops``
(``src/repro_torch/models/build.py:560``), ``ArchConfig.layer_param_count``,
``active_layer_param_count`` and ``active_param_count``
(``src/repro_torch/models/common.py:110-182``).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from rrfp_bench.harness.weights import DTYPES
from rrfp_bench.reference.precision import matmul_fn
from rrfp_bench.yardstick.flops import head_dim, padded_vocab


def pattern(c: dict) -> list[str]:
    """Layer kinds in order: ``attn`` for a dense decoder; a MoE config's
    ``first_dense`` leading ``dense`` layers, then ``moe``."""
    n = c["num_layers"]
    moe = c.get("moe")
    if moe is None:
        return ["attn"] * n
    k = moe["first_dense"]
    return ["dense"] * min(k, n) + ["moe"] * max(n - k, 0)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------
def _ffn(prefix: str, d: int, f: int, glu: bool, dt) -> dict:
    out = {f"{prefix}.wi": ((d, f), dt, 1 / math.sqrt(d))}
    if glu:
        out[f"{prefix}.wg"] = ((d, f), dt, 1 / math.sqrt(d))
    out[f"{prefix}.wo"] = ((f, d), dt, 1 / math.sqrt(f))
    return out


def layer_leaves(c: dict, kind: str) -> dict:
    """path -> (shape, dtype, std) of one layer of ``kind``."""
    d, hd = c["d_model"], head_dim(c)
    nq, nkv = c["num_heads"], c["num_kv_heads"]
    dt = DTYPES[c["dtype"]]
    glu = c["act"] in ("swiglu", "geglu")
    attn = {"ln1": ((d,), dt, 0.0),
            "attn.wq": ((d, nq * hd), dt, 1 / math.sqrt(d)),
            "attn.wk": ((d, nkv * hd), dt, 1 / math.sqrt(d)),
            "attn.wv": ((d, nkv * hd), dt, 1 / math.sqrt(d)),
            "attn.wo": ((nq * hd, d), dt, 1 / math.sqrt(nq * hd)),
            "ln2": ((d,), dt, 0.0)}
    if c.get("qkv_bias"):
        # zeros at the start, as the program initialises them
        attn.update({"attn.bq": ((nq * hd,), dt, 0.0),
                     "attn.bk": ((nkv * hd,), dt, 0.0),
                     "attn.bv": ((nkv * hd,), dt, 0.0)})
    if kind == "attn":
        own = {**attn, **_ffn("ffn", d, c["d_ff"], glu, dt)}
        return {f"blk.{k}": v for k, v in own.items()}
    moe = c["moe"]
    if kind == "dense":
        return {**attn, **_ffn("dense_ffn", d, moe["dense_d_ff"], glu, dt)}
    if kind == "moe":
        e, f = moe["num_experts"], c["d_ff"]
        out = {**attn,
               # the router is float32 in every model dtype
               "moe.router": ((d, e), torch.float32, 1 / math.sqrt(d)),
               "moe.wi": ((e, d, f), dt, 1 / math.sqrt(d))}
        if glu:
            out["moe.wg"] = ((e, d, f), dt, 1 / math.sqrt(d))
        out["moe.wo"] = ((e, f, d), dt, 1 / math.sqrt(f))
        for j in range(moe["num_shared"]):
            out.update(_ffn(f"moe.shared{j}", d, f, glu, dt))
        return out
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------
class Reference:
    """The model of config ``c`` over ``params``: path -> float32 tensor,
    stacked ``[layers, ...]`` as :mod:`rrfp_bench.harness.weights` draws
    them (``rows[path][g]`` is layer ``g``'s row)."""

    def __init__(self, c: dict, params: dict, rows: dict,
                 precision: str = "fp32"):
        self.c = c
        self.p = params
        self.rows = rows
        self.mm = matmul_fn(precision)
        self.kinds = pattern(c)
        self.hd = head_dim(c)
        hd = self.hd
        self.freqs = torch.as_tensor(
            1.0 / (c["rope_theta"] ** (np.arange(0, hd, 2) / hd)))
        #: M-RoPE's sections of the ``hd / 2`` frequencies (one: RoPE)
        self.sections = c.get("mrope_section") or [hd // 2]
        if sum(self.sections) * 2 != hd:
            raise ValueError(f"mrope_section {self.sections} does not "
                             f"cover head_dim {hd}")

    def w(self, path: str, g: int) -> torch.Tensor:
        return self.p[path][self.rows[path][g]]

    def rms(self, x, scale):
        inv = torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True)
                          + self.c["norm_eps"])
        return x * inv * (1.0 + scale)

    def rope(self, x):
        """x [b, s, h, hd]; every axis of positions 0..s-1."""
        s = x.shape[1]
        pos = torch.arange(s, dtype=x.dtype, device=x.device)
        freqs = self.freqs.to(x)
        cuts = np.cumsum([0] + list(self.sections))
        ang = torch.cat([pos[:, None] * freqs[a:b]
                         for a, b in zip(cuts[:-1], cuts[1:])], dim=-1)
        cos = torch.cos(ang)[None, :, None, :]
        sin = torch.sin(ang)[None, :, None, :]
        x1, x2 = torch.chunk(x, 2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def mask(self, g: int, s: int, device) -> torch.Tensor:
        """[s, s]: the keys each query of layer ``g`` sees (causal)."""
        return torch.ones(s, s, dtype=torch.bool, device=device).tril()

    def attention(self, pre: str, g: int, h):
        c, mm, hd = self.c, self.mm, self.hd
        b, s, _ = h.shape
        nq, nkv = c["num_heads"], c["num_kv_heads"]
        q, k, v = (mm(h, self.w(pre + f"attn.w{n}", g)) for n in "qkv")
        if c.get("qkv_bias"):
            q, k, v = (t + self.w(pre + f"attn.b{n}", g)
                       for t, n in zip((q, k, v), "qkv"))
        q = self.rope(q.view(b, s, nq, hd))
        k = self.rope(k.view(b, s, nkv, hd))
        v = v.view(b, s, nkv, hd)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        if nq != nkv:
            k = k.repeat_interleave(nq // nkv, dim=1)
            v = v.repeat_interleave(nq // nkv, dim=1)
        scores = mm(q * hd ** -0.5, k.transpose(-1, -2))
        scores = scores.masked_fill(~self.mask(g, s, h.device),
                                    float("-inf"))
        o = mm(torch.softmax(scores, dim=-1), v)
        return mm(o.transpose(1, 2).reshape(b, s, nq * hd),
                  self.w(pre + "attn.wo", g))

    def _act(self, x, wi, wg):
        mm = self.mm
        if self.c["act"] == "swiglu":
            return F.silu(mm(x, wg)) * mm(x, wi)
        if self.c["act"] == "geglu":
            return F.gelu(mm(x, wg), approximate="tanh") * mm(x, wi)
        return F.gelu(mm(x, wi), approximate="tanh")

    def ffn(self, pre: str, g: int, x):
        wg = (self.w(pre + ".wg", g) if self.c["act"] in ("swiglu", "geglu")
              else None)
        return self.mm(self._act(x, self.w(pre + ".wi", g), wg),
                       self.w(pre + ".wo", g))

    def moe(self, g: int, h):
        """Routed experts with static capacity over the ``T`` tokens of
        ``h`` (one microbatch), plus the shared experts."""
        c, mm = self.c, self.mm
        moe = c["moe"]
        e, k = moe["num_experts"], moe["top_k"]
        x = h.reshape(-1, h.shape[-1])
        t = x.shape[0]
        top, idx = torch.topk(mm(x, self.w("moe.router", g)), k, dim=-1,
                              sorted=True)
        weight = torch.softmax(top, dim=-1).reshape(-1)
        cap = max(1, int(t * k / e * moe["capacity_factor"]))
        expert = idx.reshape(-1)                       # (token, choice)
        seen = torch.cumsum(F.one_hot(expert, e), dim=0)
        slot = seen.gather(1, expert[:, None])[:, 0] - 1
        kept = slot < cap
        token = torch.arange(t, device=x.device).repeat_interleave(k)
        buf = x.new_zeros((e, cap, x.shape[1])).index_put(
            (expert[kept], slot[kept]), x[token[kept]])
        wg = (self.w("moe.wg", g) if c["act"] in ("swiglu", "geglu")
              else None)
        out = mm(self._act(buf, self.w("moe.wi", g), wg),
                 self.w("moe.wo", g))
        picked = out[expert, slot.clamp(max=cap - 1)]
        y = (picked * (weight * kept)[:, None]).view(t, k, -1).sum(1)
        for j in range(moe["num_shared"]):
            y = y + self.ffn(f"moe.shared{j}", g, x)
        return y.view_as(h)

    def layer(self, g: int, x):
        kind = self.kinds[g]
        pre = "blk." if kind == "attn" else ""
        x = x + self.attention(pre, g, self.rms(x, self.w(pre + "ln1", g)))
        h = self.rms(x, self.w(pre + "ln2", g))
        if kind == "attn":
            return x + self.ffn("blk.ffn", g, h)
        if kind == "dense":
            return x + self.ffn("dense_ffn", g, h)
        return x + self.moe(g, h)

    def loss_sum(self, tokens, labels, embeds=None):
        """Summed token cross-entropy of ``tokens`` [b, s] (or of the
        supplied ``embeds`` [b, s, d]) against ``labels`` [b, s]."""
        x = self.p["embed"][tokens] if embeds is None else embeds
        for g in range(len(self.kinds)):
            x = self.layer(g, x)
        h = self.rms(x, self.p["final_ln"])
        logits = self.mm(h, self.p["head"].T)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1), reduction="sum")


def per_microbatch(c: dict) -> bool:
    """A MoE model's rows run a microbatch at a time, since an expert's
    capacity is counted over one microbatch's tokens (a dense model's one
    row at a time: the sum is the same)."""
    return bool(c.get("moe"))


# ---------------------------------------------------------------------------
# work
# ---------------------------------------------------------------------------
def _glu(c: dict) -> int:
    return 3 if c["act"] in ("swiglu", "geglu") else 2


def _attn_params(c: dict) -> int:
    d, hd = c["d_model"], head_dim(c)
    bias = ((c["num_heads"] + 2 * c["num_kv_heads"]) * hd
            if c.get("qkv_bias") else 0)
    return (d * c["num_heads"] * hd + 2 * d * c["num_kv_heads"] * hd
            + c["num_heads"] * hd * d + bias)


def active_layer_params(c: dict, kind: str) -> int:
    """Parameters a token touches in one layer of ``kind``."""
    d, glu = c["d_model"], _glu(c)
    if kind == "attn":
        return _attn_params(c) + glu * d * c["d_ff"] + 2 * d
    moe = c["moe"]
    if kind == "dense":
        return _attn_params(c) + glu * d * moe["dense_d_ff"] + 2 * d
    if kind == "moe":
        experts = moe["top_k"] + moe["num_shared"]
        return (_attn_params(c) + experts * glu * d * c["d_ff"]
                + d * moe["num_experts"] + 2 * d)
    raise ValueError(kind)


def active_params(c: dict) -> int:
    """N_active: every layer's active parameters, the final norm and the LM
    head (``padded_vocab x d``); the input embedding is a lookup."""
    n = sum(active_layer_params(c, k) for k in pattern(c)) + c["d_model"]
    return n + padded_vocab(c) * c["d_model"]


def model_flops(c: dict, rows: int, seq: int) -> float:
    """Training FLOPs of one step over ``rows`` sequences of ``seq`` tokens:
    ``6 N_active D`` plus causal attention's ``6 x rows x seq x layers x
    seq/2 x 2 x heads x head_dim``.  Recomputed FLOPs are not counted."""
    tokens = rows * seq
    attn_layers = len(pattern(c))
    attn = (6 * rows * seq * attn_layers * (seq / 2) * 2 * c["num_heads"]
            * head_dim(c))
    return 6 * active_params(c) * tokens + attn


def attention_calls(c: dict) -> list[tuple[int, bool]]:
    """Every layer attends causally over the whole sequence."""
    return [(0, True)] * len(pattern(c))


# ---------------------------------------------------------------------------
# the program's config, and the toy cut
# ---------------------------------------------------------------------------
def check_program(c: dict, cfg) -> dict:
    """The fields of the program's ``ArchConfig`` that differ from ``c``:
    ``{field: (program, benchmark)}``.  The program has to run a plain
    decoder: no window, no encoder, no shared block, no SSM."""
    got = {"num_layers": cfg.num_layers, "d_model": cfg.d_model,
           "num_heads": cfg.num_heads, "num_kv_heads": cfg.num_kv_heads,
           "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
           "vocab_size": cfg.vocab_size, "act": cfg.act,
           "norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
           "dtype": str(cfg.dtype).removeprefix("torch."),
           "pattern": list(cfg.pattern),
           "qkv_bias": cfg.qkv_bias, "mrope": cfg.mrope,
           "embed_input": cfg.embed_input,
           "plain": (cfg.sliding_window, cfg.encoder_layers,
                     cfg.shared_attn_period, cfg.ssm is None)}
    want = {k: c[k] for k in got if k in c}
    want.update(head_dim=head_dim(c), pattern=pattern(c),
                qkv_bias=bool(c.get("qkv_bias")),
                mrope=bool(c.get("mrope_section")),
                embed_input=bool(c.get("embed_input")),
                plain=(0, 0, 0, True))
    if c.get("moe"):
        mc = cfg.moe
        got["moe"] = None if mc is None else {
            "num_experts": mc.num_experts, "top_k": mc.top_k,
            "num_shared": mc.num_shared,
            "capacity_factor": mc.capacity_factor,
            "dense_d_ff": mc.dense_d_ff}
        want["moe"] = {k: c["moe"][k] for k in got["moe"] or {}}
    return {k: (got[k], want[k]) for k in want if got.get(k) != want[k]}


#: the toy widths of the CPU tests
SMALL = dict(num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
             head_dim=16, vocab_size=256)


def small(c: dict) -> tuple[dict, dict, dict]:
    """4 layers of d 64 on 2 stages, 4 microbatches of 32 tokens."""
    c = dict(c, **SMALL)
    upd = dict(SMALL, layer_pattern=None)
    if c.get("moe"):
        c["d_ff"] = upd["d_ff"] = 32
        c["moe"] = dict(c["moe"], num_experts=8, top_k=2, num_shared=1,
                        dense_d_ff=96)
        upd["moe"] = {k: c["moe"][k] for k in (
            "num_experts", "top_k", "num_shared", "capacity_factor",
            "dense_d_ff")}
    else:
        c["d_ff"] = upd["d_ff"] = 128
    if c.get("mrope_section"):
        # grouped queries kept; M-RoPE's sections cut to head_dim 16 as
        # the program cuts them
        c["num_kv_heads"] = upd["num_kv_heads"] = 2
        c["mrope_section"] = [2, 3, 3]
    traffic = dict(stages=2, microbatches=4,
                   mb_rows=1 if c.get("moe") else 2, seq=32, trace_steps=1)
    return c, upd, traffic
