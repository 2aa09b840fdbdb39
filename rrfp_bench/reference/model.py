"""Plain PyTorch reference of the benchmark's models, in float32.

A pre-norm decoder: RMSNorm ``x * rsqrt(mean(x^2) + eps) * (1 + scale)``,
rotary positions on split halves (M-RoPE where the configuration names its
``mrope_section``: each section of the frequencies turned by its own axis
of positions; a text-only stub gives every axis ``0..s-1``), causal
softmax attention with query, key and value biases where the configuration
has ``qkv_bias``, and either a
feed-forward block (GELU in its tanh form, or SwiGLU) or, in a MoE layer,
routed experts with static capacity plus shared experts; a final RMSNorm,
an untied LM head and the mean token cross-entropy.  Its input is the
``embed`` row of each token or, for a configuration with ``embed_input``,
the embeddings a frontend supplies.  It follows the
benchmark's configuration files (``configs/<name>.json``) and imports
nothing of the program.

The MoE layer is the configuration's: softmax over the top-k router logits
of each token; an expert takes at most ``C = int(T * top_k / experts *
capacity_factor)`` of the ``T`` tokens of one microbatch, in the order of
(token, choice), and a token past that is dropped from that expert.

The control is the reference in the next precision below the one the
configuration states, every matrix product's two operands rounded before a
float32 product, the gradient passed straight through the rounding:
``precision="fp8"`` (below bfloat16) rounds them to float8 e4m3 with a
per-tensor scale (its largest magnitude to 448).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from rrfp_bench.yardstick.flops import head_dim, pattern


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 at a per-tensor scale; the gradient
    passes straight through."""
    with torch.no_grad():
        scale = 448.0 / t.abs().amax().clamp_min(1e-12)
        q = (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale
    return t + (q - t).detach()


#: the control's precision for each precision a configuration states
CONTROL = {"bfloat16": "fp8"}


def matmul_fn(precision: str):
    if precision in ("fp32", "fp64"):
        return torch.matmul
    rnd = {"fp8": _fp8}[precision]
    return lambda a, b: torch.matmul(rnd(a), rnd(b))


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
        causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
        scores = scores.masked_fill(~causal, float("-inf"))
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
