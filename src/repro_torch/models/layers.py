"""Transformer building blocks in PyTorch.

Port of ``repro.models.layers``: pre-norm decoder layer = RMSNorm (kernel
K2) -> RoPE (or qwen2-vl's 3-axis M-RoPE) -> GQA attention (kernel K1) ->
RMSNorm -> FFN; the enc-dec decoder's cross-attention (``attention_block``
with ``kv_src``: K1 with ``sq != sk``, non-causal); and its decode
half: one token against a KV cache (``decode_attention_block``,
``decoder_layer_decode``; the plain ``decode_attention``, as the reference's
self-attention decode reaches no kernel; over a cache sharded on its
sequence, the distributed flash-decode, plain PyTorch like the
reference's).  Caches are updated in place
where the reference returns new ones.  Parameters are
``nn.Module``s whose weights keep the reference's ``[in, out]`` layout
(``x @ w``), so reference parameters load by path
(:mod:`repro_torch.models.convert`).  The port's own initialisation draws
from an explicit ``torch.Generator`` with the reference's scales.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF, decode_ref
from repro_torch.models.common import ArchConfig


def dense_param(gen: torch.Generator | None, shape, dtype, device,
                scale: float | None = None) -> nn.Parameter:
    """Normal init scaled by 1/sqrt(fan_in) (the reference's ``dense_init``);
    ``gen=None`` allocates without initialising (the weights are loaded)."""
    if gen is None:
        return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return nn.Parameter((w * scale).to(dtype))


def zeros_param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm(x, scale, eps: float = 1e-5):
    return ops.rmsnorm(x, scale, eps=eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def arange_positions(x):
    """Positions ``arange(s)`` for every row of x [b, s, ...]."""
    return torch.arange(x.shape[1], device=x.device)[None].expand(
        x.shape[:2])


def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: [b, s, h, hd]; positions: [b, s] (int).  Rotates split halves."""
    hd = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(hd, theta), dtype=torch.float32,
                            device=x.device)
    ang = positions[..., None].float() * freqs  # [b, s, hd/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions3, theta: float = 10_000.0,
                sections=(16, 24, 24)):
    """Qwen2-VL multimodal RoPE: positions3 [3, b, s] (t/h/w axes).

    The rotary half-dim is split into three sections, each rotated by its
    own position stream.  ``sections`` are half-dim sizes summing to hd/2;
    a reduced head dim rescales them as the reference does (numpy int64
    truncation, the last section taking the remainder).
    """
    hd = x.shape[-1]
    secs = np.asarray(sections, dtype=np.int64)
    if secs.sum() * 2 != hd:
        secs = np.maximum(1, (secs * (hd // 2) / secs.sum()).astype(np.int64))
        secs[-1] = hd // 2 - secs[:-1].sum()
    freqs = torch.as_tensor(rope_freqs(hd, theta), dtype=torch.float32,
                            device=x.device)
    parts = np.concatenate([[0], np.cumsum(secs)])
    ang = torch.cat([positions3[i][..., None].float()
                     * freqs[parts[i]:parts[i + 1]] for i in range(3)],
                    dim=-1)  # [b, s, hd/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention block (GQA, optional bias / sliding window / M-RoPE)
# ---------------------------------------------------------------------------
class Attention(nn.Module):
    """Self-attention weights, or cross-attention's (``cross``: no biases,
    as the reference's ``init_attention(cross=True)``)."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator, device,
                 cross: bool = False):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        nq, nkv = cfg.num_heads, cfg.num_kv_heads
        self.wq = dense_param(gen, (d, nq * hd), cfg.dtype, device)
        self.wk = dense_param(gen, (d, nkv * hd), cfg.dtype, device)
        self.wv = dense_param(gen, (d, nkv * hd), cfg.dtype, device)
        self.wo = dense_param(gen, (nq * hd, d), cfg.dtype, device)
        if cfg.qkv_bias and not cross:
            self.bq = zeros_param((nq * hd,), cfg.dtype, device)
            self.bk = zeros_param((nkv * hd,), cfg.dtype, device)
            self.bv = zeros_param((nkv * hd,), cfg.dtype, device)


def attention_qkv(p: Attention, x, cfg: ArchConfig, kv_src=None):
    """q from ``x`` [b, s, d]; k and v from ``kv_src`` [b, sk, d] (``x``
    itself when None: self-attention).  Biases where the weights have
    them (cross-attention has none)."""
    kv_src = x if kv_src is None else kv_src
    b, s, _ = x.shape
    sk = kv_src.shape[1]
    nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, k, v = x @ p.wq, kv_src @ p.wk, kv_src @ p.wv
    if hasattr(p, "bq"):
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    return (q.reshape(b, s, nq, hd), k.reshape(b, sk, nkv, hd),
            v.reshape(b, sk, nkv, hd))


def attention_block(p: Attention, x, positions, cfg: ArchConfig, *,
                    causal: bool = True, window: int = 0, mrope_pos=None,
                    kv_src=None, rope: bool = True):
    """Self- (or cross-) attention sub-block; the pre-norm residual is the
    caller's.

    Cross-attention (``kv_src`` [b, sk, d], the encoder's output) takes its
    keys and values from ``kv_src``; with ``rope`` they rotate by
    ``arange(sk)`` (the enc-dec decoder passes ``rope=False``).  As in the
    reference, an M-RoPE config rotates by its 3-axis positions
    ``mrope_pos`` [3, b, s] when they are given, and by plain RoPE
    otherwise (the multimodal DAG's LM layers give none).
    """
    q, k, v = attention_qkv(p, x, cfg, kv_src)
    if rope and cfg.mrope and mrope_pos is not None:
        q = apply_mrope(q, mrope_pos, cfg.rope_theta)
        k = apply_mrope(k, mrope_pos, cfg.rope_theta)
    elif rope:
        kv_positions = (positions if kv_src is None
                        else arange_positions(kv_src))
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    o = ops.flash_attention(q, k, v, positions, causal=causal, window=window)
    b, s = x.shape[:2]
    return o.reshape(b, s, -1) @ p.wo


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------
class FFN(nn.Module):
    def __init__(self, cfg: ArchConfig, gen: torch.Generator, device,
                 d_ff: int | None = None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        self.wi = dense_param(gen, (d, f), cfg.dtype, device)
        if cfg.act in ("swiglu", "geglu"):
            self.wg = dense_param(gen, (d, f), cfg.dtype, device)
        self.wo = dense_param(gen, (f, d), cfg.dtype, device)


def ffn_block(p: FFN, x, act: str):
    h = x @ p.wi
    if act == "swiglu":
        h = F.silu(x @ p.wg) * h
    elif act == "geglu":
        h = F.gelu(x @ p.wg, approximate="tanh") * h
    else:
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    return h @ p.wo


# ---------------------------------------------------------------------------
# Standard decoder layer (attn + ffn, pre-norm)
# ---------------------------------------------------------------------------
class DecoderLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, gen: torch.Generator, device):
        super().__init__()
        self.ln1 = zeros_param((cfg.d_model,), cfg.dtype, device)
        self.attn = Attention(cfg, gen, device)
        self.ln2 = zeros_param((cfg.d_model,), cfg.dtype, device)
        self.ffn = FFN(cfg, gen, device)


def decoder_layer(p: DecoderLayer, x, positions, cfg: ArchConfig, *,
                  causal: bool = True, window: int = 0, mrope_pos=None):
    h = rmsnorm(x, p.ln1, cfg.norm_eps)
    x = x + attention_block(p.attn, h, positions, cfg, causal=causal,
                            window=window, mrope_pos=mrope_pos)
    h = rmsnorm(x, p.ln2, cfg.norm_eps)
    return x + ffn_block(p.ffn, h, cfg.act)


# ---------------------------------------------------------------------------
# KV-cache decode variants
# ---------------------------------------------------------------------------
#: single-position attention against a cache, per-row lengths (plain
#: PyTorch: the reference's self-attention decode reaches no kernel and is
#: the same function as its oracle ``decode_ref``)
decode_attention = decode_ref


def decode_attention_block(p: Attention, x, cache: dict, pos: int,
                           cfg: ArchConfig, window: int = 0, axis=None):
    """One-token attention with cache update.

    x: [b, 1, d]; cache: dict(k=[b, S, hkv, hd], v=[b, S, hkv, hd]); pos:
    the current index.  The new key and value are written into the cache
    in place (the reference returns updated copies); returns
    ``(out [b, 1, d], cache)``.  An M-RoPE config decodes with plain RoPE
    at ``pos``, as the reference's ``decode_attention_block`` does.

    ``axis`` (the reference's ``axis_name``: a
    :class:`~repro_torch.launch.mesh.AxisGroup`) shards the cache's S dim
    over a group of ranks, ``shard`` rows a rank from ``axis.index *
    shard`` (sequence parallelism for long_500k): only the rank holding
    row ``pos`` writes it, each rank scores its shard in float32, and the
    partial softmax is combined with ``pmax`` and ``psum`` (the distributed
    flash-decode; plain PyTorch, as the reference's is XLA code).
    """
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = attention_qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k_new = apply_rope(k_new, positions, cfg.rope_theta)
    if axis is None:
        cache["k"][:, pos] = k_new[:, 0]
        cache["v"][:, pos] = v_new[:, 0]
        lengths = torch.full((b,), pos + 1, dtype=torch.int32,
                             device=x.device)
        o = decode_attention(q, cache["k"], cache["v"], lengths,
                             window=window)
        return o.reshape(b, 1, -1) @ p.wo, cache
    k_cache, v_cache = cache["k"], cache["v"]
    shard, hkv, hd = k_cache.shape[1:]
    local = pos - axis.index * shard
    if 0 <= local < shard:  # the reference's where(in_range, ...)
        k_cache[:, local] = k_new[:, 0]
        v_cache[:, local] = v_new[:, 0]
    qf = (q.float() * hd**-0.5).reshape(b, hkv, -1, hd)
    s = torch.einsum("bkgd,bjkd->bkgj", qf, k_cache.float())
    kpos = axis.index * shard + torch.arange(shard, device=x.device)
    mask = kpos <= pos
    if window > 0:
        mask &= kpos > pos - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    # a shard with no key in range (a local layer once pos has left it)
    # has m_loc = NEG_INF and adds exp(NEG_INF - m_glob) = 0 to both sums
    m_glob = axis.pmax(s.amax(-1))
    p_ = torch.exp(s - m_glob[..., None])
    num = axis.psum(torch.einsum("bkgj,bjkd->bkgd", p_, v_cache.float()))
    den = axis.psum(p_.sum(-1))
    o = (num / torch.clamp(den[..., None], min=1e-30)).reshape(b, 1, -1)
    return o.to(x.dtype) @ p.wo, cache


def decoder_layer_decode(p: DecoderLayer, x, cache: dict, pos: int,
                         cfg: ArchConfig, window: int = 0, axis=None):
    h = rmsnorm(x, p.ln1, cfg.norm_eps)
    a, cache = decode_attention_block(p.attn, h, cache, pos, cfg,
                                      window=window, axis=axis)
    x = x + a
    h = rmsnorm(x, p.ln2, cfg.norm_eps)
    return x + ffn_block(p.ffn, h, cfg.act), cache
