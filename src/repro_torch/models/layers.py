"""Transformer building blocks in PyTorch.

Port of ``repro.models.layers``: pre-norm decoder layer = RMSNorm (kernel
K2) -> RoPE -> GQA attention (kernel K1) -> RMSNorm -> FFN, and its decode
half: one token against a KV cache (``decode_attention_block``,
``decoder_layer_decode``; the plain ``decode_attention``, as the reference's
self-attention decode reaches no kernel).  Caches are updated in place
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
from repro_torch.kernels.ref import decode_ref
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


# ---------------------------------------------------------------------------
# Attention block (GQA, optional bias / sliding window)
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


def attention_qkv(p: Attention, x, cfg: ArchConfig):
    b, s, _ = x.shape
    nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    return (q.reshape(b, s, nq, hd), k.reshape(b, s, nkv, hd),
            v.reshape(b, s, nkv, hd))


def attention_block(p: Attention, x, positions, cfg: ArchConfig, *,
                    causal: bool = True, window: int = 0, mrope_pos=None):
    """Self-attention sub-block; the pre-norm residual is the caller's.

    As in the reference, an M-RoPE config rotates by its 3-axis positions
    only when ``mrope_pos`` is given, and by plain RoPE otherwise (the
    multimodal DAG's LM layers give none).
    """
    if cfg.mrope and mrope_pos is not None:
        raise NotImplementedError(
            "M-RoPE positions (qwen2-vl's 3-axis rotary) are not in the "
            "port yet: apply_mrope moves with the other-families slice "
            "(ROADMAP.md queue 1, item 16)")
    q, k, v = attention_qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
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
                           cfg: ArchConfig, window: int = 0,
                           axis_name: str | None = None):
    """One-token attention with cache update.

    x: [b, 1, d]; cache: dict(k=[b, S, hkv, hd], v=[b, S, hkv, hd]); pos:
    the current index.  The new key and value are written into the cache
    in place (the reference returns updated copies); returns
    ``(out [b, 1, d], cache)``.
    """
    if axis_name is not None:
        raise NotImplementedError(
            "sequence-parallel decode (a cache sharded over devices) moves "
            "with the multi-device slice (ROADMAP.md queue 1, item 18)")
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = attention_qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k_new = apply_rope(k_new, positions, cfg.rope_theta)
    cache["k"][:, pos] = k_new[:, 0]
    cache["v"][:, pos] = v_new[:, 0]
    lengths = torch.full((b,), pos + 1, dtype=torch.int32, device=x.device)
    o = decode_attention(q, cache["k"], cache["v"], lengths, window=window)
    return o.reshape(b, 1, -1) @ p.wo, cache


def decoder_layer_decode(p: DecoderLayer, x, cache: dict, pos: int,
                         cfg: ArchConfig, window: int = 0, axis_name=None):
    h = rmsnorm(x, p.ln1, cfg.norm_eps)
    a, cache = decode_attention_block(p.attn, h, cache, pos, cfg,
                                      window=window, axis_name=axis_name)
    x = x + a
    h = rmsnorm(x, p.ln2, cfg.norm_eps)
    return x + ffn_block(p.ffn, h, cfg.act), cache
