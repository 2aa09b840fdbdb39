"""Transformer building blocks in PyTorch (training half).

Port of ``repro.models.layers``: pre-norm decoder layer = RMSNorm (kernel
K2) -> RoPE -> GQA attention (kernel K1) -> RMSNorm -> FFN.  Parameters are
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
    def __init__(self, cfg: ArchConfig, gen: torch.Generator, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        nq, nkv = cfg.num_heads, cfg.num_kv_heads
        self.wq = dense_param(gen, (d, nq * hd), cfg.dtype, device)
        self.wk = dense_param(gen, (d, nkv * hd), cfg.dtype, device)
        self.wv = dense_param(gen, (d, nkv * hd), cfg.dtype, device)
        self.wo = dense_param(gen, (nq * hd, d), cfg.dtype, device)
        if cfg.qkv_bias:
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
                    causal: bool = True, window: int = 0):
    """Self-attention sub-block; the pre-norm residual is the caller's."""
    if cfg.mrope:
        raise NotImplementedError(
            "M-RoPE (qwen2-vl) moves with the other-families slice "
            "(ROADMAP queue 1)")
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
                  causal: bool = True, window: int = 0):
    h = rmsnorm(x, p.ln1, cfg.norm_eps)
    x = x + attention_block(p.attn, h, positions, cfg, causal=causal,
                            window=window)
    h = rmsnorm(x, p.ln2, cfg.norm_eps)
    return x + ffn_block(p.ffn, h, cfg.act)
