"""Plain PyTorch oracles for the ported kernels (the allclose ground truth).

Counterparts of ``repro.kernels.ref.attention_ref`` and ``rmsnorm_ref``:
dense, unblocked, float32 arithmetic, same layouts and contracts.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, positions, causal: bool = True, window: int = 0):
    """Dense-softmax reference attention.

    q: [b, sq, hq, hd]; k, v: [b, sk, hkv, hd]; positions: [b, sq] absolute
    query positions (key positions are arange(sk)).
    """
    b, sq, hq, hd = q.shape
    _, sk, hkv, _ = k.shape
    g = hq // hkv
    qf = (q.float() * hd**-0.5).reshape(b, sq, hkv, g, hd)
    s = torch.einsum("bqkgd,bjkd->bkgqj", qf, k.float())
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((b, sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= positions[:, :, None] >= kpos[None, None, :]
    if window > 0:
        mask &= positions[:, :, None] - kpos[None, None, :] < window
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqj,bjkd->bkgqd", p, v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, hd).to(q.dtype)


def rmsnorm_ref(x, scale, eps: float = 1e-5):
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * (1.0 + scale.float())).to(x.dtype)
