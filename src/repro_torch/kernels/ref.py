"""Plain PyTorch oracles for the ported kernels (the allclose ground truth).

Counterparts of ``repro.kernels.ref.attention_ref``, ``decode_ref``,
``rmsnorm_ref``, ``ssd_ref`` and ``ssd_ref_with_state``: dense, unblocked
(the SSD one sequential over time), float32 arithmetic, same layouts and
contracts.
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


def decode_ref(q, k_cache, v_cache, lengths, window: int = 0):
    """Single-token decode attention reference.

    q: [b, 1, hq, hd]; caches: [b, S, hkv, hd]; lengths: [b].
    """
    b, _, hq, hd = q.shape
    _, S, hkv, _ = k_cache.shape
    g = hq // hkv
    qf = (q.float() * hd**-0.5).reshape(b, hkv, g, hd)
    s = torch.einsum("bkgd,bjkd->bkgj", qf, k_cache.float())
    pos = torch.arange(S, device=q.device)[None, :]
    mask = pos < lengths[:, None]
    if window > 0:
        mask &= pos >= lengths[:, None] - window
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgj,bjkd->bkgd", p, v_cache.float())
    return o.reshape(b, 1, hq, hd).to(q.dtype)


def rmsnorm_ref(x, scale, eps: float = 1e-5):
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * (1.0 + scale.float())).to(x.dtype)


def _ssd_sequential(x, dt, A, B, C, D):
    """(y, final state) of the SSD recurrence, one time step at a time."""
    bsz, s, nh, hd = x.shape
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf, Cf = B.float(), C.float()
    h = torch.zeros((bsz, nh, hd, B.shape[-1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(Af[None, :] * dtf[:, t])  # [b, nh]
        upd = torch.einsum("bnh,bs->bnhs", xf[:, t] * dtf[:, t, :, None],
                           Bf[:, t])
        h = h * decay[..., None, None] + upd
        ys.append(torch.einsum("bnhs,bs->bnh", h, Cf[:, t]))
    y = torch.stack(ys, dim=1) + D.float()[None, None, :, None] * xf
    return y.to(x.dtype), h


def ssd_ref(x, dt, A, B, C, D, chunk: int = 0):
    """Sequential (exact) Mamba-2 SSD recurrence.

    x: [b, s, nh, hd]; dt: [b, s, nh]; A: [nh] (negative); B, C: [b, s, ds];
    D: [nh].  Returns y: [b, s, nh, hd].
    State: h[nh, hd, ds];  h_t = exp(A*dt) h_{t-1} + dt * x_t B_t^T;
    y_t = (h_t C_t) + D * x_t.
    """
    return _ssd_sequential(x, dt, A, B, C, D)[0]


def ssd_ref_with_state(x, dt, A, B, C, D):
    """Like ``ssd_ref`` but also returns the final state (decode handoff)."""
    return _ssd_sequential(x, dt, A, B, C, D)
