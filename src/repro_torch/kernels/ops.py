"""Public kernel API used by the models: autograd wrappers + launch counts.

Counterpart of ``repro.kernels.ops``.  The backend follows the tensor: a CPU
tensor runs the kernel's plain PyTorch version, a CUDA tensor launches the
hand-written kernel (or raises) — there is no fallback from one to the
other.  Each forward is wrapped in a ``torch.autograd.Function`` whose
backward is plain PyTorch, as the reference's Pallas path backs its
forward kernels with an XLA backward; attention's backward is a kernel
too on bf16 CUDA tensors (K1b, ``flash_attention_bwd``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssd_scan as _ssd

KERNELS = {"flash_attention_fwd": _fa.COUNTER,
           "flash_attention_bwd": _fa.COUNTER_BWD, "rmsnorm": _rn.COUNTER,
           "flash_decode": _fd.COUNTER, "ssd_scan": _ssd.COUNTER}


def launch_counts() -> dict[str, int]:
    return {name: c.value for name, c in KERNELS.items()}


def reset_launch_counts() -> None:
    for c in KERNELS.values():
        c.reset()


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        hd = q.shape[-1]
        scale = hd ** -0.5
        qt = (q * scale).to(q.dtype).transpose(1, 2)
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        out, lse = _fa.flash_attention_fwd(qt, kt, vt, causal=causal,
                                           window=window)
        ctx.save_for_backward(qt, kt, vt, out, lse)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        return out.transpose(1, 2).contiguous()

    @staticmethod
    def backward(ctx, dout):
        qt, kt, vt, out, lse = ctx.saved_tensors
        dq, dk, dv = _fa.flash_attention_bwd(
            qt, kt, vt, out, lse, dout.contiguous().transpose(1, 2),
            causal=ctx.causal, window=ctx.window, dq_scale=ctx.scale)
        return (dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2),
                None, None)


def flash_attention(q, k, v, positions=None, *, causal: bool = True,
                    window: int = 0):
    """q: [b, sq, hq, hd]; k, v: [b, sk, hkv, hd] -> [b, sq, hq, hd].

    As on the reference's kernel path, query positions are ``arange(sq)``
    (training self-attention); ``positions`` is accepted for signature
    parity and not read.
    """
    return _FlashAttention.apply(q, k, v, causal, window)


def decode_attention(q, k_cache, v_cache, length, *, window: int = 0):
    """q: [b, 1, hq, hd]; caches: [b, S, hkv, hd]; length: an int or an
    int32 device tensor of one element (every row's valid length).

    Kernel K3 (``flash_decode``): q is scaled by ``hd**-0.5`` and rounded
    to its dtype, as the reference's Pallas path does; the caches are
    passed as strided views, never copied.  Inference only (no backward).
    """
    hd = q.shape[-1]
    qt = (q * hd ** -0.5).to(q.dtype).transpose(1, 2)
    out = _fd.flash_decode(qt, k_cache.transpose(1, 2),
                           v_cache.transpose(1, 2), length, window=window)
    return out.transpose(1, 2)


# ---------------------------------------------------------------------------
# SSD (Mamba-2)
# ---------------------------------------------------------------------------
class _SSD(torch.autograd.Function):
    """K4 forward; the backward differentiates the plain chunked version
    (recompute), as the reference's ``_pallas_ssd_bwd`` takes the VJP of
    ``_ssd_xla_chunked``."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, chunk):
        ctx.save_for_backward(x, dt, A, B, C, D)
        ctx.chunk = chunk
        return _ssd.ssd_scan(x, dt, A, B, C, D, chunk=chunk)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need) for t, need
                      in zip(ctx.saved_tensors, ctx.needs_input_grad)]
            y = _ssd.ssd_chunked_plain(*leaves, chunk=ctx.chunk)
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, g))
        return (*(next(grads) if t.requires_grad else None for t in leaves),
                None)


def ssd(x, dt, A, B, C, D, *, chunk: int = 128):
    """x: [b, s, nh, hd]; dt: [b, s, nh]; A, D: [nh]; B, C: [b, s, ds].

    Pads the length to a multiple of ``chunk`` (zeros: dt = 0 leaves the
    state unchanged) and slices y back, as the reference's ``ops.ssd``.
    """
    s = x.shape[1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    return _SSD.apply(x, dt, A, B, C, D, chunk)[:, :s]


def ssd_decode_step(state, x, dt, A, B, C, D):
    """Single-token SSD update (plain PyTorch, as in the reference).
    state: [b, nh, hd, ds] float32; x: [b, nh, hd]; dt: [b, nh]; B, C:
    [b, ds].  Returns (y [b, nh, hd] in x's dtype, new float32 state)."""
    decay = torch.exp(A.float()[None, :] * dt.float())
    upd = torch.einsum("bnh,bs->bnhs", x.float() * dt[..., None], B.float())
    state = state * decay[..., None, None] + upd
    y = torch.einsum("bnhs,bs->bnh", state, C.float())
    y = y + D.float()[None, :, None] * x.float()
    return y.to(x.dtype), state


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rn.rmsnorm(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        xf = x.float()
        inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + ctx.eps)
        n = xf * inv
        gf = g.float()
        dscale = (gf * n).reshape(-1, x.shape[-1]).sum(0)
        dn = gf * (1.0 + scale.float())
        dx = inv * (dn - n * torch.mean(dn * n, dim=-1, keepdim=True))
        return dx.to(x.dtype), dscale.to(scale.dtype), None


def rmsnorm(x, scale, *, eps: float = 1e-5):
    """x: [..., d]; scale: [d] -> x * rsqrt(mean(x^2) + eps) * (1 + scale)."""
    return _RMSNorm.apply(x, scale, eps)
