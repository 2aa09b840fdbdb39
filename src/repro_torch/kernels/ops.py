"""Public kernel API used by the models: autograd wrappers + launch counts.

Counterpart of ``repro.kernels.ops``.  The backend follows the tensor: a CPU
tensor runs the kernel's plain PyTorch version, a CUDA tensor launches the
hand-written kernel (or raises) — there is no fallback from one to the
other.  Each forward is wrapped in a ``torch.autograd.Function`` whose
backward is plain PyTorch, as the reference's Pallas path backs its
forward kernels with an XLA backward.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rmsnorm as _rn

KERNELS = {"flash_attention_fwd": _fa.COUNTER, "rmsnorm": _rn.COUNTER}


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
        dq, dk, dv = _fa.flash_attention_bwd_plain(
            qt, kt, vt, out, lse, dout.transpose(1, 2), causal=ctx.causal,
            window=ctx.window, dq_scale=ctx.scale)
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
