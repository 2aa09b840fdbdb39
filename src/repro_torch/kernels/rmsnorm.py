"""Fused RMSNorm (kernel K2): Triton launcher, plain version, counter.

Replaces the Pallas TPU kernel ``repro/kernels/rmsnorm.py`` (``rmsnorm`` /
``_kernel``): ``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` per row in
float32, cast back to the input dtype.

Bound on the H100: bytes.  Each row is read once and written once with a
handful of FLOPs per element, far below the card's ~295 FLOP/byte ridge, so
the floor is ``(2 * rows * d * itemsize + d * itemsize) / 3.35 TB/s``.  The
kernel is one pass: a program loads a block of whole rows with masked,
contiguous loads, reduces each row in registers (``tl.sum``), and stores the
normalized rows — no second read, no float32 round trip through memory.

``triton`` is imported inside the launcher, so this module imports on a
machine without it; a CPU tensor takes the plain version.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm_ref

COUNTER = _build.LaunchCounter("rmsnorm")
_LOCK = threading.Lock()  # first launches compile; keep actor threads serial
_JIT = None
tl = None  # triton.language, bound by _kernel() (the kernel reads it as a global)


#: plain PyTorch version of the kernel: the oracle computes the same function
rmsnorm_plain = rmsnorm_ref


def _rmsnorm_kernel(X, S, O, n_rows, d, x_stride, o_stride, eps,
                    BLOCK_D: tl.constexpr, ROWS: tl.constexpr):
    pid = tl.program_id(0)
    rows = pid * ROWS + tl.arange(0, ROWS)
    cols = tl.arange(0, BLOCK_D)
    row_ok = rows < n_rows
    col_ok = cols < d
    mask = row_ok[:, None] & col_ok[None, :]
    r64 = rows.to(tl.int64)
    x = tl.load(X + r64[:, None] * x_stride + cols[None, :], mask=mask,
                other=0.0).to(tl.float32)
    s = tl.load(S + cols, mask=col_ok, other=0.0).to(tl.float32)
    var = tl.sum(x * x, axis=1) / d
    inv = 1.0 / tl.sqrt(var + eps)
    y = x * inv[:, None] * (1.0 + s)[None, :]
    tl.store(O + r64[:, None] * o_stride + cols[None, :],
             y.to(O.dtype.element_ty), mask=mask)


def _kernel():
    global _JIT, tl
    if _JIT is None:
        import triton
        import triton.language as tl

        _JIT = triton.jit(_rmsnorm_kernel)
    return _JIT


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def rmsnorm(x, scale, eps: float = 1e-5):
    """K2 forward.  x: [..., d] (contiguous last axis); scale: [d].

    CPU tensors take the plain version; CUDA tensors launch the Triton
    kernel or raise.
    """
    if x.device.type in _build.PLAIN_DEVICES:
        return rmsnorm_plain(x, scale, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"rmsnorm: no kernel for {x.device}")
    d = x.shape[-1]
    if scale.shape != (d,) or scale.device != x.device:
        raise ValueError(f"rmsnorm: scale {tuple(scale.shape)} on "
                         f"{scale.device} for x {tuple(x.shape)} on {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"rmsnorm: no kernel for dtype {x.dtype}")
    x2 = x.reshape(-1, d)
    if x2.stride(-1) != 1:
        raise ValueError("rmsnorm: the normalized axis must be contiguous")
    scale = scale.contiguous()
    out = torch.empty((x2.shape[0], d), dtype=x.dtype, device=x.device)
    n_rows = x2.shape[0]
    block_d = _next_pow2(d)
    rows = max(1, min(16, 8192 // block_d))
    grid = ((n_rows + rows - 1) // rows,)
    with _LOCK:
        _kernel()[grid](x2, scale, out, n_rows, d, x2.stride(0),
                        out.stride(0), float(eps), BLOCK_D=block_d,
                        ROWS=rows, num_warps=8 if block_d >= 2048 else 4)
    COUNTER.add()
    return out.reshape(x.shape)
