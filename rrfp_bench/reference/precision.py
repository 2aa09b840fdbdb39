"""The precisions a reference computes in.

The control is the reference in the next precision below the one the
configuration states, every matrix product's two operands rounded before a
float32 product, the gradient passed straight through the rounding:
``precision="fp8"`` (below bfloat16) rounds them to float8 e4m3 with a
per-tensor scale (its largest magnitude to 448).
"""
from __future__ import annotations

import torch


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
