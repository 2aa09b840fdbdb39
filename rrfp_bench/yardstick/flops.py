"""The benchmark's frozen arithmetic that no model owns: K1 and K2 work,
H100 peaks.  A model's own counts (its FLOPs, its attention calls) are its
family's (:mod:`rrfp_bench.families`).

Copies, on the benchmark's own configuration dicts (``configs/<name>.json``),
of the port's sound counting code as it stood when the benchmark was
written.  The program may change its copies; these stay, so that a later
change to the program cannot move its own yardstick.

* :func:`k1_work`, :func:`k2_work`: ``_k1_work``, ``_k2_work`` and
  ``_pairs`` (``src/repro_torch/analysis/roofline.py:183-202``), on shapes
  instead of tensors: the operations and the bytes of each input read once
  and each output written once.
* :func:`mean_over_calls`: the mean of a bound over a model's attention
  calls.
"""
from __future__ import annotations

import collections
import math

#: dense bf16 tensor-core peak of one H100 SXM (NVIDIA H100 data sheet, 700 W)
PEAK_BF16_FLOPS = 989e12
#: each dtype's peak for a kernel's roofline: float32 off the tensor cores
#: (67 TFLOP/s; TF32 would round the operands)
PEAK_FLOPS = {"bfloat16": PEAK_BF16_FLOPS, "float16": PEAK_BF16_FLOPS,
              "float32": 67e12}
#: HBM3 bandwidth of one H100 SXM 80 GB (NVIDIA H100 data sheet)
HBM_BYTES_PER_S = 3.35e12

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def head_dim(c: dict) -> int:
    return c.get("head_dim") or c["d_model"] // c["num_heads"]


def padded_vocab(c: dict, multiple: int = 16) -> int:
    return int(math.ceil(c["vocab_size"] / multiple) * multiple)


def causal_pairs(sq: int, sk: int, causal: bool = True,
                 window: int = 0) -> int:
    """(query, key) pairs a K1 call scores."""
    if not causal:
        return sq * sk
    cap = min(window or sk, sk)
    if sq <= cap:
        return sq * (sq + 1) // 2
    return cap * (cap + 1) // 2 + (sq - cap) * cap


def k1_work(b: int, hq: int, sq: int, hkv: int, sk: int, hd: int,
            itemsize: int, causal: bool = True,
            window: int = 0) -> tuple[int, int]:
    """FLOPs and bytes of one K1 call, q ``[b, hq, sq, hd]``, k and v
    ``[b, hkv, sk, hd]``: the unmasked pairs' 4 x hd FLOPs; q read and the
    output written, k and v read, and the float32 log-sum-exp written."""
    flops = 4 * b * hq * causal_pairs(sq, sk, causal, window) * hd
    q = b * hq * sq * hd * itemsize
    kv = b * hkv * sk * hd * itemsize
    return flops, 2 * q + 2 * kv + b * hq * sq * 4


def k2_work(rows: int, d: int, itemsize: int) -> tuple[int, int]:
    """FLOPs and bytes of one K2 call on ``[rows, d]`` with a ``[d]``
    scale: x read and written once, the scale read once."""
    return 4 * rows * d, 2 * rows * d * itemsize + d * itemsize


def bound_seconds(flops: float, nbytes: float,
                  dtype: str = "bfloat16") -> float:
    """The least time one H100 could take for work in ``dtype``: the
    larger of the two terms."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def mean_over_calls(calls, bound) -> float:
    """The mean of ``bound(window, causal)`` over ``calls``, one ``(window,
    causal)`` per attention layer: every layer runs equally often in a
    step.  Each distinct call is weighted by its share of the layers, so
    that a model of one kind of layer reads that kind's bound exactly."""
    counts = collections.Counter(calls)
    n = sum(counts.values())
    return sum(k / n * bound(window, causal)
               for (window, causal), k in counts.items())
