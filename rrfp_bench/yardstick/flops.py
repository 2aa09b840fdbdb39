"""The benchmark's frozen arithmetic: model FLOPs, K1 and K2 work, H100 peaks.

Copies, on the benchmark's own configuration dicts (``configs/<name>.json``),
of the port's sound counting code as it stood when the benchmark was
written.  The program may change its copies; these stay, so that a later
change to the program cannot move its own yardstick.

* :func:`model_flops`: ``ArchModel.model_flops``
  (``src/repro_torch/models/build.py:560``) with the parameter accounting of
  ``ArchConfig.layer_param_count``, ``active_layer_param_count`` and
  ``active_param_count`` (``src/repro_torch/models/common.py:110-182``):
  6 x N_active x tokens, N_active without the embedding but with the LM
  head, plus the attention context FLOPs of every attention layer.
  Recomputed FLOPs are not counted.
* :func:`k1_work`, :func:`k2_work`: ``_k1_work``, ``_k2_work`` and
  ``_pairs`` (``src/repro_torch/analysis/roofline.py:183-202``), on shapes
  instead of tensors: the operations and the bytes of each input read once
  and each output written once.
"""
from __future__ import annotations

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


def pattern(c: dict) -> list[str]:
    """Layer kinds in order: ``attn`` for a dense decoder; a MoE config's
    ``first_dense`` leading ``dense`` layers, then ``moe``."""
    n = c["num_layers"]
    moe = c.get("moe")
    if moe is None:
        return ["attn"] * n
    k = moe["first_dense"]
    return ["dense"] * min(k, n) + ["moe"] * max(n - k, 0)


def _glu(c: dict) -> int:
    return 3 if c["act"] in ("swiglu", "geglu") else 2


def _attn_params(c: dict) -> int:
    d, hd = c["d_model"], head_dim(c)
    bias = ((c["num_heads"] + 2 * c["num_kv_heads"]) * hd
            if c.get("qkv_bias") else 0)
    return (d * c["num_heads"] * hd + 2 * d * c["num_kv_heads"] * hd
            + c["num_heads"] * hd * d + bias)


def active_layer_params(c: dict, kind: str) -> int:
    """Parameters a token touches in one layer of ``kind``."""
    d, glu = c["d_model"], _glu(c)
    if kind == "attn":
        return _attn_params(c) + glu * d * c["d_ff"] + 2 * d
    moe = c["moe"]
    if kind == "dense":
        return _attn_params(c) + glu * d * moe["dense_d_ff"] + 2 * d
    if kind == "moe":
        experts = moe["top_k"] + moe["num_shared"]
        return (_attn_params(c) + experts * glu * d * c["d_ff"]
                + d * moe["num_experts"] + 2 * d)
    raise ValueError(kind)


def active_params(c: dict) -> int:
    """N_active: every layer's active parameters, the final norm and the LM
    head (``padded_vocab x d``); the input embedding is a lookup."""
    n = sum(active_layer_params(c, k) for k in pattern(c)) + c["d_model"]
    return n + padded_vocab(c) * c["d_model"]


def model_flops(c: dict, rows: int, seq: int) -> float:
    """Training FLOPs of one step over ``rows`` sequences of ``seq`` tokens:
    ``6 N_active D`` plus causal attention's ``6 x rows x seq x layers x
    seq/2 x 2 x heads x head_dim``."""
    tokens = rows * seq
    attn_layers = len(pattern(c))
    attn = (6 * rows * seq * attn_layers * (seq / 2) * 2 * c["num_heads"]
            * head_dim(c))
    return 6 * active_params(c) * tokens + attn


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
