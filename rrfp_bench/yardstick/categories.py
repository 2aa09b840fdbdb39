"""Device kernel categories: a frozen copy of ``CATEGORIES`` and ``category``
of ``src/repro_torch/launch/profile.py:61-86``.

A kernel's category is the first whose substrings its name contains.
"""
from __future__ import annotations

K1 = "K1 flash_attention_fwd"
K2 = "K2 rmsnorm"
FP32_GEMM = "matmul float32 (no tensor cores)"
SORT_SCAN = "sort / top-k / scan"
INDEXING = "indexing"

#: (category, substrings of the kernel name), first match wins
CATEGORIES = (
    (K1, ("flash_fwd_kernel",)),
    ("K3 flash_decode", ("flash_decode_kernel",)),
    (K2, ("_rmsnorm_kernel",)),
    ("K4 ssd_scan", ("ssd_tc_kernel", "ssd_scan_kernel")),
    (FP32_GEMM, ("f32f32", "sgemm")),
    ("matmul (tensor cores)", ("nvjet", "gemm", "xmma", "cutlass",
                               "Kernel2", "sm90_")),
    ("reductions / softmax", ("reduce", "softmax", "logsumexp")),
    (SORT_SCAN, ("sort", "topk", "Sort", "scan", "radix")),
    (INDEXING, ("index", "scatter", "gather", "embedding")),
    ("cat / stack (mesh exchanges)", ("CatArrayBatchedCopy",)),
    ("copies / casts / fills", ("copy", "Memcpy", "Memset", "fill",
                                "cat")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def category(name: str) -> str:
    for cat, keys in CATEGORIES:
        if any(k in name for k in keys):
            return cat
    return "other"
