"""Device milliseconds a traced step spent in float32 matrix products off
the tensor cores (the frozen category ``matmul float32 (no tensor
cores)``): the plain attention backward, the MoE router."""
from rrfp_bench.yardstick.categories import FP32_GEMM


def read(ctx):
    s = ctx["categories"].get(FP32_GEMM)
    return None if not s else 1e3 * s / ctx["steps"]
