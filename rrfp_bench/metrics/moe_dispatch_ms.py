"""Device milliseconds a traced step spent in the MoE dispatch: the frozen
categories ``sort / top-k / scan`` (the top-k, the capacity cumsum) and
``indexing`` (the scatter into the expert buffers and its backward)."""
from rrfp_bench.yardstick.categories import INDEXING, SORT_SCAN


def read(ctx):
    s = ctx["categories"].get(SORT_SCAN, 0.0) + ctx["categories"].get(
        INDEXING, 0.0)
    return None if not s else 1e3 * s / ctx["steps"]
