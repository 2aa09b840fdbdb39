"""K2's share of its roofline (%): the least time one H100 needs (HBM
bandwidth bounds it) for the traced steps' RMSNorm calls, each counted by
the frozen ``k2_work`` at the cell's shapes (``[mb_rows x seq,
d_model]``), over the device time of the kernels in category K2."""
from rrfp_bench.yardstick.categories import K2, category
from rrfp_bench.yardstick.flops import DTYPE_BYTES, bound_seconds, k2_work


def read(ctx):
    spans = [b - a for name, a, b in ctx["kernels"] if category(name) == K2]
    if not spans:
        return None
    c, t = ctx["config"], ctx["traffic"]
    flops, nbytes = k2_work(t["mb_rows"] * t["seq"], c["d_model"],
                            DTYPE_BYTES[c["dtype"]])
    return 100.0 * len(spans) * bound_seconds(flops, nbytes, c["dtype"]) / (
        sum(spans) / 1e6)
