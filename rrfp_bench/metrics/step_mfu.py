"""The traced steps' device work as a share of one H100's dense bf16 peak
(%): the family's frozen ``model_flops`` of the traced steps (no
recompute counted) over the union of their kernels' device time
(``busy_s``), not over host time.  Every kernel of the step counts in
that time, so a kernel taken off the path leaves its own roofline unread
while this share still bounds the kernels that do the step's work;
``mfu`` is this share times the busy share of the window."""
from rrfp_bench.yardstick.flops import PEAK_BF16_FLOPS


def read(ctx):
    if not ctx["kernels"] or ctx["busy_s"] <= 0:
        return None
    flops = ctx["flops_per_step"] * ctx["steps"]
    return 100.0 * flops / ctx["busy_s"] / PEAK_BF16_FLOPS
