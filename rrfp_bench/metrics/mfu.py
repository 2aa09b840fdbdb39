"""Model FLOPs utilization (%) of the window: the family's frozen
``model_flops`` of a step (no recompute counted) times the steps that
ended in the window, over the window's host-clock time and one H100's
dense bf16 peak."""
from rrfp_bench.yardstick.flops import PEAK_BF16_FLOPS


def read(ctx):
    if not ctx["window_steps"]:
        return None
    flops = ctx["flops_per_step"] * len(ctx["window_steps"])
    return 100.0 * flops / ctx["window_s"] / PEAK_BF16_FLOPS
