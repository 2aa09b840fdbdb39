"""Share of the traced window (%) in which no kernel ran on the device:
1 - the union of kernel intervals over the traced steps' host-clock span
(not over the span from the first kernel to the last)."""


def read(ctx):
    if not ctx["kernels"] or ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
