"""K1's share of its roofline (%): the least time one H100 needs, at the
peak of the model's dtype, for the traced steps' attention-forward calls,
over the device time of the kernels in category K1.  A call's bound is the
frozen ``k1_work`` at the cell's shapes (q ``[mb_rows, heads, seq,
head_dim]``), averaged over the family's ``attention_calls``: each layer's
own window and causality."""
from rrfp_bench.harness import manifest
from rrfp_bench.yardstick.categories import K1, category
from rrfp_bench.yardstick.flops import (DTYPE_BYTES, bound_seconds, head_dim,
                                        k1_work, mean_over_calls)


def read(ctx):
    spans = [b - a for name, a, b in ctx["kernels"] if category(name) == K1]
    if not spans:
        return None
    c, t = ctx["config"], ctx["traffic"]

    def bound(window, causal):
        flops, nbytes = k1_work(t["mb_rows"], c["num_heads"], t["seq"],
                                c["num_kv_heads"], t["seq"], head_dim(c),
                                DTYPE_BYTES[c["dtype"]], causal, window)
        return bound_seconds(flops, nbytes, c["dtype"])

    call = mean_over_calls(manifest.family(c).attention_calls(c), bound)
    return 100.0 * len(spans) * call / (sum(spans) / 1e6)
