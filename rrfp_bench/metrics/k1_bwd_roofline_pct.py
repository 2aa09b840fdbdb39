"""K1b's share of its roofline (%): the least time one H100 needs, at the
peak of the model's dtype, for the traced steps' attention-backward calls,
over the device time of every kernel whose name holds ``flash_bwd``.

A call's work at the cell's shapes (q, out, dout and dq ``[mb_rows, heads,
seq, head_dim]``, k, v, dk and dv ``[mb_rows, kv_heads, seq, head_dim]``):
the five products a backward needs over the unmasked pairs, 2.5 times the
frozen ``k1_work``'s FLOPs (a recompute of S and dP is not counted, so the
share cannot pass 100 %), and those eight tensors and the float32 lse each
moved once; its bound averaged over the family's ``attention_calls``, each
layer's own window and causality.  Calls: the launches of the main pass,
the kernels named ``flash_bwd_dkdv``, one per backward."""
from rrfp_bench.harness import manifest
from rrfp_bench.yardstick.flops import (DTYPE_BYTES, bound_seconds, head_dim,
                                        k1_work, mean_over_calls)

#: every kernel of the backward, and the one launched once a call
KERNELS, MAIN_PASS = "flash_bwd", "flash_bwd_dkdv"


def read(ctx):
    spans = [(name, b - a) for name, a, b in ctx["kernels"]
             if KERNELS in name]
    calls = sum(1 for name, _ in spans if MAIN_PASS in name)
    if not calls:
        return None
    c, t = ctx["config"], ctx["traffic"]
    b, hq, hkv, s, hd = (t["mb_rows"], c["num_heads"], c["num_kv_heads"],
                         t["seq"], head_dim(c))
    size = DTYPE_BYTES[c["dtype"]]
    nbytes = 4 * (b * hq * s * hd + b * hkv * s * hd) * size + b * hq * s * 4

    def bound(window, causal):
        flops, _ = k1_work(b, hq, s, hkv, s, hd, size, causal, window)
        return bound_seconds(2.5 * flops, nbytes, c["dtype"])

    call = mean_over_calls(manifest.family(c).attention_calls(c), bound)
    return 100.0 * calls * call / (sum(d for _, d in spans) / 1e6)
