#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (one NVIDIA GPU).

    python3 chip_smoke.py                # every phase, as the port's proof
    python3 chip_smoke.py --kernels-only # build + check the kernels, stop

Phases, each of which raises on failure (non-zero exit, no result line):

1. the card (``nvidia-smi`` name and power limit) and the software versions;
2. build the CUDA sources in ``src/repro_torch/kernels/csrc`` (one ``nvcc``
   each, in parallel) and print their build logs (ptxas registers/spills);
3. every kernel against its plain PyTorch version on the card, at each main
   path's shapes and at the reference kernel tests' shapes, with the stated
   tolerance; then the kernel's time at each main path's shape beside its
   plain version's, one library call's (a yardstick only: the port never
   calls it) and the card's bound for the same work;
   every K1, K3 and K4 check launches twice and requires the same bits,
   and each of their wrappers must refuse a view off 16-byte alignment
   (K4's bf16 kernel; its float32 kernel is the scalar one); K3 (flash
   decode) is also replayed from one CUDA graph at three lengths, written
   into its length tensor in place, twice each with the same bits (its
   arrival counters are back at 0 after every launch);
4. an end-to-end check on a small input per main path: the port's model
   forward on the card (kernels) against the same weights on the CPU
   (plain versions), at the arch's full widths (gemma3-4b too, for K1 at
   head_dim 256); one multimodal DAG step (forward and backward, every
   gradient compared); and the same for serving: seamless with 2 + 2
   layers, 4 greedy tokens, then one more pass whose last hidden state is
   compared;
5. the main paths, each through ``repro_torch.launch.train`` (actor
   training, full size, 4 stages, 8 microbatches of 1 x 2048 tokens):
   ``paper-gpt3-large`` hint bf for 3 steps, then ``--hint bfw
   --split-backward`` for 2; ``zamba2-1.2b`` bf for 3 steps, then bfw for
   1; the multimodal DAG (``--workload multimodal``, qwen2-vl-2b full
   width) bf for 3 steps, bfw for 2, and 2 bf steps with the reference's
   full-size encoder settings (encoder microbatches of ~2048 tokens); then
   ``repro_torch.launch.serve`` (full size, 4 stages, batch 8,
   cache 4096): ``seamless-m4t-large-v2`` for 32 tokens (the path of K3),
   ``zamba2-1.2b`` and ``paper-gpt3-large`` for 8.  The launch counts are
   zeroed just before each run and read just after; every kernel of the
   path must have launched in each, a serve run exactly as often as its
   layers give, and one more decode pass after a serve run must give
   finite logits;
6. right after the language main paths (``phase_runtime_flags``), the
   runtime flags on paper-gpt3-large full size: telemetry
   (``--metrics-report``, ``--explain``, ``--export-perfetto``, its step
   time against runs without it, in turns), a checkpoint write and
   ``--resume``, ``--recover`` from a killed stage (live params, then a
   checkpoint), and the adaptive hint loop, each held against its unfailed
   or uninterrupted run (bitwise, or within the spread of two identical
   runs, printed).  It needs about 12 GB of free disk under the temporary
   directory for one 10 GB checkpoint, removed at the end.

The last three lines are the card, the per-kernel JSON record and the
result JSON.  A copy of the record goes to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: published dense peaks of one H100 SXM (NVIDIA data sheet, 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py TOL
TOL_LSE = 1e-4  # float32 log-sum-exp of either input dtype
#: (atol, rtol) of the SSD checks in tests/test_kernels.py
TOL_SSD = {"float32": (5e-4, 1e-5), "bfloat16": (6e-2, 3e-2)}
#: (b, sq, hq, hkv, hd, window): the main paths, then tests/test_kernels.py,
#: then every head dim at a ragged sq (not a multiple of 64 or 128), then
#: gemma3-4b's head_dim 256 (local window 1024, global, ragged)
ATTN_SHAPES = [
    (1, 2048, 16, 16, 96, 0),
    (1, 2048, 32, 32, 64, 0),
    (1, 2048, 12, 2, 128, 0),
    (1, 2052, 12, 2, 128, 0),
    (1, 128, 4, 4, 64, 0),
    (2, 200, 8, 2, 64, 0),
    (1, 384, 8, 1, 128, 0),
    (2, 160, 4, 4, 64, 64),
    (1, 96, 4, 2, 32, 0),
    (1, 1000, 8, 2, 96, 0),
    (2, 333, 4, 4, 128, 0),
    (1, 777, 4, 1, 32, 256),
    (1, 1100, 4, 4, 64, 300),
    (1, 2048, 8, 4, 256, 1024),
    (1, 2048, 8, 4, 256, 0),
    (1, 1000, 8, 4, 256, 300),
]
#: (b, s, nh, hd, ds, chunk): the zamba2 path, then tests/test_kernels.py
SSD_SHAPES = [
    (1, 2048, 64, 64, 64, 64),
    (2, 256, 4, 32, 16, 64),
    (1, 128, 8, 64, 64, 128),
    (1, 192, 2, 16, 8, 64),
    (2, 100, 2, 16, 8, 64),
]
#: (b, S, hq, hkv, hd, length, window): the seamless serve path's cross
#: attention (one micro-group against enc_len 1024), then tests/test_kernels.py
DECODE_SHAPES = [
    (1, 1024, 16, 16, 64, 1024, 0),
    (2, 300, 8, 2, 64, 157, 0),
    (1, 1024, 4, 1, 128, 1024, 0),
    (2, 512, 4, 4, 64, 300, 128),
    (1, 64, 2, 2, 32, 1, 0),
]
#: main path -> the shapes its kernels run at (timed at these, in bf16
#: unless an entry ends in its dtype's name)
PATH_SHAPES = {
    "paper-gpt3-large": {"attn": [ATTN_SHAPES[0]], "norm": [(2048, 1536)],
                         "ssd": []},
    "zamba2-1.2b": {"attn": [ATTN_SHAPES[1]],
                    "norm": [(2048, 2048), (2048, 4096)],
                    "ssd": [SSD_SHAPES[0]]},
    "seamless-m4t-large-v2 serve": {"attn": [], "norm": [(1, 1024)],
                                    "ssd": []},
    # the multimodal DAG: the text stage in bf16; the fusion and LM stages
    # (4 text slots + 2048 tokens) and the encoder in float32, as the
    # reference promotes a float32 activation meeting a bf16 weight
    "qwen2-vl-2b multimodal": {
        "attn": [(1, 2048, 12, 2, 128, 0),
                 (1, 2052, 12, 2, 128, 0, "float32")],
        "norm": [(2048, 1536), (2052, 1536, "float32"),
                 (48, 768, "float32"), (4096, 768, "float32")],
        "ssd": []},
    "gemma3-4b": {"attn": [(1, 2048, 8, 4, 256, 1024)], "norm": [],
                  "ssd": []},
}

COMMON_ARGS = ["--runtime", "actor", "--full-size", "--stages", "4",
               "--microbatches", "8", "--mb-rows", "1", "--seq", "2048",
               "--device", "cuda"]
BFW = ["--hint", "bfw", "--split-backward"]
#: (arch, [(run name, extra flags)], kernels every run must launch)
MAIN_PATHS = [
    ("paper-gpt3-large",
     [("bf", ["--steps", "3", "--hint", "bf"]),
      ("bfw", ["--steps", "2"] + BFW)],
     ("flash_attention_fwd", "rmsnorm")),
    ("zamba2-1.2b",
     [("bf", ["--steps", "3", "--hint", "bf"]),
      ("bfw", ["--steps", "1"] + BFW)],
     ("flash_attention_fwd", "rmsnorm", "ssd_scan")),
]
#: the multimodal DAG (qwen2-vl-2b full width, 2 layers per stage: 1
#: encoder stage, the text stage, fusion + 1 LM stage) through the launcher
MM_ARGS = ["--workload", "multimodal", "--arch", "qwen2-vl-2b"] + COMMON_ARGS
MM_RUNS = [("bf", ["--steps", "3", "--hint", "bf"]),
           ("bfw", ["--steps", "2"] + BFW)]
#: the reference launcher's full-size encoder settings for its cost model
#: (repro/launch/train.py:217-220): the real-encoder run's config
MM_REAL_ENCODER = dict(text_seq=512, mean_enc_tokens=2048,
                       buckets=(1024, 2048, 4096))
SERVE_ARGS = ["--full-size", "--stages", "4", "--batch", "8", "--cache-len",
              "4096", "--device", "cuda"]
#: (arch, tokens): the serve runs; each must launch its kernels exactly as
#: often as ``serve_launches`` counts from its layers
SERVE_PATHS = [("seamless-m4t-large-v2", 32), ("zamba2-1.2b", 8),
               ("paper-gpt3-large", 8)]


def check_no_spills(log: str, entry: str) -> int:
    """ptxas's verbose log: every instantiation whose name holds ``entry``
    must report 0 bytes of spill stores and loads.  Returns how many."""
    import re

    found = re.findall(r"Function properties for (\S+)\n\s*(\d+) bytes "
                       r"stack frame, (\d+) bytes spill stores, (\d+) bytes "
                       r"spill loads", log)
    hits = [(name, int(st), int(ld)) for name, _, st, ld in found
            if entry in name]
    if not hits:
        raise AssertionError(f"no {entry} instantiation in the build log")
    bad = [h for h in hits if h[1] or h[2]]
    if bad:
        raise AssertionError(f"ptxas spills in {bad}")
    return len(hits)


def card(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, arg_sets, iters: int = 20, reps: int = 3) -> float:
    """Device ms per call: ``iters`` calls cycling through ``arg_sets``
    (distinct inputs, so a call does not find the previous one's in L2) are
    captured in a CUDA graph and replayed ``reps`` times between two
    events, so the host's launch cost is not in the number.  Warm-up and
    capture share one stream (K3's arrival counters are per stream)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a in arg_sets:  # compile, autotune, warm the allocator
            fn(*a)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def check_close(name, got, want, tol, rtol=None) -> float:
    import torch

    rtol = tol if rtol is None else rtol
    err = float((got.float() - want.float()).abs().max())
    ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=rtol)
    print(f"  {name}: max |err| {err:.3e}  (tolerance atol={tol:g} "
          f"rtol={rtol:g})  {'ok' if ok else 'FAIL'}")
    if not ok or not math.isfinite(err):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max |err| {err:.3e} > {tol:g})")
    return err


def same_bits(name, got, want) -> None:
    """Two launches on the same inputs must give the same bits."""
    import torch

    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{name}: the bits differ from the first")
    print(f"  {name}: bit-identical")


def expect_raise(name, fn, exc) -> None:
    try:
        fn()
    except exc as e:
        print(f"  {name}: raises {type(e).__name__} ({str(e)[:60]}...)")
        return
    raise AssertionError(f"{name}: did not raise {exc.__name__}")


def bound(flops, peak_flops, nbytes):
    """(bound ms, what bounds it): the larger of operations over the peak
    rate for their type and bytes over the memory rate."""
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def kernel_entry(name, route, source, replaces, timings):
    """The kernel's JSON record: its first main-path shape's numbers at the
    top level, every main-path shape's under ``by_shape``."""
    top = {k: v for k, v in timings[0].items() if k not in ("path", "shape")}
    return {"name": name, "route": route, "source": source,
            "replaces": replaces, **top, "by_shape": timings}


def attention_inputs(shape, dtype, seed):
    """Pre-scaled q and k, v in the model's [b, s, h, hd] storage, viewed as
    the kernel's [b, h, s, hd] (the main path's strides)."""
    import torch

    b, sq, hq, hkv, hd, _ = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, sq, hq, hd), generator=g, device="cuda") * hd ** -0.5
    k = torch.randn((b, sq, hkv, hd), generator=g, device="cuda")
    v = torch.randn((b, sq, hkv, hd), generator=g, device="cuda")
    return tuple(t.to(dtype).transpose(1, 2) for t in (q, k, v))


def phase_attention(record):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    print("K1 flash_attention_fwd (CUDA) vs its plain version:")
    errs = {}
    for shape in ATTN_SHAPES:
        window = shape[5]
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            q, k, v = attention_inputs(shape, dtype, seed=hash(shape) % 2**31)
            out, lse = fa.flash_attention_fwd(q, k, v, causal=True,
                                              window=window)
            torch.cuda.synchronize()
            want, want_lse = fa.flash_attention_fwd_plain(
                q, k, v, causal=True, window=window)
            tag = f"b{shape[0]} s{shape[1]} hq{shape[2]} hkv{shape[3]} " \
                  f"hd{shape[4]} w{window} {dn}"
            errs[shape, dn] = check_close(f"{tag} out", out, want, TOL[dn])
            check_close(f"{tag} lse", lse, want_lse, TOL_LSE)
            again, lse2 = fa.flash_attention_fwd(q, k, v, causal=True,
                                                 window=window)
            same_bits(f"{tag} second launch", (out, lse), (again, lse2))
    # the bf16 kernel's 16-byte copies refuse a view off 16-byte alignment
    b, sq, hq, hkv, hd, _ = ATTN_SHAPES[0]
    q, k, v = attention_inputs(ATTN_SHAPES[0], torch.bfloat16, seed=1)
    wide = torch.zeros((b, sq, hq, hd + 8), dtype=torch.bfloat16,
                       device="cuda")
    off = wide[..., 4:4 + hd].transpose(1, 2)  # 8 bytes past alignment
    off.copy_(q)
    expect_raise("K1 on a misaligned q view",
                 lambda: fa.flash_attention_fwd(off, k, v), ValueError)
    timings = []
    for path, shapes in PATH_SHAPES.items():
        for entry in shapes["attn"]:
            shape, dn = entry[:6], (entry[6:] or ("bfloat16",))[0]
            dtype = getattr(torch, dn)
            b, sq, hq, hkv, hd, window = shape
            sets = [attention_inputs(shape, dtype, seed=s) for s in range(4)]
            ms = time_ms(lambda q, k, v: fa.flash_attention_fwd(
                q, k, v, window=window), sets)
            plain_ms = time_ms(lambda q, k, v: fa.flash_attention_fwd_plain(
                q, k, v, window=window), sets, iters=4)
            # one SDPA call on the same function: causal, or a boolean mask
            # for the window; GQA by its kv-head broadcast
            pos = torch.arange(sq, device="cuda")
            mask = None if window == 0 else (
                (pos[:, None] >= pos[None]) & (pos[:, None] - pos[None]
                                               < window))
            lib_sets = [tuple(t.contiguous() for t in s) for s in sets]
            lib_ms = time_ms(lambda q, k, v: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=mask is None, scale=1.0,
                enable_gqa=hq != hkv), lib_sets)
            # QK^T + PV over the unmasked (query, key) pairs of this shape
            pairs = sum(min(i + 1, window or sq) for i in range(sq))
            flops = 4 * b * hq * pairs * hd
            size = dtype.itemsize
            nbytes = (2 * b * sq * hq * hd + 2 * b * sq * hkv * hd) * size \
                + b * hq * sq * 4
            peak = PEAK_BF16_FLOPS if dn == "bfloat16" else PEAK_FP32_FLOPS
            bound_ms, bound_by = bound(flops, peak, nbytes)
            print(f"  {path} shape {shape} {dn}: kernel {ms:.4f} ms  plain "
                  f"{plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms  bound "
                  f"{bound_ms:.4f} ms ({bound_by}: {flops:.4g} FLOP / "
                  f"{peak / 1e12:g} TFLOP/s, {nbytes:.4g} B / 3.35 TB/s)")
            timings.append({"path": path, "shape": list(shape), "dtype": dn,
                            "max_abs_err": errs[shape, dn], "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": bound_ms,
                            "bound_by": bound_by, "library_ms": lib_ms})
    record["flash_attention_fwd"] = kernel_entry(
        "flash_attention_fwd", "cuda",
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:79", timings)


def phase_rmsnorm(record):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import rmsnorm as rn

    print("K2 rmsnorm (Triton) vs its plain version:")
    g = torch.Generator(device="cuda").manual_seed(7)
    timings = []
    for path, shapes in PATH_SHAPES.items():
        for entry in shapes["norm"]:
            (rows, d), tdn = entry[:2], (entry[2:] or ("bfloat16",))[0]
            tdtype = getattr(torch, tdn)
            err = {}
            for dtype in (torch.bfloat16, torch.float32):
                dn = str(dtype).split(".")[1]
                x = torch.randn((rows, d), generator=g,
                                device="cuda").to(dtype)
                scale = (torch.randn((d,), generator=g, device="cuda")
                         * 0.1).to(dtype)
                got = rn.rmsnorm(x, scale)
                torch.cuda.synchronize()
                err[dn] = check_close(f"[{rows}, {d}] {dn}", got,
                                      rn.rmsnorm_plain(x, scale), TOL[dn])
            # the model's float32 activations meet a bf16 scale
            x = torch.randn((rows, d), generator=g, device="cuda")
            scale = (torch.randn((d,), generator=g, device="cuda")
                     * 0.1).bfloat16()
            got = rn.rmsnorm(x, scale)
            torch.cuda.synchronize()
            check_close(f"[{rows}, {d}] float32 x, bfloat16 scale", got,
                        rn.rmsnorm_plain(x, scale), TOL["float32"])
            # more distinct inputs than the 50 MB L2 holds, up to one per
            # timed call (a [1, d] row stays L2-resident, as in the model)
            size = tdtype.itemsize
            n_sets = min(64, max(4, (2 * 50 * 2**20) // (rows * d * size)
                                 + 1))
            sets = []
            for _ in range(n_sets):
                x = torch.randn((rows, d), generator=g,
                                device="cuda").to(tdtype)
                sets.append((x, (torch.randn((d,), generator=g, device="cuda")
                                 * 0.1).to(torch.bfloat16)))
            ms = time_ms(lambda x, s: rn.rmsnorm(x, s), sets, iters=64)
            plain_ms = time_ms(lambda x, s: rn.rmsnorm_plain(x, s), sets,
                               iters=64)
            lib_ms = time_ms(lambda x, s, d=d: F.rms_norm(
                x, (d,), weight=1.0 + s.to(x.dtype), eps=1e-5), sets,
                iters=64)
            nbytes = 2 * rows * d * size + d * 2
            flops = 4 * rows * d
            bound_ms, bound_by = bound(flops, PEAK_FP32_FLOPS, nbytes)
            print(f"  {path} [{rows}, {d}] {tdn}: kernel {ms:.4f} ms  plain "
                  f"{plain_ms:.4f} ms  F.rms_norm {lib_ms:.4f} ms  bound "
                  f"{bound_ms:.4f} ms ({bound_by}: {nbytes:.4g} B / 3.35 "
                  f"TB/s, {flops:.4g} FLOP / 67 TFLOP/s)")
            timings.append({"path": path, "shape": [rows, d], "dtype": tdn,
                            "max_abs_err": err[tdn], "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": bound_ms,
                            "bound_by": bound_by, "library_ms": lib_ms})
    record["rmsnorm"] = kernel_entry(
        "rmsnorm", "triton", "src/repro_torch/kernels/rmsnorm.py",
        "src/repro/kernels/rmsnorm.py:19", timings)


def ssd_inputs(shape, dtype, bc_dtype, seed):
    """The reference tests' SSD inputs; x, B and C are views of one
    ``[b, s, nh*hd + 2*ds]`` buffer, as the model slices its ``xbc``."""
    import torch

    b, s, nh, hd, ds, _ = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    xbc = torch.randn((b, s, nh * hd + 2 * ds), generator=g,
                      device="cuda").to(dtype)
    x = xbc[..., :nh * hd].reshape(b, s, nh, hd)
    bc = xbc[..., nh * hd:].to(bc_dtype)  # still a view when of x's dtype
    B, C = bc[..., :ds], bc[..., ds:]
    dt = torch.randn((b, s, nh), generator=g, device="cuda").abs() * 0.1
    A = -torch.randn((nh,), generator=g, device="cuda").abs()
    D = torch.randn((nh,), generator=g, device="cuda")
    return x, dt, A, B, C, D


def phase_ssd(record):
    """K4 against its plain version run on float32 copies of the same
    inputs and cast back (the Pallas kernel's float32 arithmetic), and at
    the reference tests' shapes also against the sequential oracle.  bf16
    x takes the tensor-core kernel (float32 B and C cast to bf16 by the
    wrapper), float32 x the scalar one; every check launches twice and
    requires the same bits, and the bf16 kernel must refuse a view off
    16-byte alignment."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as ssd

    print("K4 ssd_scan (CUDA; bf16: tensor cores, float32: scalar) vs its "
          "plain version:")
    errs = {}
    for shape in SSD_SHAPES:
        chunk = shape[5]
        main = shape in PATH_SHAPES["zamba2-1.2b"]["ssd"]
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            # the main path's B and C are bf16; the tests' are float32
            bc_dtype = dtype if main else torch.float32
            x, dt, A, B, C, D = ssd_inputs(shape, dtype, bc_dtype,
                                           seed=hash(shape) % 2**31)
            got = ops.ssd(x, dt, A, B, C, D, chunk=chunk)  # pads s = 100
            torch.cuda.synchronize()
            want = ssd.ssd_chunked_plain(x.float(), dt, A, B.float(),
                                         C.float(), D, chunk).to(dtype)
            atol, rtol = TOL_SSD[dn]
            tag = f"b{shape[0]} s{shape[1]} nh{shape[2]} hd{shape[3]} " \
                  f"ds{shape[4]} chunk{chunk} {dn}"
            errs[shape, dn] = check_close(tag, got, want, atol, rtol)
            if not main:
                check_close(f"{tag} vs ssd_ref", got,
                            ref.ssd_ref(x, dt, A, B, C, D), atol, rtol)
            same_bits(f"{tag} second launch", (got,),
                      (ops.ssd(x, dt, A, B, C, D, chunk=chunk),))
    # the bf16 kernel's 16-byte copies refuse a view off 16-byte alignment
    b, s, nh, hd, ds, chunk = SSD_SHAPES[0]
    x, dt, A, B, C, D = ssd_inputs(SSD_SHAPES[0], torch.bfloat16,
                                   torch.bfloat16, seed=1)
    wide = torch.zeros((b, s, nh * hd + 8), dtype=torch.bfloat16,
                       device="cuda")
    off = wide[..., 4:4 + nh * hd].reshape(b, s, nh, hd)  # 8 bytes off
    off.copy_(x)
    expect_raise("K4 on a misaligned x view",
                 lambda: ssd.ssd_scan(off, dt, A, B, C, D, chunk=chunk),
                 ValueError)
    timings = []
    for shape in PATH_SHAPES["zamba2-1.2b"]["ssd"]:
        b, s, nh, hd, ds, chunk = shape
        per_set = b * s * (nh * hd + 2 * ds) * 2 + b * s * nh * 4
        sets = [ssd_inputs(shape, torch.bfloat16, torch.bfloat16, seed=i)
                for i in range(50 * 2**20 // per_set + 2)]  # more than L2
        ms = time_ms(lambda *a: ssd.ssd_scan(*a, chunk=chunk), sets)
        plain_ms = time_ms(lambda *a: ssd.ssd_chunked_plain(*a, chunk), sets,
                           iters=4)
        nc = s // chunk
        flops = 2 * b * nh * nc * (chunk * chunk * ds + chunk * chunk * hd
                                   + 2 * chunk * ds * hd)
        nbytes = 2 * b * s * nh * hd * 2 + 2 * b * s * ds * 2 \
            + b * s * nh * 4 + 2 * nh * 4
        bound_ms, bound_by = bound(flops, PEAK_BF16_FLOPS, nbytes)
        print(f"  zamba2-1.2b shape {shape} bf16: kernel {ms:.4f} ms  plain "
              f"{plain_ms:.4f} ms  library: none  bound {bound_ms:.4f} ms "
              f"({bound_by}: {nbytes:.4g} B / 3.35 TB/s, {flops:.4g} FLOP / "
              f"989 TFLOP/s); achieved {nbytes / ms * 1e-9:.4g} TB/s, "
              f"{flops / ms * 1e-9:.4g} TFLOP/s, {bound_ms / ms:.1%} of the "
              f"bound")
        timings.append({"path": "zamba2-1.2b", "shape": list(shape),
                        "max_abs_err": errs[shape, "bfloat16"], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": None})
    record["ssd_scan"] = kernel_entry(
        "ssd_scan", "cuda", "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan.py:56", timings)


def decode_inputs(shape, dtype, seed):
    """q [b, 1, hq, hd] and k, v caches [b, S, hkv, hd] in the model's
    layout; and q pre-scaled with the caches viewed as the kernel's
    [b, h, S, hd] (the main path's strides)."""
    import torch

    b, S, hq, hkv, hd, _, _ = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, 1, hq, hd), generator=g, device="cuda").to(dtype)
    k = torch.randn((b, S, hkv, hd), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, S, hkv, hd), generator=g, device="cuda").to(dtype)
    qs = (q * hd ** -0.5).to(dtype).transpose(1, 2)
    return (q, k, v), (qs, k.transpose(1, 2), v.transpose(1, 2))


def phase_decode(record):
    """K3 against its plain version on the same inputs (the wrapper the
    model calls, ``ops.decode_attention``), one CUDA graph replayed at
    three lengths, calls on two streams at once, then its time at the serve
    shape."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops, ref

    print("K3 flash_decode (CUDA) vs its plain version:")
    errs = {}
    for shape in DECODE_SHAPES:
        b, S, hq, hkv, hd, length, window = shape
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            (q, k, v), (qs, kt, vt) = decode_inputs(shape, dtype,
                                                    seed=hash(shape) % 2**31)
            got = ops.decode_attention(q, k, v, length, window=window)
            torch.cuda.synchronize()
            want = fd.flash_decode_plain(qs, kt, vt, length, window=window)
            tag = (f"b{b} S{S} hq{hq} hkv{hkv} hd{hd} length{length} "
                   f"w{window} {dn}")
            errs[shape, dn] = check_close(tag, got, want.transpose(1, 2),
                                          TOL[dn])
            same_bits(f"{tag} second launch", (got,),
                      (ops.decode_attention(q, k, v, length, window=window),))
    (q, k, v), (qs, kt, vt) = decode_inputs(DECODE_SHAPES[0], torch.bfloat16,
                                            seed=1)
    wide = torch.zeros(q.shape[:-1] + (q.shape[-1] + 8,), dtype=q.dtype,
                       device="cuda")
    off = wide[..., 4:4 + q.shape[-1]].transpose(1, 2)  # 8 bytes off
    off.copy_(qs)
    expect_raise("K3 on a misaligned q view",
                 lambda: fd.flash_decode(off, kt, vt, DECODE_SHAPES[0][5]),
                 ValueError)

    # tests/test_kernels.py::test_decode_length_is_dynamic on the card: one
    # captured launch sequence serves every length written into the tensor
    shape = (1, 256, 4, 2, 32, 256, 0)
    (q, k, v), (qs, kt, vt) = decode_inputs(shape, torch.float32, seed=3)
    len_t = torch.full((1,), 256, dtype=torch.int32, device="cuda")
    side = torch.cuda.Stream()  # warm-up on the capture stream: its counters
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fd.flash_decode(qs, kt, vt, len_t)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fd.flash_decode(qs, kt, vt, len_t)
    for length in (1, 100, 256):
        len_t.fill_(length)
        graph.replay()
        torch.cuda.synchronize()
        lengths = torch.full((1,), length, device="cuda")
        check_close(f"one graph, length {length} vs decode_ref",
                    out.transpose(1, 2), ref.decode_ref(q, k, v, lengths),
                    TOL["float32"])
        # a replay that finds its arrival counters left at 0 merges again
        first = out.clone()
        graph.replay()
        torch.cuda.synchronize()
        same_bits(f"one graph, length {length}, second replay", (out,),
                  (first,))

    # calls on two streams at once take separate arrival counters: each
    # gives the bits of the same call alone
    shape = DECODE_SHAPES[0]
    length = shape[5]
    _, (qs, kt, vt) = decode_inputs(shape, torch.bfloat16, seed=5)
    alone = fd.flash_decode(qs, kt, vt, length)
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    outs = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(50):
        for s in streams:
            with torch.cuda.stream(s):
                outs.append(fd.flash_decode(qs, kt, vt, length))
    for s in streams:
        torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    same_bits(f"{len(outs)} calls interleaved on two streams", outs,
              (alone,) * len(outs))

    timings = []
    b, S, hq, hkv, hd, length, _ = shape
    per_set = 2 * b * S * hkv * hd * 2
    sets = [decode_inputs(shape, torch.bfloat16, seed=i)[1]
            for i in range(50 * 2**20 // per_set + 2)]  # more than L2 holds
    len_t = torch.full((1,), length, dtype=torch.int32, device="cuda")
    ms = time_ms(lambda q, k, v: fd.flash_decode(q, k, v, length), sets)
    plain_ms = time_ms(lambda q, k, v: fd.flash_decode_plain(q, k, v, len_t),
                       sets)
    lib_ms = time_ms(lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, scale=1.0), sets)
    nbytes = 2 * b * length * hkv * hd * 2 + 2 * b * hq * hd * 2
    flops = 4 * b * hq * length * hd
    bound_ms, bound_by = bound(flops, PEAK_BF16_FLOPS, nbytes)
    print(f"  seamless serve shape {shape} bf16: kernel {ms:.4f} ms  plain "
          f"{plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms  bound {bound_ms:.5f} ms "
          f"({bound_by}: {nbytes:.4g} B / 3.35 TB/s, {flops:.4g} FLOP / "
          f"989 TFLOP/s)")
    timings.append({"path": "seamless-m4t-large-v2 serve",
                    "shape": list(shape),
                    "max_abs_err": errs[shape, "bfloat16"], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": lib_ms})
    record["flash_decode"] = kernel_entry(
        "flash_decode", "cuda", "src/repro_torch/kernels/csrc/flash_decode.cu",
        "src/repro/kernels/flash_decode.py:68", timings)


def small_config(arch: str, layers: int):
    import dataclasses

    import torch

    from repro_torch.configs import registry

    cfg = registry.get_arch(arch)
    pattern = (None if cfg.layer_pattern is None
               else cfg.layer_pattern[:layers])
    return dataclasses.replace(cfg, num_layers=layers, layer_pattern=pattern,
                               dtype=torch.float32)


def phase_small_model():
    """The port's forward on the card (kernels) against the CPU (plain
    versions) on identical weights, float32, 256 tokens, full widths:
    paper-gpt3-large with 2 layers; zamba2-1.2b with 3 Mamba layers on 2
    stages (a shared-block slot and a disabled slot); gemma3-4b with 6
    layers, five local and one global (K1 at head_dim 256)."""
    import copy

    import torch

    from repro_torch.models.build import build

    print("small-input forward, card (kernels) vs CPU (plain), float32:")
    for arch, layers in (("paper-gpt3-large", 2), ("zamba2-1.2b", 3),
                         ("gemma3-4b", 6)):
        cfg = small_config(arch, layers)
        model = build(cfg, num_stages=2)
        sp_cpu = [model.init_stage_params(s, seed=3, device="cpu")
                  for s in range(2)]
        io_cpu = model.init_io_params(seed=3, device="cpu")
        sp_gpu = [copy.deepcopy(sp).to("cuda") for sp in sp_cpu]
        io_gpu = copy.deepcopy(io_cpu).to("cuda")
        rng = torch.Generator().manual_seed(5)
        tokens = torch.randint(0, cfg.vocab_size, (1, 256), generator=rng)
        pos = torch.arange(256)[None]
        with torch.no_grad():
            want = model.reference_forward(sp_cpu, io_cpu, {"tokens": tokens},
                                           {"positions": pos})
            got = model.reference_forward(
                sp_gpu, io_gpu, {"tokens": tokens.cuda()},
                {"positions": pos.cuda()})
        torch.cuda.synchronize()
        if got.shape != (1, 256, cfg.padded_vocab()):
            raise AssertionError(f"logits of shape {tuple(got.shape)}")
        if not torch.isfinite(got).all():
            raise AssertionError("non-finite logits on the card")
        check_close(f"{arch} widths, {layers} layers {cfg.pattern} "
                    f"(shared slots {model.shared_flags.tolist()}), 256 "
                    f"tokens: logits", got.cpu(), want, 1e-3)
        del sp_cpu, io_cpu, sp_gpu, io_gpu, got, want
        torch.cuda.empty_cache()


#: the small multimodal check: qwen2-vl-2b at full width, float32, one
#: layer per stage, 1 encoder stage + text + 2 LM stages
SMALL_MM = dict(enc_stages=1, lm_stages=2, enc_layers_per_stage=1,
                lm_layers_per_stage=1, text_seq=256, mean_enc_tokens=96,
                buckets=(64, 128, 192), reduced=False)
#: relative tolerance of the small multimodal check's loss, and of each
#: gradient's max |card - CPU| against its own max |.| (float32 sums in
#: another order, through the kernels' float32 paths)
TOL_MM = 1e-3


def phase_small_multimodal():
    """One forward and one backward of the multimodal DAG on the card
    (kernels) against the CPU (plain versions) on identical weights:
    qwen2-vl-2b at full width in float32, 1 encoder stage, the text stage
    and 2 LM stages of one layer each, 2 microbatches of 256 text tokens,
    through the actor runtime in fixed order with deterministic reduction.
    The losses and every parameter gradient must agree within TOL_MM."""
    import copy
    import dataclasses

    import torch

    from repro_torch.core import HintKind
    from repro_torch.data.synthetic import multimodal_batch
    from repro_torch.launch import train
    from repro_torch.multimodal import (
        MultimodalStageFns,
        MultimodalStageProgram,
        multimodal_config,
    )
    from repro_torch.multimodal.model import MultimodalModel
    from repro_torch.multimodal.stagefn import MultimodalStageOptions
    from repro_torch.runtime.rrfp import ActorConfig, ActorDriver

    print("small multimodal DAG step, card (kernels) vs CPU (plain), "
          "float32:")
    cfg = multimodal_config("qwen2-vl-2b", **SMALL_MM)
    cfg = dataclasses.replace(cfg, lm_cfg=dataclasses.replace(
        cfg.lm_cfg, dtype=torch.float32))
    model = MultimodalModel(cfg)
    m = 2
    fns = MultimodalStageFns(model, MultimodalStageOptions(
        mb_rows=1, loss_scale=1.0 / (m * cfg.text_seq)))
    params_cpu = model.init_stage_params(seed=3, device="cpu")
    arrays = multimodal_batch(cfg, m, 1, seed=5, step=0)
    out = {}
    for dev in ("cpu", "cuda"):
        params = (params_cpu if dev == "cpu" else
                  [copy.deepcopy(p).to("cuda") for p in params_cpu])
        batch = train._device_mm_batch(arrays, dev)
        programs = [MultimodalStageProgram(fns, s, params[s], batch,
                                           deterministic_reduction=True)
                    for s in range(cfg.num_stages)]
        acfg = ActorConfig(mode="precommitted", hint=HintKind.BF,
                           fixed_order="1f1b", deadlock_timeout=300.0)
        ActorDriver(cfg.spec(m), None, acfg).run_threaded(list(programs))
        for p in programs:
            p.finalize()
        out[dev] = ([p.loss_sum for p in programs],
                    [[None if g is None else g.cpu() for g in p.d_params]
                     for p in programs])
    l_cpu, l_gpu = sum(out["cpu"][0]), sum(out["cuda"][0])
    if not math.isfinite(l_gpu) or abs(l_gpu - l_cpu) > TOL_MM * abs(l_cpu):
        raise AssertionError(f"multimodal loss: card {l_gpu} vs CPU {l_cpu}")
    print(f"  loss sum: card {l_gpu:.6f}  CPU {l_cpu:.6f}  (tolerance "
          f"{TOL_MM:g} relative)  ok")
    worst = 0.0
    for s, (gc, gg) in enumerate(zip(out["cpu"][1], out["cuda"][1])):
        names = [n for n, _ in params_cpu[s].named_parameters()]
        for name, a, b in zip(names, gc, gg):
            if (a is None) != (b is None):
                raise AssertionError(f"stage {s} {name}: a gradient on one "
                                     f"device only")
            if a is None:
                continue
            rel = float((a - b).abs().max()) / max(float(a.abs().max()),
                                                   1e-30)
            worst = max(worst, rel)
            if not math.isfinite(rel) or rel > TOL_MM:
                raise AssertionError(f"stage {s} {name}: max |card - CPU| "
                                     f"is {rel:.3e} of max |grad|")
    print(f"  every gradient of {cfg.num_stages} stages: max |card - CPU| "
          f"at most {worst:.3e} of its max |.|  (tolerance {TOL_MM:g})  ok")


def decode_pass(model, sp, io, caches, tokens, pos):
    """One more greedy-decode pass outside the serve step: every batch row
    through every stage's ``stage_decode`` (caches updated in place).
    Returns the last stage's hidden state [B, 1, d] and the float32 logits
    [B, padded vocab]."""
    import torch

    from repro_torch.models.build import tree_map

    with torch.inference_mode():
        hs = []
        for row in range(tokens.shape[0]):
            x = io.embed[tokens[row:row + 1]][:, None]
            for s in range(model.num_stages):
                c = tree_map(lambda t: t[:, row:row + 1], caches[s])
                x, _ = model.stage_decode(sp[s], io, x, c, pos, {},
                                          model.rows(s))
            hs.append(x)
        h = torch.cat(hs)
        return h, model.head_logits(io, h)[:, 0].float()


def serve_launches(model, batch: int) -> dict[str, int]:
    """K2 and K3 launches of one serve step, counted from the layers: per
    batch row (one-row micro-groups), 2 norms per attention or Mamba layer
    and shared-block application, 3 and one K3 per ``dec`` layer, none for
    ``enc``, plus the head's norm."""
    norms = {"attn": 2, "attn_local": 2, "attn_global": 2, "mamba": 2,
             "dec": 3, "enc": 0}
    kinds = [model.layer_types[t] for t in model.type_ids.ravel() if t >= 0]
    shared = int(model.shared_flags.sum()) if model.cfg.shared_attn_period \
        else 0
    return {"rmsnorm": batch * (sum(norms[k] for k in kinds) + 2 * shared
                                + 1),
            "flash_decode": batch * kinds.count("dec")}


def phase_small_serve():
    """Greedy serving on the card (kernels) against the CPU (plain
    versions) on identical weights and caches: seamless at full widths with
    2 encoder + 2 decoder layers, float32, batch 2, the encoder's keys and
    values seeded (enc_len 1024), 4 tokens; then one more pass whose last
    hidden state must agree."""
    import copy
    import dataclasses

    import torch

    from repro_torch.models.build import build
    from repro_torch.pipeline.decode import DecodeOptions, make_serve_fn

    print("small-input serve, card (kernels) vs CPU (plain), float32:")
    cfg = dataclasses.replace(small_config("seamless-m4t-large-v2", 4),
                              encoder_layers=2)
    model = build(cfg, num_stages=2)
    sp_cpu = [model.init_stage_params(s, seed=3, device="cpu")
              for s in range(2)]
    io_cpu = model.init_io_params(seed=3, device="cpu")
    caches_cpu = [model.init_stage_cache(2, 64, 1024, device="cpu")
                  for _ in range(2)]
    g = torch.Generator().manual_seed(11)
    for c in caches_cpu:
        for name in ("xk", "xv"):
            c[name].copy_(torch.randn(c[name].shape, generator=g))
    step = make_serve_fn(model, DecodeOptions(mb_rows=1, cache_len=64,
                                              enc_len=1024), num_groups=2)
    first = torch.tensor([17, 250_000])
    out = {}
    for dev, sp, io, caches in (
            ("cpu", sp_cpu, io_cpu, caches_cpu),
            ("cuda", [copy.deepcopy(p).to("cuda") for p in sp_cpu],
             copy.deepcopy(io_cpu).to("cuda"),
             [{k: t.to("cuda") for k, t in c.items()} for c in caches_cpu])):
        toks, seq = first.to(dev), [first.tolist()]
        for pos in range(4):
            toks = step(sp, io, caches, {"tokens": toks}, pos)
            seq.append(toks.tolist())
        h, logits = decode_pass(model, sp, io, caches, toks, 4)
        out[dev] = (seq, h.cpu(), logits.cpu())
    if out["cuda"][0] != out["cpu"][0]:
        raise AssertionError(f"greedy tokens differ: card {out['cuda'][0]} "
                             f"vs CPU {out['cpu'][0]}")
    print(f"  tokens equal on the card and the CPU: {out['cuda'][0]}")
    if not torch.isfinite(out["cuda"][2]).all():
        raise AssertionError("non-finite logits on the card")
    check_close("seamless widths, 2 + 2 layers, 5th pass: last hidden state",
                out["cuda"][1], out["cpu"][1], 1e-3)


def main_path_work(argv) -> tuple[int, float]:
    """Tokens and model FLOPs of one step of a main path, from the port's
    ``ArchModel.model_flops`` (6 x active matmul weights incl. the head x
    tokens, plus causal attention per attention layer and shared-block
    application; recompute not counted)."""
    from repro_torch.configs import registry
    from repro_torch.launch import train
    from repro_torch.models.build import build
    from repro_torch.models.common import ShapeCell

    args = train.parser().parse_args(argv)
    model = build(registry.get_arch(args.arch), num_stages=args.stages)
    cell = ShapeCell("main", args.seq, args.microbatches * args.mb_rows,
                     "train")
    work = model.model_flops(cell)
    return work["tokens"], work["model_flops"]


def phase_main_path():
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import train

    runs = {}
    for arch, path_runs, needed in MAIN_PATHS:
        base = ["--arch", arch] + COMMON_ARGS
        for name, extra in path_runs:
            print(f"main path {arch} ({name}): python -m "
                  f"repro_torch.launch.train " + " ".join(base + extra))
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            run = train.main(base + extra)
            counts = ops.launch_counts()
            steps = len(run.losses)
            print(f"  losses {run.losses}  step seconds {run.step_seconds}  "
                  f"launches {counts} "
                  f"({ {k: v / steps for k, v in counts.items()} } per step)"
                  f"  peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            print("  card after the run (SM clock, max SM clock, power, "
                  "temperature): " + card("clocks.sm,clocks.max.sm,"
                                          "power.draw,temperature.gpu"))
            if not all(math.isfinite(x) for x in run.losses):
                raise AssertionError(f"non-finite losses in the {arch} "
                                     f"{name} run")
            missing = [k for k in needed if counts[k] == 0]
            if missing:
                raise AssertionError(f"the {arch} {name} run launched no "
                                     f"{missing}")
            runs[arch, name] = (run, counts,
                                torch.cuda.max_memory_allocated())
            tokens, flops = main_path_work(base + extra)
            for i, sec in enumerate(run.step_seconds):
                print(f"  step {i}: {sec:.3f} s  {tokens / sec:,.0f} tokens/s"
                      f"  model FLOP utilization "
                      f"{flops / sec / PEAK_BF16_FLOPS:.2%} of 989 TFLOP/s "
                      f"({flops:.4g} FLOP/step)")
        l_bf = runs[arch, "bf"][0].losses[0]
        l_bfw = runs[arch, "bfw"][0].losses[0]
        if abs(l_bf - l_bfw) > TOL["bfloat16"] * max(1.0, abs(l_bf)):
            raise AssertionError(f"{arch} step-0 losses disagree: bf {l_bf} "
                                 f"vs bfw {l_bfw}")
        print(f"  {arch} step-0 loss bf {l_bf} vs bfw {l_bfw}: agree within "
              f"{TOL['bfloat16']:g} (relative)")
    return runs


#: the runs of phase_runtime_flags: paper-gpt3-large, full size, COMMON_ARGS
GPT3_ARGS = ["--arch", "paper-gpt3-large"] + COMMON_ARGS
FIXED_ORDER = ["--schedule", "1f1b"]
#: --hb-deadline of the recovery runs.  Their faults are kills, which
#: announce themselves: the deadline only arms the stall watchdog (no stage
#: stalls here) and sets the recovery coordinator's poll, hb/4, which a
#: step under --recover may wait out once at its end
HB_DEADLINE = "2.0"
#: free disk the checkpoint runs need: one step directory of 834,086,400
#: parameters x 4 bytes x 3 trees (params as float32, m, v) = 10.0 GB
CKPT_FREE_BYTES = 12e9


def phase_runtime_flags():
    """The runtime flags of ``repro_torch.launch.train`` on paper-gpt3-large
    (full size, GPT3_ARGS), each held against its unfailed or uninterrupted
    run; K1 and K2 must launch in every run (counts zeroed just before and
    read just after each).

    * obs: ``--steps 6 --metrics-report --explain --export-perfetto``; the
      export passes ``validate_chrome_trace`` and the recorded step-0 trace
      ``check_all``.
    * two identical unfailed ``1f1b`` runs (``--steps 2``) and, in turns
      with them, two with ``--metrics-report``: the step times with and
      without telemetry, and the identical-run spread that every equality
      below is held to (0: bitwise).
    * checkpoint: ``--steps 3 --ckpt-every 2`` saves once, at step 2 (10 GB,
      in a temporary directory removed at the end); ``--resume`` runs step 2
      from it and must give the writer's step-2 loss.
    * recovery: a ``kill`` of stage 1 under ``--recover`` (respawned from
      the live step-start params) against the unfailed run, and a kill of
      stage 2 under ``--resume --recover`` (respawned through
      ``restore_host`` of the checkpoint) against the writer's step 2; the
      recovery windows come from the recorded traces, which pass
      ``check_all``.
    * adaptive: ``--steps 6 --adaptive --resynth-every 1`` (rrfp, hint bf)
      within TOL["bfloat16"] of the obs run (the same flags without
      ``--adaptive``), ``check_all`` (table faithfulness included) on its
      step-0 trace; the scheduler's decisions and swaps are printed.
    """
    import shutil
    import tempfile

    import torch

    from repro_torch.core.taskgraph import PipelineSpec
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.obs import validate_chrome_trace
    from repro_torch.runtime.rrfp import ActorConfig
    from repro_torch.runtime.rrfp.conformance import check_all

    runs = {}
    spec = PipelineSpec(4, 8)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))

    def launch(name, extra):
        argv = GPT3_ARGS + extra
        print(f"runtime flags ({name}): python -m repro_torch.launch.train "
              + " ".join(argv))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        run = train.main(argv)
        counts = ops.launch_counts()
        mem = torch.cuda.max_memory_allocated()
        print(f"  losses {run.losses}  step seconds {run.step_seconds}  "
              f"launches {counts}  peak memory {mem / 2**30:.2f} GiB")
        if not run.losses or not all(math.isfinite(x) for x in run.losses):
            raise AssertionError(f"the {name} run gave losses {run.losses}")
        missing = [k for k in ("flash_attention_fwd", "rmsnorm")
                   if counts[k] == 0]
        if missing:
            raise AssertionError(f"the {name} run launched no {missing}")
        runs["paper-gpt3-large", name] = (run, counts, mem)
        torch.cuda.empty_cache()
        return run

    def outage(run, name):
        windows = run.trace.recovery_windows()
        if not windows:
            raise AssertionError(f"the {name} run recorded no recovery")
        for w in windows:
            print(f"  recovery of stage {w['stage']}: outage (fail to back "
                  f"in service) {w['t_end'] - w['t_fail']:.4f} s, detected "
                  f"after {w['t_detect'] - w['t_fail']:.4f} s, epoch "
                  f"{w['epoch_to']}, mode {w['mode']}")
        check_all(run.trace, spec, ActorConfig(mode="precommitted"))
        print(f"  check_all green on the {name} trace "
              f"({len(run.trace.events)} events)")

    try:
        # -- observability ------------------------------------------------
        perfetto = tmp / "step0.perfetto.json"
        obs = launch("obs", ["--steps", "6", "--metrics-report", "--explain",
                             "--export-perfetto", str(perfetto)])
        doc = json.loads(perfetto.read_text())
        validate_chrome_trace(doc)
        check_all(obs.trace, spec, ActorConfig(mode="hint"))
        print(f"  perfetto export valid ({len(doc['traceEvents'])} trace "
              f"events); check_all green on the recorded step-0 trace "
              f"({len(obs.trace.events)} events)")

        # -- identical unfailed runs; telemetry on and off in turns --------
        plain, metered = [], []
        for i in (1, 2):
            plain.append(launch(f"1f1b {i}", ["--steps", "2"] + FIXED_ORDER))
            metered.append(launch(f"1f1b metrics-report {i}",
                                  ["--steps", "2", "--metrics-report"]
                                  + FIXED_ORDER))
        spread = max(abs(a - b) for a, b in zip(plain[0].losses,
                                                 plain[1].losses))
        print(f"  two identical unfailed 1f1b runs: {plain[0].losses} vs "
              f"{plain[1].losses}: "
              + ("bitwise equal, so every gate below is bitwise"
                 if spread == 0 else
                 f"spread {spread!r}, the bound of every gate below"))

        def gate(what, got, want):
            d = max(abs(a - b) for a, b in zip(got, want, strict=True))
            if d > spread:
                raise AssertionError(f"{what}: {got} vs {want}, |diff| {d!r} "
                                     f"> identical-run spread {spread!r}")
            print(f"  {what}: {got} vs {want}: "
                  + ("bitwise equal" if d == 0 else
                     f"|diff| {d!r} <= identical-run spread {spread!r}"))

        for run in metered:
            gate("--metrics-report against the unfailed run", run.losses,
                 plain[0].losses)
        for k in range(2):
            off = [r.step_seconds[k] for r in plain]
            on = [r.step_seconds[k] for r in metered]
            print(f"  step {k} seconds without --metrics-report {off}, with "
                  f"{on}: overhead {sum(on) / 2 - sum(off) / 2:+.4f} s/step "
                  f"(mean of 2 each)")

        # -- checkpoint ----------------------------------------------------
        free = shutil.disk_usage(tmp).free
        if free < CKPT_FREE_BYTES:
            raise AssertionError(f"{tmp}: {free / 1e9:.1f} GB free, the "
                                 f"checkpoint runs need "
                                 f"{CKPT_FREE_BYTES / 1e9:.0f} GB")
        ckpt = str(tmp / "ckpt")
        writer = launch("checkpoint write",
                        ["--steps", "3", "--ckpt-dir", ckpt, "--ckpt-every",
                         "2"] + FIXED_ORDER)
        saves = [e for e in writer.ckpt_log if e["op"] == "save"]
        if [e["step"] for e in saves] != [2]:
            raise AssertionError(f"expected one save at step 2: {saves}")
        print(f"  saved step 2: {saves[0]['bytes']:,} bytes in "
              f"{saves[0]['seconds']:.3f} s "
              f"({saves[0]['bytes'] / saves[0]['seconds'] / 1e9:.2f} GB/s)")
        resumed = launch("resume", ["--steps", "3", "--ckpt-dir", ckpt,
                                    "--resume"] + FIXED_ORDER)
        (restore,) = [e for e in resumed.ckpt_log if e["op"] == "resume"]
        print(f"  resume restored step {restore['step']} in "
              f"{restore['seconds']:.3f} s")
        gate("resumed step 2 against the writer's", resumed.losses,
             writer.losses[2:])

        # -- recovery ------------------------------------------------------
        print(f"  --hb-deadline {HB_DEADLINE} s on the recovery runs")
        killed = launch("recover kill",
                        ["--steps", "2", "--chaos",
                         "fail_stage=1,fail_kind=kill,fail_after=5",
                         "--recover", "--hb-deadline", HB_DEADLINE,
                         "--record-trace", str(tmp / "kill.trace.jsonl")]
                        + FIXED_ORDER)
        gate("kill + --recover against the unfailed run", killed.losses,
             plain[0].losses)
        outage(killed, "kill")
        # --ckpt-every 2: no second 10 GB save at step 3 (--recover's
        # default cadence is 1)
        rr = launch("resume + recover",
                    ["--steps", "3", "--resume", "--recover", "--chaos",
                     "fail_stage=2,fail_after=3", "--ckpt-dir", ckpt,
                     "--ckpt-every", "2", "--hb-deadline", HB_DEADLINE,
                     "--record-trace", str(tmp / "rr.trace.jsonl")]
                    + FIXED_ORDER)
        gate("resume + kill + --recover against the writer's step 2",
             rr.losses, writer.losses[2:])
        for e in rr.ckpt_log:
            print(f"  {e['op']} restore of step {e['step']}: "
                  f"{e['seconds']:.3f} s")
        if not any(e["op"] == "respawn" for e in rr.ckpt_log):
            raise AssertionError("the respawn did not restore from the "
                                 "checkpoint")
        outage(rr, "resume + recover")
        shutil.rmtree(ckpt)

        # -- adaptive hint loop --------------------------------------------
        ad = launch("adaptive", ["--steps", "6", "--adaptive",
                                 "--resynth-every", "1", "--hint", "bf",
                                 "--record-trace",
                                 str(tmp / "adaptive.trace.jsonl")])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for k, (a, b) in enumerate(zip(ad.losses, obs.losses, strict=True)):
        if abs(a - b) > TOL["bfloat16"] * max(1.0, abs(b)):
            raise AssertionError(f"adaptive step {k} loss {a} vs the plain "
                                 f"rrfp run's {b}")
    print(f"  adaptive losses {ad.losses} vs plain rrfp {obs.losses}: agree "
          f"within {TOL['bfloat16']:g} (relative)")
    if not any(ev.info.get("path") == "table" for ev in ad.trace.events
               if ev.kind == "dispatch"):
        raise AssertionError("the adaptive step-0 trace has no table-path "
                             "dispatch")
    check_all(ad.trace, spec, ActorConfig(mode="hint"))
    print("  check_all (table faithfulness included) green on the adaptive "
          "step-0 trace")
    sched = ad.scheduler
    for d in sched.decisions:
        print(f"  decision {json.dumps(d.to_json())}")
    print(f"  adaptive swaps: {len(sched.swaps)} at steps {sched.swaps} "
          f"(table v{sched.version})"
          + ("" if sched.swaps else ": no swap fired on these costs"))
    return runs


def phase_multimodal_path():
    """The multimodal main path through ``repro_torch.launch.train
    --workload multimodal`` (MM_ARGS): hint bf for 3 steps, then bfw for 2;
    then 2 bf steps of ``train_multimodal(args, model=...)`` with the
    reference's full-size encoder settings (MM_REAL_ENCODER: encoder
    microbatches of ~2048 tokens in buckets up to 4096).  The launch
    counts are zeroed just before each run and read just after; K1 and K2
    must launch in each, the losses be finite, and bf and bfw give the same
    step-0 loss."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.multimodal import multimodal_model

    runs = {}
    label = "qwen2-vl-2b multimodal"
    real = ("real encoder bf", ["--steps", "2", "--hint", "bf"])
    for name, extra in MM_RUNS + [real]:
        argv = MM_ARGS + extra
        model = None
        if name == real[0]:
            i = argv.index("--seq") + 1
            argv[i] = str(MM_REAL_ENCODER["text_seq"])
            enc, lm = train._multimodal_stage_split(4)
            model = multimodal_model("qwen2-vl-2b", enc_stages=enc,
                                     lm_stages=lm, reduced=False,
                                     **MM_REAL_ENCODER)
        print(f"main path {label} ({name}): python -m "
              f"repro_torch.launch.train " + " ".join(argv)
              + (f"  [model: multimodal_config(..., {MM_REAL_ENCODER})]"
                 if model is not None else ""))
        args = train.parser().parse_args(argv)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        run = train.train_multimodal(args, model=model)
        counts = ops.launch_counts()
        mem = torch.cuda.max_memory_allocated()
        steps = len(run.losses)
        tokens = args.microbatches * args.mb_rows * args.seq
        print(f"  losses {run.losses}  step seconds {run.step_seconds}  "
              f"launches {counts} "
              f"({ {k: v / steps for k, v in counts.items()} } per step)"
              f"  peak memory {mem / 2**30:.2f} GiB")
        for i, sec in enumerate(run.step_seconds):
            print(f"  step {i}: {sec:.3f} s  {tokens / sec:,.0f} text "
                  f"tokens/s")
        print("  card after the run (SM clock, max SM clock, power, "
              "temperature): " + card("clocks.sm,clocks.max.sm,"
                                      "power.draw,temperature.gpu"))
        if not all(math.isfinite(x) for x in run.losses):
            raise AssertionError(f"non-finite losses in the multimodal "
                                 f"{name} run")
        missing = [k for k in ("flash_attention_fwd", "rmsnorm")
                   if counts[k] == 0]
        if missing:
            raise AssertionError(f"the multimodal {name} run launched no "
                                 f"{missing}")
        runs[label, name] = (run, counts, mem)
        del model
        torch.cuda.empty_cache()
    l_bf = runs[label, "bf"][0].losses[0]
    l_bfw = runs[label, "bfw"][0].losses[0]
    if abs(l_bf - l_bfw) > TOL["bfloat16"] * max(1.0, abs(l_bf)):
        raise AssertionError(f"multimodal step-0 losses disagree: bf {l_bf} "
                             f"vs bfw {l_bfw}")
    print(f"  {label} step-0 loss bf {l_bf} vs bfw {l_bfw}: agree within "
          f"{TOL['bfloat16']:g} (relative)")
    return runs


def phase_serve_path():
    """The serve runs of SERVE_PATHS through ``launch.serve``; each is
    checked for its exact launch counts, tokens inside the padded vocab,
    and finite logits from one more decode pass (outside the counts)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    runs = {}
    for arch, tokens in SERVE_PATHS:
        argv = ["--arch", arch, "--tokens", str(tokens)] + SERVE_ARGS
        print(f"main path {arch} (serve): python -m repro_torch.launch.serve "
              + " ".join(argv))
        args = serve.parser().parse_args(argv)
        server = serve.build_server(arch, stages=args.stages, layers=None,
                                    batch=args.batch,
                                    cache_len=args.cache_len, reduced=False,
                                    device="cuda", seed=args.seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        run = serve.serve(args, server=server)
        counts = ops.launch_counts()
        mem = torch.cuda.max_memory_allocated()
        model, cfg = server["model"], server["cfg"]
        want = {k: v * tokens for k, v in
                serve_launches(model, args.batch).items()}
        steady = run.step_seconds[1:]
        print(f"  step seconds {run.step_seconds}  launches {counts} "
              f"({ {k: v / tokens for k, v in counts.items()} } per step; "
              f"from the layers {want})  peak memory {mem / 2**30:.2f} GiB")
        print(f"  first step {run.step_seconds[0]:.3f} s, then "
              f"{sum(steady) / len(steady) * 1e3:.2f} ms/step, "
              f"{args.batch * len(steady) / sum(steady):.1f} tokens/s")
        print("  card after the run (SM clock, max SM clock, power, "
              "temperature): " + card("clocks.sm,clocks.max.sm,"
                                      "power.draw,temperature.gpu"))
        for name, n in want.items():
            if counts[name] != n:
                raise AssertionError(f"the {arch} serve run launched "
                                     f"{name} {counts[name]} times, its "
                                     f"layers give {n}")
        toks = torch.tensor(run.tokens)
        if toks.shape != (args.batch, tokens + 1) or not (
                (toks >= 0) & (toks < cfg.padded_vocab())).all():
            raise AssertionError(f"{arch} serve tokens of shape "
                                 f"{tuple(toks.shape)} or outside the vocab")
        _, logits = decode_pass(model, server["sp"], server["io"],
                                server["caches"], toks[:, -1].cuda(), tokens)
        if logits.shape != (args.batch, cfg.padded_vocab()) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"{arch}: logits of shape "
                                 f"{tuple(logits.shape)}, or not finite")
        runs[arch, "serve"] = (run, counts, mem)
        del server
        torch.cuda.empty_cache()
    return runs


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card()
    import triton

    print(f"card: {smi}  ({torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible)")
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"CUDA {torch.version.cuda}  triton {triton.__version__}")

    t0 = time.perf_counter()
    secs = _build.build_all(["flash_attention", "ssd_scan", "flash_decode"])
    for name, (s, log) in _build.BUILD_LOG.items():
        print(f"built {name}.cu in {s:.1f} s" + (f"\n{log}" if log.strip()
                                                  else ""))
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({'reused' if not secs else 'compiled'})")
    if "flash_attention" in _build.BUILD_LOG:  # K1 at head_dim 256
        n = check_no_spills(_build.BUILD_LOG["flash_attention"][1],
                            "flash_fwd_kernelILi256E")
        print(f"K1 head_dim 256: {n} instantiations, no ptxas spills")

    record: dict = {}
    phase_attention(record)
    phase_rmsnorm(record)
    phase_ssd(record)
    phase_decode(record)
    if "--kernels-only" in argv:
        return 0
    phase_small_model()
    phase_small_multimodal()
    phase_small_serve()
    runs = phase_main_path()
    torch.cuda.empty_cache()
    runs.update(phase_runtime_flags())
    runs.update(phase_multimodal_path())
    runs.update(phase_serve_path())
    kernels = []
    for name, rec in record.items():
        by_path = {f"{arch} {run}": c[name] for (arch, run), (_, c, _)
                   in runs.items()}
        kernels.append({**rec, "launches": sum(by_path.values()),
                        "launches_by_path": by_path})
    out = {"kernels": kernels}
    summary = {**out, "card": smi,
               "main_path": {f"{arch} {name}": {
                   **({"tokens": r.tokens} if name == "serve"
                      else {"losses": r.losses}),
                   "step_seconds": r.step_seconds,
                   "launches": c, "peak_memory_bytes": mem}
                   for (arch, name), (r, c, mem) in runs.items()}}
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "chip_smoke.json").write_text(
        json.dumps(summary, indent=1))
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(f"card: {smi}")
    print(json.dumps(out))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
