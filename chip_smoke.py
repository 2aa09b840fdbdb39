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
4. an end-to-end check on a small input per main path: the port's model
   forward on the card (kernels) against the same weights on the CPU
   (plain versions), at the arch's full widths;
5. the main paths, each through ``repro_torch.launch.train`` (actor
   training, full size, 4 stages, 8 microbatches of 1 x 2048 tokens):
   ``paper-gpt3-large`` hint bf for 3 steps, then ``--hint bfw
   --split-backward`` for 2; ``zamba2-1.2b`` bf for 3 steps, then bfw for
   1.  The launch counts are zeroed just before each run and read just
   after, and every kernel of the path must have launched in each.

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
#: (b, sq, hq, hkv, hd, window): the main paths, then tests/test_kernels.py
ATTN_SHAPES = [
    (1, 2048, 16, 16, 96, 0),
    (1, 2048, 32, 32, 64, 0),
    (1, 128, 4, 4, 64, 0),
    (2, 200, 8, 2, 64, 0),
    (1, 384, 8, 1, 128, 0),
    (2, 160, 4, 4, 64, 64),
    (1, 96, 4, 2, 32, 0),
]
#: (b, s, nh, hd, ds, chunk): the zamba2 path, then tests/test_kernels.py
SSD_SHAPES = [
    (1, 2048, 64, 64, 64, 64),
    (2, 256, 4, 32, 16, 64),
    (1, 128, 8, 64, 64, 128),
    (1, 192, 2, 16, 8, 64),
    (2, 100, 2, 16, 8, 64),
]
#: main path -> the shapes its kernels run at (timed at these)
PATH_SHAPES = {
    "paper-gpt3-large": {"attn": [ATTN_SHAPES[0]], "norm": [(2048, 1536)],
                         "ssd": []},
    "zamba2-1.2b": {"attn": [ATTN_SHAPES[1]],
                    "norm": [(2048, 2048), (2048, 4096)],
                    "ssd": [SSD_SHAPES[0]]},
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


def card(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, arg_sets, iters: int = 20, reps: int = 3) -> float:
    """Device ms per call: ``iters`` calls cycling through ``arg_sets``
    (distinct inputs, so a call does not find the previous one's in L2) are
    captured in a CUDA graph and replayed ``reps`` times between two
    events, so the host's launch cost is not in the number."""
    import torch

    for a in arg_sets:  # compile, autotune, warm the allocator
        fn(*a)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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
    timings = []
    for path, shapes in PATH_SHAPES.items():
        for shape in shapes["attn"]:
            b, sq, hq, hkv, hd, _ = shape
            sets = [attention_inputs(shape, torch.bfloat16, seed=s)
                    for s in range(4)]
            ms = time_ms(lambda q, k, v: fa.flash_attention_fwd(q, k, v), sets)
            plain_ms = time_ms(
                lambda q, k, v: fa.flash_attention_fwd_plain(q, k, v), sets,
                iters=4)
            lib_sets = [tuple(t.contiguous() for t in s) for s in sets]
            lib_ms = time_ms(lambda q, k, v: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=1.0), lib_sets)
            # causal QK^T + PV: half of 4*s^2*hd
            flops = 2 * b * hq * sq * sq * hd
            nbytes = 4 * b * sq * hq * hd * 2 + b * hq * sq * 4
            bound_ms, bound_by = bound(flops, PEAK_BF16_FLOPS, nbytes)
            print(f"  {path} shape {shape[:5]} bf16: kernel {ms:.4f} ms  "
                  f"plain {plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms  bound "
                  f"{bound_ms:.4f} ms ({bound_by}: {flops:.4g} FLOP / 989 "
                  f"TFLOP/s, {nbytes:.4g} B / 3.35 TB/s)")
            timings.append({"path": path, "shape": list(shape),
                            "max_abs_err": errs[shape, "bfloat16"], "ms": ms,
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
        for rows, d in shapes["norm"]:
            err = None
            for dtype in (torch.bfloat16, torch.float32):
                dn = str(dtype).split(".")[1]
                x = torch.randn((rows, d), generator=g,
                                device="cuda").to(dtype)
                scale = (torch.randn((d,), generator=g, device="cuda")
                         * 0.1).to(dtype)
                got = rn.rmsnorm(x, scale)
                torch.cuda.synchronize()
                e = check_close(f"[{rows}, {d}] {dn}", got,
                                rn.rmsnorm_plain(x, scale), TOL[dn])
                err = e if dtype == torch.bfloat16 else err
            n_sets = max(4, (2 * 50 * 2**20) // (rows * d * 2) + 1)
            sets = []  # more distinct inputs than the 50 MB L2 holds
            for _ in range(n_sets):
                x = torch.randn((rows, d), generator=g,
                                device="cuda").to(torch.bfloat16)
                sets.append((x, (torch.randn((d,), generator=g, device="cuda")
                                 * 0.1).to(torch.bfloat16)))
            ms = time_ms(lambda x, s: rn.rmsnorm(x, s), sets, iters=64)
            plain_ms = time_ms(lambda x, s: rn.rmsnorm_plain(x, s), sets,
                               iters=64)
            lib_ms = time_ms(lambda x, s, d=d: F.rms_norm(
                x, (d,), weight=1.0 + s, eps=1e-5), sets, iters=64)
            nbytes = 2 * rows * d * 2 + d * 2
            flops = 4 * rows * d
            bound_ms, bound_by = bound(flops, PEAK_FP32_FLOPS, nbytes)
            print(f"  {path} [{rows}, {d}] bf16: kernel {ms:.4f} ms  plain "
                  f"{plain_ms:.4f} ms  F.rms_norm {lib_ms:.4f} ms  bound "
                  f"{bound_ms:.4f} ms ({bound_by}: {nbytes:.4g} B / 3.35 "
                  f"TB/s, {flops:.4g} FLOP / 67 TFLOP/s)")
            timings.append({"path": path, "shape": [rows, d],
                            "max_abs_err": err, "ms": ms,
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
    the reference tests' shapes also against the sequential oracle."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as ssd

    print("K4 ssd_scan (CUDA) vs its plain version:")
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
              f"989 TFLOP/s)")
        timings.append({"path": "zamba2-1.2b", "shape": list(shape),
                        "max_abs_err": errs[shape, "bfloat16"], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": None})
    record["ssd_scan"] = kernel_entry(
        "ssd_scan", "cuda", "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan.py:56", timings)


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
    stages (a shared-block slot and a disabled slot)."""
    import copy

    import torch

    from repro_torch.models.build import build

    print("small-input forward, card (kernels) vs CPU (plain), float32:")
    for arch, layers in (("paper-gpt3-large", 2), ("zamba2-1.2b", 3)):
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
        check_close(f"{arch} widths, {layers} layers (shared slots "
                    f"{model.shared_flags.tolist()}), 256 tokens: logits",
                    got.cpu(), want, 1e-3)


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
    secs = _build.build_all(["flash_attention", "ssd_scan"])
    for name, (s, log) in _build.BUILD_LOG.items():
        print(f"built {name}.cu in {s:.1f} s" + (f"\n{log}" if log.strip()
                                                  else ""))
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({'reused' if not secs else 'compiled'})")

    record: dict = {}
    phase_attention(record)
    phase_rmsnorm(record)
    phase_ssd(record)
    if "--kernels-only" in argv:
        return 0
    phase_small_model()
    runs = phase_main_path()
    kernels = []
    for name, rec in record.items():
        by_path = {f"{arch} {run}": c[name] for (arch, run), (_, c, _)
                   in runs.items()}
        kernels.append({**rec, "launches": sum(by_path.values()),
                        "launches_by_path": by_path})
    out = {"kernels": kernels}
    summary = {**out, "card": smi,
               "main_path": {f"{arch} {name}": {
                   "losses": r.losses, "step_seconds": r.step_seconds,
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
