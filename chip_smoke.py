#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (one NVIDIA GPU).

    python3 chip_smoke.py                # every phase, as the port's proof
    python3 chip_smoke.py --kernels-only # build + check the kernels, stop

Phases, each of which raises on failure (non-zero exit, no result line):

1. the card (``nvidia-smi`` name and power limit) and the software versions;
2. build the kernels from the sources in ``src/repro_torch/kernels``;
3. every kernel against its plain PyTorch version on the card, at the main
   path's shape and at the reference kernel tests' shapes, with the stated
   tolerance; then the kernel's time beside its plain version's, one
   library call's (a yardstick only: the port never calls it) and the
   card's bound for the same work;
4. an end-to-end check on a small input: the port's model forward on the
   card (kernels) against the same weights on the CPU (plain versions);
5. the main path: ``repro_torch.launch.train`` actor training of
   ``paper-gpt3-large --full-size`` (4 stages, 8 microbatches of 1 x 2048
   tokens, hint bf, 3 steps), then 2 steps of ``--hint bfw
   --split-backward``; the launch counts are zeroed just before each run and
   read just after, and every kernel must have launched in each.

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
#: (b, sq, hq, hkv, hd, window): the main path, then tests/test_kernels.py
ATTN_SHAPES = [
    (1, 2048, 16, 16, 96, 0),
    (1, 128, 4, 4, 64, 0),
    (2, 200, 8, 2, 64, 0),
    (1, 384, 8, 1, 128, 0),
    (2, 160, 4, 4, 64, 64),
    (1, 96, 4, 2, 32, 0),
]
NORM_SHAPE = (2048, 1536)

MAIN_ARGS = ["--runtime", "actor", "--arch", "paper-gpt3-large",
             "--full-size", "--stages", "4", "--microbatches", "8",
             "--mb-rows", "1", "--seq", "2048", "--device", "cuda"]
MAIN_RUNS = [("bf", ["--steps", "3", "--hint", "bf"]),
             ("bfw", ["--steps", "2", "--hint", "bfw", "--split-backward"])]


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


def check_close(name, got, want, tol) -> float:
    import torch

    err = float((got.float() - want.float()).abs().max())
    ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
    print(f"  {name}: max |err| {err:.3e}  (tolerance atol=rtol={tol:g})"
          f"  {'ok' if ok else 'FAIL'}")
    if not ok or not math.isfinite(err):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max |err| {err:.3e} > {tol:g})")
    return err


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
    main_err = None
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
            err = check_close(f"{tag} out", out, want, TOL[dn])
            check_close(f"{tag} lse", lse, want_lse, TOL_LSE)
            if shape == ATTN_SHAPES[0] and dtype == torch.bfloat16:
                main_err = err
    b, sq, hq, hkv, hd, _ = ATTN_SHAPES[0]
    sets = [attention_inputs(ATTN_SHAPES[0], torch.bfloat16, seed=s)
            for s in range(4)]
    ms = time_ms(lambda q, k, v: fa.flash_attention_fwd(q, k, v), sets)
    plain_ms = time_ms(lambda q, k, v: fa.flash_attention_fwd_plain(q, k, v),
                       sets, iters=4)
    lib_sets = [tuple(t.contiguous() for t in s) for s in sets]
    lib_ms = time_ms(lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=1.0), lib_sets)
    flops = 2 * b * hq * sq * sq * hd  # causal QK^T + PV: half of 4*s^2*hd
    nbytes = 4 * b * sq * hq * hd * 2 + b * hq * sq * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    print(f"  main-path shape bf16: kernel {ms:.4f} ms  plain {plain_ms:.4f} "
          f"ms  sdpa {lib_ms:.4f} ms  bound max({flops:.4g} FLOP / 989 "
          f"TFLOP/s = {t_ops:.4f} ms, {nbytes:.4g} B / 3.35 TB/s = "
          f"{t_bytes:.4f} ms)")
    record["flash_attention_fwd"] = {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:79",
        "max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": lib_ms}


def phase_rmsnorm(record):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import rmsnorm as rn

    print("K2 rmsnorm (Triton) vs its plain version:")
    rows, d = NORM_SHAPE
    g = torch.Generator(device="cuda").manual_seed(7)
    main_err = None
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        x = torch.randn((rows, d), generator=g, device="cuda").to(dtype)
        scale = (torch.randn((d,), generator=g, device="cuda") * 0.1).to(dtype)
        got = rn.rmsnorm(x, scale)
        torch.cuda.synchronize()
        err = check_close(f"[{rows}, {d}] {dn}", got,
                          rn.rmsnorm_plain(x, scale), TOL[dn])
        if dtype == torch.bfloat16:
            main_err = err
    sets = []
    for _ in range(16):  # 16 x 6.3 MB inputs: more than the 50 MB L2
        x = torch.randn((rows, d), generator=g, device="cuda").to(torch.bfloat16)
        sets.append((x, (torch.randn((d,), generator=g, device="cuda") * 0.1
                         ).to(torch.bfloat16)))
    ms = time_ms(lambda x, s: rn.rmsnorm(x, s), sets, iters=64)
    plain_ms = time_ms(lambda x, s: rn.rmsnorm_plain(x, s), sets, iters=64)
    lib_ms = time_ms(lambda x, s: F.rms_norm(x, (d,), weight=1.0 + s,
                                             eps=1e-5), sets, iters=64)
    nbytes = 2 * rows * d * 2 + d * 2
    flops = 4 * rows * d
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    print(f"  [{rows}, {d}] bf16: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
          f"  F.rms_norm {lib_ms:.4f} ms  bound max({nbytes:.4g} B / 3.35 "
          f"TB/s = {t_bytes:.4f} ms, {flops:.4g} FLOP / 67 TFLOP/s = "
          f"{t_ops:.4f} ms)")
    record["rmsnorm"] = {
        "name": "rmsnorm", "route": "triton",
        "source": "src/repro_torch/kernels/rmsnorm.py",
        "replaces": "src/repro/kernels/rmsnorm.py:19",
        "max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops > t_bytes else "bytes",
        "library_ms": lib_ms}


def phase_small_model():
    """The port's forward on the card (kernels) against the CPU (plain
    versions) on identical weights: paper-gpt3-large widths, 2 layers,
    float32, 256 tokens."""
    import copy
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.models.build import build

    cfg = dataclasses.replace(registry.get_arch("paper-gpt3-large"),
                              num_layers=2, dtype=torch.float32)
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
    print("small-input forward, card (kernels) vs CPU (plain), float32:")
    check_close("paper-gpt3-large widths, 2 layers, 256 tokens: logits",
                got.cpu(), want, 1e-3)


def main_path_work() -> tuple[int, float]:
    """Tokens and model FLOPs of one main-path step: 6 x (matmul weights
    incl. the head) x tokens plus causal attention's 6 x s/2 x 2*hq*hd per
    token and layer (no recompute counted)."""
    from repro_torch.configs import registry
    from repro_torch.launch import train

    args = train.parser().parse_args(MAIN_ARGS)
    cfg = registry.get_arch(args.arch)
    seq = args.seq
    tokens = args.microbatches * args.mb_rows * seq
    n = cfg.active_param_count() + cfg.padded_vocab() * cfg.d_model
    attn = cfg.num_layers * (seq / 2) * 2 * cfg.num_heads * cfg.resolved_head_dim
    return tokens, 6.0 * tokens * (n + attn)


def phase_main_path():
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import train

    runs = {}
    for name, extra in MAIN_RUNS:
        print(f"main path ({name}): python -m repro_torch.launch.train "
              + " ".join(MAIN_ARGS + extra))
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        run = train.main(MAIN_ARGS + extra)
        counts = ops.launch_counts()
        steps = len(run.losses)
        print(f"  losses {run.losses}  step seconds {run.step_seconds}  "
              f"launches {counts} ({ {k: v / steps for k, v in counts.items()} }"
              f" per step)  peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        print("  card after the run (SM clock, max SM clock, power, "
              "temperature): " + card("clocks.sm,clocks.max.sm,power.draw,"
                                      "temperature.gpu"))
        if not all(math.isfinite(x) for x in run.losses):
            raise AssertionError(f"non-finite losses in the {name} run")
        missing = [k for k, n in counts.items() if n == 0]
        if missing:
            raise AssertionError(f"the {name} run launched no {missing}")
        runs[name] = (run, counts)
        tokens, flops = main_path_work()
        for i, sec in enumerate(run.step_seconds):
            print(f"  step {i}: {sec:.3f} s  {tokens / sec:,.0f} tokens/s  "
                  f"model FLOP utilization {flops / sec / PEAK_BF16_FLOPS:.2%}"
                  f" of 989 TFLOP/s")
    l_bf, l_bfw = runs["bf"][0].losses[0], runs["bfw"][0].losses[0]
    if abs(l_bf - l_bfw) > TOL["bfloat16"] * max(1.0, abs(l_bf)):
        raise AssertionError(f"step-0 losses disagree: bf {l_bf} vs "
                             f"bfw {l_bfw}")
    print(f"  step-0 loss bf {l_bf} vs bfw {l_bfw}: agree within "
          f"{TOL['bfloat16']:g} (relative)")
    return runs


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
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
    secs = _build.build_all(["flash_attention"])
    for name, (s, log) in _build.BUILD_LOG.items():
        print(f"built {name}.cu in {s:.1f} s" + (f"\n{log}" if log.strip()
                                                  else ""))
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({'reused' if not secs else 'compiled'})")

    record: dict = {}
    phase_attention(record)
    phase_rmsnorm(record)
    if "--kernels-only" in argv:
        return 0
    phase_small_model()
    runs = phase_main_path()
    counts = runs["bf"][1]
    kernels = []
    for name, rec in record.items():
        kernels.append({**rec, "launches": counts[name]})
    out = {"kernels": kernels}
    summary = {**out, "card": smi,
               "main_path": {name: {"losses": r.losses,
                                    "step_seconds": r.step_seconds,
                                    "launches": c}
                             for name, (r, c) in runs.items()}}
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "chip_smoke.json").write_text(
        json.dumps(summary, indent=1))
    print(f"card: {smi}")
    print(json.dumps(out))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
