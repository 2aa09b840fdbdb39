"""Where the device time of one training or serve step goes (``torch.profiler``).

    python -m repro_torch.launch.profile [--out PATH] [train flags]
    python -m repro_torch.launch.profile --workload multimodal [--out PATH]
    python -m repro_torch.launch.profile --serve [--out PATH] [serve flags]

Runs :func:`repro_torch.launch.train.train_actor` for three steps (default
flags: the first main path of ``chip_smoke.py``: paper-gpt3-large full
size, 4 stages, 8 microbatches of 1 x 2048 tokens, hint bf; give train
flags, e.g. ``--arch zamba2-1.2b --full-size ...``, for another), with
``--workload multimodal`` :func:`~repro_torch.launch.train.train_multimodal`
(default flags: qwen2-vl-2b full size, 4 stages, 8 microbatches of 1 x
2048 text tokens, hint bf), or with ``--serve``
:func:`repro_torch.launch.serve.serve` for three tokens (default flags:
the serve main path, seamless-m4t-large-v2 full size, 4 stages, batch 8,
cache 4096), and traces the third step with CUDA activity.  Prints the step's wall time, the device's
busy time (union of kernel intervals; every stage shares the default
stream) and idle share, the time per kernel category and the heaviest
kernels, and writes the same as JSON to ``--out``.  Needs a GPU; the
profiler's own host overhead lengthens the traced step, so the breakdown
is of device time and the untraced step times are the wall-time record.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from repro_torch.launch import serve, train

DEFAULT_ARGS = ["--arch", "paper-gpt3-large", "--full-size", "--stages", "4",
                "--microbatches", "8", "--mb-rows", "1", "--seq", "2048",
                "--hint", "bf"]
DEFAULT_MM_ARGS = ["--arch", "qwen2-vl-2b", "--full-size", "--stages", "4",
                   "--microbatches", "8", "--mb-rows", "1", "--seq", "2048",
                   "--hint", "bf"]
DEFAULT_SERVE_ARGS = ["--arch", "seamless-m4t-large-v2", "--full-size",
                      "--stages", "4", "--batch", "8", "--cache-len", "4096"]
#: (category, substrings of the kernel name), first match wins
CATEGORIES = (
    ("K1 flash_attention_fwd", ("flash_fwd_kernel",)),
    ("K3 flash_decode", ("flash_decode_kernel",)),
    ("K2 rmsnorm", ("_rmsnorm_kernel",)),
    ("K4 ssd_scan", ("ssd_tc_kernel", "ssd_scan_kernel")),
    ("matmul float32 (no tensor cores)", ("f32f32", "sgemm")),
    ("matmul (tensor cores)", ("nvjet", "gemm", "xmma", "cutlass",
                               "Kernel2", "sm90_")),
    ("reductions / softmax", ("reduce", "softmax", "logsumexp")),
    ("indexing", ("index", "scatter", "gather", "embedding")),
    ("copies / casts / fills", ("copy", "Memcpy", "Memset", "fill",
                                "cat")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def category(name: str) -> str:
    for cat, keys in CATEGORIES:
        if any(k in name for k in keys):
            return cat
    return "other"


def _union_us(intervals) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def breakdown(events, wall_s: float) -> dict:
    # device-side events minus the profiler's own step annotation
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("ProfilerStep")]
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    busy_us = _union_us(spans)
    window_us = (max(b for _, b in spans) - min(a for a, _ in spans)
                 if spans else 0.0)
    by_cat: dict[str, float] = {}
    by_name: dict[str, list] = {}
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        by_cat[category(e.name)] = by_cat.get(category(e.name), 0.0) + dur
        rec = by_name.setdefault(e.name, [0.0, 0])
        rec[0] += dur
        rec[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    host: dict[str, float] = {}
    for e in events:
        if (e.device_type == torch.autograd.DeviceType.CPU
                and not e.name.startswith("ProfilerStep")):
            host[e.name] = host.get(e.name, 0.0) + e.self_cpu_time_total
    return {
        "step_wall_s": wall_s,
        "kernel_window_s": window_us / 1e6,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share_of_window": 1.0 - busy_us / window_us
        if window_us else None,
        "kernels": len(kernels),
        "by_category_s": dict(sorted(((k, v / 1e6) for k, v in by_cat.items()),
                                     key=lambda kv: -kv[1])),
        "top_kernels": [{"name": n[:120], "total_s": t / 1e6, "calls": c,
                         "mean_us": t / c} for n, (t, c) in top],
        "top_host_ops_self_s": {n: t / 1e6 for n, t in sorted(
            host.items(), key=lambda kv: -kv[1])[:12]},
    }


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--out", default=None)
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--workload", default="language",
                    choices=("language", "multimodal"))
    own, rest = ap.parse_known_args(argv)
    if own.serve:
        args = serve.parser().parse_args((rest or DEFAULT_SERVE_ARGS)
                                         + ["--tokens", "3"])
        run_fn = serve.serve
    elif own.workload == "multimodal":
        args = train.parser().parse_args(
            (rest or DEFAULT_MM_ARGS)
            + ["--workload", "multimodal", "--steps", "3"])
        run_fn = train.train_multimodal
    else:
        args = train.parser().parse_args((rest or DEFAULT_ARGS)
                                         + ["--steps", "3"])
        run_fn = train.train_actor
    train.resolve_device(args.device)
    captured = {}

    def ready(prof):
        captured["events"] = prof.events()

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(skip_first=1, wait=0, warmup=1,
                                             active=1, repeat=1),
            on_trace_ready=ready) as prof:
        run = run_fn(args, step_hook=lambda step: prof.step())
    out = breakdown(captured["events"], run.step_seconds[2])
    if not out["kernels"]:
        raise RuntimeError("no device kernel was traced: the breakdown is "
                           "of device time and needs a GPU run")
    out["step_seconds"] = run.step_seconds
    out["card"] = torch.cuda.get_device_name(0)
    print(f"traced step: wall {out['step_wall_s']:.3f} s, kernels span "
          f"{out['kernel_window_s']:.3f} s, device busy "
          f"{out['device_busy_s']:.3f} s (idle "
          f"{out['device_idle_share_of_window']:.1%} of the span), "
          f"{out['kernels']} kernels")
    for cat, s in out["by_category_s"].items():
        print(f"  {cat:28s} {s:8.4f} s  {s / out['device_busy_s']:6.1%}")
    for k in out["top_kernels"]:
        print(f"  {k['total_s']:8.4f} s  {k['calls']:6d} x {k['mean_us']:9.1f}"
              f" us  {k['name']}")
    for n, t in out["top_host_ops_self_s"].items():
        print(f"  host {t:8.4f} s  {n}")
    if own.out:
        Path(own.out).parent.mkdir(parents=True, exist_ok=True)
        Path(own.out).write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
