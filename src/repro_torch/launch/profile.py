"""Where the device time of one training or serve step goes (``torch.profiler``).

    python -m repro_torch.launch.profile [--out PATH] [--depth N] [train flags]
    python -m repro_torch.launch.profile --workload multimodal [--out PATH]
    python -m repro_torch.launch.profile --serve [--out PATH] [serve flags]
    python -m repro_torch.launch.profile --runtime table [--out PATH] [flags]

Runs :func:`repro_torch.launch.train.train_actor` for three steps (default
flags: the first main path of ``chip_smoke.py``: paper-gpt3-large full
size, 4 stages, 8 microbatches of 1 x 2048 tokens, hint bf; give train
flags, e.g. ``--arch zamba2-1.2b --full-size ...``, for another, and
``--depth N`` to train the full-width config cut to its first N layers,
``registry.cut_depth``, as ``chip_smoke.py`` trains deepseek-moe-16b), with
``--workload multimodal`` :func:`~repro_torch.launch.train.train_multimodal`
(default flags: qwen2-vl-2b full size, 4 stages, 8 microbatches of 1 x
2048 text tokens, hint bf), or with ``--serve``
:func:`repro_torch.launch.serve.serve` for three tokens (default flags:
the serve main path, seamless-m4t-large-v2 full size, 4 stages, batch 8,
cache 4096), with ``--runtime table``
:func:`~repro_torch.launch.train.train_table` (default flags: the table
phase's first run in ``chip_smoke.py``: paper-gpt3-large full size,
``--devices 4 --stages 4``, 8 microbatches of 1 x 2048 tokens,
``--schedule 1f1b``; every rank is a thread of this process; with
``--depth N`` the config cut to N layers, e.g. ``--depth 4 --arch
deepseek-moe-16b --full-size --devices 8 --stages 4 --microbatches 4
--mb-rows 1 --seq 2048 --schedule 1f1b`` for the MoE ``ep`` layout over
two data ranks, whose exchanges' copies show as ``cat / stack`` and
whose collectives' calls and host seconds are printed), and traces
the third step with CUDA activity, recording every thread's operators
and ranges (``profile_all_threads``: the stage threads' too).  Prints
the step's wall time, the device's busy time (union of kernel
intervals; every stage shares the default stream) and its idle share of
the step's host span (as the benchmark measures idle), that idle summed
by the innermost program span (``rrfp.*``, ``obs/spans.py``) on any
thread, the time per kernel category, the heaviest kernels and the host
operators' self time on every thread, and writes the same as JSON to
``--out``.  Needs a GPU; the profiler's own host overhead
lengthens the traced step, so the breakdown is of device time and the
untraced step times are the wall-time record.
"""
from __future__ import annotations

import argparse
import bisect
import json
import math
import sys
from pathlib import Path

import torch

from repro_torch.configs import registry
from repro_torch.launch import serve, train

DEFAULT_ARGS = ["--arch", "paper-gpt3-large", "--full-size", "--stages", "4",
                "--microbatches", "8", "--mb-rows", "1", "--seq", "2048",
                "--hint", "bf"]
DEFAULT_MM_ARGS = ["--arch", "qwen2-vl-2b", "--full-size", "--stages", "4",
                   "--microbatches", "8", "--mb-rows", "1", "--seq", "2048",
                   "--hint", "bf"]
DEFAULT_TABLE_ARGS = ["--arch", "paper-gpt3-large", "--full-size",
                      "--devices", "4", "--stages", "4", "--microbatches",
                      "8", "--mb-rows", "1", "--seq", "2048", "--schedule",
                      "1f1b"]
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
    # the MoE dispatch's cumsum (a scan) and top-k; the deterministic
    # index_put_ sorts its indices
    ("sort / top-k / scan", ("sort", "topk", "Sort", "scan", "radix")),
    ("indexing", ("index", "scatter", "gather", "embedding")),
    # torch.cat / torch.stack: the mesh's all_to_all and stacked
    # all_gather copies (the MoE exchanges), ZeRO-1's leaf flattening
    ("cat / stack (mesh exchanges)", ("CatArrayBatchedCopy",)),
    ("copies / casts / fills", ("copy", "Memcpy", "Memset", "fill",
                                "cat")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


#: the program's spans (``obs/spans.py``): the trainer's phases and the
#: stage threads' tasks
PROGRAM_SPANS = "rrfp."
#: idle under no program span
NO_SPAN = "(no program span)"


def category(name: str) -> str:
    for cat, keys in CATEGORIES:
        if any(k in name for k in keys):
            return cat
    return "other"


def _merged(intervals) -> list[list[float]]:
    """The union of (start, end) intervals as sorted disjoint segments."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_by_span(gaps, spans) -> dict[str, float]:
    """Each idle gap's time (``gaps``: sorted disjoint ``[a, b]``) summed
    by the innermost program span (``spans``: ``(name, a, b)`` of any
    thread, the latest-started one open) over each part of the gap."""
    xs = sorted({x for _, a, b in spans for x in (a, b)})
    # the innermost span open over each segment between two boundaries
    names = [NO_SPAN]
    for x0, x1 in zip(xs, xs[1:]):
        m = (x0 + x1) / 2
        open_ = [(a, n) for n, a, b in spans if a <= m < b]
        names.append(max(open_)[1] if open_ else NO_SPAN)
    names.append(NO_SPAN)
    bounds = [-math.inf, *xs, math.inf]
    out: dict[str, float] = {}
    for a, b in gaps:
        x = a
        while x < b:
            i = bisect.bisect_right(bounds, x) - 1
            y = min(b, bounds[i + 1])
            out[names[i]] = out.get(names[i], 0.0) + (y - x)
            x = y
    return out


def breakdown(events, wall_s: float) -> dict:
    """The traced step's device time by kernel and category, its idle
    share of the step's host span (the ``ProfilerStep`` range, as the
    benchmark measures idle) with the idle gaps summed by the innermost
    program span (``rrfp.*``) on any thread, and the host operators' self
    time."""
    cuda = torch.autograd.DeviceType.CUDA
    # device-side events minus the profiler's step annotation and the
    # device-side copies of user annotations (record_function ranges)
    kernels = [e for e in events
               if e.device_type == cuda
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("ProfilerStep")]
    host = [e for e in events if e.device_type != cuda]
    marks = [(e.time_range.start, e.time_range.end) for e in host
             if e.name.startswith("ProfilerStep")]
    segs = _merged((e.time_range.start, e.time_range.end) for e in kernels)
    lo = min([a for a, _ in marks] + [s[0] for s in segs[:1]], default=0.0)
    hi = max([b for _, b in marks] + [s[1] for s in segs[-1:]],
             default=0.0)
    busy_us = sum(b - a for a, b in segs)
    edges = [lo] + [x for s in segs for x in s] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    program = [(e.name, e.time_range.start, e.time_range.end) for e in host
               if e.name.startswith(PROGRAM_SPANS)]
    by_cat: dict[str, float] = {}
    by_name: dict[str, list] = {}
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        by_cat[category(e.name)] = by_cat.get(category(e.name), 0.0) + dur
        rec = by_name.setdefault(e.name, [0.0, 0])
        rec[0] += dur
        rec[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    out = {
        "step_wall_s": wall_s,
        "step_span_s": (hi - lo) / 1e6,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / (hi - lo) if hi > lo else None,
        "kernels": len(kernels),
        "idle_by_span_s": {n: t / 1e6 for n, t in sorted(
            idle_by_span(gaps, program).items(), key=lambda kv: -kv[1])},
        "by_category_s": dict(sorted(((k, v / 1e6) for k, v in by_cat.items()),
                                     key=lambda kv: -kv[1])),
        "top_kernels": [{"name": n[:120], "total_s": t / 1e6, "calls": c,
                         "mean_us": t / c} for n, (t, c) in top],
    }
    self_us: dict[str, float] = {}
    for e in host:
        if not e.name.startswith(("ProfilerStep", PROGRAM_SPANS)):
            self_us[e.name] = (self_us.get(e.name, 0.0)
                               + e.self_cpu_time_total)
    out["top_host_ops_self_s"] = {n: t / 1e6 for n, t in sorted(
        self_us.items(), key=lambda kv: -kv[1])[:12]}
    return out


def all_threads_config():
    """The profiler's setting that records every thread's operators and
    ranges (the stage threads' too)."""
    return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--out", default=None)
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--workload", default="language",
                    choices=("language", "multimodal"))
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--runtime", default="actor", choices=("actor", "table"))
    own, rest = ap.parse_known_args(argv)
    if own.depth is not None and (own.serve or own.workload != "language"):
        raise SystemExit("--depth cuts a language training config")
    if own.runtime == "table" and (own.serve or own.workload != "language"):
        raise SystemExit("--runtime table trains the language workload")
    kw = {}
    if own.serve:
        args = serve.parser().parse_args((rest or DEFAULT_SERVE_ARGS)
                                         + ["--tokens", "3"])
        run_fn = serve.serve
    elif own.workload == "multimodal":
        args = train.parser().parse_args(
            (rest or DEFAULT_MM_ARGS)
            + ["--workload", "multimodal", "--steps", "3"])
        run_fn = train.train_multimodal
    elif own.runtime == "table":
        args = train.parser().parse_args(
            ["--runtime", "table"] + (rest or DEFAULT_TABLE_ARGS)
            + ["--steps", "3"])
        run_fn = train.train_table
        if own.depth is not None:
            kw["cfg"] = registry.cut_depth(args.arch, own.depth)
    else:
        args = train.parser().parse_args((rest or DEFAULT_ARGS)
                                         + ["--steps", "3"])
        run_fn = train.train_actor
        if own.depth is not None:
            kw["cfg"] = registry.cut_depth(args.arch, own.depth)
    train.resolve_device(args.device)
    captured = {}

    def ready(prof):
        captured["events"] = prof.events()

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(skip_first=1, wait=0, warmup=1,
                                             active=1, repeat=1),
            on_trace_ready=ready,
            experimental_config=all_threads_config()) as prof:
        run = run_fn(args, step_hook=lambda *_: prof.step(), **kw)
    out = breakdown(captured["events"], run.step_seconds[2])
    if not out["kernels"]:
        raise RuntimeError("no device kernel was traced: the breakdown is "
                           "of device time and needs a GPU run")
    out["step_seconds"] = run.step_seconds
    out["runtime"] = own.runtime
    if own.runtime == "table":
        out["collectives"] = {k: {"calls": n, "host_s": sec} for k, (n, sec)
                              in run.collectives[2].items()}
    out["card"] = torch.cuda.get_device_name(0)
    print(f"traced step: wall {out['step_wall_s']:.3f} s, host span "
          f"{out['step_span_s']:.3f} s, device busy "
          f"{out['device_busy_s']:.3f} s (idle "
          f"{out['device_idle_share']:.1%} of the host span), "
          f"{out['kernels']} kernels")
    for n, t in out["idle_by_span_s"].items():
        print(f"  idle {t:8.4f} s  {n}")
    for cat, s in out["by_category_s"].items():
        print(f"  {cat:28s} {s:8.4f} s  {s / out['device_busy_s']:6.1%}")
    for k in out["top_kernels"]:
        print(f"  {k['total_s']:8.4f} s  {k['calls']:6d} x {k['mean_us']:9.1f}"
              f" us  {k['name']}")
    for n, t in out["top_host_ops_self_s"].items():
        print(f"  host {t:8.4f} s  {n}")
    for k, c in out.get("collectives", {}).items():
        print(f"  mesh {k:12s} {c['calls']:6d} calls  {c['host_s']:8.3f} s "
              f"host inside them (summed over the ranks)")
    if own.out:
        Path(own.out).parent.mkdir(parents=True, exist_ok=True)
        Path(own.out).write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
