"""One run of one cell: the program's set-up and window, its metrics, then
the reference and the comparison that decides ``correct``."""
from __future__ import annotations

import gc
import subprocess
import sys
import time

import torch

from rrfp_bench.harness import checks, manifest, program, trace
from rrfp_bench.reference import train as reference


def _power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def _metrics(specs: list[dict], ctx: dict) -> dict:
    out = {}
    for m in specs:
        value = manifest.reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell: manifest.Cell, *, seed: int, seconds: float,
             trace_on: bool, device: str, t_start: float,
             cfg=None) -> tuple[dict, list[str]]:
    """The result object of one run, and the lines that name each number
    compared beside its limit."""
    c, t = cell.config, cell.traffic
    rows = t["microbatches"] * t["mb_rows"]
    ran = program.run(c, t, seed=seed, seconds=seconds, trace=trace_on,
                      device=device, t_start=t_start, cfg=cfg)
    dev = torch.device(device)
    notes = []
    ctx = {"config": c, "traffic": t, "tokens_per_step": rows * t["seq"],
           "flops_per_step": manifest.family(c).model_flops(c, rows,
                                                            t["seq"])}
    if trace_on:
        tr = ran.trace
        if tr is None:
            raise RuntimeError("the traced steps were never read")
        ctx.update(kernels=tr["kernels"], steps=tr["steps"],
                   window_s=tr["window_s"],
                   busy_s=trace.busy_seconds(tr["kernels"]),
                   categories=trace.categories(tr["kernels"]))
        metrics = _metrics(cell.per_layer, ctx)
        attempted = tr["steps"]
        notes.append(f"trace: {tr['steps']} steps, {len(tr['kernels'])} "
                     f"device events, read in {tr['read_s']:.1f} s")
    else:
        ctx.update(window_steps=ran.window_steps, window_s=ran.window_s,
                   peak_bytes=ran.peak_bytes, setup_s=ran.setup_s)
        metrics = _metrics(cell.end_to_end, ctx)
        attempted = len(ran.window_steps)
        notes.append("window steps (s): " + " ".join(
            f"{s:.4f}" for s in ran.window_steps))
    t0 = time.perf_counter()
    ref = reference.train(c, t, seed=seed, device=dev,
                          lr=c["train"]["lr"],
                          total_steps=program.STEPS_BOUND,
                          steps=program.SETUP_STEPS)
    notes.append(f"reference: {program.SETUP_STEPS} steps in "
                 f"{time.perf_counter() - t0:.1f} s")
    correct, numbers = checks.compare(ran.readings, ref, cell.limits)
    correct = correct and attempted > 0
    notes.append(f"losses program {ran.readings.losses} reference "
                 f"{ref.losses}")
    if ran.readings.grad_norms:
        notes.append("worst slices (slice, gap, program, reference): "
                     + repr(checks.worst_slices(ran.readings, ref)))
    cuda = dev.type == "cuda"
    device_info = {
        "platform": "gpu" if cuda else dev.type,
        "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
        "count": cell.chips, "memory_peak_bytes": ran.peak_bytes}
    if cuda:
        device_info["power_limit"] = _power_limit()
    result = {"correct": correct, "attempted": attempted,
              "failed": 0 if correct else attempted, "metrics": metrics,
              "device": device_info}
    if trace_on:
        device_info.update(busy_s=ctx["busy_s"], window_s=ctx["window_s"])
        result["breakdown"] = trace.breakdown(ran.trace)
    result["checks"] = numbers
    del ran, ref
    gc.collect()
    lines = notes + [f"check {k} {v['value']!r} limit {v['limit']!r}"
                     for k, v in numbers.items()]
    return result, lines


def forbidden_modules() -> list[str]:
    """JAX, flax and the JAX package, by whole top-level module name."""
    banned = {"jax", "jaxlib", "flax", "repro"}
    return sorted({k.split(".")[0] for k in sys.modules} & banned)
