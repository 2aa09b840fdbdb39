"""Quickstart: the RRFP runtime in a minute (port of ``examples/quickstart.py``).

1. Simulate a jittery, imbalanced 8-stage pipeline with the faithful engine:
   pre-committed 1F1B vs readiness-first RRFP (the paper's contrast).
2. Train a tiny model with the schedule-table executor under the RRFP table
   (``launch.train.build_trainer``, ZeRO-1 AdamW) on a 2 x 4 mesh of rank
   threads on one device, where the reference forced 8 host devices.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The flags after ``--device`` cut the model part down (the reference's
sizes are the defaults); its losses are those of ``python -m
repro_torch.launch.train --runtime table --schedule rrfp --arch
deepseek-7b --devices 8 --stages 4`` with the same ``--layers``,
``--microbatches``, ``--seq`` and ``--steps``.
"""
from __future__ import annotations

import argparse

from repro_torch.core import (
    CostModel,
    EngineConfig,
    HintKind,
    PipelineSpec,
    multimodal_stage_flops,
    run_iteration,
)
from repro_torch.data.synthetic import synth_batch
from repro_torch.launch.train import _device_batch, build_trainer, resolve_device


def engine_contrast() -> dict:
    """One engine iteration of an 8-stage, 32-microbatch pipeline with
    multimodal stage imbalance and jitter, pre-committed 1F1B against
    RRFP's BF hint; prints and returns both results."""
    S, M = 8, 32
    spec = PipelineSpec(S, M)
    costs = CostModel.from_stage_flops(
        multimodal_stage_flops(5e12, 2e12, S), comm_base=2e-3, seed=0)
    r_fixed = run_iteration(spec, costs, EngineConfig(mode="precommitted",
                                                      fixed_order="1f1b"))
    r_rrfp = run_iteration(spec, costs, EngineConfig(mode="hint",
                                                     hint=HintKind.BF))
    print("== engine: one iteration under jitter + stage imbalance ==")
    print(f"pre-committed 1F1B: {r_fixed.makespan:.3f}s  "
          f"(blocking {r_fixed.breakdown()['blocking']:.3f}s)")
    print(f"RRFP (BF hint):     {r_rrfp.makespan:.3f}s  "
          f"(blocking {r_rrfp.breakdown()['blocking']:.3f}s)  "
          f"speedup {r_fixed.makespan / r_rrfp.makespan:.2f}x")
    return {"fixed": r_fixed, "rrfp": r_rrfp}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs CUDA")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--steps", type=int, default=5)
    return ap


def main(argv=None) -> dict:
    """Runs both parts; returns the engine's two results (``fixed``,
    ``rrfp``), the trainer's ``losses`` and its table's ``bubble``
    fraction."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    out = engine_contrast()

    print("\n== schedule-table executor: train a tiny LM with the RRFP "
          "table ==")
    t = build_trainer("deepseek-7b", data=2, stages=4, layers=args.layers,
                      mb_rows=1, microbatches=args.microbatches,
                      seq=args.seq, schedule="rrfp", device=device)
    losses = []
    for step in range(args.steps):
        batch = synth_batch(t["cfg"], t["batch_size"], t["seq"], step=step)
        m = t["train_step"](_device_batch(batch, device), step)
        losses.append(float(m["loss"]))
        print(f"step {step}  loss {losses[-1]:.4f}")
    bubble = t["table"].bubble_fraction()
    print("table bubble fraction:", round(bubble, 3))
    return {**out, "losses": losses, "bubble": bubble}


if __name__ == "__main__":
    main()
