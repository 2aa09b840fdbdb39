"""Actor-runtime quickstart: dispatch by arrival, not by table tick (port
of ``examples/async_runtime.py``).

Part 1, simulated transport: the same 8-stage/32-microbatch pipeline run
through the actor runtime in both consumption modes on identical sampled
latencies (CRN keying), across the paper's jitter levels.

Part 2, thread transport: a tiny real model, forward and backward for a
few steps, with thread-per-stage actors driving the port's stage
callables (``pipeline.stagefn.ActorStageProgram``).

    PYTHONPATH=src python -m repro_torch.examples.async_runtime [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import registry
from repro_torch.core import (
    INJECTION_LEVELS,
    CostModel,
    PipelineSpec,
    multimodal_stage_flops,
)
from repro_torch.data.synthetic import synth_batch
from repro_torch.launch.train import _device_batch, resolve_device
from repro_torch.models.build import build
from repro_torch.pipeline.stagefn import (
    ActorStageProgram,
    StageFnOptions,
    StageFns,
)
from repro_torch.runtime.rrfp import (
    ActorConfig,
    ActorDriver,
    average_makespan_actor,
)


def simulated(iters: int = 3) -> dict:
    """Mean makespans over ``iters`` seeds, pre-committed 1F1B and the
    hint mode, at each of ``INJECTION_LEVELS``; printed as the reference
    prints them.  Returns ``{level: (1f1b s, rrfp s)}``."""
    print("=== simulated transport: hint vs precommitted under jitter ===")
    S, M = 8, 32
    spec = PipelineSpec(S, M)
    base = CostModel.from_stage_flops(
        multimodal_stage_flops(4e12, 2e12, S), comm_base=2e-3)
    print(f"{'level':>6} {'1F1B (s)':>10} {'RRFP (s)':>10} {'speedup':>8}")
    out = {}
    for level, inj in INJECTION_LEVELS.items():
        costs = dataclasses.replace(base, injection=inj)
        pre, _, _ = average_makespan_actor(
            spec, costs, ActorConfig(mode="precommitted", fixed_order="1f1b"),
            iters)
        hint, _, _ = average_makespan_actor(
            spec, costs, ActorConfig(mode="hint"), iters)
        print(f"{level:>6} {pre:>10.3f} {hint:>10.3f} {pre / hint:>7.2f}x")
        out[level] = (pre, hint)
    return out


def threaded(device, steps: int = 3) -> list[float]:
    """Reduced deepseek-7b (4 layers) on 2 stages, 4 microbatches of 2 x 16
    tokens: ``steps`` steps of forward and backward through
    ``ActorDriver.run_threaded`` (no update, as in the reference).
    Returns each step's loss."""
    print("\n=== thread transport: real stage callables ===")
    S2, M2, mb_rows, seq = 2, 4, 2, 16
    cfg = registry.reduced_config("deepseek-7b", num_layers=4)
    model = build(cfg, num_stages=S2)
    # the seeded init: each stage and the io from their own torch.Generator
    sp = [model.init_stage_params(s, seed=0, device=device)
          for s in range(S2)]
    io = model.init_io_params(seed=0, device=device)
    tokens = M2 * mb_rows * seq
    fns = StageFns(model, StageFnOptions(
        mb_rows=mb_rows, seq_len=seq, loss_scale=1.0 / tokens))
    spec2 = PipelineSpec(S2, M2)
    losses = []
    for step in range(steps):
        batch = _device_batch(synth_batch(cfg, M2 * mb_rows, seq, step=step),
                              device)
        programs = [ActorStageProgram(fns, s, sp[s], io, batch)
                    for s in range(S2)]
        res = ActorDriver(spec2, None, ActorConfig(mode="hint")).run_threaded(
            list(programs))
        losses.append(sum(p.loss_sum for p in programs) / tokens)
        print(f"step {step}: loss {losses[-1]:.4f}  wall makespan "
              f"{res.makespan * 1e3:.1f} ms  tasks {len(res.end)}")
    print("\nSame runtime, two transports: simulation for schedule studies, "
          "threads for real execution.")
    return losses


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs CUDA")
    ap.add_argument("--iters", type=int, default=3,
                    help="seeds a simulated makespan is averaged over")
    ap.add_argument("--steps", type=int, default=3)
    return ap


def main(argv=None) -> dict:
    """Runs both parts; returns ``simulated`` ({level: (1f1b, rrfp)}) and
    the threaded ``losses``."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    return {"simulated": simulated(args.iters),
            "losses": threaded(device, args.steps)}


if __name__ == "__main__":
    main()
