#!/usr/bin/env python3
"""Where a mesh of processes spends its first step, on the GPU.

    python3 tools/procs_warmup.py

Spawns two 1 x 4 worlds (``launch/procs.spawn_world``, gloo) of
paper-gpt3-large at full width (``chip_smoke.py``'s ``TABLE_ARGS``: 4
stages, 8 microbatches of 1 x 2048 tokens, 1f1b) and runs three steps in
each: the first world straight from ``build_trainer``, the second after
``launch.train._warm_up`` (each rank one forward and one backward of its
stage, all processes at once), which ``--procs`` runs.  Prints, per rank,
the warm-up's seconds, each step's seconds and the host seconds inside
``ppermute``: a cold start costs each process its own first calls, and in
step 0 of the pipeline the stages pay them one after another.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

STEPS = 3


def world(mesh, argv, warm: bool) -> dict:
    """One process: build its rank, warm it up or not, run STEPS steps."""
    import torch

    from repro_torch.data.synthetic import synth_batch
    from repro_torch.launch import train

    args = train.parser().parse_args(argv)
    t = train.build_trainer(
        args.arch, data=args.devices // args.stages, stages=args.stages,
        layers=args.layers, mb_rows=args.mb_rows,
        microbatches=args.microbatches, seq=args.seq,
        schedule=args.schedule, reduced=False, lr=args.lr,
        total_steps=STEPS, mesh=mesh)

    def arrays(step):
        return synth_batch(t["cfg"], t["batch_size"], t["seq"], seed=0,
                           step=step)

    out = {"rank": mesh.rank, "warm_up_s": None, "steps": []}
    if warm:
        t0 = time.perf_counter()
        train._warm_up(t, arrays(0))
        torch.cuda.synchronize()
        out["warm_up_s"] = time.perf_counter() - t0
    for step in range(STEPS):
        batch = train._device_batch(arrays(step), mesh.device)
        mesh.sync()
        mesh.reset_counts()
        t0 = time.perf_counter()
        float(t["train_step"](batch, step)["loss"])
        out["steps"].append((time.perf_counter() - t0,
                             mesh.seconds.get("ppermute", 0.0)))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("procs_warmup: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.launch.procs import spawn_world

    print(f"card: {chip_smoke.card()}")
    _build.build_all(["flash_attention"])
    argv = chip_smoke.TABLE_ARGS + ["--devices", "4", "--microbatches", "8",
                                    "--schedule", "1f1b"]
    for warm in (False, True):
        t0 = time.perf_counter()
        res = spawn_world(world, (argv, warm), 4,
                          shape={"data": 1, "model": 4}, device="cuda",
                          deadline=600.0)
        print(f"world {'after the warm-up' if warm else 'cold'}: "
              f"{time.perf_counter() - t0:.1f} s with the spawn")
        for r in res:
            print(f"  rank {r['rank']}: warm-up "
                  + ("-" if r["warm_up_s"] is None else
                     f"{r['warm_up_s']:.3f} s")
                  + "; steps (s, ppermute host s): "
                  + ", ".join(f"({s:.3f}, {p:.3f})" for s, p in r["steps"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
