"""The readings the limits of ``correct`` are set from, at a cell's own size.

    python3 rrfp_bench/calibrate.py --workload <name> --seeds 11,12,... \
        [--control-seeds 3] [--out calib.json]

For each seed: the program's compared steps (set-up alone, no window) and
the reference's, and the gaps between them (the lower readings).  For the
first ``--control-seeds`` seeds also: the control, the reference in the
next precision below the configuration's (float8 matrix products below
bfloat16: ``reference/precision.py``), and the fault of half the batch left
out (its second half of rows a copy of the first, the mean over the rest),
each against the float32 reference.  A step that leaves the state unchanged
reads a ``change_gap`` of 1 and needs no run.  Needs the cell's CUDA card;
the benchmark's own runs never run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "rrfp_bench" / ".cache"
                                         / "triton")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from rrfp_bench.harness import checks, manifest, program
    from rrfp_bench.reference import train as reference
    from rrfp_bench.reference.precision import CONTROL

    cell = manifest.cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    c, t = cell.config, cell.traffic
    seeds = [int(s) for s in args.seeds.split(",")]
    out = {"workload": args.workload, "card": torch.cuda.get_device_name(0),
           "seeds": {}}

    def ref(seed, **kw):
        t0 = time.perf_counter()
        r = reference.train(c, t, seed=seed, device=dev, lr=c["train"]["lr"],
                            total_steps=program.STEPS_BOUND,
                            steps=program.SETUP_STEPS, **kw)
        return r, time.perf_counter() - t0

    for i, seed in enumerate(seeds):
        row = {}
        base, row["reference_s"] = ref(seed)
        t0 = time.perf_counter()
        ran = program.run(c, t, seed=seed, seconds=0.0, trace=False,
                          device="cuda", t_start=T_START, window=False)
        row["program_s"] = time.perf_counter() - t0
        row["program"] = checks.readings_gaps(ran.readings, base)
        row["program_worst"] = checks.worst_slices(ran.readings, base)
        row["losses"] = [ran.readings.losses, base.losses]
        del ran
        if i < args.control_seeds:
            ctl, row["control_s"] = ref(seed, precision=CONTROL[c["dtype"]])
            row["control"] = checks.readings_gaps(ctl, base)
            row["control_worst"] = checks.worst_slices(ctl, base)
            half, _ = ref(seed, fault="half_batch")
            row["half_batch"] = checks.readings_gaps(half, base)
            row["half_batch_worst"] = checks.worst_slices(half, base)
            del ctl, half
        out["seeds"][seed] = row
        print(json.dumps({"seed": seed, **row}), flush=True)
        del base
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
