"""One run of one cell of the port's benchmark.

    python3 rrfp_bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Runs from the root of a checkout on a machine with the cards the cell asks
for.  Prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``, each number compared for
``correct`` beside its limit; the same numbers are the last lines of
standard error.  Exits non-zero, printing no result, without enough CUDA
cards, or if JAX or the JAX package is loaded once the run is over.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: the kernel caches live at fixed paths inside the checkout, so that only
#: a checkout's first run compiles (the port's nvcc output goes to
#: ``build/repro_torch`` by itself)
CACHE = ROOT / "rrfp_bench" / ".cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    from rrfp_bench.harness import cell as cell_run
    from rrfp_bench.harness import manifest

    try:
        cell = manifest.cell(ROOT, args.workload)
    except KeyError as e:
        print(e, file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, lines = cell_run.run_cell(
        cell, seed=args.seed, seconds=args.seconds,
        trace_on=bool(args.trace), device="cuda", t_start=T_START)
    loaded = cell_run.forbidden_modules()
    if loaded:
        print(f"loaded in this process: {loaded}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
