#!/usr/bin/env python3
"""Time variants of K4's tensor-core kernel (``csrc/ssd_scan.cu``) on the GPU.

    python3 tools/k4_variants.py            # the plan's alternatives
    python3 tools/k4_variants.py --phases   # cycles per chunk and phase

Each variant is a copy of the source with one or more text substitutions
(a tile constant, or a phase switched off), built with ``nvcc`` into
``build/k4_variants/`` (all at once, one process each) and timed at the
zamba2 shape ``[1, 2048, 64, 64]`` ds 64 chunk 64 bf16 through the port's
wrapper, as ``chip_smoke.py`` times the kernel (CUDA-graph replay over more
inputs than L2 holds), in two rounds of turns.  Variants that keep the
function print their max |y - plain|; those that switch a phase off
compute something else and say so: they show what the phase costs.

``--phases`` builds one copy whose blocks (0, 0, 0) write ``clock64()``
deltas between the kernel's phase boundaries to a device array, and prints
the cycles per chunk of each phase for every warp (the producer warps last).
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "ssd_scan.cu"
OUT = ROOT / "build" / "k4_variants"
SHAPE = (1, 2048, 64, 64, 64, 64)  # b, s, nh, hd, ds, chunk (zamba2)

WARPS = "constexpr int WARPS = 8;"
PRODUCERS = "constexpr int PRODUCERS = 4;"
SLICE = "constexpr int HD_SLICE = 32;"
STAGES = "constexpr int STAGES = 2;"
#: name -> (substitutions, keeps the function)
VARIANTS = {
    "as built": ([], True),
    "4 compute warps": ([(WARPS, "constexpr int WARPS = 4;")], True),
    "16 compute warps": ([(WARPS, "constexpr int WARPS = 16;")], True),
    "1 producer warp": ([(PRODUCERS, "constexpr int PRODUCERS = 1;")], True),
    "2 producer warps": ([(PRODUCERS, "constexpr int PRODUCERS = 2;")],
                         True),
    "8 producer warps": ([(PRODUCERS, "constexpr int PRODUCERS = 8;")],
                         True),
    "hd slice 16": ([(SLICE, "constexpr int HD_SLICE = 16;")], True),
    "hd slice 64": ([(SLICE, "constexpr int HD_SLICE = 64;")], True),
    "3-stage ring": ([(STAGES, "constexpr int STAGES = 3;")], True),
    "no w phase": ([("if (k % WARPS != warp) continue;", "continue;")],
                   False),
    "no y phase": ([("for (int rnd = 0; rnd * WARPS < ny; ++rnd) {",
                     "for (int rnd = 0; rnd < 0; ++rnd) {")], False),
    "no state update": ([("mma_bf16(sacc[r][0], ahi",
                          "if (false) mma_bf16(sacc[r][0], ahi")], False),
}
#: (phase boundary in the source, phase that ends there)
PHASES = [
    ("    if (producer) cp_async_wait<STAGES - 2>();", "state"),
    ("    if (producer) {\n      const int k = c + STAGES - 1", "barrier"),
    ("    const bf16* tX = sX + stg * q * LX;", "copies"),
    ("      // w = (C B^T) exp(cum_i - cum_j) dt_j, as bf16", "cum"),
    ("    __syncthreads();  // the w tile is complete", "w"),
    ("      const bf16* rSh = sSh + sb * PP * LN;", "barrier w"),
    ("      const float total = expf(cum_last);", "y"),
]


def substituted(subs) -> str:
    src = SOURCE.read_text()
    for old, new in subs:
        if src.count(old) != 1:
            raise SystemExit(f"variant anchor not found once: {old!r}")
        src = src.replace(old, new)
    return src


def with_clocks() -> str:
    head, tc = substituted([]).split("namespace tc {\n", 1)
    head += "__device__ long long k4_cycles[32][8];\n"
    probe = ("if (lane == 0 && blockIdx.x == 0 && blockIdx.y == 0 && "
             "blockIdx.z == 0) {{ const long long now = clock64(); "
             "k4_cycles[warp][{}] += now - k4_t; k4_t = now; }}\n")
    start = "  const bool producer = warp >= WARPS;"
    if tc.count(start) != 1:
        raise SystemExit(f"anchor not found once: {start!r}")
    tc = tc.replace(start, "long long k4_t = clock64();\n" + start, 1)
    for i, (anchor, _) in enumerate(PHASES):
        if tc.count(anchor) != 1:
            raise SystemExit(f"phase anchor not found once: {anchor!r}")
        tc = tc.replace(anchor, probe.format(i) + anchor, 1)
    src = head + "namespace tc {\n" + tc
    return src.replace(
        'extern "C" {',
        'extern "C" {\nint k4_cycles_read(long long* out) { return '
        'cudaMemcpyFromSymbol(out, k4_cycles, sizeof(k4_cycles)); }\n', 1)


def build(sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, src) in enumerate(sources.items()):
        cu = OUT / f"v{i}.cu"
        cu.write_text(src)
        procs[name] = (OUT / f"v{i}.so", subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / f"v{i}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{out}")
        lib = ctypes.CDLL(str(so))
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        libs[name] = lib
    return libs


def use(lib, source: str) -> None:
    """Route the wrapper to ``lib``, with the hd slice its source states."""
    import re

    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as ssd

    _build._LIBS["ssd_scan"] = lib
    ssd.TC_HD_SLICE = int(re.search(r"int HD_SLICE = (\d+);", source)[1])


def main(argv=None) -> int:
    args = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    args.add_argument("--phases", action="store_true")
    args = args.parse_args(argv)
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ssd_scan as ssd

    if not torch.cuda.is_available():
        print("k4_variants: no CUDA device", file=sys.stderr)
        return 2
    print(f"card: {cs.card()}")
    chunk = SHAPE[5]
    if args.phases:
        src = with_clocks()
        lib = build({"clocks": src})["clocks"]
        use(lib, src)
        x = cs.ssd_inputs(SHAPE, torch.bfloat16, torch.bfloat16, seed=0)
        for _ in range(3):
            ssd.ssd_scan(*x, chunk=chunk)
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * 256)()
        lib.k4_cycles_read(buf)
        per = 3 * SHAPE[1] // chunk  # chunks walked in the three calls
        warps = ssd.TC_WARPS + ssd.TC_PRODUCERS
        names = [n for _, n in PHASES]
        print("cycles per chunk, block (0, 0, 0); rows: warps, the producers "
              "last; columns: the phase that ends at each boundary")
        print("warp " + "".join(f"{n:>11s}" for n in names))
        for w in range(warps):
            row = [buf[w * 8 + i] / per for i in range(len(names))]
            print(f"{w:4d} " + "".join(f"{v:11.0f}" for v in row))
        return 0

    sources = {n: substituted(subs) for n, (subs, _) in VARIANTS.items()}
    libs = build(sources)
    b, s, nh, hd, ds, _ = SHAPE
    per_set = b * s * (nh * hd + 2 * ds) * 2 + b * s * nh * 4
    sets = [cs.ssd_inputs(SHAPE, torch.bfloat16, torch.bfloat16, seed=i)
            for i in range(50 * 2**20 // per_set + 2)]
    x, dt, A, B, C, D = sets[0]
    want = ssd.ssd_chunked_plain(x.float(), dt, A, B.float(), C.float(), D,
                                 chunk)
    times = {n: [] for n in VARIANTS}
    errs = {}
    for _ in range(2):
        for name in VARIANTS:
            use(libs[name], sources[name])
            y = ssd.ssd_scan(*sets[0], chunk=chunk)
            torch.cuda.synchronize()
            errs[name] = float((y.float() - want).abs().max())
            times[name].append(cs.time_ms(
                lambda *a: ssd.ssd_scan(*a, chunk=chunk), sets))
    for name, (_, same) in VARIANTS.items():
        what = (f"max |y - plain| {errs[name]:.3g}" if same
                else "computes something else")
        print(f"{name:18s} " + "  ".join(f"{t:.4f}" for t in times[name])
              + f" ms  ({what})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
