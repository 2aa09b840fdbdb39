"""Batched serving demo (port of ``examples/serve_batch.py``): pipelined
one-token decode steps with stage-local KV caches on a 2 x 4 serve mesh.

    PYTHONPATH=src python -m repro_torch.examples.serve_batch [--device cpu]

``launch.serve.build_server`` makes reduced deepseek-7b on a mesh of two
data ranks and four stages (rank threads on one device, where the
reference forced 8 host devices) and its ``serve_step`` decodes greedily
from seeded prompt tokens; the tokens are those of ``python -m
repro_torch.launch.serve --arch deepseek-7b --devices 8 --stages 4`` with
the same ``--layers``, ``--batch``, ``--tokens`` and ``--cache-len``
(the reference's sizes are the defaults).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.launch.serve import build_server
from repro_torch.launch.train import resolve_device


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs CUDA")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--cache-len", type=int, default=64)
    return ap


def main(argv=None) -> list[list[int]]:
    """Decodes ``--tokens`` tokens; returns the rows ``[batch][tokens +
    1]``, the prompt token first."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    s = build_server("deepseek-7b", data=2, stages=4, layers=args.layers,
                     batch=args.batch, cache_len=args.cache_len,
                     device=device)
    cfg = s["cfg"]
    tokens = torch.randint(0, cfg.vocab_size, (args.batch,),
                           generator=torch.Generator().manual_seed(7))
    seqs = [tokens.tolist()]
    tokens = tokens.to(device)
    t0 = time.time()
    for pos in range(args.tokens):
        tokens = s["serve_step"](s["sp"], s["io"], s["caches"],
                                 {"tokens": tokens}, pos)
        seqs.append(tokens.tolist())
    dt = time.time() - t0
    rows = [list(row) for row in zip(*seqs)]
    print(f"decoded {args.tokens} tokens x batch {args.batch} in {dt:.2f}s "
          f"({args.batch * args.tokens / dt:.1f} tok/s on {device})")
    print("sample rows:")
    for row in rows[:3]:
        print("  ", row)
    return rows


if __name__ == "__main__":
    main()
