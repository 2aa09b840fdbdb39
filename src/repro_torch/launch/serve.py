"""Batched serving driver of the port: pipelined decode with stage-local caches.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch seamless-m4t-large-v2 --full-size --stages 4 --batch 8 \
        --tokens 32 --cache-len 4096
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch deepseek-7b --devices 4 --stages 2 --batch 4 --tokens 4

Port of ``repro.launch.serve``: ``build_server`` makes the model, its
seeded weights and zeroed caches (``enc_len = max(1, cache_len // 4)``;
like the reference, nothing fills the encoder's ``xk``/``xv``: there is no
encoder prefill), and ``main`` decodes greedily from seeded tokens.  With
``--devices`` a multiple of ``--stages`` above it, the batch is sharded
over ``devices // stages`` data ranks of an in-process ``(data x model)``
mesh (``pipeline/decode.make_serve_fn``; each rank its own weights, io and
cache shard, the MoE layouts' experts sharded); with ``--devices`` equal
to ``--stages`` (the default; the reference's is 8) one thread runs the
staircase (``make_staircase_fn``).  Each step's wall time ends in the copy
of its tokens to the host, so it is device-honest; the first step
(allocator growth, cuBLAS and Triton warm-up, kernel builds) is reported
apart from the rest.

Runs on the GPU unless ``--device cpu`` is given; without CUDA it raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import registry
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import rank_params, resolve_device
from repro_torch.models.build import build
from repro_torch.pipeline.decode import (
    DecodeOptions,
    make_serve_fn,
    make_staircase_fn,
)
from repro_torch.pipeline.executor import shard_batch


@dataclasses.dataclass
class ServeRun:
    tokens: list[list[int]]     # [batch][tokens + 1]: the prompt token first
    step_seconds: list[float]   # per decode step, the first included
    #: on a mesh: each step's collectives, name -> (calls summed over the
    #: ranks, host seconds inside them)
    collectives: list[dict] = dataclasses.field(default_factory=list)


def build_server(arch: str, *, stages: int, layers: int | None, batch: int,
                 cache_len: int, reduced: bool = True, device="cuda",
                 seed: int = 0, cfg=None, data: int = 1) -> dict:
    """The model, its seeded weights, zeroed caches and serve step; ``cfg``
    replaces the config of ``arch`` (a full-width config of fewer
    layers).  With ``data > 1`` the server holds a ``data x stages`` mesh
    and per-rank lists: ``sp`` and ``io`` (``launch.train.rank_params``),
    ``caches`` (each rank's ``batch / data`` rows) and the rank program
    ``rank_fn``; ``serve_step`` shards the batch, runs every rank and
    returns the tokens of every data rank in order."""
    if cfg is None:
        cfg = (registry.reduced_config(arch, num_layers=layers)
               if reduced else registry.get_arch(arch))
    model = build(cfg, num_stages=stages)
    opts = DecodeOptions(mb_rows=1, cache_len=cache_len,
                         enc_len=max(1, cache_len // 4))
    if data == 1:
        sp = [model.init_stage_params(s, seed=seed, device=device)
              for s in range(stages)]
        io = model.init_io_params(seed=seed, device=device)
        caches = [model.init_stage_cache(batch, cache_len, opts.enc_len,
                                         device=device)
                  for _ in range(stages)]
        return dict(cfg=cfg, model=model, sp=sp, io=io, caches=caches,
                    serve_step=make_staircase_fn(model, opts,
                                                 num_groups=batch))
    if batch % data:
        raise ValueError(f"batch {batch} does not divide over {data} data "
                         f"ranks")
    mesh = make_mesh(data, stages, device=device)
    sp, io = rank_params(model, mesh, seed=seed, device=device)
    caches = [model.init_stage_cache(batch // data, cache_len, opts.enc_len,
                                     device=device)
              for _ in range(mesh.size)]
    fn, _, batch_specs = make_serve_fn(model, mesh, opts,
                                       num_groups=batch // data)
    return dict(cfg=cfg, model=model, sp=sp, io=io, caches=caches,
                mesh=mesh, rank_fn=fn, batch_specs=batch_specs,
                serve_step=mesh_step(mesh, fn, batch_specs))


def mesh_step(mesh, fn, batch_specs):
    """``serve_step(sp, io, caches, batch, pos) -> tokens`` of the rank
    program ``fn`` over per-rank lists: the global batch sharded over the
    data ranks, the tokens of data ranks 0, 1, ... concatenated."""
    def serve_step(sp, io, caches, batch, pos):
        shards = shard_batch(mesh, batch, batch_specs)
        out = mesh.run(fn, [(sp[r], io[r], caches[r], shards[r], pos)
                            for r in range(mesh.size)])
        return torch.cat([out[mesh.rank_of(data=i)][0]
                          for i in range(mesh.shape["data"])])

    return serve_step


def serve(args, *, server: dict | None = None, step_hook=None) -> ServeRun:
    """Decode ``args.tokens`` tokens for ``args.batch`` sequences.
    ``server`` replaces ``build_server``'s (the tests load the reference's
    weights and caches into it); ``step_hook(step)`` runs after each step
    (the profiler advances its schedule there)."""
    device = resolve_device(args.device)
    devices = args.devices or args.stages
    if devices % args.stages:
        raise SystemExit(f"--devices {devices} is not a multiple of "
                         f"--stages {args.stages}")
    s = server or build_server(
        args.arch, stages=args.stages, layers=args.layers, batch=args.batch,
        cache_len=args.cache_len, reduced=not args.full_size, device=device,
        seed=args.seed, data=devices // args.stages)
    mesh = s.get("mesh")
    cfg = s["cfg"]
    gen = torch.Generator().manual_seed(args.seed + 7)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch,), generator=gen)
    seqs = [tokens.tolist()]
    tokens = tokens.to(device)
    run = ServeRun(tokens=[], step_seconds=[])
    for pos in range(args.tokens):
        t0 = time.perf_counter()
        batch = {"tokens": tokens}
        if cfg.embed_input:
            batch = {"embeds": torch.randn(
                (args.batch, 1, cfg.d_model),
                generator=torch.Generator().manual_seed(pos)).to(device)
                * 0.02}
        if mesh is not None:
            mesh.reset_counts()
        tokens = s["serve_step"](s["sp"], s["io"], s["caches"], batch, pos)
        seqs.append(tokens.tolist())  # the host copy ends the step
        run.step_seconds.append(time.perf_counter() - t0)
        if mesh is not None:
            run.collectives.append({k: (n, mesh.seconds[k]) for k, n
                                    in sorted(mesh.counts.items())})
        if step_hook is not None:
            step_hook(pos)
    run.tokens = [list(row) for row in zip(*seqs)]
    first, rest = run.step_seconds[0], run.step_seconds[1:]
    line = (f"decoded {args.tokens} tokens x batch {args.batch} on {device}: "
            f"first step {first:.3f} s")
    if rest:
        line += (f", then {sum(rest) / len(rest) * 1e3:.2f} ms/step "
                 f"({args.batch * len(rest) / sum(rest):.1f} tok/s)")
    print(line)
    if run.collectives:
        print(f"{mesh}: collectives a step (calls, host s summed over the "
              f"ranks): {run.collectives[-1]}")
    for row in run.tokens[:4]:
        print("  ", row)
    return run


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="pipelined greedy decode (PyTorch port)")
    ap.add_argument("--arch", default="deepseek-7b",
                    help="architecture id (registry.ARCHS)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs CUDA")
    ap.add_argument("--devices", type=int, default=None,
                    help="mesh ranks, data x stages (default --stages: one "
                         "data rank; the reference's default is 8)")
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--full-size", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> ServeRun:
    return serve(parser().parse_args(argv))


if __name__ == "__main__":
    main()
