"""Batched serving driver of the port: pipelined decode with stage-local caches.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch seamless-m4t-large-v2 --full-size --stages 4 --batch 8 \
        --tokens 32 --cache-len 4096
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch deepseek-7b --devices 4 --stages 2 --batch 4 --tokens 4
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --procs \
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
staircase (``make_staircase_fn``).  With ``--procs`` every rank is a
process of its own (``launch/procs.ProcessMesh``, ``--dist-backend``),
``1 x S`` included: each process holds its rank's weights and cache
shard, feeds its data shard and keeps its shard's tokens from step to
step (the rank program returns them on every model rank), so a step adds
no collective to the mesh's; the batch's rows are put together from the
processes' reports after the run.  Each step's wall time ends in the copy
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
    make_warm_fn,
)
from repro_torch.pipeline.executor import shard_batch


@dataclasses.dataclass
class ServeRun:
    tokens: list[list[int]]     # [batch][tokens + 1]: the prompt token first
    step_seconds: list[float]   # per decode step, the first included
    #: on a mesh: each step's collectives, name -> (calls summed over the
    #: ranks, host seconds inside them)
    collectives: list[dict] = dataclasses.field(default_factory=list)
    #: ``--procs``: each process's ``rank``, ``coords``, K2/K3 ``launches``
    #: (the warm-up's included) and ``peak_bytes`` of device memory
    ranks: list[dict] = dataclasses.field(default_factory=list)
    #: ``--procs``: the warm-up's seconds in rank 0's process
    warm_seconds: float = 0.0


def build_server(arch: str, *, stages: int, layers: int | None, batch: int,
                 cache_len: int, reduced: bool = True, device="cuda",
                 seed: int = 0, cfg=None, data: int = 1, mesh=None,
                 init=None) -> dict:
    """The model, its seeded weights, zeroed caches and serve step; ``cfg``
    replaces the config of ``arch`` (a full-width config of fewer
    layers).  With ``data > 1`` or a ``mesh`` the server holds a ``data x
    stages`` mesh and per-rank lists: ``sp`` and ``io``
    (``launch.train.rank_params``), ``caches`` (each rank's ``batch /
    data`` rows) and the rank program ``rank_fn``; ``serve_step`` runs
    every local rank (:func:`mesh_step`).  ``mesh`` (a
    ``launch.procs.ProcessMesh``) replaces the in-process mesh of rank
    threads: the lists hold this process's rank only (None for the
    others), and ``device`` is the mesh's.  ``init(model, mesh, device) ->
    (sp, io, caches)`` (per-rank lists) replaces the seeded weights and
    zeroed caches on a mesh."""
    if cfg is None:
        cfg = (registry.reduced_config(arch, num_layers=layers)
               if reduced else registry.get_arch(arch))
    model = build(cfg, num_stages=stages)
    opts = DecodeOptions(mb_rows=1, cache_len=cache_len,
                         enc_len=max(1, cache_len // 4))
    if data == 1 and mesh is None:
        sp = [model.init_stage_params(s, seed=seed, device=device)
              for s in range(stages)]
        io = model.init_io_params(seed=seed, device=device)
        caches = [model.init_stage_cache(batch, cache_len, opts.enc_len,
                                         device=device)
                  for _ in range(stages)]
        return dict(cfg=cfg, model=model, sp=sp, io=io, caches=caches,
                    opts=opts, serve_step=make_staircase_fn(
                        model, opts, num_groups=batch))
    if mesh is None:
        mesh = make_mesh(data, stages, device=device)
    elif mesh.shape != {"data": data, "model": stages}:
        raise ValueError(f"a mesh {mesh.shape} for data {data} x {stages} "
                         f"stages")
    device = mesh.device
    if batch % data:
        raise ValueError(f"batch {batch} does not divide over {data} data "
                         f"ranks")
    if init is None:
        sp, io = rank_params(model, mesh, seed=seed, device=device)
        caches = mesh.per_rank(lambda r: model.init_stage_cache(
            batch // data, cache_len, opts.enc_len, device=device))
    else:
        sp, io, caches = init(model, mesh, device)
    fn, _, batch_specs = make_serve_fn(model, mesh, opts,
                                       num_groups=batch // data)
    return dict(cfg=cfg, model=model, sp=sp, io=io, caches=caches,
                opts=opts, mesh=mesh, rank_fn=fn, batch_specs=batch_specs,
                serve_step=mesh_step(mesh, fn, batch_specs))


def _local_data(mesh) -> list[int]:
    """The data indices of this process's ranks, ascending (every one on
    a thread mesh)."""
    return sorted({mesh.coords(r)["data"] for r in mesh.local_ranks})


def mesh_step(mesh, fn, batch_specs):
    """``serve_step(sp, io, caches, batch, pos) -> tokens`` of the rank
    program ``fn`` over per-rank lists: ``batch`` holds the rows of this
    process's data ranks in data order (the global batch on a thread mesh,
    sharded over its data ranks; one data shard in a process of a
    ``ProcessMesh``), and the tokens of those data ranks come back in the
    same order."""
    procs = len(mesh.local_ranks) < mesh.size
    # each local data index's first local rank: the tokens are on every
    # model rank (a psum over model)
    lead = [min(r for r in mesh.local_ranks if mesh.coords(r)["data"] == i)
            for i in _local_data(mesh)]

    def serve_step(sp, io, caches, batch, pos):
        shards = (mesh.per_rank(lambda r: batch) if procs
                  else shard_batch(mesh, batch, batch_specs))
        out = mesh.run(fn, mesh.per_rank(
            lambda r: (sp[r], io[r], caches[r], shards[r], pos)))
        return torch.cat([out[r][0] for r in lead])

    return serve_step


def _local_rows(mesh, batch: int) -> slice:
    """The global batch's rows that this process feeds: all of them on one
    rank or a thread mesh, its data shard in a process of a mesh of
    processes."""
    if mesh is None:
        return slice(0, batch)
    data = _local_data(mesh)
    n = batch // mesh.shape["data"]
    return slice(data[0] * n, (data[-1] + 1) * n)


def serve(args, *, server: dict | None = None, step_hook=None) -> ServeRun:
    """Decode ``args.tokens`` tokens for ``args.batch`` sequences.
    ``server`` replaces ``build_server``'s (the tests load the reference's
    weights and caches into it); ``step_hook(step)`` runs after each step
    (the profiler advances its schedule there).  With ``--procs`` the
    ranks are processes (:func:`serve_procs`)."""
    devices = args.devices or args.stages
    if devices % args.stages:
        raise SystemExit(f"--devices {devices} is not a multiple of "
                         f"--stages {args.stages}")
    if args.procs:
        if server is not None or step_hook is not None:
            raise ValueError("--procs builds its server and runs its steps "
                             "in the processes of its world")
        return serve_procs(args)
    device = resolve_device(args.device)
    s = server or build_server(
        args.arch, stages=args.stages, layers=args.layers, batch=args.batch,
        cache_len=args.cache_len, reduced=not args.full_size, device=device,
        seed=args.seed, data=devices // args.stages)
    run = _serve_loop(args, s, device, step_hook)
    _report(args, run, device, s.get("mesh"))
    return run


def _serve_loop(args, s: dict, device, step_hook) -> ServeRun:
    """The decode loop over the rows that this process feeds (the whole
    batch unless its ranks are one process of a mesh of processes): the
    prompt tokens and an embed-input config's embeddings drawn for the
    whole batch from the seed in every process, this process's rows
    taken, its tokens kept from step to step."""
    mesh = s.get("mesh")
    cfg = s["cfg"]
    rows = _local_rows(mesh, args.batch)
    gen = torch.Generator().manual_seed(args.seed + 7)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch,),
                           generator=gen)[rows]
    seqs = [tokens.tolist()]
    tokens = tokens.to(device)
    run = ServeRun(tokens=[], step_seconds=[])
    for pos in range(args.tokens):
        t0 = time.perf_counter()
        batch = {"tokens": tokens}
        if cfg.embed_input:
            batch = {"embeds": torch.randn(
                (args.batch, 1, cfg.d_model),
                generator=torch.Generator().manual_seed(pos))[rows].to(device)
                * 0.02}
        if mesh is not None:
            mesh.reset_counts()
        tokens = s["serve_step"](s["sp"], s["io"], s["caches"], batch, pos)
        seqs.append(tokens.tolist())  # the host copy ends the step
        run.step_seconds.append(time.perf_counter() - t0)
        if mesh is not None:
            run.collectives.append(mesh.local_counts())
        if step_hook is not None:
            step_hook(pos)
    run.tokens = [list(row) for row in zip(*seqs)]
    return run


def _report(args, run: ServeRun, device, mesh) -> None:
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


# ---------------------------------------------------------------------------
# one process per rank (--procs)
# ---------------------------------------------------------------------------
def _serve_world(mesh, args) -> ServeRun:
    """One process of ``--procs``: its rank's server, every rank's warm-up
    at once, the decode loop over its data shard, then (once, after the
    loop) every process's report on every process: rank 0's run gets the
    batch's rows in data order, each step's collectives summed over the
    processes and every process's entry in ``ranks``; rank 0 prints."""
    from repro_torch.kernels import ops
    from repro_torch.launch.procs import sum_counts

    s = build_server(
        args.arch, stages=args.stages, layers=args.layers, batch=args.batch,
        cache_len=args.cache_len, reduced=not args.full_size,
        seed=args.seed, data=mesh.shape["data"], mesh=mesh)
    t0 = time.perf_counter()
    warm = make_warm_fn(s["model"], mesh, s["opts"])
    mesh.run(warm, mesh.per_rank(lambda r: (s["sp"][r], s["io"][r])))
    warm_seconds = time.perf_counter() - t0
    mesh.sync()  # every process built and warmed its rank: step 0 together
    run = _serve_loop(args, s, mesh.device, None)
    (r,) = mesh.local_ranks
    cuda = mesh.device.type == "cuda"
    report = {
        "rank": r, "coords": mesh.coords(r), "tokens": run.tokens,
        "collectives": run.collectives, "launches": ops.launch_counts(),
        "peak_bytes": torch.cuda.max_memory_allocated(mesh.device)
        if cuda else 0}
    reports = mesh.all_objects(report)
    run.ranks = [{k: rep[k] for k in ("rank", "coords", "launches",
                                      "peak_bytes")} for rep in reports]
    run.warm_seconds = warm_seconds
    if r != 0:
        return run
    run.tokens = [row for i in range(mesh.shape["data"])
                  for row in reports[mesh.rank_of(data=i)]["tokens"]]
    run.collectives = [sum_counts(step) for step in zip(
        *(rep["collectives"] for rep in reports))]
    print(f"{mesh!r}: every rank warmed in {warm_seconds:.3f} s (rank 0)")
    _report(args, run, mesh.device, mesh)
    return run


def serve_procs(args) -> ServeRun:
    """``serve --procs``: the mesh serve with one process per rank
    (``launch/procs.ProcessMesh``, ``--dist-backend``), ``devices //
    stages`` data ranks, ``1 x S`` included: spawned here
    (``procs.spawn_world``), or this process's rank when ``torchrun`` set
    the world.  Each rank first decodes once against a throwaway cache,
    all at once (``pipeline/decode.make_warm_fn``; its seconds in
    ``warm_seconds``, its launches in ``ranks``), so that step 0 does not
    add up the processes' first calls stage after stage.  Returns rank 0's
    run:
    every row of the batch, rank 0's step seconds, each step's
    collectives summed over the processes and every process's entry in
    ``ranks``.  Runs on the GPU unless ``--device cpu`` was given; the
    parent frees its CUDA cache before spawning."""
    from repro_torch.launch import procs

    backend = args.dist_backend or "gloo"
    devices = args.devices or args.stages
    shape = {"data": devices // args.stages, "model": args.stages}
    procs.check_backend(backend, args.device, devices)
    resolve_device(args.device)
    if procs.in_world():
        mesh = procs.join_world(shape, device=args.device, backend=backend)
        try:
            return _serve_world(mesh, args)
        finally:
            procs.leave_world()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    print(f"--procs: {devices} processes, backend {backend}"
          + ("; every payload staged through host memory (gloo on CUDA "
             "tensors)" if backend == "gloo"
             and torch.device(args.device).type == "cuda" else ""))
    # each process with this one's intra-op threads: on the CPU the bits
    # of a GEMM may depend on them
    runs = procs.spawn_world(_serve_world, (args,), devices,
                             shape=shape, device=args.device,
                             backend=backend,
                             threads=torch.get_num_threads())
    return runs[0]


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
    ap.add_argument("--procs", action="store_true",
                    help="one process per mesh rank (torch.distributed; "
                         "spawned here, or this process's rank under "
                         "torchrun), 1 x S included")
    ap.add_argument("--dist-backend", default=None, choices=("gloo", "nccl"),
                    help="--procs: the process group's backend (default "
                         "gloo; nccl needs a card per rank)")
    return ap


def main(argv=None) -> ServeRun:
    args = parser().parse_args(argv)
    if args.dist_backend and not args.procs:
        raise SystemExit("--dist-backend picks the backend of --procs")
    return serve(args)


if __name__ == "__main__":
    main()
