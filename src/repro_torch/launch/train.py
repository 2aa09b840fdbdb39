"""Training driver of the port: readiness-driven actor training, and the
schedule-table executor with ZeRO-1 AdamW.

    PYTHONPATH=src python -m repro_torch.launch.train --runtime actor \
        --arch paper-gpt3-large --full-size --stages 4 --microbatches 8 \
        --seq 2048 --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --runtime table \
        --arch paper-gpt3-large --full-size --devices 8 --stages 4 \
        --microbatches 4 --seq 2048 --schedule 1f1b --steps 3

Port of ``train_actor`` of ``repro.launch.train``: thread-per-stage actors
(the copied ``runtime/rrfp`` driver) dispatch the real stage callables of
``pipeline/stagefn.py`` by message arrival under hint-order arbitration,
accumulate grads per stage, and AdamW runs over the accumulated grads.
The stages share one device and its default CUDA stream: a payload is
enqueued before it is sent, so stream order is data order (and stages do
not overlap on the device).  Task times the driver records are host
enqueue times; the step wall time, which ends in the loss's ``float()``
sync, is the device-honest number.

``--workload multimodal`` trains the branch+fusion DAG instead (port of
the reference's ``train_multimodal``: encoder branch and text frontend
feeding a fusion stage, then the LM chain; ``--arch`` qwen2-vl-2b by
default, or seamless-m4t-large-v2), on the thread substrate, or with
``--substrate sim`` through the virtual-clock actor substrate on the DAG's
cost model:

    PYTHONPATH=src python -m repro_torch.launch.train --workload multimodal \
        --full-size --stages 4 --microbatches 8 --seq 2048 --steps 3

Every flag of the reference's single-device actor launcher is here:
telemetry (``--metrics-report``, ``--export-perfetto``, ``--explain``),
checkpoints in the reference's format (``--ckpt-dir``, ``--ckpt-every``,
``--resume``), fail-stop recovery (``--recover``, ``--hb-deadline``: a
``--chaos fail_stage=...`` death respawns the stage from the latest
checkpoint or the live step-start parameters), and the adaptive hint loop
(``--adaptive``, ``--resynth-every``, ``--swap-threshold``).  Where the
reference silently ignores a flag (``--ckpt-dir`` under ``--workload
multimodal``, ``--resume`` without ``--ckpt-dir``, the adaptive knobs
without ``--adaptive``), the port stops and says so.

``--runtime table`` is the port of the reference's default runtime
(``build_trainer`` and its loop): the schedule-table SPMD executor
(``pipeline/executor.py``) and the ZeRO-1 optimizer on a ``(data ×
model)`` mesh of ``--devices`` ranks, ``data = devices // stages``.  The
ranks are threads of this process on one device (``launch/mesh.py``), or,
with ``--procs``, one process each (``launch/procs.py``: spawned here, or
the world that ``torchrun`` set; ``--dist-backend gloo`` stages CUDA
payloads through host memory, ``nccl`` needs a card per rank), with the
same bits: each holds its stage's parameters, its own io parameters and
its ZeRO-1 state, so memory grows with every data replica.  Its
checkpoints are the reference's table checkpoint, one ``shard_0.npz`` on
either mesh: with ``--procs`` every rank moves its state to rank 0's host,
and rank 0 alone writes and reads the directory.  The port's
``--runtime`` default stays ``actor``; the reference's is ``table``.  The telemetry
flags instrument the actor runtime and stop under ``table``, as the
reference's do; the other actor-only flags stop too.  The enc-dec config
(seamless-m4t-large-v2) trains under ``table`` only, with ``--seq``
encoder frames per row after its ``--seq`` decoder tokens; ``actor``
stops on it.

Runs on the GPU unless ``--device cpu`` is given; without CUDA it raises.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import os
import threading
import time
from typing import Any

import torch

from repro_torch.ckpt.store import CheckpointStore
from repro_torch.configs import registry
from repro_torch.core.costs import CostModel
from repro_torch.core.hints import HintKind
from repro_torch.core.taskgraph import PipelineSpec
from repro_torch.data.synthetic import (
    PrefetchIterator,
    multimodal_batch,
    synth_batch,
)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.build import build
from repro_torch.models.convert import (
    params_from_reference,
    params_to_reference,
    rank_params_from_reference,
    rank_params_to_reference,
    rank_reference_layout,
    reference_layout,
    state_from_reference,
    state_to_reference,
    zero1_state_from_reference,
    zero1_state_layout,
    zero1_state_to_reference,
)
from repro_torch.multimodal import (
    MULTIMODAL_ARCHS,
    MultimodalStageFns,
    MultimodalStageProgram,
    multimodal_config,
    multimodal_dag_costs,
    multimodal_model,
)
from repro_torch.multimodal.stagefn import MultimodalStageOptions
from repro_torch.obs import MetricsRegistry, export_perfetto, spans
from repro_torch.obs.report import explain
from repro_torch.optim.adamw import (
    AdamWConfig,
    make_host_update,
    make_optimizer,
)
from repro_torch.pipeline import schedules
from repro_torch.pipeline.executor import (
    ExecOptions,
    make_train_fn,
    shard_batch,
    stage_fns,
)
from repro_torch.pipeline.sharding import partition_for
from repro_torch.pipeline.stagefn import (
    ActorStageProgram,
    StageFnOptions,
    StageFns,
    microbatch,
)
from repro_torch.runtime.adaptive import AdaptiveConfig, AdaptiveScheduler
from repro_torch.runtime.rrfp import ActorConfig, ActorDriver, Trace, parse_chaos
from repro_torch.runtime.straggler import StragglerMonitor

SCHEDULES = tuple(schedules.BUILDERS)

@dataclasses.dataclass
class TrainRun:
    losses: list[float]
    step_seconds: list[float]
    #: ``--substrate sim``: the simulated makespan of each step (s)
    makespans: list[float] = dataclasses.field(default_factory=list)
    #: the first step's recorded trace (``--record-trace``,
    #: ``--export-perfetto`` or ``--explain``), else None
    trace: Any = None
    #: ``--adaptive``: the run's ``AdaptiveScheduler``
    scheduler: Any = None
    #: checkpoint I/O: one dict per save, resume or respawn restore
    #: (``op``, ``step``, ``seconds``, and ``bytes`` for a save; a table
    #: save also ``gather_seconds``, the global tree on the host (of which
    #: ``move_seconds`` moved every rank's state to rank 0's host under
    #: ``--procs``), and ``write_seconds``, its asynchronous write; a table
    #: resume
    #: ``read_seconds``, the file's read where it was read; a table save
    #: and resume ``peak_rss_bytes``, the process's host memory peak so far)
    ckpt_log: list[dict] = dataclasses.field(default_factory=list)
    #: each step's global grad norm (the table runtime's before clipping;
    #: the actor path does not clip)
    gnorms: list[float] = dataclasses.field(default_factory=list)
    #: ``--runtime table``: the :func:`build_trainer` dict (the per-rank
    #: parameters and optimizer state after the last step)
    trainer: Any = None
    #: ``--runtime table``: each step's mesh collectives, name -> (calls,
    #: host seconds inside them), summed over the ranks
    #: (``MeshBase.counts_over_ranks``)
    collectives: list[dict] = dataclasses.field(default_factory=list)
    #: ``--runtime table``: this process's peak resident host memory over
    #: the loop (bytes; sampled, ``_RssPeak``)
    peak_rss_bytes: int = 0
    #: ``--procs``: each process's ``rank``, ``coords``, K1/K2
    #: ``launches``, ``peak_bytes`` of device memory, ``peak_rss_bytes`` of
    #: host memory and ``digests`` of its
    #: replicated stage leaves (``procs.leaf_digests``)
    ranks: list[dict] = dataclasses.field(default_factory=list)


def resolve_device(name: str) -> torch.device:
    """The device to train on; CUDA must exist unless the CPU was asked for."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU unless it is "
            "asked for the CPU (--device cpu)")
    return dev


def _device_batch(arrays: dict, device) -> dict:
    """numpy batch -> device tensors (token ids as int64 for indexing)."""
    out = {}
    for k, a in arrays.items():
        t = torch.from_numpy(a)
        if k in ("tokens", "labels"):
            t = t.long()
        out[k] = t.to(device)
    return out


# ---------------------------------------------------------------------------
# observability (--metrics-report / --export-perfetto / --explain)
# ---------------------------------------------------------------------------
def _obs_registry(args):
    """A MetricsRegistry when ``--metrics-report`` asked for one, else None
    (None keeps the runtime's metrics hooks at their zero-cost path)."""
    return MetricsRegistry() if args.metrics_report else None


def _obs_record_step0(args, step: int, first: int = 0) -> bool:
    """Record the first step's trace when any end-of-run consumer needs
    it (Perfetto export, the --explain health report, or --record-trace)."""
    return step == first and (bool(args.record_trace)
                              or bool(args.export_perfetto)
                              or bool(args.explain))


def _obs_finish(args, registry, trace) -> None:
    """End-of-run sync point: print the summary table, export Perfetto."""
    if registry is not None and args.metrics_report:
        print("\nper-stage metrics (accumulated over all steps):")
        print(registry.report())
    if args.export_perfetto:
        if trace is None:
            raise SystemExit(
                "--export-perfetto: no trace was recorded to export")
        export_perfetto(trace, args.export_perfetto)
        print(f"perfetto export ({len(trace.events)} events) -> "
              f"{args.export_perfetto}  (open at ui.perfetto.dev)")
    if args.explain:
        if trace is None:
            raise SystemExit(
                "--explain: no trace was recorded to analyze")
        print("\n" + explain(trace).format())


def _save_trace(args, driver, step: int, loss: float | None):
    """Stamp the recorded step's trace, save it under --record-trace, and
    return it for the end-of-run consumers."""
    trace = driver.trace
    trace.meta["step"] = step
    if loss is not None:
        trace.meta["final_loss"] = loss
    if args.record_trace:
        trace.save(args.record_trace)
        print(f"recorded step-0 trace ({len(trace.events)} events) "
              f"-> {args.record_trace}")
    return trace


# ---------------------------------------------------------------------------
# checkpoints (--ckpt-dir / --ckpt-every / --resume), in the reference's
# tree: {"params": {"sp", "io"}, "m": {"sp", "io"}, "v": {"sp", "io"}}
# ---------------------------------------------------------------------------
def _ckpt_tree(model, stage_params, io_params, mstate, vstate) -> dict:
    def pair(t):
        return {"sp": t[0], "io": t[1]}

    return {"params": pair(params_to_reference(model, stage_params,
                                               io_params)),
            "m": pair(state_to_reference(model, stage_params, io_params,
                                         mstate)),
            "v": pair(state_to_reference(model, stage_params, io_params,
                                         vstate))}


def _ckpt_target(model, stage_params, io_params, with_state: bool) -> dict:
    """The restore target: meta tensors of the parameters' dtypes (float32
    for ``m``/``v``)."""
    sp, io = reference_layout(model, stage_params, io_params)
    tree = {"params": {"sp": sp, "io": io}}
    if with_state:
        sp32, io32 = reference_layout(model, stage_params, io_params,
                                      torch.float32)
        tree["m"] = {"sp": sp32, "io": io32}
        tree["v"] = {"sp": sp32, "io": io32}
    return tree


def _or(value, default):
    """A flag's value, or its default when it was not given (None)."""
    return default if value is None else value


def _step_bytes(store: CheckpointStore, step: int) -> int:
    d = os.path.join(store.dir, f"step_{step}")
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))


@torch.no_grad()
def _global_norm(grads) -> torch.Tensor:
    """The float32 norm of every gradient together (``None``: zero), the
    table runtime's clip norm; the actor path records it and does not
    clip."""
    sq = None
    for g in grads:
        if g is not None:
            gf = g.float()
            sq = torch.sum(gf * gf) if sq is None else sq + torch.sum(gf * gf)
    return torch.sqrt(sq)


def train_actor(args, *, cfg=None, init_params=None,
                step_hook=None) -> TrainRun:
    """Train with thread-per-stage actors dispatching real stage callables.

    Single process: stage s's parameters live with stage s's actor; AdamW
    runs over the accumulated per-stage grads.  ``cfg`` replaces the
    ``ArchConfig`` built from the flags (``--full-size`` takes every layer:
    a caller trains a full-width config of fewer layers this way);
    ``init_params(model, device) -> (stage_modules, io_module)`` replaces
    the seeded init (the parity tests load the reference's weights through
    it); ``step_hook(step)`` runs after each step (the profiler advances
    its schedule there).
    """
    device = resolve_device(args.device)
    if args.arch is None:
        args.arch = "deepseek-7b"
    if cfg is None:
        cfg = (registry.reduced_config(args.arch, num_layers=args.layers)
               if not args.full_size else registry.get_arch(args.arch))
    if cfg.encoder_layers:
        raise SystemExit(
            f"--runtime actor has no enc-dec path ({args.arch}: the "
            f"reference's actor stage callables give its layers no "
            f"dec_len); train it with --runtime table")
    model = build(cfg, num_stages=args.stages)
    if init_params is None:
        stage_params = [model.init_stage_params(s, seed=0, device=device)
                        for s in range(args.stages)]
        io_params = model.init_io_params(seed=0, device=device)
    else:
        stage_params, io_params = init_params(model, device)
    split = args.split_backward or args.schedule == "zb"
    hint = HintKind(args.hint)
    chaos = parse_chaos(args.chaos) if args.chaos else None
    replay = None
    if args.replay_trace:
        if args.chaos:
            raise SystemExit("--replay-trace replays the recorded arrival "
                             "order; combining it with --chaos is undefined")
        replay = Trace.load(args.replay_trace)
        meta = replay.meta
        for k, want in (("num_stages", args.stages),
                        ("num_microbatches", args.microbatches),
                        ("split_backward", split)):
            if meta.get(k) is not None and meta[k] != want:
                raise SystemExit(
                    f"--replay-trace {args.replay_trace}: recorded {k}="
                    f"{meta[k]} does not match this run's {want}")
    spec = PipelineSpec(args.stages, args.microbatches, split_backward=split)
    batch_size = args.microbatches * args.mb_rows
    tokens = batch_size * args.seq
    fns = StageFns(model, StageFnOptions(
        mb_rows=args.mb_rows, seq_len=args.seq, loss_scale=1.0 / tokens))
    if args.schedule == "rrfp":
        mode, fixed = "hint", "1f1b"
        if split != (hint == HintKind.BFW):
            raise SystemExit(
                "--hint bfw and --split-backward go together: the BFW hint "
                "needs W tasks, which only exist under split backward (and "
                "only the BFW hint dispatches them)")
    elif args.schedule == "zb":
        mode, fixed = "precommitted", "zb"
    elif args.schedule in ("1f1b", "gpipe"):
        if split:
            raise SystemExit(
                f"--split-backward is not defined for the fused-order "
                f"{args.schedule!r} baseline; use --schedule zb")
        mode, fixed = "precommitted", args.schedule
    else:
        raise SystemExit(
            f"--runtime actor supports schedules rrfp/1f1b/gpipe/zb, "
            f"not {args.schedule!r}")
    metrics_reg = _obs_registry(args)
    scheduler = None
    if args.adaptive:
        if mode != "hint":
            raise SystemExit("--adaptive re-synthesizes the hint table; it "
                             "requires --schedule rrfp")
        if args.replay_trace:
            raise SystemExit("--adaptive changes the hint table between "
                             "steps; combining it with --replay-trace is "
                             "undefined")
        if metrics_reg is None:
            metrics_reg = MetricsRegistry(args.stages)
        # synthesis prices tables on an expected cost model; the registry's
        # measured EWMAs (real stage timings) overwrite it cell by cell
        base_costs = CostModel.uniform(args.stages)
        if split:
            base_costs = base_costs.with_split_backward()
        scheduler = AdaptiveScheduler(
            spec, base_costs,
            AdaptiveConfig(resynth_every=_or(args.resynth_every, 1),
                           swap_threshold=_or(args.swap_threshold, 1.03),
                           hint=hint),
            registry=metrics_reg)
    acfg = ActorConfig(mode=mode, hint=hint, fixed_order=fixed,
                       w_defer_cap=args.w_defer_cap,
                       deadlock_timeout=args.deadlock_timeout,
                       chaos=chaos, recover=args.recover,
                       hb_deadline=args.hb_deadline,
                       replay=replay, metrics=metrics_reg)

    run = TrainRun(losses=[], step_seconds=[], scheduler=scheduler)
    store = CheckpointStore(args.ckpt_dir) if args.ckpt_dir else None
    ckpt_every = _or(args.ckpt_every, 1 if args.recover else 10)
    start_step = 0
    if store and args.resume and store.latest_step() is not None:
        start_step = store.latest_step()
        t0 = time.perf_counter()
        state, _ = store.restore(start_step, _ckpt_target(
            model, stage_params, io_params, with_state=True))
        stage_params, io_params = params_from_reference(
            model, state["params"]["sp"], state["params"]["io"], device)
        mstate, vstate = (
            state_from_reference(model, stage_params, io_params,
                                 state[k]["sp"], state[k]["io"], device)
            for k in ("m", "v"))
        del state
        run.ckpt_log.append({"op": "resume", "step": start_step,
                             "seconds": time.perf_counter() - t0})
        print(f"resumed from step {start_step}")
    else:
        mstate = [torch.zeros(p.shape, dtype=torch.float32, device=device)
                  for sp in (*stage_params, io_params)
                  for p in sp.parameters()]
        vstate = [torch.zeros_like(m) for m in mstate]
    params = [p for sp in stage_params for p in sp.parameters()]
    params += list(io_params.parameters())
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps),
                          total_steps=max(args.steps, 1))
    apply_update = make_host_update(opt_cfg)
    # restore target of a respawned stage (shapes and dtypes only)
    respawn_target = (_ckpt_target(model, stage_params, io_params,
                                   with_state=False)
                      if store is not None else None)

    # The monitor re-synthesizes precommitted tables through the DES engine,
    # whose baseline orders model a fused backward — feed it the fused twin.
    monitor = StragglerMonitor(
        spec=PipelineSpec(args.stages, args.microbatches),
        costs=CostModel.uniform(args.stages))
    print(f"arch={args.arch} N={cfg.param_count():,} params  runtime=actor "
          f"mode={mode}  hint={hint.value}  split_backward={split}  "
          f"stages={args.stages}  microbatches={args.microbatches}  "
          f"device={device}")
    for step in range(start_step, args.steps):
        # the step record (obs/spans.py) closes before the caller's hook
        with spans.step(step, "rrfp.step") as rec:
            with spans.span("rrfp.batch"):
                batch = _device_batch(
                    synth_batch(cfg, batch_size, args.seq, seed=args.seed,
                                step=step),
                    device)
            with spans.span("rrfp.programs"):
                programs = [
                    ActorStageProgram(fns, s, stage_params[s], io_params,
                                      batch, split_backward=split)
                    for s in range(args.stages)
                ]

                def respawn(s, programs=programs, batch=batch):
                    # the stage's in-memory state died with it: rebuild its
                    # program from the latest checkpoint (under
                    # --ckpt-every 1 that is exactly the params this step
                    # started from) or, before the first checkpoint, from
                    # the live step-start params (the update runs in place
                    # only after the step)
                    sp_r, io_r = stage_params[s], io_params
                    if store is not None and store.latest_step() is not None:
                        t0 = time.perf_counter()
                        host, _ = store.restore_host(store.latest_step(),
                                                     respawn_target)
                        (sp_r,), io_r = params_from_reference(
                            model, host["params"]["sp"],
                            host["params"]["io"], device, stages=[s])
                        run.ckpt_log.append(
                            {"op": "respawn", "stage": s,
                             "step": store.latest_step(),
                             "seconds": time.perf_counter() - t0})
                        print(f"recover: stage {s} restored from checkpoint "
                              f"step {store.latest_step()}")
                    programs[s] = ActorStageProgram(fns, s, sp_r, io_r, batch,
                                                    split_backward=split)
                    return programs[s]

                t0 = time.perf_counter()
                # recording costs lock traffic on the dispatch path: enable
                # it only for the step whose trace is actually kept
                record_this = _obs_record_step0(args, step, first=start_step)
                acfg_step = (dataclasses.replace(acfg, respawn=respawn)
                             if args.recover else acfg)
                if scheduler is not None:
                    # iteration-boundary quiesce point: adopt the
                    # scheduler's current table (HINT_SWAP events mark
                    # mid-run adoptions only)
                    acfg_step = dataclasses.replace(
                        acfg_step, hint_table=scheduler.table,
                        hint_table_version=scheduler.version)
                driver = ActorDriver(
                    spec, None,
                    dataclasses.replace(acfg_step, record_trace=True)
                    if record_this else acfg_step)
            with spans.span("rrfp.pipeline"):
                result = driver.run_threaded(programs)
            with spans.span("rrfp.grads"):
                grads = [g for p in programs for g in p.d_stage]
                d_io = list(programs[0].d_io)
                for p in programs[1:]:
                    d_io = [a if b is None else b if a is None else a + b
                            for a, b in zip(d_io, p.d_io)]
                gnorm = _global_norm(grads + d_io)
            with spans.span("rrfp.adamw"):
                lr = apply_update(params, grads + d_io, mstate, vstate, step)
            with spans.span("rrfp.loss_sync"):
                # one device sync per step: the programs keep the loss on
                # device
                loss = float(sum(p.loss_acc for p in programs)) / tokens
            dt = time.perf_counter() - t0
            with spans.span("rrfp.after"):
                run.losses.append(loss)
                run.gnorms.append(float(gnorm))
                run.step_seconds.append(dt)
                if record_this:
                    run.trace = _save_trace(args, driver, step, loss)
                bd = result.breakdown()
                new_table = monitor.observe_result(result)
                swap_note = ""
                if scheduler is not None:
                    decision = scheduler.maybe_resynthesize(step)
                    if decision.swapped:
                        swap_note = (f"  [hint-swap v{scheduler.version} "
                                     f"ratio={decision.ratio:.3f}]")
                print(f"step {step:4d}  loss {loss:8.4f}  lr {lr:.2e}  "
                      f"{dt*1e3:7.1f} ms  makespan "
                      f"{result.makespan*1e3:7.1f} ms  "
                      f"blocking {bd['blocking']*1e3:6.1f} ms"
                      + ("  [replan]" if new_table is not None else "")
                      + swap_note)
                if store and (step + 1) % ckpt_every == 0:
                    t1 = time.perf_counter()
                    store.save(step + 1, _ckpt_tree(model, stage_params,
                                                    io_params, mstate,
                                                    vstate),
                               meta={"arch": args.arch, "step": step + 1})
                    nbytes = _step_bytes(store, step + 1)
                    run.ckpt_log.append(
                        {"op": "save", "step": step + 1,
                         "seconds": time.perf_counter() - t1,
                         "bytes": nbytes})
                    print(f"checkpoint step {step + 1}: {nbytes:,} bytes in "
                          f"{run.ckpt_log[-1]['seconds']:.2f} s -> "
                          f"{args.ckpt_dir}")
            rec.add_run(result)
        if step_hook is not None:
            step_hook(step)
    if monitor.replans:
        print(f"straggler monitor triggered {monitor.replans} replan(s)")
    if scheduler is not None and scheduler.swaps:
        print(f"adaptive scheduler swapped the hint table "
              f"{len(scheduler.swaps)} time(s) at step(s) {scheduler.swaps} "
              f"(table v{scheduler.version})")
    _obs_finish(args, metrics_reg, run.trace)
    return run


# ---------------------------------------------------------------------------
# schedule-table executor + ZeRO-1 (--runtime table)
# ---------------------------------------------------------------------------
def rank_params(model, mesh, *, seed: int, device) -> tuple[list, list]:
    """Each local rank's own stage module (its ``model`` index's stage) and
    io module from the seeded init, each data replica a copy (a list by
    rank, None for a rank of another process).  The init draws each stage
    from its stage and slot, so a process draws exactly what the thread
    mesh's rank draws.  Under an MoE expert layout over more than one data
    rank each stage is drawn whole, as on one rank, and each rank keeps its
    shard of the routed experts (``ArchModel.shard_stage_params``)."""
    data = mesh.shape["data"]
    shard = model.moe_layout != "none" and data > 1
    stage_params: list = [None] * mesh.size
    io_params: list = [None] * mesh.size
    for s in sorted({mesh.coords(r)["model"] for r in mesh.local_ranks}):
        full = model.init_stage_params(s, seed=seed, device=device)
        ranks = [r for r in mesh.local_ranks if mesh.coords(r)["model"] == s]
        for k, r in enumerate(ranks):
            stage_params[r] = (
                model.shard_stage_params(full, data, mesh.coords(r)["data"])
                if shard else full if k == 0 else copy.deepcopy(full))
        del full  # under a shard layout: each rank kept its shard only
    io0 = model.init_io_params(seed=seed, device=device)
    for k, r in enumerate(mesh.local_ranks):
        io_params[r] = io0 if k == 0 else copy.deepcopy(io0)
    return stage_params, io_params


def build_trainer(arch: str, *, data: int, stages: int, layers: int | None,
                  mb_rows: int, microbatches: int, seq: int,
                  schedule: str = "rrfp", reduced: bool = True,
                  lr: float = 1e-3, total_steps: int = 1000,
                  device="cuda", cfg=None, init_params=None,
                  exec_options: dict | None = None, mesh=None) -> dict:
    """The table runtime's model, mesh, per-rank state and ``train_step``
    (port of the reference's ``build_trainer``).

    Every rank ``r`` holds ``stage_params[r]`` (its ``model`` index's
    stage), ``io_params[r]`` and ``opt_state[r]``; the weights are the
    actor path's seeded init (seed 0), copied to every replica, so a table
    run and an actor run of one arch start from the same weights.  Under
    an MoE expert layout over ``data > 1`` ranks each stage is drawn
    whole, as the actor path draws it, and each rank keeps its shard of
    the routed experts (``ArchModel.shard_stage_params``), so every
    ``data`` starts from the same global weights.
    ``cfg`` replaces the config built from ``arch``/``layers``/``reduced``;
    ``mesh`` replaces the in-process ``data x stages`` mesh of rank threads
    (``launch.procs.ProcessMesh``: this process's rank only; the per-rank
    lists hold None for the others' ranks, and ``device`` is the mesh's);
    ``init_params(model, mesh, device) -> (stage_params, io_params)``
    (per-rank lists) replaces the seeded init; ``exec_options`` replaces
    :class:`ExecOptions` fields (the float32 checks set ``io_grad_dtype``
    and ``flat_dtype``; an enc-dec config takes ``enc_len = seq`` encoder
    frames unless it sets ``enc_len``).  ``train_step(batch, step)``
    shards a global ``[data * microbatches * mb_rows, seq]`` batch (and,
    enc-dec, its ``[..., enc_len, d]`` frames) over the data axis, runs the
    executor and the optimizer on every local rank (one ``mesh.run``) and
    returns the first local rank's metrics and stats (``loss`` and
    ``gnorm`` are reduced over every rank: the same on each).
    """
    if mesh is None:
        mesh = make_mesh(data, stages, device=resolve_device(str(device)))
    elif mesh.shape != {"data": data, "model": stages}:
        raise ValueError(f"a mesh {mesh.shape} for data {data} x {stages} "
                         f"stages")
    device = mesh.device
    if cfg is None:
        cfg = (registry.reduced_config(arch, num_layers=layers)
               if reduced else registry.get_arch(arch))
    model = build(cfg, num_stages=stages)
    if init_params is None:
        stage_params, io_params = rank_params(model, mesh, seed=0,
                                              device=device)
    else:
        stage_params, io_params = init_params(model, mesh, device)
    first = mesh.local_ranks[0]
    partition = partition_for(model, stage_params[first], io_params[first])

    spec = PipelineSpec(stages, microbatches,
                        split_backward=(schedule == "zb"))
    table = schedules.BUILDERS[schedule](spec)
    global_tokens = data * microbatches * mb_rows * seq
    # an enc-dec config's encoder frames: ``seq`` per row, the length that
    # ``synth_batch`` makes (the reference's launcher passes none)
    opts = ExecOptions(**{
        "mb_rows": mb_rows, "seq_len": seq,
        "enc_len": seq if cfg.encoder_layers else 0,
        "loss_scale": 1.0 / global_tokens, **(exec_options or {})})
    exec_fn, batch_specs = make_train_fn(model, table, mesh, opts, partition)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=20, total_steps=total_steps)
    opt_init, opt_update = make_optimizer(model, mesh, partition, opt_cfg)
    opt_state = mesh.run(opt_init, mesh.per_rank(
        lambda r: (stage_params[r], io_params[r])))

    def rank_step(sp, io, opt, batch, step):
        metrics, grad_shards, expert_grads = exec_fn(sp, io, batch)
        stats = opt_update(sp, io, opt, grad_shards, expert_grads, step)
        return {**metrics, **stats}

    def train_step(batch: dict, step: int) -> dict:
        shards = shard_batch(mesh, batch, batch_specs)
        out = mesh.run(rank_step, mesh.per_rank(lambda r: (
            stage_params[r], io_params[r], opt_state[r], shards[r], step)))
        return out[first]

    return dict(
        cfg=cfg, model=model, mesh=mesh, table=table, spec=spec,
        stage_params=stage_params, io_params=io_params,
        opt_state=opt_state, train_step=train_step,
        batch_size=data * microbatches * mb_rows, seq=seq,
        partition=partition, exec_fn=exec_fn, batch_specs=batch_specs,
        opts=opts, opt_cfg=opt_cfg,
    )


def _state_leaves(sp, io, opt: dict) -> list[torch.Tensor]:
    """A rank's stage parameters, io parameters (``io`` None: left out) and
    ZeRO-1 state, in one order on every rank: what a table checkpoint moves
    between processes."""
    out = list(sp.parameters()) + ([] if io is None else list(io.parameters()))
    return out + [opt[kind][k][n] for kind in ("shards", "experts")
                  for k in sorted(opt[kind]) for n in sorted(opt[kind][k])]


class _HostModule:
    """Another rank's parameters on this host, by name, for the conversions
    to the global layout (which read ``named_parameters``)."""

    def __init__(self, names, values):
        self._items = list(zip(names, values, strict=True))

    def named_parameters(self):
        return iter(self._items)

    def parameters(self):
        return (v for _, v in self._items)


def _gather_ranks(t: dict):
    """Every rank's stage parameters and ZeRO-1 state on rank 0's host,
    and rank 0's io parameters (the checkpoint reads no other rank's):
    ``(stage_params, io_params, opt_state)`` lists by rank on rank 0, None
    on the others.  Every leaf travels as a host tensor of its dtype (bf16
    as bf16; the conversion widens it) through ``ProcessMesh.move``, rank
    by rank: no device holds another rank's state."""
    mesh = t["mesh"]
    (me,) = mesh.local_ranks
    sp, opt = t["stage_params"][me], t["opt_state"][me]
    mine = _state_leaves(sp, None, opt)
    n_sp = len(list(sp.parameters()))
    got = [[mesh.move(x.detach().to("cpu", copy=True) if r == me else None,
                      src=r, dst=0) for x in mine] for r in range(mesh.size)]
    if me != 0:
        return None
    names = [n for n, _ in sp.named_parameters()]
    stage_params, opt_state = [], []
    for leaves in got:
        stage_params.append(_HostModule(names, leaves[:n_sp]))
        it = iter(leaves[n_sp:])
        opt_state.append({kind: {k: {n: next(it) for n in sorted(opt[kind][k])}
                                 for k in sorted(opt[kind])}
                          for kind in ("shards", "experts")})
    io = _HostModule([n for n, _ in t["io_params"][0].named_parameters()],
                     [p.detach().to("cpu", copy=True)
                      for p in t["io_params"][0].parameters()])
    return stage_params, [io] + [None] * (mesh.size - 1), opt_state


def _table_ckpt_tree(t: dict, ranks: tuple | None = None) -> dict:
    """The reference's table checkpoint: stacked stage params, io params
    and the global ZeRO-1 state (numpy), of ``ranks`` (``(stage_params,
    io_params, opt_state)`` lists by rank: on a mesh of processes what
    :func:`_gather_ranks` brings rank 0) or the trainer's own."""
    sp, io, opt = ranks or (t["stage_params"], t["io_params"],
                            t["opt_state"])
    sp_tree, io_tree = rank_params_to_reference(t["model"], t["mesh"], sp,
                                                io)
    return {"stage_params": sp_tree, "io_params": io_tree,
            "opt_state": zero1_state_to_reference(
                t["model"], t["mesh"], t["partition"], opt)}


def _table_layout(t: dict) -> dict:
    """The restore target of a table checkpoint: the global tree's
    ``meta`` tensors, from what every process knows: each stage's module
    allocated on the ``meta`` device and this process's ZeRO-1 state.
    Every stage must have this rank's parameter shapes, so that ZeRO-1's
    ``[S, dp * n]`` leaves have one ``n``."""
    model, mesh = t["model"], t["mesh"]
    me = mesh.local_ranks[0]
    stages = [model.init_stage_params(s, seed=None, device="meta",
                                      data_size=mesh.shape["data"])
              for s in range(model.num_stages)]
    mine = [p.shape for p in t["stage_params"][me].parameters()]
    for s, m in enumerate(stages):
        if [p.shape for p in m.parameters()] != mine:
            raise ValueError(f"stage {s}'s parameters have other shapes "
                             f"than rank {me}'s: no one ZeRO-1 layout")
    sp_meta, io_meta = rank_reference_layout(
        model, mesh, [stages[mesh.coords(r)["model"]]
                      for r in range(mesh.size)],
        [model.init_io_params(seed=None, device="meta")] * mesh.size)
    return {"stage_params": sp_meta, "io_params": io_meta,
            "opt_state": zero1_state_layout(model, mesh, t["partition"],
                                            t["opt_state"][me])}


def _table_restore(t: dict, store: CheckpointStore | None, step: int
                   ) -> float:
    """Load checkpoint ``step`` into the trainer's per-rank state; returns
    the seconds its read took (~0 where it read nothing).  On a mesh of
    processes only rank 0 holds ``store`` and reads it; every rank takes
    part (:func:`_move_restored`)."""
    model, mesh, device = t["model"], t["mesh"], t["mesh"].device
    target = None if store is None else _table_layout(t)
    t0 = time.perf_counter()
    state = None if store is None else store.restore(step, target)[0]
    read = time.perf_counter() - t0
    if len(mesh.local_ranks) != mesh.size:
        _move_restored(t, state)
        return read
    sp, io = rank_params_from_reference(model, mesh, state["stage_params"],
                                        state["io_params"], device)
    opt = zero1_state_from_reference(
        model, mesh, t["partition"], state["opt_state"], device,
        expert_dtype=t["opt_cfg"].expert_state_dtype)
    with torch.no_grad():
        for mods, new in ((t["stage_params"], sp), (t["io_params"], io)):
            for m, n in zip(mods, new):
                for p, q in zip(m.parameters(), n.parameters()):
                    p.copy_(q)
    for r, st in enumerate(opt):
        t["opt_state"][r].clear()
        t["opt_state"][r].update(st)
    return read


@torch.no_grad()
def _move_restored(t: dict, state: dict | None) -> None:
    """A mesh of processes: rank 0 (``state``: the restored global tree on
    its host) builds each rank's own parameters and ZeRO-1 state on its
    host, one rank at a time, and moves them to that rank
    (``ProcessMesh.move``), which copies them into its own; the other
    ranks pass None."""
    model, mesh = t["model"], t["mesh"]
    (me,) = mesh.local_ranks
    mine = _state_leaves(t["stage_params"][me], t["io_params"][me],
                         t["opt_state"][me])
    for r in range(mesh.size):
        theirs = None
        if state is not None:
            sp, io = rank_params_from_reference(
                model, mesh, state["stage_params"], state["io_params"],
                "cpu", ranks=(r,))
            opt = zero1_state_from_reference(
                model, mesh, t["partition"], state["opt_state"], "cpu",
                expert_dtype=t["opt_cfg"].expert_state_dtype, ranks=(r,))
            theirs = _state_leaves(sp[r], io[r], opt[r])
            if len(theirs) != len(mine):
                raise ValueError(f"rank {r}: {len(theirs)} leaves restored "
                                 f"for {len(mine)}")
        for j, x in enumerate(mine):
            got = mesh.move(None if theirs is None else theirs[j], src=0,
                            dst=r, like=x)
            if got is None:
                continue
            if got.shape != x.shape or got.dtype != x.dtype:
                raise ValueError(f"rank {r}: a restored leaf {got.dtype} "
                                 f"{tuple(got.shape)} for {x.dtype} "
                                 f"{tuple(x.shape)}")
            x.copy_(got)


def train_table(args, *, cfg=None, step_hook=None) -> TrainRun:
    """Train with the schedule-table executor and ZeRO-1 AdamW on a
    ``(devices // stages) × stages`` mesh of ranks (port of the
    reference's ``--runtime table`` loop).  ``cfg`` as
    :func:`build_trainer`'s; ``step_hook(step, trainer)`` runs after each
    step and its checkpoint's gather (``trainer``: the
    :func:`build_trainer` dict, its per-rank state after the step).  With
    ``--procs`` the ranks are processes (:func:`train_procs`)."""
    if args.arch is None:
        args.arch = "deepseek-7b"
    data = args.devices // args.stages
    if data < 1:
        raise SystemExit(f"--runtime table needs --devices >= --stages "
                         f"({args.devices} < {args.stages})")
    if args.procs:
        return train_procs(args, cfg=cfg)
    return _table_loop(args, None, cfg, step_hook)


def _table_loop(args, mesh, cfg, step_hook) -> TrainRun:
    """The table runtime's loop on ``mesh`` (None: the thread mesh) for
    this process's ranks; the rank-0 process prints."""
    data = args.devices // args.stages
    t = build_trainer(
        args.arch, data=data, stages=args.stages, layers=args.layers,
        mb_rows=args.mb_rows, microbatches=args.microbatches, seq=args.seq,
        schedule=args.schedule, reduced=not args.full_size, lr=args.lr,
        total_steps=args.steps, device=args.device, cfg=cfg, mesh=mesh)
    mesh = t["mesh"]
    say = print if mesh.local_ranks[0] == 0 else (lambda *a, **k: None)
    say(f"arch={args.arch} N={t['cfg'].param_count():,} params  "
        f"mesh=({data}×{args.stages})  schedule={args.schedule}  "
        f"bubble={t['table'].bubble_fraction():.2f}  device={mesh.device}"
        + (f"  {mesh!r}" if args.procs else ""))
    run = TrainRun(losses=[], step_seconds=[], trainer=t)
    rss = _RssPeak()
    try:
        _table_steps(args, t, run, rss, step_hook, say)
    finally:
        rss.close()
        run.peak_rss_bytes = rss.peak
    return run


def _table_steps(args, t: dict, run: TrainRun, rss, step_hook, say) -> None:
    """The table loop's checkpoint resume, steps and saves, into ``run``."""
    mesh = t["mesh"]
    # on a mesh of processes rank 0 alone reads and writes the directory
    # (under torchrun the others may not see it); every rank takes part
    procs = len(mesh.local_ranks) != mesh.size
    store = (CheckpointStore(args.ckpt_dir)
             if args.ckpt_dir and mesh.local_ranks[0] == 0 else None)
    ckpt_every = _or(args.ckpt_every, 10)
    start_step = 0
    if args.ckpt_dir and args.resume:
        latest = store.latest_step() if store else None
        latest = mesh.share(latest) if procs else latest
        if latest is not None:
            start_step = latest
            t0 = time.perf_counter()
            read = _table_restore(t, store, start_step)
            run.ckpt_log.append({"op": "resume", "step": start_step,
                                 "seconds": time.perf_counter() - t0,
                                 "read_seconds": read,
                                 "peak_rss_bytes": rss.peak})
            print(f"{f'rank {mesh.local_ranks[0]}: ' if procs else ''}"
                  f"resumed from step {start_step} in "
                  f"{run.ckpt_log[-1]['seconds']:.2f} s ("
                  + (f"read in {read:.2f} s, " if store else "")
                  + f"peak host RSS {rss.peak / 2**30:.2f} GiB)")

    def make(step):
        return synth_batch(t["cfg"], t["batch_size"], t["seq"],
                           seed=args.seed, step=step,
                           enc_len=t["opts"].enc_len)

    if args.procs:
        _warm_up(t, make(start_step))
    it = PrefetchIterator(make, start_step=start_step)
    mesh.sync()  # every process built its ranks: step 0 starts together
    try:
        for _ in range(args.steps - start_step):
            step, arrays = next(it)
            mesh.reset_counts()
            t0 = time.perf_counter()
            m = t["train_step"](_device_batch(arrays, mesh.device), step)
            loss = float(m["loss"])  # the step's one device sync
            dt = time.perf_counter() - t0
            run.collectives.append(mesh.counts_over_ranks())
            run.losses.append(loss)
            run.step_seconds.append(dt)
            run.gnorms.append(float(m["gnorm"]))
            say(f"step {step:4d}  loss {loss:8.4f}  gnorm "
                f"{run.gnorms[-1]:7.3f}  lr {m['lr']:.2e}  {dt*1e3:7.1f} ms")
            if args.ckpt_dir and (step + 1) % ckpt_every == 0:
                t1 = time.perf_counter()
                ranks = _gather_ranks(t) if procs else None  # every rank
                moved = time.perf_counter() - t1
                tree = (None if procs and ranks is None
                        else _table_ckpt_tree(t, ranks))
                del ranks
                entry = {"op": "save", "step": step + 1,
                         "move_seconds": moved,
                         "gather_seconds": time.perf_counter() - t1,
                         "peak_rss_bytes": rss.peak}
                run.ckpt_log.append(entry)
                if store:
                    _landed(store, run, say)  # the previous save's write
                    store.save(step + 1, tree,
                               meta={"arch": args.arch, "step": step + 1},
                               asynchronous=True)
                del tree
                entry["seconds"] = time.perf_counter() - t1
            if step_hook is not None:
                step_hook(step, t)
        if store:
            _landed(store, run, say)
    finally:
        it.close()


def _landed(store: CheckpointStore, run: TrainRun, say) -> None:
    """Wait for the store's pending write (its error raises here) and note
    its seconds and bytes in the save's ``ckpt_log`` entry."""
    store.wait()
    done = store.last_write
    if done is None:
        return
    store.last_write = None
    (entry,) = [e for e in run.ckpt_log
                if e["op"] == "save" and e["step"] == done["step"]]
    entry["write_seconds"] = done["seconds"]
    entry["bytes"] = _step_bytes(store, done["step"])
    say(f"checkpoint step {done['step']}: {entry['bytes']:,} bytes, "
        f"gathered in {entry['gather_seconds']:.2f} s (moves "
        f"{entry['move_seconds']:.2f} s), written in {done['seconds']:.2f} "
        f"s -> {store.dir}")


def _rss() -> int:
    """This process's resident host memory now (``VmRSS``), in bytes."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("/proc/self/status has no VmRSS")


class _RssPeak:
    """This process's peak resident host memory since it was made: ``VmRSS``
    sampled every ``every`` s on a thread (some kernels have no
    ``VmHWM``, and ``getrusage``'s ``ru_maxrss`` of a spawned process
    starts at its parent's peak)."""

    def __init__(self, every: float = 0.05):
        self.peak = _rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, args=(every,),
                                        daemon=True)
        self._thread.start()

    def _sample(self, every: float) -> None:
        while not self._stop.wait(every):
            self.peak = max(self.peak, _rss())

    def close(self) -> None:
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _rss())


def _warm_up(t: dict, arrays: dict) -> None:
    """``--procs``: each rank runs its stage's forward and backward once on
    the first microbatch of its shard of ``arrays``, before the timed
    steps, and keeps nothing.  A process pays its own first-call costs
    (CUDA modules loaded on first launch, cuBLAS plans: ~11 s a process at
    gpt3 full width on an H100), all processes at once; in step 0 the
    pipeline would add them up stage after stage (~45 s at 1 x 4).  An
    exchanging MoE stage exchanges here too, with every rank of its data
    group in the same order."""
    mesh, opts, cfg = t["mesh"], t["opts"], t["cfg"]
    fns = stage_fns(t["model"], mesh, opts)
    shards = shard_batch(mesh, _device_batch(arrays, mesh.device),
                         t["batch_specs"])

    def warm(sp, io, shard):
        stage = mesh.axis_index("model")
        bm = microbatch(shard, 0, opts.mb_rows)
        x = torch.zeros((opts.mb_rows, fns.eff_seq, cfg.d_model),
                        dtype=cfg.dtype, device=mesh.device)
        fns.forward(stage)(sp, io, None if stage == 0 else x, bm)
        fns.backward(stage)(sp, io, None if stage == 0 else x, x, bm)

    mesh.run(warm, mesh.per_rank(lambda r: (
        t["stage_params"][r], t["io_params"][r], shards[r])))


def _rank_report(run: TrainRun) -> TrainRun:
    """What a process of a ``--procs`` run sends back: its rank's run
    (losses, gnorms, step seconds, collectives over every rank), its K1/K2
    launches and peak device memory, and its replicated stage leaves'
    digests (the replica check across processes)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.procs import leaf_digests

    t = run.trainer
    mesh = t["mesh"]
    (r,) = mesh.local_ranks
    cuda = mesh.device.type == "cuda"
    run.trainer = None
    run.ranks = [{
        "rank": r, "coords": mesh.coords(r), "launches": ops.launch_counts(),
        "peak_bytes": torch.cuda.max_memory_allocated(mesh.device)
        if cuda else 0, "peak_rss_bytes": run.peak_rss_bytes,
        "digests": leaf_digests(t["partition"], t["stage_params"][r])}]
    return run


def _train_world(mesh, args, cfg) -> TrainRun:
    """One process of ``--procs``: the table loop on its rank."""
    return _rank_report(_table_loop(args, mesh, cfg, None))


def train_procs(args, *, cfg=None) -> TrainRun:
    """``--runtime table --procs``: the table loop with one process per
    rank (``launch/procs.ProcessMesh``, ``--dist-backend``): spawned here
    (``procs.spawn_world``), or this process's rank when ``torchrun`` set
    the world.  Returns rank 0's run (losses, gnorms, step seconds, each
    step's collectives summed over the ranks) with every rank's launches,
    peak memory and digests in ``ranks``.  Runs on the GPU unless ``--device
    cpu`` was given; the parent frees its CUDA cache before spawning."""
    from repro_torch.launch import procs

    resolve_device(args.device)
    backend = args.dist_backend or "gloo"
    shape = {"data": args.devices // args.stages, "model": args.stages}
    if procs.in_world():
        mesh = procs.join_world(shape, device=args.device, backend=backend)
        try:
            return _train_world(mesh, args, cfg)
        finally:
            procs.leave_world()
    procs.check_backend(backend, args.device, args.devices)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    print(f"--procs: {args.devices} processes, backend {backend}"
          + ("; every payload staged through host memory (gloo on CUDA "
             "tensors)" if backend == "gloo"
             and torch.device(args.device).type == "cuda" else ""))
    # each process with this one's intra-op threads: on the CPU the bits
    # of a GEMM may depend on them
    runs = procs.spawn_world(_train_world, (args, cfg), args.devices,
                             shape=shape, device=args.device,
                             backend=backend,
                             threads=torch.get_num_threads())
    run = runs[0]
    run.ranks = [rr.ranks[0] for rr in runs]
    return run


# ---------------------------------------------------------------------------
# multimodal DAG workload (--workload multimodal)
# ---------------------------------------------------------------------------
def _multimodal_stage_split(stages: int) -> tuple[int, int]:
    """Split a total stage budget into (encoder, LM) branch depths.

    Total stages = encoder branch + 1 text frontend + LM chain; the LM
    chain (fusion + decoder) gets at least as many stages as the encoder.
    """
    if stages < 3:
        raise SystemExit(
            "--workload multimodal needs --stages >= 3 "
            "(encoder branch + text frontend + fusion/LM chain)")
    enc = max(1, (stages - 1) // 2)
    return enc, stages - 1 - enc


def _device_mm_batch(arrays: dict, device) -> dict:
    """numpy multimodal batch -> device tensors; the valid encoder lengths
    stay host integers (they set shapes and masks, not values)."""
    return {"tokens": torch.from_numpy(arrays["tokens"]).long().to(device),
            "labels": torch.from_numpy(arrays["labels"]).long().to(device),
            "enc_embeds": [torch.from_numpy(e).to(device)
                           for e in arrays["enc_embeds"]],
            "enc_lens": [int(n) for n in arrays["enc_lens"]]}


def train_multimodal(args, *, model=None, init_params=None,
                     step_hook=None) -> TrainRun:
    """Train the branch+fusion multimodal DAG pipeline on the actor runtime.

    ``--substrate thread`` (default) drives the real encoder / text /
    fusion / LM stage callables with thread-per-stage actors, including
    variable-length vision/audio microbatches padded to buckets and
    (optionally) BFW split backward; AdamW runs over the accumulated
    per-stage grads.  ``--substrate sim`` runs the same DAG task graph
    through the virtual-clock actor substrate on the DES cost model of the
    full-size topology and returns the makespans.

    ``model`` replaces the ``MultimodalModel`` built from the flags (a
    caller's other ``multimodal_config`` keywords); ``init_params(model,
    device) -> stage modules`` replaces the seeded init (the parity tests
    load the reference's weights through it); ``step_hook(step)`` runs
    after each step.
    """
    if args.arch is None:
        args.arch = "qwen2-vl-2b"
    if args.arch not in MULTIMODAL_ARCHS:
        raise SystemExit(
            f"--workload multimodal needs a multimodal arch, not "
            f"{args.arch!r}; registered: {sorted(MULTIMODAL_ARCHS)}")
    if args.replay_trace:
        raise SystemExit("--replay-trace is not supported for the "
                         "multimodal workload yet; record works")
    enc_stages, lm_stages = _multimodal_stage_split(args.stages)
    if model is None:
        model = multimodal_model(
            args.arch, enc_stages=enc_stages, lm_stages=lm_stages,
            text_seq=args.seq, reduced=not args.full_size,
            num_layers=args.layers)
    cfg = model.cfg
    split = args.split_backward or args.schedule == "zb"
    hint = HintKind(args.hint)
    chaos = parse_chaos(args.chaos) if args.chaos else None
    spec = cfg.spec(args.microbatches, split_backward=split)
    if args.schedule == "rrfp":
        mode, fixed = "hint", "1f1b"
        if split != (hint == HintKind.BFW):
            raise SystemExit(
                "--hint bfw and --split-backward go together (the BFW hint "
                "needs W tasks, which only exist under split backward)")
    elif args.schedule in ("1f1b", "gpipe", "zb"):
        mode, fixed = "precommitted", args.schedule
        if (args.schedule == "zb") != split:
            raise SystemExit("--schedule zb is the split-backward baseline; "
                             "1f1b/gpipe are fused-only")
    else:
        raise SystemExit(
            f"--workload multimodal supports schedules rrfp/1f1b/gpipe/zb, "
            f"not {args.schedule!r}")
    metrics_reg = _obs_registry(args)
    acfg = ActorConfig(mode=mode, hint=hint, fixed_order=fixed,
                       w_defer_cap=args.w_defer_cap,
                       deadlock_timeout=args.deadlock_timeout,
                       chaos=chaos, seed=args.seed, metrics=metrics_reg)
    print(f"arch={args.arch} workload=multimodal modality={cfg.modality}  "
          f"substrate={args.substrate}  mode={mode}  hint={hint.value}  "
          f"split_backward={split}\n"
          f"  DAG: encoder x{cfg.enc_stages} | text | fusion + LM x"
          f"{cfg.lm_stages - 1}  edges={cfg.stage_graph().edges}  "
          f"buckets={cfg.buckets}")
    run = TrainRun(losses=[], step_seconds=[])

    if args.substrate == "sim":
        # cost model from the FULL-SIZE arch (simulated timing reflects the
        # real widths even when the thread path runs reduced)
        cost_cfg = multimodal_config(
            args.arch, enc_stages=enc_stages, lm_stages=lm_stages,
            text_seq=max(args.seq, 512), mean_enc_tokens=2048,
            buckets=(1024, 2048, 4096), reduced=False)
        costs = multimodal_dag_costs(cost_cfg, mb_rows=args.mb_rows,
                                     seed=args.seed)
        for step in range(args.steps):
            record_this = _obs_record_step0(args, step)
            cfg_i = dataclasses.replace(acfg, seed=args.seed + 1000 * step,
                                        record_trace=record_this)
            driver = ActorDriver(spec, costs, cfg_i)
            res = driver.run()
            if record_this:
                run.trace = _save_trace(args, driver, step, None)
            bd = res.breakdown()
            run.makespans.append(res.makespan)
            print(f"step {step:4d}  makespan {res.makespan*1e3:8.2f} ms  "
                  f"compute {bd['compute']*1e3:7.2f} ms  "
                  f"blocking {bd['blocking']*1e3:7.2f} ms")
        _obs_finish(args, metrics_reg, run.trace)
        return run

    # ---- thread substrate: real DAG training on the device -------------
    device = resolve_device(args.device)
    if init_params is None:
        params = model.init_stage_params(seed=args.seed, device=device)
    else:
        params = init_params(model, device)
    tokens = args.microbatches * args.mb_rows * cfg.text_seq
    fns = MultimodalStageFns(model, MultimodalStageOptions(
        mb_rows=args.mb_rows, loss_scale=1.0 / tokens))
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps),
                          total_steps=max(args.steps, 1))
    flat = [t for sp in params for t in sp.parameters()]
    mstate = [torch.zeros(t.shape, dtype=torch.float32, device=device)
              for t in flat]
    vstate = [torch.zeros(t.shape, dtype=torch.float32, device=device)
              for t in flat]
    apply_update = make_host_update(opt_cfg)
    print(f"  N={sum(t.numel() for t in flat):,} params  stages="
          f"{cfg.num_stages}  microbatches={args.microbatches}  "
          f"device={device}")
    for step in range(args.steps):
        batch = _device_mm_batch(
            multimodal_batch(cfg, args.microbatches, args.mb_rows,
                             seed=args.seed, step=step), device)
        programs = [
            MultimodalStageProgram(fns, s, params[s], batch,
                                   split_backward=split)
            for s in range(cfg.num_stages)
        ]
        t0 = time.perf_counter()
        record_this = _obs_record_step0(args, step)
        driver = ActorDriver(
            spec, None,
            dataclasses.replace(acfg, record_trace=True) if record_this
            else acfg)
        result = driver.run_threaded(list(programs))
        grads = [g for p in programs for g in p.d_params]
        lr = apply_update(flat, grads, mstate, vstate, step)
        # one device sync per step: the programs keep the loss on device
        loss = float(sum(p.loss_acc for p in programs)) / tokens
        dt = time.perf_counter() - t0
        run.losses.append(loss)
        run.step_seconds.append(dt)
        if record_this:
            run.trace = _save_trace(args, driver, step, loss)
        bd = result.breakdown()
        print(f"step {step:4d}  loss {loss:8.4f}  lr {lr:.2e}  "
              f"{dt*1e3:7.1f} ms  makespan {result.makespan*1e3:7.1f} ms  "
              f"blocking {bd['blocking']*1e3:6.1f} ms")
        if step_hook is not None:
            step_hook(step)
    _obs_finish(args, metrics_reg, run.trace)
    return run


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="readiness-driven actor training (PyTorch port)")
    ap.add_argument("--arch", default=None,
                    help="architecture id (registry.ARCHS; default "
                         "deepseek-7b, or qwen2-vl-2b for --workload "
                         "multimodal)")
    ap.add_argument("--runtime", default="actor", choices=("table", "actor"),
                    help="actor: thread-per-stage readiness-driven runtime "
                         "(default); table: the schedule-table SPMD "
                         "executor with ZeRO-1 AdamW on a (data x model) "
                         "mesh of --devices ranks (the reference's default)")
    ap.add_argument("--devices", type=int, default=8,
                    help="--runtime table: ranks of the mesh; data = "
                         "devices // stages")
    ap.add_argument("--procs", action="store_true",
                    help="--runtime table: one process per rank "
                         "(torch.distributed; spawned here, or the world "
                         "that torchrun set) instead of one thread each")
    ap.add_argument("--dist-backend", default=None, choices=("gloo", "nccl"),
                    help="--procs: gloo (default; CUDA payloads staged "
                         "through host memory) or nccl (one card per rank)")
    ap.add_argument("--workload", default="language",
                    choices=("language", "multimodal"),
                    help="language: linear-chain LM pipeline (default); "
                         "multimodal: branch+fusion DAG pipeline (encoder "
                         "branch || text frontend -> fusion -> LM chain) — "
                         "archs qwen2-vl-2b / seamless-m4t-large-v2")
    ap.add_argument("--substrate", default="thread",
                    choices=("thread", "sim"),
                    help="multimodal workload: thread = real stage "
                         "callables (default); sim = virtual-clock actor "
                         "substrate on the DAG cost model")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs CUDA")
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--mb-rows", type=int, default=1)
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--schedule", default="rrfp", choices=SCHEDULES)
    ap.add_argument("--hint", default="bf",
                    choices=[h.value for h in HintKind],
                    help="--schedule rrfp: hint order for ready-set "
                         "arbitration (bfw needs --split-backward)")
    ap.add_argument("--split-backward", action="store_true",
                    help="BFW decomposition — B computes dX only, deferrable "
                         "W tasks accumulate weight grads")
    ap.add_argument("--w-defer-cap", type=int, default=4,
                    help="split backward: max outstanding un-executed W "
                         "tasks per stage (0 = unbounded)")
    ap.add_argument("--deadlock-timeout", type=float, default=120.0,
                    help="seconds of stage starvation before aborting with "
                         "DeadlockError")
    ap.add_argument("--chaos", default=None,
                    help="fault-injection spec — a level (C0..C3) and/or "
                         "key=value overrides, e.g. 'C2'")
    ap.add_argument("--record-trace", default=None, metavar="PATH",
                    help="record the step-0 event trace to PATH")
    ap.add_argument("--replay-trace", default=None, metavar="PATH",
                    help="re-execute the per-stage dispatch order recorded "
                         "in PATH")
    ap.add_argument("--metrics-report", action="store_true",
                    help="collect runtime telemetry (repro_torch.obs "
                         "metrics shards) and print the end-of-run "
                         "per-stage summary table")
    ap.add_argument("--export-perfetto", default=None, metavar="PATH",
                    help="export the first step's trace as Chrome "
                         "trace-event JSON (open at ui.perfetto.dev); "
                         "implies recording that step")
    ap.add_argument("--explain", action="store_true",
                    help="print the critical-path health report of the "
                         "first step's trace (binding bottleneck, what-if "
                         "ranking, stragglers, bubble cross-check); implies "
                         "recording that step")
    ap.add_argument("--adaptive", action="store_true",
                    help="--schedule rrfp: close the schedule loop — "
                         "accumulate measured per-stage timings, "
                         "re-synthesize the hint table every "
                         "--resynth-every steps, and swap it at the "
                         "iteration boundary when the drift detector fires")
    ap.add_argument("--resynth-every", type=int, default=None,
                    help="--adaptive: drift-detector cadence in steps "
                         "(default 1)")
    ap.add_argument("--swap-threshold", type=float, default=None,
                    help="--adaptive: required predicted-makespan "
                         "improvement factor (active/candidate) before a "
                         "check counts toward the swap hysteresis "
                         "(default 1.03)")
    ap.add_argument("--recover", action="store_true",
                    help="treat a fail-stop fault (--chaos fail_stage=S"
                         "[,fail_kind=kill|permanent_stall,fail_after=K]) "
                         "as recoverable — detect the death, fence the "
                         "stale epoch, respawn the stage from the latest "
                         "checkpoint (--ckpt-dir) or the live step-start "
                         "params, and replay its in-flight microbatches")
    ap.add_argument("--hb-deadline", type=float, default=2.0,
                    help="seconds without stage progress before a "
                         "permanent stall is declared dead")
    ap.add_argument("--full-size", action="store_true")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (the reference's npz format)")
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="checkpoint cadence in steps (default 10; under "
                         "--recover default 1, so the respawn path restores "
                         "exactly the params the failed step started from)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in --ckpt-dir")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def _check_flags(args) -> None:
    """The reference's guards, and a stop where the reference would
    silently ignore a flag."""
    if args.recover and args.workload != "language":
        raise SystemExit("--recover drives the thread-per-stage actor "
                         "runtime; add --runtime actor (language workload)")
    if args.adaptive and args.workload != "language":
        raise SystemExit("--adaptive drives the thread-per-stage actor "
                         "runtime; add --runtime actor (language workload)")
    ckpt_flags = [f for f, on in (("--ckpt-dir", args.ckpt_dir),
                                  ("--ckpt-every", args.ckpt_every is not None),
                                  ("--resume", args.resume)) if on]
    if ckpt_flags and args.workload == "multimodal":
        raise SystemExit(f"{'/'.join(ckpt_flags)}: the multimodal workload "
                         f"keeps no checkpoints (the reference's "
                         f"train_multimodal never reads these flags)")
    for flag, on in (("--ckpt-every", args.ckpt_every is not None),
                     ("--resume", args.resume)):
        if on and not args.ckpt_dir:
            raise SystemExit(f"{flag} needs --ckpt-dir (the reference "
                             f"ignores it without one)")
    for flag, value in (("--resynth-every", args.resynth_every),
                        ("--swap-threshold", args.swap_threshold)):
        if value is not None and not args.adaptive:
            raise SystemExit(f"{flag} tunes --adaptive (the reference "
                             f"ignores it without)")


def _check_procs_flags(args) -> None:
    """``--procs``: the table runtime only, without the actor-runtime
    flags."""
    if args.dist_backend and not args.procs:
        raise SystemExit("--dist-backend picks the backend of --procs")
    if not args.procs:
        return
    if args.runtime != "table" or args.workload != "language":
        raise SystemExit("--procs runs the ranks of --runtime table as "
                         "processes (language workload)")
    for flag, on in (("--adaptive", args.adaptive), ("--chaos", args.chaos),
                     ("--recover", args.recover)):
        if on:
            raise SystemExit(
                f"{flag} under --procs: an actor-runtime flag; --procs runs "
                f"the ranks of the table runtime as processes")


def _check_table_flags(args) -> None:
    """``--runtime table``: the reference's guards on the telemetry flags,
    and a stop for the other actor-runtime flags (which the reference
    ignores under ``table``)."""
    if args.metrics_report or args.export_perfetto or args.explain:
        raise SystemExit("--metrics-report / --export-perfetto / --explain "
                         "instrument the actor runtime; add --runtime actor "
                         "(or --workload multimodal)")
    if args.recover:
        raise SystemExit("--recover drives the thread-per-stage actor "
                         "runtime; add --runtime actor (language workload)")
    if args.adaptive:
        raise SystemExit("--adaptive drives the thread-per-stage actor "
                         "runtime; add --runtime actor (language workload)")
    actor_only = [f for f, on in (
        ("--split-backward", args.split_backward), ("--chaos", args.chaos),
        ("--record-trace", args.record_trace),
        ("--replay-trace", args.replay_trace)) if on]
    if actor_only:
        raise SystemExit(f"{'/'.join(actor_only)}: actor-runtime flags; "
                         f"--runtime table runs the table of --schedule "
                         f"(zb is its split-backward table)")


def main(argv=None) -> TrainRun:
    args = parser().parse_args(argv)
    if args.workload == "multimodal":
        args.runtime = "actor"  # the DAG only runs on the actor runtime
    _check_procs_flags(args)
    if args.runtime == "table":
        _check_table_flags(args)
    _check_flags(args)
    if args.workload == "multimodal":
        return train_multimodal(args)
    if args.runtime == "table":
        return train_table(args)
    return train_actor(args)


if __name__ == "__main__":
    main()
