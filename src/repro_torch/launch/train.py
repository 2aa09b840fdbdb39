"""Training driver of the port: readiness-driven actor training.

    PYTHONPATH=src python -m repro_torch.launch.train --runtime actor \
        --arch paper-gpt3-large --full-size --stages 4 --microbatches 8 \
        --seq 2048 --steps 3

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
without ``--adaptive``), the port stops and says so.  ``--runtime table``
moves with the multi-device slice.

Runs on the GPU unless ``--device cpu`` is given; without CUDA it raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Any

import torch

from repro_torch.ckpt.store import CheckpointStore
from repro_torch.configs import registry
from repro_torch.core.costs import CostModel
from repro_torch.core.hints import HintKind
from repro_torch.core.taskgraph import PipelineSpec
from repro_torch.data.synthetic import multimodal_batch, synth_batch
from repro_torch.models.build import build
from repro_torch.models.convert import (
    params_from_reference,
    params_to_reference,
    reference_layout,
    state_from_reference,
    state_to_reference,
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
from repro_torch.obs import MetricsRegistry, export_perfetto
from repro_torch.obs.report import explain
from repro_torch.optim.adamw import AdamWConfig, make_host_update
from repro_torch.pipeline.stagefn import (
    ActorStageProgram,
    StageFnOptions,
    StageFns,
)
from repro_torch.runtime.adaptive import AdaptiveConfig, AdaptiveScheduler
from repro_torch.runtime.rrfp import ActorConfig, ActorDriver, Trace, parse_chaos
from repro_torch.runtime.straggler import StragglerMonitor

SCHEDULES = ("gpipe", "1f1b", "zb", "rrfp")

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
    #: (``op``, ``step``, ``seconds``, and ``bytes`` for a save)
    ckpt_log: list[dict] = dataclasses.field(default_factory=list)


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


def train_actor(args, *, init_params=None, step_hook=None) -> TrainRun:
    """Train with thread-per-stage actors dispatching real stage callables.

    Single process: stage s's parameters live with stage s's actor; AdamW
    runs over the accumulated per-stage grads.  ``init_params(model,
    device) -> (stage_modules, io_module)`` replaces the seeded init (the
    parity tests load the reference's weights through it); ``step_hook(step)``
    runs after each step (the profiler advances its schedule there).
    """
    device = resolve_device(args.device)
    if args.arch is None:
        args.arch = "deepseek-7b"
    cfg = (registry.reduced_config(args.arch, num_layers=args.layers)
           if not args.full_size else registry.get_arch(args.arch))
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
        batch = _device_batch(
            synth_batch(cfg, batch_size, args.seq, seed=args.seed, step=step),
            device)
        programs = [
            ActorStageProgram(fns, s, stage_params[s], io_params, batch,
                              split_backward=split)
            for s in range(args.stages)
        ]

        def respawn(s, programs=programs, batch=batch):
            # the stage's in-memory state died with it: rebuild its program
            # from the latest checkpoint (under --ckpt-every 1 that is
            # exactly the params this step started from) or, before the
            # first checkpoint, from the live step-start params (the update
            # runs in place only after the step)
            sp_r, io_r = stage_params[s], io_params
            if store is not None and store.latest_step() is not None:
                t0 = time.perf_counter()
                host, _ = store.restore_host(store.latest_step(),
                                             respawn_target)
                (sp_r,), io_r = params_from_reference(
                    model, host["params"]["sp"], host["params"]["io"],
                    device, stages=[s])
                run.ckpt_log.append({"op": "respawn", "stage": s,
                                     "step": store.latest_step(),
                                     "seconds": time.perf_counter() - t0})
                print(f"recover: stage {s} restored from checkpoint step "
                      f"{store.latest_step()}")
            programs[s] = ActorStageProgram(fns, s, sp_r, io_r, batch,
                                            split_backward=split)
            return programs[s]

        t0 = time.perf_counter()
        # recording costs lock traffic on the dispatch path: enable it only
        # for the step whose trace is actually kept
        record_this = _obs_record_step0(args, step, first=start_step)
        acfg_step = (dataclasses.replace(acfg, respawn=respawn)
                     if args.recover else acfg)
        if scheduler is not None:
            # iteration-boundary quiesce point: adopt the scheduler's
            # current table (HINT_SWAP events mark mid-run adoptions only)
            acfg_step = dataclasses.replace(
                acfg_step, hint_table=scheduler.table,
                hint_table_version=scheduler.version)
        driver = ActorDriver(
            spec, None,
            dataclasses.replace(acfg_step, record_trace=True) if record_this
            else acfg_step)
        result = driver.run_threaded(programs)
        grads = [g for p in programs for g in p.d_stage]
        d_io = list(programs[0].d_io)
        for p in programs[1:]:
            d_io = [a if b is None else b if a is None else a + b
                    for a, b in zip(d_io, p.d_io)]
        lr = apply_update(params, grads + d_io, mstate, vstate, step)
        # one device sync per step: the programs keep the loss on device
        loss = float(sum(p.loss_acc for p in programs)) / tokens
        dt = time.perf_counter() - t0
        run.losses.append(loss)
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
              f"{dt*1e3:7.1f} ms  makespan {result.makespan*1e3:7.1f} ms  "
              f"blocking {bd['blocking']*1e3:6.1f} ms"
              + ("  [replan]" if new_table is not None else "")
              + swap_note)
        if store and (step + 1) % ckpt_every == 0:
            t1 = time.perf_counter()
            store.save(step + 1, _ckpt_tree(model, stage_params, io_params,
                                            mstate, vstate),
                       meta={"arch": args.arch, "step": step + 1})
            nbytes = _step_bytes(store, step + 1)
            run.ckpt_log.append({"op": "save", "step": step + 1,
                                 "seconds": time.perf_counter() - t1,
                                 "bytes": nbytes})
            print(f"checkpoint step {step + 1}: {nbytes:,} bytes in "
                  f"{run.ckpt_log[-1]['seconds']:.2f} s -> {args.ckpt_dir}")
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
                         "(the port's only runtime so far)")
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


def main(argv=None) -> TrainRun:
    args = parser().parse_args(argv)
    if args.workload == "multimodal":
        args.runtime = "actor"  # the DAG only runs on the actor runtime
    if args.runtime == "table":
        raise SystemExit("--runtime table (the compiled schedule-table SPMD "
                         "executor) moves with the multi-device slice "
                         "(ROADMAP.md queue 1, 'Multi-device, last')")
    _check_flags(args)
    if args.workload == "multimodal":
        return train_multimodal(args)
    return train_actor(args)


if __name__ == "__main__":
    main()
