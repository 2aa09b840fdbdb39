"""Actor-runtime driver: builds the actors, pumps messages, records traces.

Two execution substrates behind one configuration:

* ``run()`` — :class:`~repro_torch.runtime.rrfp.transport.SimTransport` on a
  virtual clock.  Arrivals and completions are heap events; actors make
  every dispatch decision reactively (no schedule-table tick).  Compute and
  communication samples are keyed per task (common random numbers), so hint
  vs. precommitted runs on the same seed experience the same realized
  variability — the paper's one-schedule-two-consumption-modes contrast
  isolated from sampling noise.

* ``run_threaded(work_fn)`` — thread-per-stage actors over the
  :class:`~repro_torch.runtime.rrfp.transport.ThreadTransport`, executing real
  work callables (e.g. jitted stage functions from
  ``repro_torch.pipeline.stagefn``) on the wall clock.

Both return the DES engine's :class:`~repro_torch.core.engine.RunResult`, so
``benchmarks/``, the Theorem 6.1 bound checker and
``runtime.straggler`` consume actor traces unchanged.

Record / chaos / replay (the conformance machinery):

* ``ActorConfig.record_trace`` threads a
  :class:`~repro_torch.runtime.rrfp.trace.TraceRecorder` through every mailbox,
  TP gate, transport and actor; after a run the full event log is on
  ``driver.trace`` (and ``RunResult.trace``).
* ``ActorConfig.chaos`` plugs a :class:`~repro_torch.runtime.rrfp.chaos.ChaosEngine`
  into the delivery and compute paths of both substrates: per-edge latency,
  message reorder/duplication, stage stragglers and transient stalls, all
  CRN-keyed so the same scenario hits every consumption mode identically.
* ``ActorConfig.replay`` re-executes a recorded trace.  On the sim
  substrate replay is *time-exact*: a
  :class:`~repro_torch.runtime.rrfp.trace.ReplayOracle` substitutes the recorded
  delivery times and task durations for every sample, so the event heap
  evolves identically and the replayed trace is bit-for-bit the recorded
  one.  On the thread substrate replay is *order-exact*: the recorded
  per-stage dispatch orders are consumed as a pre-committed schedule, which
  pins the floating-point reduction order and therefore the loss/grad bits.

Elastic fault recovery (``ActorConfig.recover``):

A chaos ``kill`` / ``permanent_stall`` fault becomes a *recoverable event*
instead of a dead run.  The driver detects the death (heartbeat deadline on
the sim virtual clock; a died thread or a stale execution heartbeat on the
thread substrate), then a recovery coordinator: (1) bumps the recovery
*epoch* and fences the failed stage's mailbox — any pre-failure straggler
still in flight is dropped, never admitted; (2) respawns the stage (or
re-maps it onto a surviving neighbor's device,
``recovery_mode="remap"``, feasibility-checked by
:func:`repro_torch.runtime.elastic.plan_remesh`); (3) restores the stage's
progress — on the sim substrate from the recorded completion set ("replay
from trace", modeled restore latency ``restore_cost``), on the thread
substrate by full re-execution with state rebuilt via ``respawn`` (e.g.
params from :class:`repro_torch.ckpt.store.CheckpointStore`); and (4) replays the
in-flight microbatches destined to the dead stage from the send log, tagged
with the new epoch.  Exactly-once is preserved end to end: re-sent messages
are idempotently dropped by the TP gate, re-executed contributions
overwrite their per-task slot, and the conformance suite checks the
resulting trace (``check_recovery_exactly_once``).  Without ``recover``,
the fault is promoted to a fail-fast
:class:`~repro_torch.runtime.rrfp.chaos.StageFailure`.
"""
from __future__ import annotations

import dataclasses
import heapq
import threading
import zlib
from typing import Any, Callable

import numpy as np

from repro_torch.core.costs import CostModel
from repro_torch.core.engine import DeadlockError, RunResult, StageStats
from repro_torch.core.hints import FIXED_ORDERS, HintKind
from repro_torch.core.taskgraph import Kind, PipelineSpec, Task

from repro_torch.runtime.rrfp import trace as _tr
from repro_torch.runtime.rrfp.actor import StageActor
from repro_torch.runtime.rrfp.chaos import (
    ChaosConfig,
    ChaosEngine,
    ChaosThreadTransport,
    StageFailure,
)
from repro_torch.runtime.rrfp.mailbox import Mailbox
from repro_torch.runtime.rrfp.messages import Envelope, envelopes_for, reset_seq
from repro_torch.runtime.rrfp.trace import ReplayOracle, Trace, TraceRecorder
from repro_torch.runtime.rrfp.transport import (
    ReliableChannel,
    ReliableConfig,
    ReliableThreadTransport,
    SimTransport,
    ThreadTransport,
    rng_for,
)


class _StageDeath(Exception):
    """Internal thread-substrate signal: the chaos layer killed this stage.

    Distinct from user-code exceptions so the runner can route it to the
    recovery coordinator (``ActorConfig.recover``) or promote it to
    :class:`StageFailure` instead of the generic abort path."""

    def __init__(self, stage: int, fail_kind: str, task: Task | None = None,
                 t_fail: float = 0.0):
        self.stage = stage
        self.fail_kind = fail_kind
        self.task = task
        self.t_fail = t_fail
        super().__init__(f"stage {stage} died ({fail_kind})")


@dataclasses.dataclass
class ActorConfig:
    """Runtime configuration (mirrors ``EngineConfig`` where they overlap)."""

    mode: str = "hint"  # "hint" (RRFP) | "precommitted" (fixed-order baselines)
    hint: HintKind = HintKind.BF
    fixed_order: str = "1f1b"  # precommitted mode: key into FIXED_ORDERS
    custom_orders: list[list[Task]] | None = None  # overrides fixed_order
    buffer_limit: int = 32  # App. C backpressure limit
    #: BFW: max outstanding un-executed W tasks per stage (each holds one
    #: stashed (x, g_in) activation pair); 0 = unbounded deferral
    w_defer_cap: int = 0
    tp_degree: int = 1
    tp_coord_base: float = 75e-6  # scalar all-gather cost (Table 3)
    seed: int = 0
    #: thread mode: seconds of mailbox starvation before DeadlockError
    deadlock_timeout: float = 30.0
    #: fault injection scenario (None = no chaos)
    chaos: ChaosConfig | None = None
    #: reliable-delivery layer (per-edge sequence numbers, checksums,
    #: ACK/NACK, CRN-keyed retransmission, receiver-side dedup).  Required
    #: whenever the chaos scenario is *lossy* (drop/corrupt/partition):
    #: without retransmission a dropped message is a silent deadlock.
    reliable: ReliableConfig | None = None
    #: record a structured event trace (driver.trace / RunResult.trace)
    record_trace: bool = False
    #: re-execute a recorded trace (time-exact on sim, order-exact threaded)
    replay: Trace | None = None
    #: record full sorted ready-set snapshots on every dispatch instead of
    #: the cheap incremental diff encoding (``Trace.ready_sets()`` decodes
    #: both) — opt-in, for human-readable traces
    trace_full_ready: bool = False
    #: verification/benchmark knob: arbitrate via the reference
    #: sort-then-rank path instead of the incremental ReadySet index
    #: (decision-identical by construction; only per-decision cost differs)
    reference_arbitration: bool = False
    #: observability: a :class:`repro_torch.obs.metrics.MetricsRegistry` whose
    #: per-stage shards the runtime feeds (None = zero-cost).  Reuse one
    #: registry across steps to accumulate and keep cost EWMAs warm.
    #: Metrics never alter scheduling decisions (CI's paired-trace check);
    #: with a recorder also attached they add info annotations (e.g.
    #: ``ewma`` on COMPLETE) that replay tolerates.
    metrics: Any | None = None
    #: ---- elastic fault recovery ----------------------------------------
    #: arm the recovery coordinator: chaos kill/permanent_stall faults are
    #: survived (quiesce -> respawn/re-map -> restore -> replay) instead of
    #: raising :class:`~repro_torch.runtime.rrfp.chaos.StageFailure`
    recover: bool = False
    #: heartbeat deadline, in substrate time (virtual seconds on sim, wall
    #: seconds on threads): how long a stage may be silent before the
    #: coordinator declares it dead — the detection-latency half of MTTR
    hb_deadline: float = 5e-3
    #: sim substrate: modeled virtual-time cost of restoring the respawned
    #: stage's params/optimizer from the last committed checkpoint — the
    #: restore half of MTTR
    restore_cost: float = 1e-3
    #: "respawn" = fresh actor on the failed stage's own device;
    #: "remap" = no spare device — the stage re-hosts on a surviving
    #: neighbor (repro_torch.runtime.elastic.remap_stages) and the pair
    #: time-share it (sim substrate)
    recovery_mode: str = "respawn"
    #: thread substrate: ``respawn(stage) -> work_fn`` rebuilds the dead
    #: stage's program (e.g. params restored via CheckpointStore); None
    #: reuses the original work_fn (stateless programs)
    respawn: Callable[[int], Any] | None = None
    #: an :class:`repro_torch.runtime.adaptive.AdaptiveScheduler` (or None): on an
    #: elastic re-map the driver calls ``note_remap(host_of)`` and, if the
    #: re-synthesized table prices better on the degraded topology, hot-swaps
    #: it into every live actor (recorded as HINT_SWAP events)
    adaptive: Any | None = None
    #: ---- adaptive scheduling (schedules are data; docs/adaptive.md) -----
    #: hint-mode rank table: per-stage synthesized orders consumed as a
    #: *non-binding* priority table from t=0 (dispatch path "table").
    #: Replaces the directional hint without recompilation.
    hint_table: list[list[Task]] | None = None
    #: version stamp of hint_table (bumped by the adaptive re-synthesizer
    #: across iteration-boundary swaps; recorded in trace meta)
    hint_table_version: int = 0
    #: mid-run hot-swap target: per-stage orders every live stage adopts
    #: at its quiesce point, recorded as HINT_SWAP trace events
    swap_table: list[list[Task]] | None = None
    #: sim substrate: virtual time of the swap (a dedicated heap event)
    swap_at: float | None = None
    #: thread substrate: per-stage completion count triggering the swap
    swap_after: int | None = None


def _compute_rng(seed: int, task: Task) -> np.random.Generator:
    return np.random.default_rng(
        [seed & 0x7FFFFFFF, zlib.crc32(b"rrfp-compute"),
         int(task.kind), task.stage, task.mb, task.chunk])


class ActorDriver:
    """One training iteration through the actor runtime."""

    def __init__(self, spec: PipelineSpec, costs: CostModel | None,
                 config: ActorConfig):
        if costs is not None and costs.num_stages != spec.num_stages:
            raise ValueError("cost model / spec stage mismatch")
        if (spec.split_backward and config.mode == "hint"
                and config.replay is None
                and config.hint != HintKind.BFW
                and config.hint_table is None):
            raise ValueError(
                f"hint mode on a split-backward spec requires HintKind.BFW "
                f"(got {config.hint}): only the BFW hint dispatches W tasks")
        for name in ("hint_table", "swap_table"):
            tbl = getattr(config, name)
            if tbl is not None and len(tbl) != spec.num_stages:
                raise ValueError(
                    f"{name} has {len(tbl)} stage orders for a "
                    f"{spec.num_stages}-stage spec")
        if (config.swap_table is not None and config.replay is None
                and config.swap_at is None and config.swap_after is None):
            raise ValueError(
                "swap_table needs a quiesce trigger: swap_at (sim virtual "
                "time) or swap_after (thread per-stage completion count)")
        if (config.chaos is not None and config.chaos.lossy()
                and config.reliable is None and config.replay is None):
            raise ValueError(
                "lossy chaos (drop_prob/corrupt_prob/partitions) requires "
                "ActorConfig.reliable: without retransmission a dropped "
                "message is a silent deadlock, not a detectable fault")
        self.spec = spec
        self.costs = costs
        self.config = config
        #: event log of the last run (when record_trace was set)
        self.trace: Trace | None = None

    # ------------------------------------------------------------------
    def _meta(self, cfg: ActorConfig, substrate: str) -> dict:
        spec = self.spec
        return {
            "substrate": substrate,
            "mode": cfg.mode,
            "hint": cfg.hint.value,
            "fixed_order": cfg.fixed_order,
            "buffer_limit": cfg.buffer_limit,
            "w_defer_cap": cfg.w_defer_cap,
            "tp_degree": cfg.tp_degree,
            "seed": cfg.seed,
            "num_stages": spec.num_stages,
            "num_microbatches": spec.num_microbatches,
            "num_chunks": spec.num_chunks,
            "split_backward": spec.split_backward,
            "graph": ([list(e) for e in spec.graph.edges]
                      if spec.graph is not None else None),
            "chaos": cfg.chaos.to_json() if cfg.chaos is not None else None,
            "trace_ready": "full" if cfg.trace_full_ready else "diff",
            **({"reliable": dataclasses.asdict(cfg.reliable)}
               if cfg.reliable is not None else {}),
            **({"recover": True, "recovery_mode": cfg.recovery_mode,
                "hb_deadline": cfg.hb_deadline,
                "restore_cost": cfg.restore_cost} if cfg.recover else {}),
            **({"hint_table": [[_tr.task_key(t) for t in o]
                               for o in cfg.hint_table],
                "hint_table_version": cfg.hint_table_version}
               if cfg.hint_table is not None else {}),
            **({"swap_table": [[_tr.task_key(t) for t in o]
                               for o in cfg.swap_table],
                "swap_at": cfg.swap_at, "swap_after": cfg.swap_after}
               if cfg.swap_table is not None else {}),
        }

    def _effective_config(self, substrate: str) -> ActorConfig:
        """Resolve replay: adopt the recorded run's scheduling parameters.

        Sim replays keep the recorded consumption mode (decisions re-derive
        identically from the replayed arrivals); thread replays consume the
        realized dispatch orders as a pre-committed schedule.
        """
        cfg = self.config
        if cfg.replay is None:
            return cfg
        meta = cfg.replay.meta
        def _orders(key: str) -> list[list[Task]] | None:
            v = meta.get(key)
            if v is None:
                return None
            return [[_tr.task_from_key(k) for k in o] for o in v]

        cfg = dataclasses.replace(
            cfg,
            mode=meta.get("mode", cfg.mode),
            hint=HintKind(meta.get("hint", cfg.hint.value)),
            buffer_limit=meta.get("buffer_limit", cfg.buffer_limit),
            w_defer_cap=meta.get("w_defer_cap", cfg.w_defer_cap),
            tp_degree=meta.get("tp_degree", cfg.tp_degree),
            chaos=None,  # realized durations/arrivals already include chaos
            reliable=None,  # recorded DELIVERs are post-dedup admissions
            # adaptive tables: the recorded run's active table (+ any
            # mid-run swap) re-derives the same decisions on sim replay
            hint_table=_orders("hint_table"),
            hint_table_version=meta.get("hint_table_version", 0),
            swap_table=_orders("swap_table"),
            swap_at=meta.get("swap_at"),
            swap_after=meta.get("swap_after"),
        )
        if substrate == "thread" or cfg.mode == "precommitted":
            # order-exact replay: realized orders become the schedule
            cfg = dataclasses.replace(
                cfg, mode="precommitted",
                custom_orders=cfg.replay.dispatch_orders(self.spec.num_stages))
        return cfg

    def _make_stage(
        self, s: int, cfg: ActorConfig, recorder: TraceRecorder | None,
        epoch: int = 0,
    ) -> tuple[Mailbox, StageActor]:
        """Build one stage's mailbox + actor (initial build and respawn).

        A respawned incarnation passes the post-recovery ``epoch``: its
        mailbox fences every envelope from an earlier epoch."""
        spec = self.spec
        order = None
        if cfg.mode == "precommitted":
            if cfg.custom_orders is not None:
                order = cfg.custom_orders[s]
            else:
                order = FIXED_ORDERS[cfg.fixed_order](spec, s)
        shard = (cfg.metrics.shard(s)
                 if cfg.metrics is not None else None)
        mb = Mailbox(s, cfg.tp_degree, recorder=recorder,
                     fan_in=spec.fan_in, metrics=shard)
        mb.epoch = epoch
        table = (cfg.hint_table[s]
                 if cfg.hint_table is not None and cfg.mode == "hint"
                 else None)
        actor = StageActor(
            s, spec, mb, mode=cfg.mode, hint=cfg.hint, order=order,
            buffer_limit=cfg.buffer_limit, w_defer_cap=cfg.w_defer_cap,
            reference_arbitration=cfg.reference_arbitration,
            trace_full_ready=cfg.trace_full_ready, metrics=shard,
            table=table, table_version=cfg.hint_table_version)
        return mb, actor

    def _build_actors(
        self, cfg: ActorConfig, recorder: TraceRecorder | None,
    ) -> tuple[list[Mailbox], list[StageActor]]:
        mailboxes, actors = [], []
        for s in range(self.spec.num_stages):
            mb, actor = self._make_stage(s, cfg, recorder)
            mailboxes.append(mb)
            actors.append(actor)
        return mailboxes, actors

    def _restore_progress(self, actor: StageActor, done: set) -> None:
        """Seed a respawned actor with the progress the coordinator restored
        from the trace: completed tasks never re-execute (sim substrate),
        and every locally-enabled not-yet-done task re-enters the ready set.
        Message-fed tasks re-arrive via the coordinator's replay."""
        actor.done = set(done)
        for t in done:
            if t.kind == Kind.F:
                actor.n_f += 1
            elif t.kind == Kind.B:
                actor.n_b += 1
            else:
                actor.n_w += 1
        if actor.mode == "precommitted":
            # a fixed order executes strictly in sequence, so the restored
            # position is the done prefix
            while (actor.order_pos < len(actor.order)
                   and actor.order[actor.order_pos] in done):
                actor.order_pos += 1
        for t in self.spec.tasks():
            if t.stage == actor.idx and t not in done:
                actor._maybe_enqueue(t)

    def _seed_inputs(self, mailboxes: list[Mailbox]) -> None:
        """Source stages' chunk-0 forward inputs are locally available at
        t=0 (stage 0 on a chain; every branch root on a DAG)."""
        for s in self.spec.source_stages():
            for j in range(self.spec.num_microbatches):
                mailboxes[s].deliver_local(Task(Kind.F, s, j, 0))

    # ---- simulation substrate -----------------------------------------
    def run(self) -> RunResult:
        spec = self.spec
        reset_seq()  # envelope seqs are run-local: traces stay byte-stable
        cfg = self._effective_config("sim")
        oracle = ReplayOracle(cfg.replay) if cfg.replay is not None else None
        if oracle is not None and cfg.replay.recovery_windows():
            raise ValueError(
                "time-exact replay of a recovered trace is not supported: "
                "replay the unfailed run and re-inject the fault instead")
        if self.costs is None and oracle is None:
            raise ValueError("simulation mode requires a CostModel")
        costs = self.costs
        recorder = (TraceRecorder(self._meta(cfg, "sim"))
                    if cfg.record_trace else None)
        chaos = (ChaosEngine(cfg.chaos)
                 if cfg.chaos is not None and cfg.chaos.active() else None)
        mailboxes, actors = self._build_actors(cfg, recorder)

        # fail-stop fault plan: a pure (CRN) function of the chaos config.
        # Each stage carries a *list* of planned faults in dispatch order —
        # the multi-fault generalization (concurrent deaths and
        # death-during-recovery are just overlapping entries).
        fails: dict[int, list[tuple[str, int]]] = {}
        if chaos is not None:
            for s in range(spec.num_stages):
                fps = chaos.fail_points(s, spec.num_tasks_per_stage())
                if fps:
                    fails[s] = fps
        epoch = 0  # recovery generation; stamps every outgoing envelope
        dead: set[int] = set()
        #: per-stage incarnation counter: a "complete" heap event carries the
        #: incarnation that scheduled it, so an in-flight completion of a
        #: stage killed *mid-execution* (link failure on a live stage) is
        #: discarded instead of committing zombie state
        incarnation = [0] * spec.num_stages
        n_disp = [0] * spec.num_stages
        fail_time: dict[int, float] = {}
        fail_kind_of: dict[int, str] = {}
        recoveries: list[dict] = []
        #: stages whose hosting device has been lost (cumulative across
        #: overlapping recovery windows): the re-map fold's dead set
        remapped: set[int] = set()
        #: (task, rank, src) of every envelope handed to the transport —
        #: the recovery coordinator's replay source (sim payloads are the
        #: fact of arrival, so identity is the whole message)
        sent_log: set[tuple[Task, int, int]] = set()
        host_of = list(range(spec.num_stages))  # stage -> hosting device

        events: list = []  # (time, seq, kind, payload)
        seq = 0

        def push(t: float, ekind: str, payload) -> None:
            nonlocal seq
            heapq.heappush(events, (t, seq, ekind, payload))
            seq += 1

        def schedule_delivery(t: float, env: Envelope) -> None:
            """Transport hook; the chaos layer perturbs the arrival here."""
            if chaos is None:
                push(t, "deliver", env)
                return
            for copy in range(chaos.copies(env)):
                push(t + chaos.comm_delay(env, copy), "deliver", env)

        def record_send(env: Envelope, _lat: float) -> None:
            if recorder is not None:
                rel = {"eseq": env.eseq} if env.eseq >= 0 else {}
                recorder.record(_tr.SEND, env.src_stage, env.task,
                                rank=env.rank, t=env.send_time, seq=env.seq,
                                **rel)

        transport = SimTransport(
            costs, schedule=schedule_delivery, seed=cfg.seed,
            on_send=record_send) if oracle is None else None

        # ---- reliable-delivery layer over a lossy virtual wire ----------
        def link_fail(src: int, dst: int, env: Envelope, now: float) -> None:
            """Retry budget exhausted on src->dst: escalate to a stage fault
            on the unreachable receiver, detected immediately (the transport
            itself is the failure detector — no heartbeat wait)."""
            if dst in dead:
                return  # already under recovery; its replay covers this edge
            dead.add(dst)
            fail_time[dst] = now
            fail_kind_of[dst] = "link"
            incarnation[dst] += 1  # discard any in-flight completion
            busy_until[host_of[dst]] = float("inf")
            if recorder is not None:
                recorder.record(_tr.FAIL, dst, env.task, t=now,
                                fail_kind="link", src=src)
            if not cfg.recover:
                if recorder is not None:
                    self.trace = recorder.trace()
                raise StageFailure(
                    dst, "link",
                    f"edge {src}->{dst} unhealable at t={now:.6g}")
            push(now, "detect", dst)

        def wire_transmit(env: Envelope, attempt: int, now: float) -> None:
            copies = chaos.copies(env) if chaos is not None else 1
            for copy in range(copies):
                if chaos is not None and chaos.dropped(env, now, attempt,
                                                       copy):
                    if recorder is not None:
                        recorder.record(_tr.DROP, env.src_stage, env.task,
                                        rank=env.rank, t=now,
                                        dst=env.dst_stage, eseq=env.eseq,
                                        attempt=attempt, copy=copy)
                    continue
                arriving = env
                if chaos is not None and chaos.corrupted(env, attempt):
                    arriving = dataclasses.replace(
                        env, checksum=env.checksum ^ (attempt + 1))
                lat = costs.sample_comm(rng_for(cfg.seed, env))
                if chaos is not None:
                    lat += chaos.comm_delay(env, copy)
                push(now + lat, "rdeliver", (arriving, attempt))

        def wire_ack(ack, env: Envelope, now: float) -> None:
            if chaos is not None and chaos.ack_dropped(env, now,
                                                       ack.attempt):
                return  # sender's RTO covers it; receiver dedups the retry
            push(now + cfg.reliable.ack_latency, "call",
                 lambda t, a=ack: channel.on_ack(a, t))

        def wire_deliver(env: Envelope, now: float) -> None:
            s = env.dst_stage
            adm = mailboxes[s].deliver(env, now=now)
            if adm is not None:
                actors[s].sync_mailbox()
                try_dispatch(s, now)

        #: current virtual time (updated at every heap pop): the reliable
        #: channel's RTO timers anchor to it when they re-arm
        simnow = [0.0]

        channel = None
        if cfg.reliable is not None and oracle is None:
            channel = ReliableChannel(
                cfg.reliable,
                transmit=wire_transmit,
                send_ack=wire_ack,
                set_timer=lambda delay, fn: push(
                    simnow[0] + delay, "call", fn),
                deliver=wire_deliver,
                on_link_fail=link_fail,
                recorder=recorder,
                on_send=record_send,
                seed=cfg.seed,
            )

        def send_messages(succ: Task, src: int, now: float) -> None:
            for env in envelopes_for(succ, src, cfg.tp_degree, send_time=now,
                                     epoch=epoch):
                if fails or dead or channel is not None:
                    sent_log.add((env.task, env.rank, env.src_stage))
                if channel is not None:
                    channel.send(env, now=now)
                elif oracle is None:
                    transport.send(env, now=now)
                else:
                    record_send(env, 0.0)
                    for at in oracle.delivery_times(env.task, env.rank,
                                                    env.src_stage):
                        push(at, "deliver", env)

        inj_states = [
            costs.injection.make_state() if costs is not None else None
            for _ in range(spec.num_stages)]
        busy_until = [0.0] * spec.num_stages
        idle_since = [0.0] * spec.num_stages
        start: dict[Task, float] = {}
        end: dict[Task, float] = {}
        n_done = 0
        total = spec.total_tasks()

        self._seed_inputs(mailboxes)
        for a in actors:
            a.sync_mailbox()

        def task_duration(s: int, task: Task) -> float:
            if oracle is not None:
                return oracle.duration(task)
            rng = _compute_rng(cfg.seed, task)
            dur = costs.sample_compute(task.kind, s, task.mb, rng)
            if task.kind != Kind.W:
                dur += costs.injection.sample_delay(inj_states[s], dur, rng)
            if chaos is not None:
                # straggler slowdown + transient stall, folded into the
                # realized duration (and therefore into recorded traces)
                dur = dur * chaos.compute_scale(s) + chaos.stall(task)
            return dur

        def try_dispatch(s: int, now: float) -> None:
            if s in dead:
                return
            actor = actors[s]
            h = host_of[s]
            if busy_until[h] > now:
                return
            task, sel_info = actor.select_traced()
            if task is None:
                return
            actor.begin(task, now=now, info=sel_info)
            k = n_disp[s]
            n_disp[s] += 1
            fps = fails.get(s)
            if fps and k >= fps[0][1]:
                # fail-stop: the stage dies executing this task — no
                # COMPLETE, no outgoing messages, in-memory state lost.
                # ``n_disp`` counts across incarnations, so a second entry
                # on the same stage fires on the *respawned* incarnation
                # (death-during-recovery).
                kind_f = fps.pop(0)[0]
                if not fps:
                    del fails[s]
                dead.add(s)
                fail_time[s] = now
                fail_kind_of[s] = kind_f
                busy_until[h] = float("inf")
                if recorder is not None:
                    recorder.record(_tr.FAIL, s, task, t=now,
                                    fail_kind=kind_f)
                if not cfg.recover:
                    if recorder is not None:
                        self.trace = recorder.trace()
                    raise StageFailure(
                        s, kind_f, f"t={now:.6g}, dispatch #{k}")
                # heartbeat deadline: the coordinator declares the stage
                # dead only after hb_deadline of silence
                push(now + cfg.hb_deadline, "detect", s)
                return
            coord = mailboxes[s].group.coordination_cost(task, cfg.tp_coord_base)
            dur = task_duration(s, task)
            actor.stats.blocking += max(0.0, now - idle_since[h])
            actor.stats.tp_coord += coord
            actor.stats.compute += dur
            begin = now + coord
            start[task] = begin
            busy_until[h] = begin + dur
            push(busy_until[h], "complete", (task, incarnation[s]))

        def co_hosted(h: int) -> list[int]:
            return [s2 for s2 in range(spec.num_stages) if host_of[s2] == h]

        swap_done = False
        if (cfg.mode == "hint" and cfg.swap_table is not None
                and cfg.swap_at is not None):
            # pushed before the first dispatch so the event's heap seq (and
            # therefore its order among same-time events) is replay-stable
            push(cfg.swap_at, "hint_swap", None)

        for s in range(spec.num_stages):
            try_dispatch(s, 0.0)

        while events:
            now, _, ekind, payload = heapq.heappop(events)
            simnow[0] = now
            if ekind == "complete":
                task, inc = payload
                s = task.stage
                if inc != incarnation[s]:
                    # a completion scheduled by an incarnation that was
                    # since killed mid-execution (link failure): zombie
                    # state, never committed — the successor incarnation
                    # re-executes the task
                    continue
                end[task] = now
                n_done += 1
                succs = actors[s].complete(task, now=now, dur=now - start[task])
                for succ in succs:
                    send_messages(succ, s, now)
                h = host_of[s]
                idle_since[h] = now
                for s2 in co_hosted(h):
                    try_dispatch(s2, now)
            elif ekind == "call":
                # reliable-transport timer/ack hop: invoke with fire time
                payload(now)
            elif ekind == "rdeliver":
                # one wire transmission survived drop/partition: the channel
                # verifies the checksum, dedups, acks, and (first admission
                # only) delivers into the mailbox
                env, attempt = payload
                channel.on_wire(env, attempt, now)
            elif ekind == "deliver":
                env: Envelope = payload
                s = env.dst_stage
                adm = mailboxes[s].deliver(env, now=now)
                if adm is not None:
                    actors[s].sync_mailbox()
                    try_dispatch(s, now)
            elif ekind == "hint_swap":
                # quiesce point: between heap events no stage holds an
                # un-completed decision — adopt the new table everywhere,
                # then re-arbitrate (priorities changed, readiness didn't)
                swap_done = True
                for s2 in range(spec.num_stages):
                    if s2 not in dead:
                        actors[s2].set_hint_table(
                            cfg.swap_table[s2], now=now,
                            version=cfg.hint_table_version + 1)
                for s2 in range(spec.num_stages):
                    try_dispatch(s2, now)
            elif ekind == "detect":
                # ---- recovery coordinator -----------------------------
                s = payload
                if recorder is not None:
                    recorder.record(_tr.RECOVERY_BEGIN, s, t=now,
                                    epoch_from=epoch, epoch_to=epoch + 1)
                epoch += 1
                incarnation[s] += 1
                if recorder is not None:
                    recorder.epoch = epoch
                if cfg.recovery_mode == "remap":
                    # no spare device: fold the dead stage onto a surviving
                    # neighbor (feasibility-checked MeshPlan re-layout).
                    # The dead set is cumulative across overlapping windows
                    # — a second concurrent death folds onto a device that
                    # is actually still alive, never onto a dead neighbor.
                    from repro_torch.runtime.elastic import remap_stages

                    remapped.add(s)
                    host_of = remap_stages(spec.num_stages, remapped)
                # respawn: fresh mailbox (fenced at the new epoch) + actor
                mb, actor = self._make_stage(s, cfg, recorder, epoch=epoch)
                mailboxes[s] = mb
                actors[s] = actor
                # restore progress from the last committed state: completed
                # tasks never re-execute; the doomed + undispatched remainder
                # re-enter through local enablement and message replay
                done_s = {t for t in end if t.stage == s}
                self._restore_progress(actor, done_s)
                if swap_done and cfg.swap_table is not None:
                    # the fleet swapped while this stage was down: the new
                    # incarnation adopts the active table, not the stale one
                    actor.set_hint_table(cfg.swap_table[s], now=now,
                                         version=cfg.hint_table_version + 1)
                if (cfg.recovery_mode == "remap"
                        and cfg.adaptive is not None and cfg.mode == "hint"):
                    # re-synthesize against the post-remap topology: stages
                    # now time-sharing a device price slower, and the
                    # recovery cost folds into the candidate's pricing
                    d = cfg.adaptive.note_remap(
                        host_of, recovery_cost=cfg.restore_cost)
                    if d.swapped:
                        for s2 in range(spec.num_stages):
                            a2 = actors[s2] if s2 != s else actor
                            if s2 == s or s2 not in dead:
                                a2.set_hint_table(
                                    cfg.adaptive.table[s2], now=now)
                t_up = now + cfg.restore_cost
                for task_, rank_, src_ in sorted(
                        e for e in sent_log
                        if e[0].stage == s and e[0] not in done_s):
                    push(t_up, "deliver", Envelope(
                        task=task_, src_stage=src_, dst_stage=s, rank=rank_,
                        send_time=now, epoch=epoch))
                h = host_of[s]
                if cfg.recovery_mode == "remap":
                    busy_until[h] = max(busy_until[h], t_up)
                else:
                    busy_until[h] = t_up
                    idle_since[h] = t_up
                recoveries.append({
                    "stage": s, "fail_kind": fail_kind_of[s],
                    "t_fail": fail_time[s], "t_detect": now, "t_up": t_up,
                    "epoch": epoch, "mode": cfg.recovery_mode,
                    "mttr": t_up - fail_time[s]})
                push(t_up, "respawned", s)
            else:  # respawned: the new incarnation is back in service
                s = payload
                dead.discard(s)
                if recorder is not None:
                    recorder.record(_tr.RECOVERY_END, s, t=now,
                                    mode=cfg.recovery_mode,
                                    mttr=now - fail_time[s])
                if cfg.metrics is not None:
                    # incarnation boundary: old-speed samples become a
                    # weak prior so re-synthesis tracks the new regime
                    cfg.metrics.on_recovery(s)
                actors[s].sync_mailbox()
                try_dispatch(s, now)

        if recorder is not None:
            self.trace = recorder.trace()
        if n_done != total:
            starved = {
                a.idx: a.waiting_on()[:4] for a in actors if not a.finished()
            }
            raise DeadlockError(
                f"actor runtime stalled with {total - n_done} tasks "
                f"unexecuted (mode={cfg.mode}); starved stages -> first "
                f"missing messages: {starved}")
        makespan = max(end.values())
        for s, a in enumerate(actors):
            a.stats.blocking += max(0.0, makespan - busy_until[host_of[s]])
            a.stats.deferrals = mailboxes[s].group.deferrals
        if recorder is not None:
            recorder.meta["makespan"] = makespan
            if recoveries:
                recorder.meta["recoveries"] = recoveries
            if channel is not None:
                recorder.meta["reliable_stats"] = channel.stats()
            self.trace = recorder.trace()
        return RunResult(
            makespan=makespan,
            stage_stats=[a.stats for a in actors],
            start=start,
            end=end,
            spec=spec,
            trace=self.trace,
            metrics=cfg.metrics,
        )

    # ---- thread-per-stage substrate ------------------------------------
    def run_threaded(
        self,
        work_fn: Callable[[Task, Any], Any] | list[Callable[[Task, Any], Any]],
    ) -> RunResult:
        """Drive real per-stage callables with thread actors (wall clock).

        ``work_fn(task, payload)`` (or one callable per stage) performs the
        actual computation and returns the payload for the outgoing message.
        """
        import queue as _queue
        import time as _time

        spec = self.spec
        reset_seq()  # envelope seqs are run-local: traces stay byte-stable
        cfg = self._effective_config("thread")
        recorder = (TraceRecorder(self._meta(cfg, "thread"))
                    if cfg.record_trace else None)
        chaos = (ChaosEngine(cfg.chaos)
                 if cfg.chaos is not None and cfg.chaos.active() else None)
        mailboxes, actors = self._build_actors(cfg, recorder)
        if (cfg.mode == "hint" and cfg.swap_table is not None
                and cfg.swap_after is not None):
            for a in actors:
                a.swap_table = cfg.swap_table[a.idx]
                a.swap_after = cfg.swap_after
        t0 = _time.perf_counter()
        clock = lambda: _time.perf_counter() - t0  # noqa: E731

        # fail-stop fault plan (CRN: a pure function of the chaos config).
        # Per-stage *lists* of planned faults in dispatch order: overlapping
        # entries express concurrent deaths and death-during-recovery.
        fail_points: dict[int, list[tuple[str, int]]] = {}
        if chaos is not None:
            for s in range(spec.num_stages):
                fps = chaos.fail_points(s, spec.num_tasks_per_stage())
                if fps:
                    fail_points[s] = fps
        rcfg = cfg.reliable
        #: recovery generation; the transport shim stamps it on every
        #: outgoing envelope under ``gate``, so no send can interleave with
        #: a coordinator epoch bump
        gate = threading.RLock()
        epoch_box = [0]
        #: (task, rank, src) -> last payload sent — the coordinator's replay
        #: source for messages destined to a respawned stage
        send_log: dict[tuple[Task, int, int], Any] = {}
        all_actors: list[StageActor] = list(actors)
        fail_time: dict[int, float] = {}
        recoveries: list[dict] = []
        #: set once every stage thread has joined: late transport timers
        #: (an RTO escalating after the run drained) must not wake the
        #: recovery coordinator for a run that already finished
        run_done = threading.Event()
        abort = threading.Event()
        errors: list[BaseException] = []
        fail_q: _queue.Queue = _queue.Queue()
        #: stage -> hosting device, and the cumulative lost-device set
        #: (thread-substrate elastic remap)
        host_of = list(range(spec.num_stages))
        remapped: set[int] = set()
        #: per-stage host lock: stages folded onto one device time-share it
        #: by serializing their work_fns (assigned at remap time; absent =
        #: the stage still has its own device, no serialization)
        host_locks: dict[int, threading.Lock] = {}

        def record_send(env: Envelope, now: float) -> None:
            if recorder is not None:
                rel = {"eseq": env.eseq} if env.eseq >= 0 else {}
                recorder.record(_tr.SEND, env.src_stage, env.task,
                                rank=env.rank, t=now, seq=env.seq, **rel)

        def thread_link_fail(src: int, dst: int, env: Envelope,
                             now: float) -> None:
            """Reliable transport exhausted its retry budget on src->dst:
            the unreachable receiver is treated as a failed stage."""
            if run_done.is_set():
                return  # the run already completed; nothing left to heal
            fail_time[dst] = now
            if recorder is not None:
                recorder.record(_tr.FAIL, dst, env.task, t=now,
                                fail_kind="link", src=src)
            if cfg.recover:
                fail_q.put(_StageDeath(dst, "link", env.task, t_fail=now))
                return
            errors.append(StageFailure(
                dst, "link", f"edge {src}->{dst} unhealable at t={now:.6g}"))
            abort.set()
            for m in mailboxes:
                m.stop()

        mb_map = {m.stage: m for m in mailboxes}
        if rcfg is not None:
            base_transport = ReliableThreadTransport(
                mb_map, rcfg, chaos=chaos, seed=cfg.seed, clock=clock,
                recorder=recorder, on_send=record_send,
                on_link_fail=thread_link_fail)
        elif chaos is not None:
            base_transport = ChaosThreadTransport(mb_map, chaos,
                                                  on_send=record_send)
        else:
            base_transport = ThreadTransport(mb_map, on_send=record_send)

        #: log sends whenever recovery might need to replay them: planned
        #: faults, or a reliable transport whose link failures can escalate
        #: into unplanned ones
        log_sends = bool(fail_points) or rcfg is not None

        class _EpochTransport:
            """Stamp the current recovery epoch on every envelope (and log
            it for replay) before handing off to the real transport.  The
            gate serializes sends against the coordinator's epoch bump +
            mailbox swap, so an envelope either predates a recovery (old
            epoch -> fenced at the respawned mailbox) or fully follows it."""

            def send(self, env: Envelope, now: float = 0.0):
                with gate:
                    if env.epoch != epoch_box[0]:
                        env = dataclasses.replace(env, epoch=epoch_box[0])
                    if log_sends:
                        send_log[(env.task, env.rank, env.src_stage)] = \
                            env.payload
                    base_transport.send(env, now=now)

        transport = _EpochTransport() if log_sends else base_transport
        base_fns = list(work_fn) if isinstance(work_fn, list) \
            else [work_fn] * spec.num_stages
        if chaos is not None:
            def chaotic(fn):
                def wrapped(task, payload):
                    d = chaos.thread_delay(task)
                    if d > 0:
                        if recorder is not None:
                            recorder.record(_tr.STALL, task.stage, task,
                                            t=clock(), dur=d)
                        _time.sleep(d)
                    return fn(task, payload)
                return wrapped
        else:
            chaotic = None

        # fail-stop wrapper: a doomed dispatch never completes.  ``kill``
        # raises immediately; ``permanent_stall`` hangs inside work_fn until
        # the watchdog notices the stale execution heartbeat and releases it
        # (the release is the moment of *detection*, not of death).  The
        # execution counter is shared across incarnations, so a later entry
        # in a stage's fault list fires on the respawned incarnation —
        # death-during-recovery and repeated deaths fall out naturally.
        exec_n = {s: 0 for s in fail_points}
        fail_remaining = {s: list(pts) for s, pts in fail_points.items()}
        stall_stages = {s for s, pts in fail_points.items()
                        if any(k == "permanent_stall" for k, _ in pts)}
        stall_release = {s: threading.Event() for s in stall_stages}

        def failing(fn, s: int):
            def wrapped(task, payload):
                i = exec_n[s]
                exec_n[s] = i + 1
                rem = fail_remaining[s]
                if rem and i >= rem[0][1]:
                    kind_ = rem.pop(0)[0]
                    t_fail = clock()
                    if kind_ == "permanent_stall":
                        stall_release[s].wait()
                        stall_release[s] = threading.Event()  # re-arm
                    raise _StageDeath(s, kind_, task, t_fail=t_fail)
                return fn(task, payload)
            return wrapped

        def hosted(fn, s: int):
            """Serialize this stage's work_fn with its host's cohabitants
            after an elastic remap folds stages onto one device.  Late-bound:
            before any remap ``host_locks`` has no entry and the wrapper is
            pass-through."""
            def wrapped(task, payload):
                lk = host_locks.get(s)
                if lk is None:
                    return fn(task, payload)
                with lk:
                    return fn(task, payload)
            return wrapped

        def stage_fn(s: int, respawned: bool = False):
            fn = base_fns[s]
            if respawned and cfg.respawn is not None:
                fn = cfg.respawn(s)
            if chaotic is not None:
                fn = chaotic(fn)
            fn = hosted(fn, s)
            # the failing wrapper stays armed on respawn: remaining entries
            # in the stage's fault list target later incarnations
            if s in fail_points:
                fn = failing(fn, s)
            return fn

        def runner(actor: StageActor, fn):
            try:
                actor.run_thread(
                    fn, transport, clock,
                    tp_degree=cfg.tp_degree,
                    deadlock_timeout=cfg.deadlock_timeout,
                    abort=abort,
                )
            except _StageDeath as d:
                fail_time[d.stage] = d.t_fail
                if recorder is not None:
                    recorder.record(_tr.FAIL, d.stage, d.task, t=d.t_fail,
                                    fail_kind=d.fail_kind)
                if cfg.recover:
                    fail_q.put(d)  # hand off to the recovery coordinator
                    return
                errors.append(StageFailure(
                    d.stage, d.fail_kind, f"t={d.t_fail:.6g}"))
                abort.set()
                for m in mailboxes:
                    m.stop()
            except BaseException as e:  # noqa: BLE001 - reraised on join
                errors.append(e)
                abort.set()
                # Event-driven wakeups have no poll period to fall back on:
                # sibling actors blocked on their mailbox condition must be
                # notified, or they sleep until their starvation deadline.
                for m in mailboxes:
                    m.stop()

        self._seed_inputs(mailboxes)
        threads = [
            threading.Thread(target=runner, args=(a, stage_fn(a.idx)),
                             name=f"stage-{a.idx}", daemon=True)
            for a in actors
        ]

        def recover_stage(death: _StageDeath) -> None:
            s = death.stage
            t_detect = clock()
            with gate:
                if run_done.is_set():
                    return  # late escalation: the run already finished
                # Halt the old incarnation BEFORE the epoch bump.  A link
                # failure can kill a *live* stage whose thread is mid-
                # work_fn; halting under the old mailbox's condition makes
                # any racing completion either see ``halted`` and abandon,
                # or land entirely at the old epoch — never a zombie
                # COMPLETE stamped with the new incarnation's epoch.
                old_actor = actors[s]
                old_mb = mb_map[s]
                with old_mb.cond:
                    old_actor.halted = True
                    old_mb.cond.notify_all()
                if recorder is not None:
                    recorder.record(_tr.RECOVERY_BEGIN, s, t=t_detect,
                                    epoch_from=epoch_box[0],
                                    epoch_to=epoch_box[0] + 1)
                epoch_box[0] += 1
                if recorder is not None:
                    recorder.epoch = epoch_box[0]
                mb, actor = self._make_stage(s, cfg, recorder,
                                             epoch=epoch_box[0])
                mailboxes[s] = mb
                mb_map[s] = mb
                actors[s] = actor
                all_actors.append(actor)
                old_mb.stop()
                if cfg.recovery_mode == "remap":
                    # elastic remap on the thread substrate: the dead
                    # stage's device is gone for good; fold the respawned
                    # actor onto the nearest survivor and serialize the
                    # cohabitants' work_fns via a shared host lock
                    from repro_torch.runtime.elastic import remap_stages

                    remapped.add(s)
                    host_of[:] = remap_stages(spec.num_stages, remapped)
                    for h in set(host_of):
                        cohab = [s2 for s2 in range(spec.num_stages)
                                 if host_of[s2] == h]
                        if len(cohab) < 2:
                            continue  # sole resident: no serialization
                        lk = next((host_locks[s2] for s2 in cohab
                                   if s2 in host_locks), None) \
                            or threading.Lock()
                        for s2 in cohab:
                            host_locks[s2] = lk
                # In-memory state (stashed activations) died with the stage:
                # the incarnation re-executes from scratch.  Re-seed local
                # inputs, then replay every logged send destined here at the
                # new epoch; late duplicates of the originals are fenced.
                nowc = clock()
                if s in spec.source_stages():
                    for j in range(spec.num_microbatches):
                        mb.deliver_local(Task(Kind.F, s, j, 0), now=nowc)
                for (task_, rank_, src_), payload in sorted(
                        send_log.items(), key=lambda kv: kv[0]):
                    if task_.stage == s:
                        mb.deliver(Envelope(
                            task=task_, src_stage=src_, dst_stage=s,
                            rank=rank_, payload=payload, send_time=nowc,
                            epoch=epoch_box[0]), now=nowc)
            th = threading.Thread(
                target=runner, args=(actor, stage_fn(s, respawned=True)),
                name=f"stage-{s}-r{epoch_box[0]}", daemon=True)
            th.start()  # start before publishing: the join loop may see it
            threads.append(th)
            t_up = clock()
            mttr = t_up - fail_time.get(s, t_detect)
            mode = cfg.recovery_mode
            host = host_of[s] if mode == "remap" else s
            if recorder is not None:
                recorder.record(_tr.RECOVERY_END, s, t=t_up, mode=mode,
                                mttr=mttr, host=host)
            if cfg.metrics is not None:
                cfg.metrics.on_recovery(s)
            recoveries.append({
                "stage": s, "fail_kind": death.fail_kind,
                "t_fail": fail_time.get(s, t_detect), "t_detect": t_detect,
                "t_up": t_up, "epoch": epoch_box[0], "mode": mode,
                "host": host, "mttr": mttr})
            if (mode == "remap" and cfg.adaptive is not None
                    and cfg.mode == "hint"):
                # re-price the hint table against the degraded (co-hosted)
                # topology; adopt immediately on improvement — each live
                # actor swaps under its own mailbox condition (its thread
                # only touches the arbiter/ready-set under that lock)
                d = cfg.adaptive.note_remap(
                    host_of, recovery_cost=cfg.restore_cost)
                if d.swapped:
                    nowh = clock()
                    for s2 in range(spec.num_stages):
                        a2 = actors[s2]
                        with a2.mailbox.cond:
                            if not a2.halted:
                                a2.set_hint_table(cfg.adaptive.table[s2],
                                                  now=nowh)

        def coordinator() -> None:
            """Failure detection + recovery: drains the death queue (kills
            and link failures announce themselves) and runs a heartbeat
            watchdog for armed permanent stalls (silent deaths detected by
            staleness).  Persistent — it outlives its planned fault list,
            because reliable-transport link failures and later entries in a
            stage's fault list can arrive at any time until the run ends."""
            while not run_done.is_set() and not abort.is_set():
                try:
                    death = fail_q.get(
                        timeout=max(cfg.hb_deadline / 4, 0.002))
                except _queue.Empty:
                    for s2 in stall_stages:
                        es = actors[s2].exec_since
                        if (es is not None
                                and _time.monotonic() - es > cfg.hb_deadline):
                            stall_release[s2].set()
                    continue
                recover_stage(death)
                fail_q.task_done()

        coord_th = None
        # the coordinator doubles as the stall watchdog, so it also runs
        # without ``recover``: a released stall is then promoted to a
        # fail-fast StageFailure instead of a silent hang
        if (fail_points and (cfg.recover or stall_release)) or \
                (rcfg is not None and cfg.recover):
            coord_th = threading.Thread(
                target=coordinator, name="recovery-coordinator", daemon=True)
            coord_th.start()
        for th in list(threads):  # snapshot: a respawn may append
            th.start()
        i = 0
        while True:
            while i < len(threads):
                threads[i].join()
                i += 1
            if i == len(threads) and (
                    coord_th is None or abort.is_set()
                    or fail_q.unfinished_tasks == 0):
                # every started thread joined and no recovery is queued or
                # in flight (a recovery may still append a thread, which
                # the outer loop then picks up)
                break
            _time.sleep(0.002)
        with gate:
            run_done.set()  # under gate: no recovery can start after this
        if coord_th is not None:
            coord_th.join()
            while i < len(threads):
                # a recovery that slipped in between the break above and
                # run_done still spawned a thread; sweep it up
                threads[i].join()
                i += 1
        if isinstance(base_transport, ReliableThreadTransport):
            # land outstanding ACKs/retransmissions, then cancel timers so
            # none outlives the run
            base_transport.drain(timeout=cfg.deadlock_timeout)
            base_transport.close()
        elif isinstance(base_transport, ChaosThreadTransport):
            # chaos duplicates may still be in flight; land them before
            # stopping so no timer outlives the run
            base_transport.drain(timeout=cfg.deadlock_timeout)
        for m in mailboxes:
            m.stop()
        if recorder is not None:
            self.trace = recorder.trace()
        if errors:
            raise errors[0]
        # later incarnations override: a re-executed task's times are its
        # post-recovery ones (all_actors is in creation order)
        start: dict[Task, float] = {}
        end: dict[Task, float] = {}
        for a in all_actors:
            for tr in a.traces:
                start[tr.task] = tr.start
                end[tr.task] = tr.end
        if len(end) != spec.total_tasks():
            raise DeadlockError(
                f"threaded run finished {len(end)}/{spec.total_tasks()} tasks")
        makespan = max(end.values())
        for a in actors:
            a.stats.blocking += max(
                0.0, makespan - max(tr.end for tr in a.traces))
            a.stats.deferrals = a.mailbox.group.deferrals
        if recorder is not None:
            recorder.meta["makespan"] = makespan
            if recoveries:
                recorder.meta["recoveries"] = recoveries
            if isinstance(base_transport, ReliableThreadTransport):
                recorder.meta["reliable_stats"] = base_transport.stats()
            self.trace = recorder.trace()
        return RunResult(
            makespan=makespan,
            stage_stats=[a.stats for a in actors],
            start=start,
            end=end,
            spec=spec,
            trace=self.trace,
            metrics=cfg.metrics,
        )


# --------------------------------------------------------------------------
def run_actor_iteration(
    spec: PipelineSpec, costs: CostModel, config: ActorConfig
) -> RunResult:
    return ActorDriver(spec, costs, config).run()


def average_makespan_actor(
    spec: PipelineSpec,
    costs: CostModel,
    config: ActorConfig,
    iters: int = 10,
) -> tuple[float, float, list[RunResult]]:
    """Mean/std of makespan over independently-seeded iterations (CRN per seed)."""
    results = []
    for i in range(iters):
        cfg = dataclasses.replace(config, seed=config.seed + 1000 * i)
        results.append(ActorDriver(spec, costs, cfg).run())
    xs = np.array([r.makespan for r in results])
    return float(xs.mean()), float(xs.std()), results
