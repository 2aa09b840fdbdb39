"""RRFP discrete-event runtime engine (§3–§5, Appendices A/C/D).

Faithfully models the paper's runtime at task granularity:

* **Message-driven asynchronous communication** (§4.1): task completion posts a
  message; its arrival (after a sampled, possibly heavy-tailed latency) updates
  the receiver's ready buffers.  Send/receive never occupy the compute thread.
* **Ready-set arbitration** (§5/App. A): when the compute thread is free it
  scans the hint order over the *current* ready buffers and dispatches the
  first ready entry (``HINT`` mode), or — for the fixed-order baselines —
  waits for the exact next entry of a pre-committed sequence (``PRECOMMITTED``
  mode).  One schedule, two consumption modes: the paper's core contrast.
* **Backpressure** (App. C): when D_i = n_f - n_b reaches the buffer limit the
  stage switches to backward-only drain (non-interleaved) or the deterministic
  per-microbatch completion order (interleaved).
* **Tensor-parallel coordination** (§4.2/App. D): with tp_degree K, message
  arrivals are sampled per TP rank and a task only becomes ready once *all*
  ranks hold it (the group cannot agree earlier); each collective-relevant
  dispatch additionally pays a scalar all-gather overhead.  Rank-divergence
  deferrals are counted whenever the per-rank arrival spread is nonzero.

The engine records the paper's RQ2 breakdown (compute / blocking / TP-coord)
and full per-task traces for the Theorem 6.1 bound checker and the Fig. 6
bottleneck statistics.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Callable

import numpy as np

from repro_torch.core.costs import CostModel
from repro_torch.core.hints import (
    FIXED_ORDERS,
    HintArbiter,
    HintKind,
    ReadySet,
    backpressure_drain,
)
from repro_torch.core.taskgraph import Kind, PipelineSpec, Task


class DeadlockError(RuntimeError):
    pass


@dataclasses.dataclass
class StageStats:
    compute: float = 0.0
    blocking: float = 0.0
    tp_coord: float = 0.0
    deferrals: int = 0


@dataclasses.dataclass
class RunResult:
    makespan: float
    stage_stats: list[StageStats]
    #: realized durations: dur[(task)] and start/end times
    start: dict[Task, float]
    end: dict[Task, float]
    spec: PipelineSpec
    #: structured event trace (actor runtime with record_trace=True)
    trace: object | None = None
    #: the run's :class:`repro_torch.obs.metrics.MetricsRegistry` (actor runtime
    #: with ``ActorConfig.metrics`` attached)
    metrics: object | None = None

    # ---- derived ----------------------------------------------------------
    def durations(self, kind: Kind) -> np.ndarray:
        """[stage, mb] realized durations (chunk-summed)."""
        S, M = self.spec.num_stages, self.spec.num_microbatches
        out = np.zeros((S, M))
        for t, e in self.end.items():
            if t.kind == kind:
                out[t.stage, t.mb] += e - self.start[t]
        return out

    def breakdown(self) -> dict[str, float]:
        n = len(self.stage_stats)
        return {
            "iter": self.makespan,
            "compute": sum(s.compute for s in self.stage_stats) / n,
            "blocking": sum(s.blocking for s in self.stage_stats) / n,
            "tp_coord": sum(s.tp_coord for s in self.stage_stats) / n,
        }

    def stage_orders(self) -> list[list[Task]]:
        """Per-stage realized execution order (for schedule synthesis).

        Cached after the first call: the result is immutable post-run and
        this sits on diagnostic/synthesis paths that may poll it
        repeatedly, so the full re-sort of ``start`` must not recur.
        """
        cached = self.__dict__.get("_stage_orders")
        if cached is not None:
            return cached
        S = self.spec.num_stages
        orders: list[list[Task]] = [[] for _ in range(S)]
        for t in sorted(self.start, key=lambda t: self.start[t]):
            orders[t.stage].append(t)
        self.__dict__["_stage_orders"] = orders
        return orders


@dataclasses.dataclass
class EngineConfig:
    mode: str = "hint"  # "hint" (RRFP) | "precommitted" (fixed-order baselines)
    hint: HintKind = HintKind.BF
    fixed_order: str = "1f1b"  # for precommitted mode: key into FIXED_ORDERS
    buffer_limit: int = 32  # App. C backpressure limit (paper default)
    tp_degree: int = 1
    tp_coord_base: float = 75e-6  # scalar all-gather cost, calibrated to Table 3
    seed: int = 0
    custom_orders: list[list[Task]] | None = None  # overrides fixed_order
    #: pre-committed mode only: sends rendezvous with the receiver's matching
    #: recv (Megatron-style paired p2p, §4.1); ``send_queue`` irecvs may be
    #: posted ahead.  RRFP's message-driven comm never blocks the sender.
    sync_sends: bool = True
    send_queue: int = 1
    #: replay a recorded actor-runtime trace: the realized per-stage dispatch
    #: orders are consumed as a pre-committed schedule (order-exact replay;
    #: timing is re-sampled — use the actor driver's replay for time-exact).
    replay_trace: object | None = None
    #: verification/benchmark knob: arbitrate via the reference
    #: sort-then-rank path instead of the incremental ReadySet index.
    #: Decisions are identical by construction (the dispatch-overhead
    #: benchmark and the property suite check this); only the per-decision
    #: cost differs.
    reference_arbitration: bool = False


# --------------------------------------------------------------------------


class _Stage:
    __slots__ = (
        "idx", "ready", "arrived", "done", "busy_until", "idle_since",
        "n_f", "n_b", "arbiter", "order", "order_pos", "stats", "inj_state",
        "drain_focus", "outstanding", "send_blocked",
    )

    def __init__(self, idx: int, arbiter: HintArbiter, order: list[Task] | None):
        self.idx = idx
        self.ready = ReadySet()
        #: per-task arrived source stages (DAG fan-in needs every edge)
        self.arrived: dict[Task, set[int]] = {}
        self.done: set[Task] = set()
        self.busy_until = 0.0
        self.idle_since = 0.0
        self.n_f = 0
        self.n_b = 0
        self.arbiter = arbiter
        self.order = order
        self.order_pos = 0
        self.stats = StageStats()
        self.inj_state: dict = {}
        self.drain_focus = 0  # interleaved backpressure: focused microbatch
        self.outstanding = 0  # unmatched rendezvous sends (sync_sends mode)
        self.send_blocked = False


class Engine:
    """One training-iteration simulation."""

    def __init__(self, spec: PipelineSpec, costs: CostModel, config: EngineConfig):
        if costs.num_stages != spec.num_stages:
            raise ValueError("cost model / spec stage mismatch")
        if config.replay_trace is not None:
            # replay mode: the recorded dispatch orders ARE the schedule
            config = dataclasses.replace(
                config, mode="precommitted", sync_sends=False,
                custom_orders=config.replay_trace.dispatch_orders(
                    spec.num_stages))
        if (spec.split_backward and config.mode == "hint"
                and config.hint != HintKind.BFW):
            raise ValueError(
                f"hint mode on a split-backward spec requires HintKind.BFW "
                f"(got {config.hint}): only the BFW hint dispatches W tasks")
        self.spec = spec
        self.costs = costs
        self.config = config
        self.rng = costs.make_rng(config.seed)
        self._tp_coord_cost = (
            0.0
            if config.tp_degree <= 1
            else config.tp_coord_base * (1.0 + math.log2(config.tp_degree))
        )

    # ---- public -----------------------------------------------------------
    def run(self) -> RunResult:
        spec, cfg = self.spec, self.config
        stages = []
        for s in range(spec.num_stages):
            order = None
            if cfg.mode == "precommitted":
                if cfg.custom_orders is not None:
                    order = cfg.custom_orders[s]
                else:
                    order = FIXED_ORDERS[cfg.fixed_order](spec, s)
            stages.append(_Stage(s, HintArbiter(cfg.hint), order))
            stages[s].inj_state = self.costs.injection.make_state()

        start: dict[Task, float] = {}
        end: dict[Task, float] = {}
        events: list = []  # (time, seq, kind, payload)
        seq = 0

        def push(t: float, kind: str, payload) -> None:
            nonlocal seq
            heapq.heappush(events, (t, seq, kind, payload))
            seq += 1

        # Source stages' chunk-0 forward data is locally available at t=0
        # (stage 0 on a chain; every branch root on a DAG).
        for s0 in spec.source_stages():
            for j in range(spec.num_microbatches):
                stages[s0].ready.add(Task(Kind.F, s0, j, 0))

        total = spec.total_tasks()
        n_done = 0
        now = 0.0

        # ---- helpers -------------------------------------------------------
        def is_ready(st: _Stage, t: Task) -> bool:
            mps = spec.message_predecessors(t)
            if mps and len(st.arrived.get(t, ())) < len(mps):
                return False
            lp = spec.local_predecessor(t)
            if lp is not None and lp not in st.done:
                return False
            return True

        def maybe_enqueue_local(st: _Stage, t: Task) -> None:
            if t not in st.done and t not in st.ready and is_ready(st, t):
                st.ready.add(t)

        def backpressured(st: _Stage) -> bool:
            return (
                cfg.mode == "hint"
                and st.n_f - st.n_b >= cfg.buffer_limit
            )

        ref = cfg.reference_arbitration

        def select_backpressure(st: _Stage) -> Task | None:
            """App. C drain orders (shared impl in core.hints)."""
            task, st.drain_focus = backpressure_drain(
                spec, st.idx, sorted(st.ready) if ref else st.ready,
                st.done, st.drain_focus
            )
            return task

        def select(st: _Stage) -> Task | None:
            if cfg.mode == "precommitted":
                if st.order_pos >= len(st.order):
                    return None
                nxt = st.order[st.order_pos]
                return nxt if nxt in st.ready else None
            if backpressured(st):
                return select_backpressure(st)
            return st.arbiter.select(sorted(st.ready) if ref else st.ready)

        def dispatch(st: _Stage, t_now: float) -> None:
            """If the stage is idle, pick and start the next task."""
            if st.busy_until > t_now or st.send_blocked:
                return
            task = select(st)
            if task is None:
                return
            # TP coordination: per-dispatch scalar all-gather (F/B only).
            coord = self._tp_coord_cost if task.kind != Kind.W else 0.0
            dur = self.costs.sample_compute(task.kind, st.idx, task.mb, self.rng)
            if task.kind != Kind.W:
                dur += self.costs.injection.sample_delay(st.inj_state, dur, self.rng)
            st.stats.blocking += max(0.0, t_now - st.idle_since)
            st.stats.tp_coord += coord
            st.stats.compute += dur
            st.ready.discard(task)
            if cfg.mode == "precommitted":
                st.order_pos += 1
            begin = t_now + coord
            start[task] = begin
            st.busy_until = begin + dur
            push(st.busy_until, "complete", task)

        def arrival_time(t_now: float) -> float:
            """Message arrival; with TP, all K ranks must hold the message."""
            k = max(1, cfg.tp_degree)
            samples = [self.costs.sample_comm(self.rng) for _ in range(k)]
            return t_now + max(samples), max(samples) - min(samples)

        # rendezvous state (sync_sends / pre-committed): (succ task, sender
        # stage) -> completion time.  Keyed per edge: DAG fan-in receivers
        # rendezvous with each branch's send independently.
        pending: dict[tuple[Task, int], float] = {}
        sync = cfg.mode == "precommitted" and cfg.sync_sends

        def try_match(t_now: float) -> None:
            """Match pending sends whose receiver has posted the recv."""
            matched = []
            for (succ, sender_idx), _done_at in pending.items():
                recv = stages[succ.stage]
                # the receiver's recv window covers its next `send_queue`+1
                # order entries (irecvs posted one step ahead)
                window = []
                if recv.order is not None:
                    for k in range(recv.order_pos,
                                   min(recv.order_pos + 1 + cfg.send_queue,
                                       len(recv.order))):
                        window.append(recv.order[k])
                if succ in window or recv.order is None:
                    matched.append((succ, sender_idx))
            for succ, sender_idx in matched:
                del pending[(succ, sender_idx)]
                at, spread = arrival_time(t_now)
                if spread > 0:
                    stages[succ.stage].stats.deferrals += 1
                push(at, "message", (succ, sender_idx))
                snd = stages[sender_idx]
                snd.outstanding -= 1
                if snd.send_blocked and snd.outstanding <= cfg.send_queue:
                    snd.send_blocked = False
                    snd.idle_since = min(snd.idle_since, t_now)
                    dispatch(snd, max(t_now, snd.busy_until))

        # ---- main loop -----------------------------------------------------
        for s in range(spec.num_stages):
            dispatch(stages[s], 0.0)

        while events:
            now, _, ekind, payload = heapq.heappop(events)
            if ekind == "complete":
                task: Task = payload
                st = stages[task.stage]
                end[task] = now
                st.done.add(task)
                n_done += 1
                if task.kind == Kind.F:
                    st.n_f += 1
                elif task.kind == Kind.B:
                    st.n_b += 1
                # local successors
                if task.kind == Kind.F:
                    maybe_enqueue_local(st, Task(Kind.B, st.idx, task.mb, task.chunk))
                if task.kind == Kind.B and spec.split_backward:
                    maybe_enqueue_local(st, Task(Kind.W, st.idx, task.mb, task.chunk))
                # outgoing messages: async (RRFP sender threads) or
                # rendezvous (pre-committed paired p2p); one per out-edge
                for succ in spec.message_successors(task):
                    if sync:
                        pending[(succ, st.idx)] = now
                        st.outstanding += 1
                        if st.outstanding > cfg.send_queue:
                            st.send_blocked = True
                        try_match(now)
                    else:
                        at, spread = arrival_time(now)
                        if spread > 0:
                            stages[succ.stage].stats.deferrals += 1
                        push(at, "message", (succ, st.idx))
                st.idle_since = now
                dispatch(st, now)
                if sync:
                    # order pointers advanced: pending sends may now match
                    try_match(now)
            else:  # message arrival enabling one edge of `payload`
                tgt, src = payload
                st = stages[tgt.stage]
                st.arrived.setdefault(tgt, set()).add(src)
                if tgt not in st.done and is_ready(st, tgt):
                    st.ready.add(tgt)
                dispatch(st, now)
                if sync:
                    try_match(now)

        if n_done != total:
            missing = total - n_done
            raise DeadlockError(
                f"engine stalled with {missing} tasks unexecuted "
                f"(mode={cfg.mode}, limit={cfg.buffer_limit})"
            )
        makespan = max(end.values())
        # Blocking accounting: idle tail up to makespan counts as blocking.
        for st in stages:
            st.stats.blocking += max(0.0, makespan - st.busy_until)
        return RunResult(
            makespan=makespan,
            stage_stats=[st.stats for st in stages],
            start=start,
            end=end,
            spec=spec,
        )



# --------------------------------------------------------------------------


def run_iteration(
    spec: PipelineSpec,
    costs: CostModel,
    config: EngineConfig,
) -> RunResult:
    return Engine(spec, costs, config).run()


def average_makespan(
    spec: PipelineSpec,
    costs: CostModel,
    config: EngineConfig,
    iters: int = 10,
) -> tuple[float, float, list[RunResult]]:
    """Mean/std of makespan over ``iters`` independently-seeded iterations."""
    results = []
    for i in range(iters):
        cfg = dataclasses.replace(config, seed=config.seed + 1000 * i)
        results.append(Engine(spec, costs, cfg).run())
    xs = np.array([r.makespan for r in results])
    return float(xs.mean()), float(xs.std()), results
