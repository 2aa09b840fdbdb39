"""Deterministic event traces for the actor runtime (record / replay).

Every observable scheduling decision in the runtime — mailbox enqueue and
dequeue, TP-gate hold/admit/duplicate, dispatch (with the arbitration path
taken and an *incremental* ready-set snapshot: by default only the tasks
added since the stage's previous dispatch are serialized — ``radd`` — and
:meth:`Trace.ready_sets` reconstructs the full per-dispatch snapshots
offline; ``ActorConfig.trace_full_ready`` opts into verbose full
snapshots), completion (with the realized duration and
the W-deferral backlog), and every transport send/delivery — is recorded as a
structured :class:`TraceEvent` stamped with a *logical clock*: a process-wide
monotone counter assigned under one lock, giving a total order over events
that is meaningful on both substrates (the sim driver's virtual clock and the
thread runtime's wall clock).

A :class:`Trace` is the recorded sequence plus run metadata.  It serializes
to JSON lines, diffs against another trace (:meth:`signature`), and projects
out the two replay artifacts:

* :meth:`delivery_schedule` — for the sim substrate, the exact virtual time
  of every envelope delivery (including chaos-injected duplicates), letting
  :meth:`~repro_torch.runtime.rrfp.driver.ActorDriver.run` re-execute a recorded
  arrival order *exactly* — same heap evolution, same event sequence, same
  makespan — without touching a random stream;
* :meth:`dispatch_orders` — the realized per-stage execution order, which
  the thread substrate (and the DES engine via
  :func:`engine_replay_config`) re-executes as a pre-committed order, pinning
  the floating-point reduction order and therefore the loss bit pattern.

The conformance suite (``tests/conformance``) checks runtime invariants —
exactly-once execution, w_defer_cap, hint faithfulness — directly against
recorded traces, so "robust under variability" is a property of the event
log, not of any particular end-to-end metric.
"""
from __future__ import annotations

import dataclasses
import json
import threading
from typing import Any, Iterable

from repro_torch.core.taskgraph import Kind, PipelineSpec, Task

# Event kinds (strings, not an enum: traces are a serialization format first).
SEND = "send"          # envelope handed to a transport
DELIVER = "deliver"    # envelope arrived at the destination mailbox
TP_HOLD = "tp_hold"    # TP gate holds a rank copy (rank set incomplete)
TP_ADMIT = "tp_admit"  # TP gate admitted: all ranks hold the message
TP_DUP = "tp_dup"      # duplicate / post-admission copy ignored
ENQUEUE = "enqueue"    # task appended to a per-kind arrival buffer
DEQUEUE = "dequeue"    # task consumed from its arrival buffer at dispatch
DISPATCH = "dispatch"  # actor committed to execute a task
COMPLETE = "complete"  # task finished executing
STALL = "stall"        # chaos: transient stage stall injected
FANIN_HOLD = "fanin_hold"  # DAG fan-in: edge admitted, other branch missing
FAIL = "fail"          # fail-stop fault: a stage died (kill/permanent_stall)
RECOVERY_BEGIN = "recovery_begin"  # coordinator detected the death; quiesce
RECOVERY_END = "recovery_end"      # stage respawned/re-mapped; epoch bumped
FENCE = "fence"        # stale (pre-recovery epoch) envelope dropped
HINT_SWAP = "hint_swap"  # adaptive: a stage adopted a re-synthesized table
DROP = "drop"          # lossy wire: one transmission (attempt x copy) lost
CORRUPT = "corrupt"    # lossy wire: checksum mismatch detected -> NACK
RETRANSMIT = "retransmit"  # reliable sender re-sent after RTO/NACK
RDUP = "rdup"          # reliable receiver deduplicated an already-seen eseq
LINK_FAIL = "link_fail"  # retry budget exhausted: edge escalated to a fault
EVENT_KINDS = (SEND, DELIVER, TP_HOLD, TP_ADMIT, TP_DUP, ENQUEUE, DEQUEUE,
               DISPATCH, COMPLETE, STALL, FANIN_HOLD, FAIL, RECOVERY_BEGIN,
               RECOVERY_END, FENCE, HINT_SWAP, DROP, CORRUPT, RETRANSMIT,
               RDUP, LINK_FAIL)


def task_key(t: Task) -> list[int]:
    """JSON-stable task identity: [kind, stage, mb, chunk]."""
    return [int(t.kind), t.stage, t.mb, t.chunk]


def _jsonable(v: Any):
    """Coerce an info value to a plain-JSON type (numpy scalars -> Python)."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if hasattr(v, "item"):  # numpy scalar
        return v.item()
    return v


def task_from_key(k: Iterable[int]) -> Task:
    kind, stage, mb, chunk = k
    return Task(Kind(kind), stage, mb, chunk)


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One recorded runtime event, totally ordered by logical clock ``lc``.

    ``epoch`` is the recovery generation the event belongs to: 0 until a
    fail-stop recovery bumps it, so a recovered run's logical clock is
    (epoch, lc) and the conformance checkers can tell a pre-failure
    completion from its post-recovery re-execution.  Serialized only when
    nonzero, so traces of failure-free runs are byte-identical to those
    recorded before recovery existed.
    """

    lc: int
    kind: str
    stage: int
    task: Task | None = None
    rank: int = 0
    t: float = 0.0  # substrate time: virtual (sim) or wall (thread)
    epoch: int = 0
    info: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        d: dict[str, Any] = {"lc": self.lc, "kind": self.kind,
                             "stage": self.stage, "rank": self.rank,
                             "t": self.t}
        if self.epoch:
            d["epoch"] = self.epoch
        if self.task is not None:
            d["task"] = task_key(self.task)
        if self.info:
            # info may carry extra annotations (e.g. metrics-enabled runs
            # stamp EWMA values) whose values can be numpy scalars; coerce
            # so save/load round-trips any recorded run
            d["info"] = {k: _jsonable(v) for k, v in self.info.items()}
        return d

    @staticmethod
    def from_json(d: dict) -> "TraceEvent":
        return TraceEvent(
            lc=d["lc"], kind=d["kind"], stage=d["stage"],
            task=task_from_key(d["task"]) if "task" in d else None,
            rank=d.get("rank", 0), t=d.get("t", 0.0),
            epoch=d.get("epoch", 0), info=d.get("info", {}))


class TraceRecorder:
    """Thread-safe event sink assigning the logical clock.

    One recorder instance is threaded through the mailboxes, TP groups,
    transports and actors of a single run; ``record`` is called under
    whatever lock the caller already holds (or none), and serializes event
    ordering itself.
    """

    def __init__(self, meta: dict | None = None):
        self._lock = threading.Lock()
        self._events: list[TraceEvent] = []
        self.meta = dict(meta or {})
        #: current recovery generation; the recovery coordinator bumps this
        #: so every subsequent event is stamped with the new epoch
        self.epoch = 0

    def record(self, kind: str, stage: int, task: Task | None = None,
               rank: int = 0, t: float = 0.0, **info) -> None:
        with self._lock:
            self._events.append(TraceEvent(
                lc=len(self._events), kind=kind, stage=stage, task=task,
                rank=rank, t=t, epoch=self.epoch, info=info))

    def completed_tasks(self, stage: int) -> set:
        """Tasks this stage has COMPLETEd so far — the progress the recovery
        coordinator restores into a respawned actor ("replay from trace")."""
        with self._lock:
            return {ev.task for ev in self._events
                    if ev.kind == COMPLETE and ev.stage == stage}

    def trace(self) -> "Trace":
        with self._lock:
            return Trace(meta=dict(self.meta), events=list(self._events))


@dataclasses.dataclass
class Trace:
    """A completed run's event log + metadata."""

    meta: dict
    events: list[TraceEvent]

    # ---- persistence -------------------------------------------------------
    def save(self, path: str) -> None:
        """JSON-lines: first line metadata, one event per following line."""
        with open(path, "w") as f:
            f.write(json.dumps({"meta": self.meta}) + "\n")
            for ev in self.events:
                f.write(json.dumps(ev.to_json()) + "\n")

    @staticmethod
    def load(path: str) -> "Trace":
        with open(path) as f:
            head = json.loads(f.readline())
            events = [TraceEvent.from_json(json.loads(line))
                      for line in f if line.strip()]
        return Trace(meta=head.get("meta", {}), events=events)

    # ---- comparison --------------------------------------------------------
    def signature(self, include_time: bool = True,
                  kinds: Iterable[str] | None = None) -> list[tuple]:
        """Hashable per-event identity for replay-equivalence checks.

        With ``include_time`` the virtual-clock timestamps must match too
        (sim replays are exact); without it only the event sequence is
        compared (thread replays reproduce order, not wall time).  ``kinds``
        restricts the signature to a subset of event kinds (e.g. compare
        only the wire-level DROP/RETRANSMIT realization of two lossy runs).
        """
        want = set(kinds) if kinds is not None else None
        out = []
        for ev in self.events:
            if want is not None and ev.kind not in want:
                continue
            tk = tuple(task_key(ev.task)) if ev.task is not None else None
            key = (ev.kind, ev.stage, tk, ev.rank, ev.info.get("src", -1))
            if include_time:
                key += (round(ev.t, 12),)
            out.append(key)
        return out

    def select(self, *kinds: str) -> list[TraceEvent]:
        want = set(kinds)
        return [ev for ev in self.events if ev.kind in want]

    # ---- replay projections ------------------------------------------------
    def dispatch_orders(self, num_stages: int | None = None) -> list[list[Task]]:
        """Realized per-stage execution order (logical-clock order)."""
        if num_stages is None:
            num_stages = int(self.meta.get("num_stages", 0)) or 1 + max(
                ev.stage for ev in self.events)
        orders: list[list[Task]] = [[] for _ in range(num_stages)]
        for ev in self.select(DISPATCH):
            orders[ev.stage].append(ev.task)
        return orders

    def delivery_schedule(self) -> dict[tuple[tuple, int, int], list[float]]:
        """(task, rank, src_stage) -> recorded delivery times, in
        logical-clock order.

        Chaos-duplicated envelopes appear as extra entries; the sim replay
        re-schedules every one of them at its recorded virtual time.  DAG
        fan-in tasks receive one entry stream per source edge.  Traces
        recorded before source stamping use src=-1 (single-edge chains only,
        where the source is unambiguous).
        """
        sched: dict[tuple[tuple, int, int], list[float]] = {}
        for ev in self.select(DELIVER):
            key = (tuple(task_key(ev.task)), ev.rank,
                   int(ev.info.get("src", -1)))
            sched.setdefault(key, []).append(ev.t)
        return sched

    def ready_sets(self) -> dict[int, list[Task]]:
        """DISPATCH event lc -> the full ready-set snapshot at that dispatch.

        Decodes both snapshot encodings: the verbose ``ready`` form (a full
        sorted task list per dispatch, opt-in via
        ``ActorConfig.trace_full_ready``) and the default incremental
        ``radd`` form, which records only the tasks *added* to the stage's
        ready set since its previous dispatch.  The diff reconstruction
        relies on the runtime invariant that between two dispatches the only
        task ever *removed* from a stage's ready set is the one the earlier
        dispatch committed to — so replaying adds and removing each
        dispatched task recovers every snapshot exactly.
        """
        out: dict[int, list[Task]] = {}
        running: dict[int, set[Task]] = {}
        for ev in self.events:
            if ev.kind == RECOVERY_BEGIN:
                # the failed stage's in-memory ready set died with it; the
                # respawned incarnation re-derives readiness from replayed
                # deliveries, so the diff reconstruction restarts empty
                running.pop(ev.stage, None)
                continue
            if ev.kind != DISPATCH:
                continue
            if "ready" in ev.info:
                out[ev.lc] = [task_from_key(k) for k in ev.info["ready"]]
                continue
            cur = running.setdefault(ev.stage, set())
            cur.update(task_from_key(k) for k in ev.info.get("radd", ()))
            out[ev.lc] = sorted(cur)
            cur.discard(ev.task)
        return out

    def durations(self) -> dict[tuple, float]:
        """Full task identity (kind, stage, mb, chunk) -> realized compute
        duration (chaos effects included).

        Keys carry the *complete* task key, so two tasks differing only in
        kind, stage, microbatch or chunk never collapse onto one entry; on
        a malformed trace with duplicate COMPLETEs for the same task the
        first (logical-clock order) duration wins rather than the last
        silently overwriting it — replay consumes the duration the heap
        actually used."""
        out: dict[tuple, float] = {}
        for ev in self.select(COMPLETE):
            if "dur" in ev.info:
                out.setdefault(tuple(task_key(ev.task)), ev.info["dur"])
        return out

    def recovery_windows(self) -> list[dict]:
        """Fail-stop recovery episodes, in order: one dict per FAIL with the
        matching RECOVERY_BEGIN/RECOVERY_END times and the epoch transition.

        ``t_fail`` is when the stage died, ``t_detect`` when the coordinator
        declared it (heartbeat deadline), ``t_end`` when the respawned or
        re-mapped incarnation was back in service; ``t_end - t_fail`` is the
        episode's time-to-recover (the benchmark's MTTR numerator).
        """
        out: list[dict] = []
        open_by_stage: dict[int, dict] = {}
        for ev in self.events:
            if ev.kind == FAIL:
                w = {"stage": ev.stage, "t_fail": ev.t,
                     "fail_kind": ev.info.get("fail_kind", "kill"),
                     "t_detect": None, "t_end": None,
                     "epoch_from": ev.epoch, "epoch_to": None}
                open_by_stage[ev.stage] = w
                out.append(w)
            elif ev.kind == RECOVERY_BEGIN:
                w = open_by_stage.get(ev.stage)
                if w is not None:
                    w["t_detect"] = ev.t
            elif ev.kind == RECOVERY_END:
                w = open_by_stage.pop(ev.stage, None)
                if w is not None:
                    w["t_end"] = ev.t
                    w["epoch_to"] = ev.epoch
                    w["mode"] = ev.info.get("mode", "respawn")
        return out

    def max_epoch(self) -> int:
        return max((ev.epoch for ev in self.events), default=0)

    def to_perfetto(self) -> dict:
        """Chrome trace-event JSON view of this trace (Perfetto-loadable).

        Delegates to :func:`repro_torch.obs.export.to_perfetto`; imported lazily
        so the runtime layer does not depend on the observability layer."""
        from repro_torch.obs.export import to_perfetto

        return to_perfetto(self)

    def final_loss(self) -> float | None:
        return self.meta.get("final_loss")


def engine_replay_config(trace: Trace, base=None):
    """DES-engine replay: consume a recorded trace as a pre-committed order.

    Returns an :class:`~repro_torch.core.engine.EngineConfig` with
    ``replay_trace`` set; the engine resolves it into the trace's realized
    per-stage dispatch orders (order-exact; timing is re-sampled by the
    engine's own cost model — use the actor driver's replay for time-exact
    reproduction).
    """
    import dataclasses as _dc

    from repro_torch.core.engine import EngineConfig

    base = base if base is not None else EngineConfig()
    return _dc.replace(base, replay_trace=trace)


class ReplayOracle:
    """Answers the sim driver's two questions from a recorded trace:
    when does each envelope arrive, and how long does each task run.

    Delivery times are consumed per (task, rank) in recorded order, so a
    chaos duplicate's second copy replays at its own recorded time.
    """

    def __init__(self, trace: Trace):
        self._sched = {k: list(v) for k, v in trace.delivery_schedule().items()}
        self._dur = trace.durations()

    def delivery_times(self, task: Task, rank: int,
                       src_stage: int = -1) -> list[float]:
        key = (tuple(task_key(task)), rank, src_stage)
        if key not in self._sched and src_stage != -1:
            # pre-source-stamp traces: single-edge chains recorded src=-1
            key = (tuple(task_key(task)), rank, -1)
        return self._sched.pop(key, [])

    def duration(self, task: Task) -> float:
        return self._dur[tuple(task_key(task))]
