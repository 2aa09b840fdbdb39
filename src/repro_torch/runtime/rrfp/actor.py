"""Stage actors: readiness-driven dispatch at host level (§4, §5, App. A/C).

A :class:`StageActor` owns one pipeline stage's scheduling state: the set of
tasks whose messages have been admitted (``arrived``), the currently ready
set, the done set, the F/B balance counters for Appendix C backpressure, and
a :class:`~repro_torch.core.hints.HintArbiter` for ready-set arbitration.  The
actor is *reactive*: it makes a dispatch decision only when poked by an
arrival or a completion — there is no schedule-table tick anywhere.

The same actor expresses both consumption modes of the paper's central
contrast:

* ``hint``        — Algorithm 1 over the current ready set, plus the App. C
                    backward-only / deterministic drain under backpressure;
* ``precommitted``— follow a fixed per-stage order, waiting on any entry
                    that is not yet ready (1F1B / GPipe / ZB baselines).

``run_thread`` is the thread-per-stage execution loop used by the
ThreadTransport: it blocks on the mailbox condition, dispatches real work
callables, and reports completions back through the transport.
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import Any, Callable

from repro_torch.core.engine import DeadlockError, StageStats
from repro_torch.core.hints import (
    HintArbiter,
    HintKind,
    ReadySet,
    backpressure_drain,
    pick,
    table_ranks,
)
from repro_torch.core.taskgraph import Kind, PipelineSpec, Task

from repro_torch.runtime.rrfp import trace as _tr
from repro_torch.runtime.rrfp.mailbox import Mailbox
from repro_torch.runtime.rrfp.messages import (
    EdgePayloads,
    envelopes_for,
    payload_for_edge,
)


@dataclasses.dataclass
class TaskTrace:
    """One dispatch record (start/end on the driver's clock)."""

    task: Task
    start: float
    end: float


class StageActor:
    """Scheduling brain + (optionally) execution thread for one stage."""

    def __init__(
        self,
        idx: int,
        spec: PipelineSpec,
        mailbox: Mailbox,
        *,
        mode: str = "hint",
        hint: HintKind = HintKind.BF,
        order: list[Task] | None = None,
        buffer_limit: int = 32,
        w_defer_cap: int = 0,
        reference_arbitration: bool = False,
        trace_full_ready: bool = False,
        metrics=None,
        table: list[Task] | None = None,
        table_version: int = 0,
    ):
        if mode not in ("hint", "precommitted"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "precommitted" and order is None:
            raise ValueError("precommitted mode needs a per-stage order")
        if table is not None and mode != "hint":
            raise ValueError("a rank table is a hint-mode consumption knob")
        self.idx = idx
        self.spec = spec
        self.mailbox = mailbox
        self.recorder = mailbox.recorder
        self.mode = mode
        self.arbiter = HintArbiter(hint)
        #: synthesized-schedule-as-data: when set, the arbiter serves the
        #: minimum-rank ready task under this table instead of the
        #: directional round structure (still non-binding; see
        #: docs/adaptive.md).  Hot-swapped mid-run via set_hint_table().
        self.table_version = table_version
        if table is not None:
            self.arbiter.table = table_ranks(table)
        self.order = order
        self.order_pos = 0
        #: thread-substrate swap trigger (driver-armed): adopt swap_table
        #: after this stage's swap_after-th completion — a per-stage
        #: quiesce point (no task in flight when it fires)
        self.swap_table: list[Task] | None = None
        self.swap_after: int | None = None
        self._n_complete = 0
        self.buffer_limit = buffer_limit
        self.w_defer_cap = w_defer_cap
        #: verification knob: arbitrate via the reference sort-then-rank
        #: path (decision-identical; only the per-decision cost differs)
        self.reference_arbitration = reference_arbitration
        #: record full sorted ready snapshots per dispatch instead of the
        #: cheap incremental diff (``radd``) encoding
        self.trace_full_ready = trace_full_ready
        #: per-stage single-writer metric shard
        #: (:class:`repro_torch.obs.metrics.StageShard`), or None = zero-cost
        self.metrics = metrics
        self.arrived: set[Task] = set()
        self.ready = ReadySet(table=self.arbiter.table)
        self.done: set[Task] = set()
        #: ready-set additions since the last recorded dispatch (diff-mode
        #: trace snapshots; maintained only while a recorder is attached)
        self._ready_added: list[Task] = []
        #: lazily built waiting_on() index (diagnostics)
        self._awaiting: set[Task] | None = None
        self.n_f = 0
        self.n_b = 0
        self.n_w = 0
        self.drain_focus = 0
        self.stats = StageStats()
        self.traces: list[TaskTrace] = []
        self._total = spec.num_tasks_per_stage()
        #: execution heartbeat (thread substrate): ``time.monotonic()`` at
        #: which the currently-running ``work_fn`` started, or None when not
        #: executing.  The recovery coordinator's watchdog reads this to
        #: detect a permanently-stalled stage by heartbeat staleness.
        self.exec_since: float | None = None
        #: thread substrate: set (under the mailbox condition) by the
        #: recovery coordinator to kill a *live* incarnation — e.g. the
        #: victim of a link failure, which is healthy but unreachable.  The
        #: run loop re-checks it at both quiesce points (the wait loop and
        #: immediately before recording a completion), so a halted actor can
        #: never commit state after its successor incarnation exists.
        self.halted = False

    # ---- readiness bookkeeping (call under the mailbox lock) ---------------
    def _is_ready(self, t: Task) -> bool:
        # the mailbox buffers a task only when its full message set (all TP
        # ranks x all fan-in edges) has been admitted, so task-level arrival
        # tracking stays correct on DAG specs
        if self.spec.fan_in(t) > 0 and t not in self.arrived:
            return False
        lp = self.spec.local_predecessor(t)
        if lp is not None and lp not in self.done:
            return False
        return True

    def _maybe_enqueue(self, t: Task) -> None:
        if t not in self.done and t not in self.ready and self._is_ready(t):
            self.ready.add(t)
            if self.recorder is not None and not self.trace_full_ready:
                self._ready_added.append(t)

    def sync_mailbox(self) -> None:
        """Drain arrivals admitted since the last sync into the ready set.

        ``Mailbox.drain_arrivals`` hands over only the tasks buffered since
        the previous drain, so repeated syncs stop rescanning already-seen
        envelopes; ``self.arrived`` is the persistent memory that lets a
        task whose local predecessor lags be re-attempted at the
        predecessor's completion."""
        for t in self.mailbox.drain_arrivals():
            self.arrived.add(t)
            if self._awaiting is not None:
                self._awaiting.discard(t)
            self._maybe_enqueue(t)

    # ---- arbitration -------------------------------------------------------
    def backpressured(self) -> bool:
        return self.mode == "hint" and self.n_f - self.n_b >= self.buffer_limit

    def w_backlog(self) -> int:
        """Completed-B microbatches whose W has not executed yet.  Each holds
        a stashed (x, g_in) pair, so this is the stage's deferred-W
        activation-memory footprint."""
        return self.n_b - self.n_w

    def w_overcap(self) -> bool:
        """App. C-style memory backpressure on W deferral: at the cap the
        stage must retire a weight-gradient task before any further B."""
        return (self.mode == "hint" and self.spec.split_backward
                and self.w_defer_cap > 0
                and self.w_backlog() >= self.w_defer_cap)

    def set_hint_table(self, order: list[Task], now: float = 0.0,
                       version: int | None = None) -> None:
        """Hot-swap a re-synthesized rank table into the live arbiter.

        Schedules are data: the swap replaces a priority table (O(ready)
        heap rebuild), no recompilation, no draining of in-flight work
        beyond the caller's quiesce point — the sim driver fires it
        between heap events, the thread loop under the mailbox condition
        right after a completion.  Recorded as a HINT_SWAP trace event
        (with the full new order) so replay and the conformance
        table-faithfulness check reconstruct the active table exactly."""
        ranks = table_ranks(order)
        self.arbiter.set_table(ranks)
        self.ready.set_table(ranks)
        self.table_version = (self.table_version + 1 if version is None
                              else version)
        if self.recorder is not None:
            self.recorder.record(
                _tr.HINT_SWAP, self.idx, t=now, version=self.table_version,
                order=[_tr.task_key(t) for t in order])

    def select(self) -> Task | None:
        """Pick the next task to dispatch from the *currently* ready set."""
        return self.select_traced()[0]

    def select_traced(self) -> tuple[Task | None, dict | None]:
        """Like ``select``, plus the arbitration path taken — recorded into
        the dispatch event so the conformance checker can verify, offline,
        that each decision followed the hint (or deviated only because the
        hinted task was unready).  The info dict is only materialized when a
        recorder or a metric shard is attached: this runs on the dispatch
        hot path of every arbitration attempt.

        With metrics attached the hint path also stamps ``slot``: the index
        of the dispatched task's *kind* in the arbiter's preference order —
        the hint-divergence metric (0 = hinted direction served, >0 = the
        hinted direction was unready).  Within a direction the dispatched
        task is always the App. A minimum ready candidate (conformance's
        hint-faithfulness invariant), so kind-level rank is the whole
        divergence signal."""
        rec = self.recorder is not None
        obs = rec or self.metrics is not None
        ref = self.reference_arbitration
        # Failed attempts (task None) always return info None: nothing is
        # recorded or counted for a no-dispatch, and roughly half of all
        # arbitration attempts fail, so they must not pay the dict/tuple
        # materialization.
        if self.mode == "precommitted":
            if self.order_pos >= len(self.order):
                return None, None
            nxt = self.order[self.order_pos]
            if nxt not in self.ready:
                return None, None
            return nxt, ({"path": "precommitted"} if obs else None)
        if self.w_overcap():
            # Every completed B locally enables its W, so a ready W exists
            # whenever the backlog is nonzero; retiring it frees the stash.
            task = pick(sorted(self.ready) if ref else self.ready, Kind.W)
            if task is not None:
                return task, ({"path": "wcap", "backlog": self.w_backlog()}
                              if obs else None)
        if self.backpressured():
            task, self.drain_focus = backpressure_drain(
                self.spec, self.idx,
                sorted(self.ready) if ref else self.ready, self.done,
                self.drain_focus)
            if task is None:
                return None, None
            return task, ({"path": "backpressure"} if obs else None)
        # select() advances the round alternation, so capture last_dir
        # first: order/slot are reconstructed post-hoc only on a dispatch.
        prev_dir = self.arbiter.last_dir
        task = self.arbiter.select(sorted(self.ready) if ref else self.ready)
        if not obs or task is None:
            return task, None
        if self.arbiter.table is not None:
            # rank-table consumption: no directional round structure, so
            # no order/slot — faithfulness is checked against the table
            return task, {"path": "table", "tv": self.table_version}
        info: dict = {"path": "hint"}
        if rec:
            info["order"] = [
                int(k) for k in self.arbiter.order_given(prev_dir)]
        if self.metrics is not None:
            info["slot"] = self.arbiter.rank_given(task.kind, prev_dir)
        return task, info

    def begin(self, task: Task, now: float = 0.0,
              info: dict | None = None) -> Any:
        """Commit to a dispatch: consume the task's buffered message (if any)
        and return its payload."""
        if self.metrics is not None:
            # info is always materialized when a shard is attached
            self.metrics.on_dispatch(task, len(self.ready), info["path"],
                                     info.get("slot"))
        if self.recorder is not None:
            # Ready-set snapshot: the default "diff" encoding records only
            # the tasks *added* since this stage's previous dispatch (the
            # sole removal between dispatches is the dispatched task
            # itself), so recording stops paying O(n log n) per decision —
            # `Trace.ready_sets()` reconstructs the full snapshots offline.
            # `trace_full_ready` opts back into the verbose sorted form.
            if self.trace_full_ready:
                snap = {"ready": [_tr.task_key(t) for t in sorted(self.ready)]}
            else:
                snap = {"radd": [_tr.task_key(t) for t in self._ready_added]}
                self._ready_added = []
            self.recorder.record(
                _tr.DISPATCH, self.idx, task, t=now, **snap, **(info or {}))
        self.ready.discard(task)
        if self.mode == "precommitted":
            self.order_pos += 1
        payload = None
        if task in self.mailbox.buffers[task.kind]:
            payload = self.mailbox.consume(task, now=now)
        return payload

    def complete(self, task: Task, now: float = 0.0,
                 dur: float | None = None) -> tuple[Task, ...]:
        """Mark done, enable local successors; return the remote successors
        whose messages must now be sent (empty for stage-local results)."""
        self.done.add(task)
        if task.kind == Kind.F:
            self.n_f += 1
            self._maybe_enqueue(Task(Kind.B, self.idx, task.mb, task.chunk))
        elif task.kind == Kind.B:
            self.n_b += 1
            if self.spec.split_backward:
                self._maybe_enqueue(Task(Kind.W, self.idx, task.mb, task.chunk))
        elif task.kind == Kind.W:
            self.n_w += 1
        if self.metrics is not None and dur is not None:
            self.metrics.on_complete(
                task, dur,
                (self.n_b - self.n_w) if self.spec.split_backward else 0)
        if self.recorder is not None:
            info: dict[str, Any] = {"nf": self.n_f, "nb": self.n_b}
            if dur is not None:
                info["dur"] = dur
            if self.spec.split_backward:
                info["w_backlog"] = self.w_backlog()
            if self.metrics is not None and dur is not None:
                # annotate with the live cost-table state: extra info fields
                # that save/load and ReplayOracle must tolerate
                info["ewma"] = self.metrics.cost_ewma[task.kind].value
            self.recorder.record(_tr.COMPLETE, self.idx, task, t=now, **info)
        # W tasks are stage-local by construction: message_successors(W) is
        # empty, so no envelope is emitted and no TP admission gate applies.
        # DAG fan-out tasks feed one successor per outgoing edge.
        return self.spec.message_successors(task)

    def finished(self) -> bool:
        return len(self.done) == self._total

    def waiting_on(self) -> list[Task]:
        """Diagnostics: not-yet-done tasks whose message set is incomplete.

        The index is built once on first use (this-stage tasks that need a
        message and have not yet arrived) and then maintained incrementally
        by ``sync_mailbox``, so repeated diagnostic polls cost O(pending)
        instead of re-scanning every task in the spec."""
        if self._awaiting is None:
            self._awaiting = {
                t for t in self.spec.tasks()
                if t.stage == self.idx and t not in self.arrived
                and self.spec.fan_in(t) > 0}
        return sorted(self._awaiting - self.done)

    # ---- thread-per-stage execution loop (ThreadTransport) -----------------
    def run_thread(
        self,
        work_fn: Callable[[Task, Any], Any],
        transport,
        clock: Callable[[], float],
        *,
        tp_degree: int = 1,
        deadlock_timeout: float = 30.0,
        abort=None,
    ) -> None:
        """Execute this stage's tasks as they become ready.

        ``work_fn(task, payload) -> out_payload`` runs the real computation
        (e.g. a jitted stage callable); ``out_payload`` rides on the outgoing
        envelope.  Raises :class:`DeadlockError` if the mailbox starves for
        ``deadlock_timeout`` seconds while work remains.

        The wait is event-driven: the actor blocks on the mailbox condition
        until ``Mailbox.deliver``/``deliver_local``/``stop`` notifies it —
        zero busy-wait, wakeup latency bounded by the notify, not by a poll
        period.  The only timed wake is the starvation deadline (deadlock
        detection), so abort/stop signals must notify the condition to be
        seen promptly (``Mailbox.stop`` does; the driver stops every
        mailbox when a sibling stage errors).
        """
        idle_since = clock()
        while not self.finished():
            if abort is not None and abort.is_set():
                return
            with self.mailbox.cond:
                task = None
                while True:
                    if self.halted:
                        return
                    self.sync_mailbox()
                    task, sel_info = self.select_traced()
                    if task is not None or self.finished():
                        break
                    if self.mailbox.stopped or (
                            abort is not None and abort.is_set()):
                        return
                    remaining = deadlock_timeout - self.mailbox.starved_for()
                    if remaining <= 0:
                        if abort is not None:
                            abort.set()
                        raise DeadlockError(
                            f"stage {self.idx} starved >{deadlock_timeout}s "
                            f"with {self._total - len(self.done)} tasks left; "
                            f"waiting on messages for {self.waiting_on()[:4]}")
                    self.mailbox.wait_for_work(remaining)
                if task is None:  # finished() flipped
                    return
                payload = self.begin(task, now=clock(), info=sel_info)
            start = clock()
            self.stats.blocking += max(0.0, start - idle_since)
            self.exec_since = _time.monotonic()
            try:
                out_payload = work_fn(task, payload)
            finally:
                self.exec_since = None
            end = clock()
            self.stats.compute += end - start
            with self.mailbox.cond:
                if self.halted:
                    # killed mid-execution (link failure on a live stage):
                    # the successor incarnation re-executes this task, so
                    # committing it here would double-complete it
                    return
                succs = self.complete(task, now=end, dur=end - start)
                self._n_complete += 1
                if (self.swap_table is not None
                        and self._n_complete == self.swap_after):
                    # quiesce point: this stage holds no in-flight task
                    self.set_hint_table(self.swap_table, now=end)
                self.mailbox.touch()
            self.traces.append(TaskTrace(task, start, end))
            idle_since = end
            if isinstance(out_payload, EdgePayloads):
                # a missing edge entry would silently deliver payload=None
                # (downstream substitutes a zero gradient) — fail fast
                missing = [t.stage for t in succs
                           if t.stage not in out_payload]
                if missing:
                    raise ValueError(
                        f"stage {self.idx}: {task!r} returned EdgePayloads "
                        f"without entries for successor stage(s) {missing}")
            for succ in succs:
                for env in envelopes_for(
                        succ, self.idx, tp_degree, send_time=end,
                        payload=payload_for_edge(out_payload, succ.stage)):
                    transport.send(env, now=end)
