"""Per-stage mailbox: message intake + per-kind ready buffers (§4.1).

The mailbox is the only shared state between a stage actor and the transport
that feeds it, so it is fully thread-safe (one lock + condition per mailbox).
Incoming envelopes pass the TP-group admission gate; admitted tasks land in
per-kind *arrival buffers* — the host analog of the paper's four per-stage
message buffers — in FIFO arrival order.  The actor consumes them under the
same lock when it arbitrates.

In simulation mode the driver calls ``deliver`` from the virtual-clock pump
(single thread, the lock is uncontended); in thread mode each sender's actor
thread calls it concurrently.

With a :class:`~repro_torch.runtime.rrfp.trace.TraceRecorder` attached, every
delivery, admission (enqueue) and consumption (dequeue) is logged with the
logical clock — the record side of record/replay.
"""
from __future__ import annotations

import threading
import time as _time

from repro_torch.core.taskgraph import Kind, Task

from repro_torch.runtime.rrfp import trace as _tr
from repro_torch.runtime.rrfp.messages import Envelope
from repro_torch.runtime.rrfp.tp_group import Admission, TPGroup


class Mailbox:
    """Arrival buffers for one stage actor.

    ``fan_in`` (usually ``PipelineSpec.fan_in``) tells the mailbox how many
    distinct source-stage messages a task needs before it is buffered.  On a
    chain that is always 1; on a DAG a fan-in stage's task is buffered only
    once *every* incoming edge has passed the TP admission gate.
    """

    def __init__(self, stage: int, tp_degree: int = 1, recorder=None,
                 fan_in=None, metrics=None):
        self.stage = stage
        self.recorder = recorder
        #: per-stage metric shard (:class:`repro_torch.obs.metrics.StageShard`);
        #: written only under ``cond`` (or the sim pump), never contended
        self.metrics = metrics
        self.fan_in = fan_in or (lambda task: 1)
        self.group = TPGroup(stage, tp_degree, recorder=recorder,
                             metrics=metrics)
        self.cond = threading.Condition()
        #: admitted-but-unconsumed arrivals, FIFO per kind
        self.buffers: dict[Kind, list[Task]] = {k: [] for k in Kind}
        #: tasks buffered since the consumer's last ``drain_arrivals`` (in
        #: admission order): the hand-off that lets ``sync_mailbox`` stop
        #: rescanning already-seen envelopes
        self._fresh: list[Task] = []
        #: admitted payloads per task, keyed by source stage (thread mode)
        self.payloads: dict[Task, dict[int, object]] = {}
        #: source stages whose edge for a task has been TP-admitted
        self._edges: dict[Task, set[int]] = {}
        self.stopped = False
        #: minimum acceptable envelope epoch.  A respawned stage's mailbox
        #: starts at the post-recovery epoch, so any pre-failure straggler
        #: (epoch < this) is *fenced*: dropped before the TP gate, never
        #: admitted.  Survivor mailboxes keep their incarnation's epoch and
        #: still accept in-flight messages from before the failure.
        self.epoch = 0
        #: fenced-envelope count (diagnostics / property tests)
        self.fenced = 0
        #: monotonic wall time of the last admission/consumption (thread-mode
        #: starvation detection)
        self.last_progress = _time.monotonic()
        self.high_water = {k: 0 for k in Kind}

    # ---- producer side ----------------------------------------------------
    def deliver(self, env: Envelope, now: float = 0.0) -> Admission | None:
        """Offer one envelope; buffer the task once its full message set
        (all TP ranks × all fan-in edges) is admitted.  Returns the *edge*
        admission (or None), so callers poke the actor only on progress.

        Envelopes from a recovery epoch older than the mailbox's are fenced
        (dropped, recorded as FENCE) — the total-fencing guarantee that
        makes a respawned incarnation's state independent of pre-failure
        stragglers still in flight."""
        with self.cond:
            # reliable-transport envelopes stamp their per-edge sequence into
            # the record (conformance's check_reliable_delivery keys on it);
            # omitted when -1 so pre-reliable traces stay byte-identical
            rel = {"eseq": env.eseq} if env.eseq >= 0 else {}
            if env.epoch < self.epoch:
                self.fenced += 1
                if self.recorder is not None:
                    self.recorder.record(_tr.FENCE, self.stage, env.task,
                                         rank=env.rank, t=now, seq=env.seq,
                                         src=env.src_stage,
                                         env_epoch=env.epoch,
                                         mailbox_epoch=self.epoch, **rel)
                return None
            if self.recorder is not None:
                self.recorder.record(_tr.DELIVER, self.stage, env.task,
                                     rank=env.rank, t=now, seq=env.seq,
                                     src=env.src_stage, **rel)
            adm = self.group.offer(env, now)
            # Late duplicates of an already-admitted message must not re-stash
            # a payload the consumer has already popped (or never will pop).
            fresh = adm is not None or not self.group.was_admitted(
                env.task, env.src_stage)
            if env.payload is not None and fresh:
                self.payloads.setdefault(env.task, {})[env.src_stage] = \
                    env.payload
            if adm is not None:
                srcs = self._edges.setdefault(env.task, set())
                srcs.add(env.src_stage)
                need = self.fan_in(env.task)
                if len(srcs) < need:
                    # fan-in edge admitted, task still waiting on a branch
                    self.last_progress = _time.monotonic()
                    if self.metrics is not None:
                        self.metrics.on_fanin_hold()
                    if self.recorder is not None:
                        self.recorder.record(
                            _tr.FANIN_HOLD, self.stage, env.task, t=now,
                            src=env.src_stage, missing=need - len(srcs))
                    return adm
                del self._edges[env.task]
                buf = self.buffers[adm.task.kind]
                buf.append(adm.task)
                self._fresh.append(adm.task)
                self.high_water[adm.task.kind] = max(
                    self.high_water[adm.task.kind], len(buf))
                self.last_progress = _time.monotonic()
                if self.metrics is not None:
                    # fused enqueue + transport-latency sample (the latency
                    # of the envelope that completed the message set)
                    self.metrics.on_admitted(adm.task.kind, len(buf),
                                             now - env.send_time)
                if self.recorder is not None:
                    self.recorder.record(_tr.ENQUEUE, self.stage, adm.task,
                                         t=now, src="message")
                self.cond.notify_all()
            return adm

    def deliver_local(self, task: Task, now: float = 0.0) -> None:
        """Buffer a task whose input is locally produced (no message needed):
        stage-0/chunk-0 forwards at iteration start, and the last stage's
        loss gradient."""
        with self.cond:
            self.buffers[task.kind].append(task)
            self._fresh.append(task)
            self.high_water[task.kind] = max(
                self.high_water[task.kind], len(self.buffers[task.kind]))
            self.last_progress = _time.monotonic()
            if self.metrics is not None:
                self.metrics.on_enqueue(task.kind,
                                        len(self.buffers[task.kind]))
            if self.recorder is not None:
                self.recorder.record(_tr.ENQUEUE, self.stage, task, t=now,
                                     src="local")
            self.cond.notify_all()

    def touch(self) -> None:
        """Record actor progress (call under ``cond``).  Task completions
        count against starvation even when no message moved — e.g. a stage
        draining locally-enabled W tasks never touches its buffers but is
        anything but starved."""
        self.last_progress = _time.monotonic()

    def stop(self) -> None:
        """Shut the mailbox down and wake *every* waiter.

        With event-driven actor wakeups there is no poll period to fall
        back on: a blocked actor only wakes on a notify (or its distant
        starvation deadline), so ``notify_all`` here is what makes actor
        threads exit promptly on shutdown/abort."""
        with self.cond:
            self.stopped = True
            self.cond.notify_all()

    # ---- consumer side (call under ``cond``) ------------------------------
    def arrived_tasks(self) -> list[Task]:
        """All buffered tasks in FIFO-per-kind order (F, B, W).

        Diagnostic/test view; the consumer hot path uses
        :meth:`drain_arrivals` so each sync touches only new admissions."""
        out: list[Task] = []
        for k in Kind:
            out.extend(self.buffers[k])
        return out

    def drain_arrivals(self) -> list[Task]:
        """Tasks buffered since the last drain, in admission order.

        The actor's ``sync_mailbox`` memory (its ``arrived`` set) persists
        across drains, so handing each admission over exactly once is
        sufficient — and turns per-sync cost from O(buffered) rescans into
        O(new)."""
        out = self._fresh
        if out:
            self._fresh = []
        return out

    def consume(self, task: Task, now: float = 0.0) -> object:
        """Remove a dispatched task from its buffer; return its payload.

        Single-predecessor tasks get the raw payload (chain behavior);
        fan-in tasks get a ``{src_stage: payload}`` dict — one entry per
        incoming edge — which the stage program routes to its inputs.
        """
        self.buffers[task.kind].remove(task)
        self.last_progress = _time.monotonic()
        if self.metrics is not None:
            self.metrics.on_dequeue(task.kind)
        if self.recorder is not None:
            self.recorder.record(_tr.DEQUEUE, self.stage, task, t=now)
        by_src = self.payloads.pop(task, None)
        if by_src is None:
            return None
        if self.fan_in(task) <= 1:
            return next(iter(by_src.values()))
        return by_src

    def wait_for_work(self, timeout: float | None = None) -> bool:
        """Block until new work arrives or ``stop``; False on timeout."""
        return self.cond.wait(timeout)

    def starved_for(self) -> float:
        """Seconds since the mailbox last made progress (thread mode)."""
        return _time.monotonic() - self.last_progress
