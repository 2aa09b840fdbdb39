"""Tensor-parallel group consistency barrier (§4.2, Appendix D).

A stage with tp_degree K is K ranks executing in lockstep; the group can only
agree to dispatch a task once *all* ranks hold its input message.  The
:class:`TPGroup` tracks per-rank arrivals and admits a task at the arrival of
its last rank.  Whenever the per-rank arrival spread is nonzero the group has
been *deferred* by rank divergence — the paper's App. D counter.

Each collective-relevant dispatch additionally pays a scalar all-gather
(``coordination_cost``), calibrated to Table 3 like the DES engine.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.taskgraph import Kind, Task

from repro_torch.runtime.rrfp import trace as _tr
from repro_torch.runtime.rrfp.messages import Envelope


@dataclasses.dataclass
class Admission:
    """Result of the last-rank arrival that completed a task's message set."""

    task: Task
    admit_time: float
    spread: float  # max - min per-rank arrival time

    @property
    def deferred(self) -> bool:
        return self.spread > 0.0


class TPGroup:
    """All-ranks readiness gate for one pipeline stage."""

    def __init__(self, stage: int, tp_degree: int = 1, recorder=None,
                 metrics=None):
        self.stage = stage
        self.tp_degree = max(1, tp_degree)
        self.recorder = recorder
        #: per-stage metric shard (:class:`repro_torch.obs.metrics.StageShard`)
        self.metrics = metrics
        #: per-edge rank holds: (task, src_stage) -> {rank: arrival time}.
        #: DAG fan-in stages receive one message per incoming edge for the
        #: same task; each edge's rank set completes independently.
        self._held: dict[tuple[Task, int], dict[int, float]] = {}
        self._admitted: set[tuple[Task, int]] = set()
        self.deferrals = 0
        self.admitted = 0
        self.duplicates = 0

    def was_admitted(self, task: Task, src_stage: int) -> bool:
        return (task, src_stage) in self._admitted

    def offer(self, env: Envelope, now: float) -> Admission | None:
        """Record one rank's copy; return an Admission when the set completes.

        Duplicate deliveries are idempotent at two levels: a repeated rank
        copy is ignored (first arrival wins, matching a receive-side buffer
        that holds the message), and an edge whose rank set already completed
        is never re-admitted — a full set of chaos-duplicated envelopes must
        not re-enqueue an already-buffered task.
        """
        if env.dst_stage != self.stage:
            raise ValueError(
                f"envelope for stage {env.dst_stage} offered to group "
                f"{self.stage}")
        if not 0 <= env.rank < self.tp_degree:
            raise ValueError(f"rank {env.rank} out of range for K={self.tp_degree}")
        key = (env.task, env.src_stage)
        if key in self._admitted:
            self.duplicates += 1
            if self.metrics is not None:
                self.metrics.on_tp_dup()
            self._record(_tr.TP_DUP, env, now, reason="post_admission")
            return None
        holds = self._held.setdefault(key, {})
        if env.rank in holds:
            self.duplicates += 1
            if self.metrics is not None:
                self.metrics.on_tp_dup()
            self._record(_tr.TP_DUP, env, now, reason="rank_held")
            return None
        holds[env.rank] = now
        if len(holds) < self.tp_degree:
            if self.metrics is not None:
                self.metrics.on_tp_hold()
            self._record(_tr.TP_HOLD, env, now,
                         missing=self.tp_degree - len(holds))
            return None
        del self._held[key]
        self._admitted.add(key)
        times = sorted(holds.values())
        spread = times[-1] - times[0]
        if spread > 0:
            self.deferrals += 1
        self.admitted += 1
        if self.metrics is not None:
            self.metrics.on_tp_admit(spread)
        self._record(_tr.TP_ADMIT, env, now, spread=spread)
        return Admission(task=env.task, admit_time=now, spread=spread)

    def _record(self, kind: str, env: Envelope, now: float, **info) -> None:
        if self.recorder is not None:
            self.recorder.record(kind, self.stage, env.task, rank=env.rank,
                                 t=now, src=env.src_stage, **info)

    def pending(self) -> dict[tuple[Task, int], int]:
        """Edges with an incomplete rank set -> number of ranks still missing."""
        return {
            k: self.tp_degree - len(h) for k, h in self._held.items()
        }

    def coordination_cost(self, task: Task, base: float) -> float:
        """Per-dispatch scalar all-gather overhead (F/B only, like the engine)."""
        if self.tp_degree <= 1 or task.kind == Kind.W:
            return 0.0
        return base * (1.0 + math.log2(self.tp_degree))
