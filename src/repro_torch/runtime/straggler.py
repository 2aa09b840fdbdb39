"""Straggler mitigation: the RRFP readiness loop at host timescale.

On GPU the paper's runtime reacts to realized readiness per task; an XLA step
is atomic, so the reaction point moves to step boundaries: per-stage step
timings update an EMA cost model (the paper's e_t estimator, RQ4) and a
sustained skew triggers schedule re-synthesis — the new table is data, so no
recompilation happens.  On persistent device loss, ``runtime.elastic`` plans
a re-mesh from the last checkpoint instead.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.costs import CostModel
from repro_torch.core.engine import RunResult
from repro_torch.core.hints import HintKind
from repro_torch.core.synthesis import ema_update_costs, synthesize
from repro_torch.core.taskgraph import Kind, PipelineSpec
from repro_torch.pipeline.spec import ScheduleTable, from_stage_orders


@dataclasses.dataclass
class StragglerMonitor:
    spec: PipelineSpec
    costs: CostModel
    threshold: float = 1.25  # re-plan when max/median stage EMA exceeds this
    decay: float = 0.9
    hint: HintKind = HintKind.BF
    min_steps_between_replans: int = 10
    _steps_since: int = 0
    replans: int = 0

    def observe(self, stage_f_times: np.ndarray,
                stage_b_times: np.ndarray) -> ScheduleTable | None:
        """Feed per-stage measured times; returns a new table when skew
        warrants re-synthesis, else None."""
        self.costs = ema_update_costs(
            self.costs, stage_f_times, stage_b_times, decay=self.decay)
        self._steps_since += 1
        skew = float(self.costs.f_cost.max() / max(np.median(self.costs.f_cost), 1e-12))
        if (skew > self.threshold
                and self._steps_since >= self.min_steps_between_replans):
            self._steps_since = 0
            self.replans += 1
            syn = synthesize(self.spec, self.costs, hint=self.hint)
            return from_stage_orders(self.spec, syn.stage_orders)
        return None

    def observe_result(self, result: RunResult) -> ScheduleTable | None:
        """EMA feedback from realized actor-runtime (or DES) task timings.

        Collapses a :class:`RunResult` trace to per-stage mean F/B durations
        and feeds :meth:`observe` — the paper's e_t estimator driven by the
        host runtime's own dispatch records instead of external profiling.
        """
        f = result.durations(Kind.F).mean(axis=1)
        b = result.durations(Kind.B).mean(axis=1)
        return self.observe(f, b)
