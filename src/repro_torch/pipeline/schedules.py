"""Schedule-table builders for the compiled executor.

Fixed baselines (GPipe / 1F1B / ZB-lite) come from the same per-stage order
generators the engine's pre-committed mode uses; the RRFP tables come from
``core.synthesis`` — the readiness-driven engine run on the (EMA-updated)
cost model.  All are just data to the executor: switching schedule never
recompiles.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.costs import CostModel
from repro_torch.core.hints import (
    HintKind,
    gpipe_order,
    one_f_one_b_order,
    zero_bubble_order,
)
from repro_torch.core.synthesis import synthesize
from repro_torch.core.taskgraph import Kind, PipelineSpec, Task
from repro_torch.pipeline.spec import ScheduleTable, from_stage_orders


def gpipe(spec: PipelineSpec) -> ScheduleTable:
    return from_stage_orders(
        spec, [gpipe_order(spec, s) for s in range(spec.num_stages)]
    )


def one_f_one_b(spec: PipelineSpec) -> ScheduleTable:
    return from_stage_orders(
        spec, [one_f_one_b_order(spec, s) for s in range(spec.num_stages)]
    )


def zero_bubble(spec: PipelineSpec) -> ScheduleTable:
    assert spec.split_backward
    return from_stage_orders(
        spec, [zero_bubble_order(spec, s) for s in range(spec.num_stages)]
    )


def rrfp(
    spec: PipelineSpec,
    costs: CostModel | None = None,
    hint: HintKind = HintKind.BF,
    buffer_limit: int = 32,
) -> ScheduleTable:
    """Readiness-driven table: what the RRFP runtime would realize under the
    expected cost model (uniform costs if none provided)."""
    if costs is None:
        costs = CostModel.uniform(spec.num_stages)
    syn = synthesize(spec, costs, hint=hint, buffer_limit=buffer_limit)
    return from_stage_orders(spec, syn.stage_orders)


def decode_forward(spec: PipelineSpec) -> ScheduleTable:
    """F-only staircase for serve_step: M micro-groups through S stages."""
    S, M = spec.num_stages, spec.num_microbatches
    T = M + S - 1
    from repro_torch.pipeline.spec import OP_F

    ops = np.zeros((S, T), np.int32)
    mbs = np.zeros((S, T), np.int32)
    for s in range(S):
        for j in range(M):
            ops[s, s + j] = OP_F
            mbs[s, s + j] = j
    return ScheduleTable(spec=spec, ops=ops, mbs=mbs)


BUILDERS = {
    "gpipe": gpipe,
    "1f1b": one_f_one_b,
    "zb": zero_bubble,
    "rrfp": rrfp,
}
