"""ScheduleTable: the compiled executor's tick-grid schedule.

A table assigns every (stage, tick) one op (IDLE/F/B/W) and a microbatch id.
``from_stage_orders`` list-schedules per-stage task sequences (e.g. the
realized orders extracted from the RRFP engine) onto the grid under the
executor's communication model: one ring-permute hop per tick, so a message
produced at tick t is consumable at tick t+1.

``validate`` enforces exactly the paper's buffer-policy legality (App. C):
dependency order, one op per stage per tick, and bounded buffer-slot
occupancy (no two in-flight microbatches may collide in a slot).  The
returned occupancy maxima size the executor's on-device buffers.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.taskgraph import Kind, PipelineSpec, Task

OP_IDLE, OP_F, OP_B, OP_W = 0, 1, 2, 3
OP_NAMES = {OP_IDLE: ".", OP_F: "F", OP_B: "B", OP_W: "W"}


@dataclasses.dataclass
class ScheduleTable:
    spec: PipelineSpec
    ops: np.ndarray  # [S, T] int32
    mbs: np.ndarray  # [S, T] int32

    @property
    def num_ticks(self) -> int:
        return self.ops.shape[1]

    # ------------------------------------------------------------------
    def tick_of(self) -> dict[Task, int]:
        out = {}
        S, T = self.ops.shape
        kind_of = {OP_F: Kind.F, OP_B: Kind.B, OP_W: Kind.W}
        for s in range(S):
            for t in range(T):
                if self.ops[s, t] != OP_IDLE:
                    out[Task(kind_of[int(self.ops[s, t])], s, int(self.mbs[s, t]))] = t
        return out

    # ------------------------------------------------------------------
    def validate(self) -> dict[str, int]:
        """Check legality; return buffer occupancy maxima.

        Occupancies (per stage):
          act   — activation received from prev stage, held until F runs
          res   — F's input saved for recompute, held until B (and W) run
          grad  — gradient received from next stage, held until B runs
        """
        spec = self.spec
        S, M = spec.num_stages, spec.num_microbatches
        tick = self.tick_of()
        expect = set(spec.tasks())
        got = set(tick)
        if got != expect:
            missing = sorted(expect - got)[:4]
            extra = sorted(got - expect)[:4]
            raise ValueError(f"schedule incomplete: missing={missing} extra={extra}")
        # dependencies (message deps need a full tick of transit)
        for task, t in tick.items():
            mp = spec.message_predecessor(task)
            if mp is not None and tick[mp] >= t:
                raise ValueError(f"{task}@{t} before message dep {mp}@{tick[mp]}")
            lp = spec.local_predecessor(task)
            if lp is not None and tick[lp] >= t:
                raise ValueError(f"{task}@{t} before local dep {lp}@{tick[lp]}")
        # buffer occupancy intervals; the executor keys slots by mb % K, so K
        # must cover the microbatch-index *span* of concurrently live entries
        occ = {"act": 0, "res": 0, "grad": 0,
               "act_span": 0, "res_span": 0, "grad_span": 0}
        for s in range(S):
            ivs = {"act": [], "res": [], "grad": []}
            for j in range(M):
                f_t = tick[Task(Kind.F, s, j)]
                b_t = tick[Task(Kind.B, s, j)]
                end_t = tick[Task(Kind.W, s, j)] if spec.split_backward else b_t
                if s > 0:
                    ivs["act"].append((tick[Task(Kind.F, s - 1, j)] + 1, f_t, j))
                ivs["res"].append((f_t, end_t, j))
                if s < S - 1:
                    end_g = (tick[Task(Kind.W, s, j)]
                             if spec.split_backward else b_t)
                    ivs["grad"].append((tick[Task(Kind.B, s + 1, j)] + 1, end_g, j))
            for name, iv in ivs.items():
                occ[name] = max(occ[name], _max_overlap([(a, b) for a, b, _ in iv]))
                occ[name + "_span"] = max(occ[name + "_span"], _max_span(iv))
        return occ

    def render(self) -> str:
        S, T = self.ops.shape
        rows = []
        for s in range(S):
            cells = [
                f"{OP_NAMES[int(self.ops[s, t])]}{int(self.mbs[s, t]):<2d}"
                if self.ops[s, t] != OP_IDLE else " . "
                for t in range(T)
            ]
            rows.append(f"s{s:<2d} " + " ".join(cells))
        return "\n".join(rows)

    def bubble_fraction(self) -> float:
        busy = (self.ops != OP_IDLE).sum()
        return 1.0 - busy / self.ops.size


def _max_overlap(intervals) -> int:
    events = []
    for a, b in intervals:
        events.append((a, 1))
        events.append((b + 1, -1))
    events.sort()
    cur = peak = 0
    for _, d in events:
        cur += d
        peak = max(peak, cur)
    return peak


def _max_span(intervals) -> int:
    """Max (max_j - min_j + 1) over microbatches live at the same tick."""
    if not intervals:
        return 0
    ticks = sorted({t for a, b, _ in intervals for t in (a, b)})
    span = 0
    for t in ticks:
        live = [j for a, b, j in intervals if a <= t <= b]
        if live:
            span = max(span, max(live) - min(live) + 1)
    return span


# ---------------------------------------------------------------------------
def from_stage_orders(
    spec: PipelineSpec, stage_orders: list[list[Task]]
) -> ScheduleTable:
    """Greedy list-schedule of per-stage task sequences onto the tick grid.

    Each stage executes its sequence in order; a task waits until its
    dependencies' completion ticks are strictly earlier (message deps need
    one transit tick, modeled by the strict inequality).
    """
    S, M = spec.num_stages, spec.num_microbatches
    tick: dict[Task, int] = {}
    ptr = [0] * S
    stage_free = [0] * S  # earliest tick the stage can run something
    placed = 0
    total = spec.total_tasks()
    ops = []
    while placed < total:
        progress = False
        for s in range(S):
            while ptr[s] < len(stage_orders[s]):
                task = stage_orders[s][ptr[s]]
                deps = spec.predecessors(task)
                ready_at = stage_free[s]
                ok = True
                for d in deps:
                    if d not in tick:
                        ok = False
                        break
                    ready_at = max(ready_at, tick[d] + 1)
                if not ok:
                    break
                tick[task] = ready_at
                stage_free[s] = ready_at + 1
                ptr[s] += 1
                placed += 1
                progress = True
        if not progress:
            stuck = [
                stage_orders[s][ptr[s]]
                for s in range(S)
                if ptr[s] < len(stage_orders[s])
            ]
            raise ValueError(f"cyclic stage orders; stuck at {stuck[:4]}")
    T = max(tick.values()) + 1
    ops_arr = np.zeros((S, T), np.int32)
    mbs_arr = np.zeros((S, T), np.int32)
    op_of = {Kind.F: OP_F, Kind.B: OP_B, Kind.W: OP_W}
    for task, t in tick.items():
        ops_arr[task.stage, t] = op_of[task.kind]
        mbs_arr[task.stage, t] = task.mb
    return ScheduleTable(spec=spec, ops=ops_arr, mbs=mbs_arr)
