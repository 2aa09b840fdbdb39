"""Coz-style causal what-if profiling over the critical-path graph.

A :class:`Speedup` is a *virtual* speedup — "what if this op class / this
stage / the message latencies were ``factor``× as expensive" — applied to
the :class:`~repro_torch.obs.critpath.ExecGraph` recurrence rather than to the
system.  :func:`predict` re-runs the generative recurrence with scaled
durations (``dur * factor`` for matching compute nodes) or scaled
SEND->DELIVER latencies (``comm * factor``), holding everything the
speedup does not touch — dispatch residuals, gate residuals, coordination,
and the recorded dependency structure — fixed.  The answer is what Coz
calls a causal profile: the *predicted* makespan if only that one thing
got faster, with zero re-execution.

Two deliberate exactness properties:

* ``factor == 1.0`` regenerates the recorded makespan (to ~1e-9 relative —
  the recurrence is :meth:`ExecGraph.verify`'s identity);
* **recovery windows are pinned**: a recovery node's completion stays at
  its *recorded* RECOVERY_END regardless of upstream speedups, so MTTR is
  attributed, never "sped up" — detection deadlines and restore costs do
  not shrink because a kernel got faster (the recovery-aware mirror of the
  cost table's epoch-aware EWMA hygiene).

:func:`apply_to_cost_model` maps the same speedup spec onto a
:class:`~repro_torch.core.costs.CostModel` so a benchmark can *realize* the
speedup in an actual DES rerun and gate predicted-vs-realized error
(``benchmarks/critical_path.py`` -> ``BENCH_critpath.json``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.costs import CostModel

from repro_torch.obs.critpath import ROOT_KEY, ExecGraph

#: op-class label -> CostModel rows it scales (dX/dW are the split-backward
#: names of the B/W rows)
_OP_ROWS = {"F": ("f",), "B": ("b",), "dX": ("b",), "W": ("w",),
            "dW": ("w",)}


@dataclasses.dataclass(frozen=True)
class Speedup:
    """One virtual speedup: scale an op class, a stage, or comm latency.

    ``factor`` multiplies the matched durations (0.5 = twice as fast,
    2.0 = twice as slow — virtual slowdowns are valid what-ifs too).
    ``op`` and ``stage`` compose conjunctively ("dX on stage 2"); ``comm``
    is its own edge-latency class and ignores both.
    """

    factor: float
    op: str | None = None      # "F" / "B" / "W" / "dX" / "dW"
    stage: int | None = None
    comm: bool = False

    def __post_init__(self):
        if not (self.factor > 0.0):
            raise ValueError(f"factor must be > 0, got {self.factor}")
        if self.comm and (self.op is not None or self.stage is not None):
            raise ValueError("comm speedups scale edge latency only; "
                             "op/stage do not apply")
        if self.op is not None and self.op not in _OP_ROWS:
            raise ValueError(f"unknown op class {self.op!r}")

    def describe(self) -> str:
        if self.comm:
            return f"comm x{self.factor:g}"
        parts = []
        if self.op is not None:
            parts.append(self.op)
        if self.stage is not None:
            parts.append(f"stage {self.stage}")
        return f"{' @ '.join(parts) or 'compute'} x{self.factor:g}"

    def matches(self, op: str, stage: int) -> bool:
        if self.comm:
            return False
        if self.op is not None and op != self.op:
            return False
        if self.stage is not None and stage != self.stage:
            return False
        return True


def predict_ends(graph: ExecGraph,
                 speedups: list[Speedup]) -> dict[tuple, float]:
    """Per-node predicted completion under the virtual speedups."""
    comm_scale = 1.0
    for s in speedups:
        if s.comm:
            comm_scale *= s.factor
    ends: dict[tuple, float] = {ROOT_KEY: 0.0}
    for key in graph.order:
        if key == ROOT_KEY:
            continue
        n = graph.nodes[key]
        if n.op == "recovery":
            # MTTR is pinned: the outage ends when it ended
            ends[key] = n.end_t
            continue
        arr = max((ends.get(e.src, graph.nodes[e.src].end_t)
                   + e.comm * comm_scale + e.gate
                   for e in n.in_edges), default=0.0)
        dur = n.dur
        for s in speedups:
            if s.matches(n.op, n.stage):
                dur *= s.factor
        ends[key] = arr + n.residual + n.coord + dur
    return ends


def predict(graph: ExecGraph, speedups: list[Speedup]) -> float:
    """Predicted makespan under the virtual speedups (no re-execution)."""
    ends = predict_ends(graph, speedups)
    return max(ends.values(), default=0.0)


def apply_to_cost_model(cm: CostModel,
                        speedups: list[Speedup]) -> CostModel:
    """Realize the speedups in a cost model (for a validating DES rerun).

    Compute speedups scale the matching base-cost rows (jitter is
    multiplicative, so CRN-seeded realized durations scale exactly
    proportionally); comm speedups scale ``comm_base``.
    """
    f = cm.f_cost.copy()
    b = cm.b_cost.copy()
    w = cm.w_cost.copy()
    rows = {"f": f, "b": b, "w": w}
    comm = cm.comm_base
    for s in speedups:
        if s.comm:
            comm *= s.factor
            continue
        names = _OP_ROWS[s.op] if s.op is not None else ("f", "b", "w")
        idx = slice(None) if s.stage is None else s.stage
        for name in names:
            rows[name][idx] = rows[name][idx] * s.factor
    return dataclasses.replace(cm, f_cost=f, b_cost=b, w_cost=w,
                               comm_base=comm)


def candidate_speedups(graph: ExecGraph,
                       factor: float = 0.75) -> list[Speedup]:
    """The default what-if sweep: each op class present on the graph, each
    stage's compute, and the comm edge-latency class."""
    ops = sorted({n.op for n in graph.nodes.values()
                  if n.task is not None})
    stages = sorted({n.stage for n in graph.nodes.values()
                     if n.task is not None})
    out = [Speedup(factor=factor, op=op) for op in ops]
    out += [Speedup(factor=factor, stage=s) for s in stages]
    out.append(Speedup(factor=factor, comm=True))
    return out


def rank(graph: ExecGraph, speedups: list[Speedup] | None = None,
         factor: float = 0.75) -> list[dict]:
    """Rank virtual speedups by predicted makespan gain (best first)."""
    base = graph.makespan
    out = []
    for s in (speedups if speedups is not None
              else candidate_speedups(graph, factor)):
        p = predict(graph, [s])
        out.append({
            "speedup": s.describe(),
            "op": s.op, "stage": s.stage, "comm": s.comm,
            "factor": s.factor,
            "predicted_makespan": p,
            "gain": base - p,
            "gain_frac": (base - p) / base if base else 0.0,
        })
    out.sort(key=lambda r: -r["gain"])
    return out
