"""Online per-(stage, op) cost tables from realized durations (ROADMAP 3).

The paper's Table-3-style cost models are *inputs* to hint synthesis; this
module closes the loop by measuring them *online*: every COMPLETE event's
realized duration feeds a per-(stage, kind) EWMA — the same 0.9/0.1 EMA the
paper's injection protocol uses for delay tracking — and the resulting table
snapshots into a :class:`~repro_torch.core.costs.CostModel` that hint re-synthesis
(ROADMAP item 3) can consume directly.

Two feeding paths:

* **live** — :class:`~repro_torch.obs.metrics.MetricsRegistry` maintains the EWMAs
  on the runtime's completion hook and assembles an ``OnlineCostTable``
  snapshot at any sync point (``registry.cost_table()``);
* **offline** — :meth:`OnlineCostTable.update_from_trace` folds a recorded
  :class:`~repro_torch.runtime.rrfp.trace.Trace`'s COMPLETE durations (in
  logical-clock order) and SEND→DELIVER transport latencies into the table.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.costs import CostModel, InjectionModel, JitterModel
from repro_torch.core.taskgraph import Kind


class Ewma:
    """Exponentially-weighted moving average: v <- (1-a) v + a x.

    Deferred like ``repro_torch.obs.metrics.Histogram``: ``observe`` is a bare
    list append on the single-writer hot path; the order-sensitive fold
    runs lazily at the first ``value``/``count`` read (sync points)."""

    __slots__ = ("alpha", "_value", "_count", "_pending")

    def __init__(self, alpha: float = 0.1,
                 value: float | None = None, count: int = 0):
        self.alpha = alpha
        self._value = value
        self._count = count
        self._pending: list[float] = []

    def observe(self, x: float) -> None:
        self._pending.append(x)

    def _fold(self) -> None:
        pending = self._pending
        if not pending:
            return
        v, a = self._value, self.alpha
        for x in pending:
            v = x if v is None else (1.0 - a) * v + a * x
        self._value = v
        self._count += len(pending)
        self._pending = []

    @property
    def value(self) -> float | None:
        self._fold()
        return self._value

    @property
    def count(self) -> int:
        self._fold()
        return self._count

    def seed(self, value: float, count: int) -> None:
        """Adopt an externally-maintained state (registry snapshots)."""
        self._pending = []
        self._value = value
        self._count = count

    def downweight(self, keep: int = 1) -> None:
        """Collapse history to a weak prior (recovery boundaries).

        The current value survives as a prior worth ``keep`` samples, so
        post-recovery observations dominate quickly while cold cells still
        have a sane starting point.  No-op on an empty cell.
        """
        self._fold()
        if self._value is not None:
            self._count = min(self._count, max(0, keep))

    def __repr__(self) -> str:
        return f"Ewma(alpha={self.alpha}, value={self.value}, count={self.count})"


class OnlineCostTable:
    """Per-(stage, kind) duration EWMAs + a transport-latency EWMA."""

    def __init__(self, num_stages: int, alpha: float = 0.1):
        self.num_stages = num_stages
        self.alpha = alpha
        self._cells: dict[tuple[int, Kind], Ewma] = {}
        self.comm = Ewma(alpha)

    def _cell(self, stage: int, kind: Kind) -> Ewma:
        if stage >= self.num_stages:
            self.num_stages = stage + 1
        key = (stage, kind)
        cell = self._cells.get(key)
        if cell is None:
            cell = self._cells[key] = Ewma(self.alpha)
        return cell

    # ---- feeding -----------------------------------------------------------
    def observe(self, stage: int, kind: Kind, dur: float) -> None:
        self._cell(stage, kind).observe(dur)

    def observe_comm(self, latency: float) -> None:
        if latency >= 0.0:
            self.comm.observe(latency)

    def seed(self, stage: int, kind: Kind, value: float, count: int) -> None:
        self._cell(stage, kind).seed(value, count)

    def seed_comm(self, value: float, count: int) -> None:
        # merging shards: weight each stage's comm EWMA by its sample count
        if self.comm.value is None:
            self.comm.seed(value, count)
        else:
            total = self.comm.count + count
            self.comm.seed(
                (self.comm.value * self.comm.count + value * count) / total,
                total)

    def update_from_trace(self, trace) -> "OnlineCostTable":
        """Fold a recorded trace's durations + transport latencies in.

        COMPLETE events are consumed in logical-clock order (the EWMA is
        order-sensitive); SEND→DELIVER pairs match on envelope ``seq``, so
        chaos-duplicated copies each contribute their own latency sample.

        Recovered traces need epoch hygiene: a FENCEd delivery is a
        stale-epoch envelope the mailbox rejected, and a SEND→DELIVER pair
        straddling an epoch bump spans the recovery outage itself — neither
        is a transport-latency sample.  Only same-epoch, non-fenced pairs
        feed the comm EWMA.
        """
        from repro_torch.runtime.rrfp import trace as _tr

        fenced = {int(ev.info["seq"]) for ev in trace.events
                  if ev.kind == _tr.FENCE and "seq" in ev.info}
        sends: dict[int, tuple[float, int]] = {}
        for ev in trace.events:
            if ev.kind == _tr.COMPLETE and "dur" in ev.info:
                self.observe(ev.stage, ev.task.kind, float(ev.info["dur"]))
            elif ev.kind == _tr.SEND and "seq" in ev.info:
                sends.setdefault(int(ev.info["seq"]), (ev.t, ev.epoch))
            elif ev.kind == _tr.DELIVER and "seq" in ev.info:
                seq = int(ev.info["seq"])
                rec = sends.get(seq)
                if rec is not None and rec[1] == ev.epoch and seq not in fenced:
                    self.observe_comm(ev.t - rec[0])
        return self

    # ---- reading -----------------------------------------------------------
    def value(self, stage: int, kind: Kind) -> float | None:
        cell = self._cells.get((stage, kind))
        return cell.value if cell is not None else None

    def samples(self, stage: int, kind: Kind) -> int:
        cell = self._cells.get((stage, kind))
        return cell.count if cell is not None else 0

    def as_cost_model(self, default: CostModel | None = None) -> CostModel:
        """Jitter-free :class:`CostModel` snapshot of the current EWMAs.

        Cells with no observations fall back to ``default``'s base costs
        (or 0.0) — e.g. W rows on fused-backward pipelines.  The snapshot is
        an *expected* model (no jitter/injection): realized variability is
        already baked into the measured EWMAs, and synthesis wants the
        central tendency.
        """
        arrays = {}
        for kind, name in ((Kind.F, "f_cost"), (Kind.B, "b_cost"),
                           (Kind.W, "w_cost")):
            fallback = (getattr(default, name)
                        if default is not None else None)
            col = np.zeros(self.num_stages)
            for s in range(self.num_stages):
                v = self.value(s, kind)
                if v is None and fallback is not None:
                    v = float(fallback[s])
                col[s] = v if v is not None else 0.0
            arrays[name] = col
        comm = (self.comm.value if self.comm.value is not None
                else (default.comm_base if default is not None else 1e-4))
        return CostModel(
            comm_base=float(comm),
            compute_jitter=JitterModel(),
            comm_jitter=JitterModel(),
            injection=InjectionModel(),
            **arrays,
        )

    def to_json(self) -> dict:
        return {
            "num_stages": self.num_stages,
            "alpha": self.alpha,
            "cells": [
                {"stage": s, "kind": k.name, "ewma": c.value,
                 "count": c.count}
                for (s, k), c in sorted(
                    self._cells.items(), key=lambda kv: (kv[0][0], kv[0][1]))
            ],
            "comm": {"ewma": self.comm.value, "count": self.comm.count},
        }
