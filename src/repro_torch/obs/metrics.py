"""Low-overhead runtime metrics: counters, gauges, log-bucketed histograms.

Design constraints (the dispatch hot path runs in single-digit microseconds,
see ``BENCH_dispatch.json``):

* **Per-stage shards, single writer.**  Each :class:`StageShard` is written
  by exactly one thread — the stage's actor thread (thread substrate) or the
  driver's event pump (sim substrate) — so every observation is a plain
  int/float update with **no lock, no allocation, no string formatting**.
  Aggregation happens at sync points (end of run / between steps) by the
  caller that owns the registry, never concurrently with the hot path.
* **Fixed bucket edges, deferred bucketing.**  Histograms use log-spaced
  edges computed once at construction; ``observe`` is a bare list append,
  and the bisect-per-observation fold runs lazily at the first read — sync
  points, never the hot path.
* **Pay for what you use.**  When no registry is attached
  (``ActorConfig.metrics is None``) the runtime's only added cost is an
  ``is None`` test per hook site.  The CI overhead gate
  (``benchmarks/dispatch_overhead.py``, ``METRICS_OVERHEAD_MAX``) enforces
  that metrics-ON stays within 10% of metrics-OFF per decision.

Metric catalogue (see ``docs/observability.md`` for semantics):

==========================  =============================================
``dispatches[kind]``        per-stage dispatch count per task kind
``dispatch_paths[path]``    arbitration path taken (hint / backpressure /
                            wcap / precommitted)
``divergence[slot]``        hint-divergence: index of the dispatched
                            task's *kind* in the arbiter's preference
                            order at dispatch time (0 = hinted direction
                            served; >0 = hinted direction was unready)
``ready_depth``             histogram of ready-set size at each decision
``durations[kind]``         histogram of realized task durations
``cost_ewma[kind]``         EWMA of realized durations (online cost table)
``queue_depth``             histogram of post-enqueue arrival-buffer depth
``enqueues/dequeues[kind]`` mailbox buffer traffic per kind
``comm_ewma``               EWMA of transport latency, sampled from the
                            envelope that completes each message set
``tp_admits/holds/dups``    TP all-ranks gate outcomes
``tp_spread``               histogram of per-rank arrival spread (the TP
                            hold time: last-rank minus first-rank arrival)
``fanin_holds``             DAG fan-in: edge admitted, other branch missing
``backpressure_drains``     dispatches taken on the App. C drain path
``wcap_dispatches``         dispatches forced by the W-deferral cap
``w_backlog_peak``          max observed deferred-W backlog
==========================  =============================================
"""
from __future__ import annotations

import math
from bisect import bisect_left
from typing import Iterable

from repro_torch.core.taskgraph import Kind, Task

from repro_torch.obs.cost_table import Ewma, OnlineCostTable

#: arbitration-path labels, fixed order for stable reports ("table" =
#: synthesized-rank table consumed as a non-binding hint, see docs/adaptive.md)
PATHS = ("hint", "table", "backpressure", "wcap", "precommitted")

#: default duration buckets: 1 µs .. 100 s, 8 buckets per decade
DURATION_EDGES = None  # computed below (module import time, once)

#: default depth buckets: 1 .. 4096, doubling
DEPTH_EDGES = None


def log_edges(lo: float, hi: float, n: int) -> tuple[float, ...]:
    """``n + 1`` log-spaced bucket edges covering [lo, hi] geometrically."""
    if not (lo > 0 and hi > lo and n >= 1):
        raise ValueError(f"bad edge spec lo={lo} hi={hi} n={n}")
    ratio = (hi / lo) ** (1.0 / n)
    edges = [lo * ratio**i for i in range(n + 1)]
    edges[-1] = hi  # kill accumulated float error at the top edge
    return tuple(edges)


DURATION_EDGES = log_edges(1e-6, 1e2, 8 * 8)
DEPTH_EDGES = tuple(float(2**i) for i in range(13))  # 1 .. 4096


class Histogram:
    """Fixed-edge histogram with deferred bucketing.

    ``observe`` is a bare list append — the raw observations queue in
    ``_pending`` and fold into buckets (one bisect each) lazily, the first
    time a reader asks for ``counts``/``count``/``total``/quantiles.  The
    hot path is written once per event by a single owner; readers are
    sync-point aggregation only, so the deferred fold is safe and keeps
    per-event cost at one append instead of a bisect + three updates.

    Bucket ``i`` counts observations ``x`` with ``edges[i-1] < x <=
    edges[i]`` (bucket 0 is the underflow ``x <= edges[0]``); one overflow
    bucket at the end counts ``x > edges[-1]``.  Exact sum and count ride
    along so means stay exact regardless of bucketing.
    """

    __slots__ = ("edges", "_counts", "_count", "_total", "_pending")

    def __init__(self, edges: Iterable[float] = DURATION_EDGES):
        if edges is DURATION_EDGES or edges is DEPTH_EDGES:
            # module defaults are pre-validated; shard construction sits on
            # the driver's build path, so skip the per-instance reconversion
            self.edges = edges
        else:
            self.edges = tuple(float(e) for e in edges)
            if list(self.edges) != sorted(set(self.edges)):
                raise ValueError("histogram edges must be strictly increasing")
        self._counts = [0] * (len(self.edges) + 1)
        self._count = 0
        self._total = 0.0
        self._pending: list[float] = []

    def observe(self, x: float) -> None:
        self._pending.append(x)

    def _fold(self) -> None:
        pending = self._pending
        if not pending:
            return
        counts, edges, total = self._counts, self.edges, self._total
        for x in pending:
            counts[bisect_left(edges, x)] += 1
            total += x  # incremental adds, same order as observed
        self._total = total
        self._count += len(pending)
        self._pending = []

    @property
    def counts(self) -> list[int]:
        self._fold()
        return self._counts

    @property
    def count(self) -> int:
        self._fold()
        return self._count

    @property
    def total(self) -> float:
        self._fold()
        return self._total

    def merge(self, other: "Histogram") -> None:
        if other.edges != self.edges:
            raise ValueError("cannot merge histograms with different edges")
        self._fold()
        for i, c in enumerate(other.counts):  # folds ``other`` too
            self._counts[i] += c
        self._count += other._count
        self._total += other._total

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Upper edge of the bucket containing the q-quantile (0 < q <= 1).

        A bucketed bound, not an exact order statistic; the overflow bucket
        reports ``inf``."""
        if not self.count:
            return 0.0
        target = math.ceil(q * self.count)
        run = 0
        for i, c in enumerate(self._counts):
            run += c
            if run >= target:
                return self.edges[i] if i < len(self.edges) else math.inf
        return math.inf

    def to_json(self) -> dict:
        return {"edges": list(self.edges), "counts": list(self.counts),
                "count": self._count, "total": self._total}


class StageShard:
    """Single-writer metric shard for one stage (see module docstring)."""

    __slots__ = (
        "stage", "dispatches", "dispatch_paths", "divergence", "ready_depth",
        "durations", "cost_ewma", "queue_depth", "enqueues", "dequeues",
        "comm_ewma", "tp_admits", "tp_holds", "tp_dups", "tp_spread",
        "fanin_holds", "backpressure_drains", "wcap_dispatches",
        "w_backlog_peak", "busy",
    )

    def __init__(self, stage: int, alpha: float = 0.1):
        self.stage = stage
        # Kind is an IntEnum with values 0..2, so the per-kind structures
        # are flat lists indexed by the kind itself — no dict hashing on
        # the hot path.
        self.dispatches = [0] * len(Kind)
        self.dispatch_paths = {p: 0 for p in PATHS}
        # try_order() yields at most 3 kinds; slot 0 = hinted direction
        self.divergence = [0, 0, 0]
        self.ready_depth = Histogram(DEPTH_EDGES)
        self.durations = [Histogram(DURATION_EDGES) for _ in Kind]
        self.cost_ewma = [Ewma(alpha) for _ in Kind]
        self.queue_depth = Histogram(DEPTH_EDGES)
        self.enqueues = [0] * len(Kind)
        self.dequeues = [0] * len(Kind)
        self.comm_ewma = Ewma(alpha)
        self.tp_admits = 0
        self.tp_holds = 0
        self.tp_dups = 0
        self.tp_spread = Histogram(DURATION_EDGES)
        self.fanin_holds = 0
        self.backpressure_drains = 0
        self.wcap_dispatches = 0
        self.w_backlog_peak = 0
        self.busy = 0.0

    # ---- hooks (hot path; each a handful of plain updates) ---------------
    def on_dispatch(self, task: Task, ready_depth: int,
                    path: str, slot: int | None) -> None:
        self.dispatches[task.kind] += 1
        self.dispatch_paths[path] += 1
        self.ready_depth.observe(ready_depth)
        if slot is not None:
            self.divergence[slot] += 1
        elif path == "backpressure":
            self.backpressure_drains += 1
        elif path == "wcap":
            self.wcap_dispatches += 1

    def on_complete(self, task: Task, dur: float, w_backlog: int = 0) -> None:
        k = task.kind
        self.durations[k].observe(dur)
        self.cost_ewma[k].observe(dur)
        self.busy += dur
        if w_backlog > self.w_backlog_peak:
            self.w_backlog_peak = w_backlog

    def on_enqueue(self, kind: Kind, depth: int) -> None:
        self.enqueues[kind] += 1
        self.queue_depth.observe(depth)

    def on_admitted(self, kind: Kind, depth: int, latency: float) -> None:
        """Fused enqueue + transport-latency hook: one call per envelope
        that completes a task's message set (the mailbox's buffer path)."""
        self.enqueues[kind] += 1
        self.queue_depth.observe(depth)
        if latency >= 0.0:  # duplicate copies may replay at odd times
            self.comm_ewma.observe(latency)

    def on_dequeue(self, kind: Kind) -> None:
        self.dequeues[kind] += 1

    def on_tp_hold(self) -> None:
        self.tp_holds += 1

    def on_tp_admit(self, spread: float) -> None:
        self.tp_admits += 1
        self.tp_spread.observe(spread)

    def on_tp_dup(self) -> None:
        self.tp_dups += 1

    def on_fanin_hold(self) -> None:
        self.fanin_holds += 1

    # ---- aggregation (sync points only) -----------------------------------
    def hint_divergences(self) -> int:
        """Hint-path dispatches where the hinted direction was unready."""
        return sum(self.divergence[1:])

    def to_json(self) -> dict:
        return {
            "stage": self.stage,
            "dispatches": {k.name: self.dispatches[k] for k in Kind},
            "dispatch_paths": dict(self.dispatch_paths),
            "divergence": list(self.divergence),
            "ready_depth": self.ready_depth.to_json(),
            "durations": {k.name: self.durations[k].to_json() for k in Kind},
            "cost_ewma": {k.name: self.cost_ewma[k].value for k in Kind},
            "queue_depth": self.queue_depth.to_json(),
            "enqueues": {k.name: self.enqueues[k] for k in Kind},
            "dequeues": {k.name: self.dequeues[k] for k in Kind},
            "comm_ewma": self.comm_ewma.value,
            "tp": {"admits": self.tp_admits, "holds": self.tp_holds,
                   "dups": self.tp_dups,
                   "spread": self.tp_spread.to_json()},
            "fanin_holds": self.fanin_holds,
            "backpressure_drains": self.backpressure_drains,
            "wcap_dispatches": self.wcap_dispatches,
            "w_backlog_peak": self.w_backlog_peak,
            "busy": self.busy,
        }


class MetricsRegistry:
    """Owns the per-stage shards; aggregates at sync points.

    Pass one registry through :class:`~repro_torch.runtime.rrfp.driver.ActorConfig`
    ``.metrics``; the driver hands each stage its shard.  Reusing the same
    registry across steps accumulates (and keeps the cost EWMAs warm across
    iterations — exactly what online cost tables want).
    """

    def __init__(self, num_stages: int = 0, alpha: float = 0.1):
        self.alpha = alpha
        #: keyed by *logical* stage — a respawned/remapped incarnation
        #: reuses its logical stage's shard, so co-hosted stages never
        #: merge their durations into one cell (cost-table correctness)
        self._shards: dict[int, StageShard] = {
            s: StageShard(s, alpha) for s in range(num_stages)}

    @property
    def num_stages(self) -> int:
        return max(self._shards) + 1 if self._shards else 0

    def shard(self, stage: int) -> StageShard:
        """The single-writer shard for logical ``stage`` (created on first
        use).  Sparse creation is fine: rows are keyed, not positional."""
        sh = self._shards.get(stage)
        if sh is None:
            sh = self._shards[stage] = StageShard(stage, self.alpha)
        return sh

    def shards(self) -> list[StageShard]:
        return [self._shards[s] for s in sorted(self._shards)]

    def on_recovery(self, stage: int, keep: int = 1) -> None:
        """RECOVERY_END boundary: the new incarnation may run at a
        different speed (cold caches, remapped device time-sharing) —
        collapse the stage's EWMAs to weak priors so post-recovery
        samples dominate instead of averaging across incarnations."""
        sh = self._shards.get(stage)
        if sh is None:
            return
        for e in sh.cost_ewma:
            e.downweight(keep)
        sh.comm_ewma.downweight(keep)

    # ---- sync-point aggregation -------------------------------------------
    def totals(self) -> dict:
        disp = {k.name: 0 for k in Kind}
        paths = {p: 0 for p in PATHS}
        div = [0, 0, 0]
        tp_admits = tp_holds = tp_dups = bp = wcap = fanin = 0
        for sh in self.shards():
            for k in Kind:
                disp[k.name] += sh.dispatches[k]
            for p in PATHS:
                paths[p] += sh.dispatch_paths[p]
            for i in range(3):
                div[i] += sh.divergence[i]
            tp_admits += sh.tp_admits
            tp_holds += sh.tp_holds
            tp_dups += sh.tp_dups
            bp += sh.backpressure_drains
            wcap += sh.wcap_dispatches
            fanin += sh.fanin_holds
        return {"dispatches": disp, "dispatch_paths": paths,
                "divergence": div, "tp_admits": tp_admits,
                "tp_holds": tp_holds, "tp_dups": tp_dups,
                "backpressure_drains": bp, "wcap_dispatches": wcap,
                "fanin_holds": fanin}

    def cost_table(self) -> OnlineCostTable:
        """Snapshot the live per-(stage, kind) EWMAs as an
        :class:`~repro_torch.obs.cost_table.OnlineCostTable` (ROADMAP item 3's
        input for hint re-synthesis)."""
        table = OnlineCostTable(self.num_stages, alpha=self.alpha)
        for sh in self.shards():
            for k in Kind:
                e = sh.cost_ewma[k]
                if e.count:
                    table.seed(sh.stage, k, e.value, e.count)
            if sh.comm_ewma.count:
                table.seed_comm(sh.comm_ewma.value, sh.comm_ewma.count)
        return table

    def to_json(self) -> dict:
        return {"stages": [sh.to_json() for sh in self.shards()],
                "totals": self.totals()}

    def report(self) -> str:
        """End-of-run per-stage summary table (``--metrics-report``)."""
        hdr = (f"{'stage':>5} {'disp':>6} {'F/B/W':>11} {'diverge':>7} "
               f"{'ready(p50)':>10} {'q(p50)':>7} {'bp':>5} {'wcap':>5} "
               f"{'tp h/a':>9} {'ewma F':>9} {'ewma B':>9} {'ewma W':>9} "
               f"{'comm':>9}")
        lines = [hdr, "-" * len(hdr)]

        def fmt(v: float | None) -> str:
            return f"{v * 1e3:.3f}ms" if v is not None else "-"

        for sh in self.shards():
            disp = sum(sh.dispatches)
            fbw = "/".join(str(sh.dispatches[k]) for k in Kind)
            lines.append(
                f"{sh.stage:>5} {disp:>6} {fbw:>11} "
                f"{sh.hint_divergences():>7} "
                f"{sh.ready_depth.quantile(0.5):>10.0f} "
                f"{sh.queue_depth.quantile(0.5):>7.0f} "
                f"{sh.backpressure_drains:>5} {sh.wcap_dispatches:>5} "
                f"{sh.tp_holds:>4}/{sh.tp_admits:<4} "
                f"{fmt(sh.cost_ewma[Kind.F].value):>9} "
                f"{fmt(sh.cost_ewma[Kind.B].value):>9} "
                f"{fmt(sh.cost_ewma[Kind.W].value):>9} "
                f"{fmt(sh.comm_ewma.value):>9}")
        t = self.totals()
        lines.append("-" * len(hdr))
        lines.append(
            f"total dispatches={sum(t['dispatches'].values())} "
            f"paths={t['dispatch_paths']} hint_divergences={sum(t['divergence'][1:])} "
            f"tp holds/admits/dups={t['tp_holds']}/{t['tp_admits']}/{t['tp_dups']} "
            f"fanin_holds={t['fanin_holds']}")
        return "\n".join(lines)
