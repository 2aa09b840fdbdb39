"""Bubble decomposition: attribute every idle second to a cause (§6, §7).

Turns "BFW beats 1F1B by 1.44x" into "because it removed X ms of
dependency-wait on stage 2".  Operates purely on a recorded logical-clock
:class:`~repro_torch.runtime.rrfp.trace.Trace` — no runtime hooks — so any saved
trace (sim or thread substrate, chaos or not) decomposes offline.

Per stage, the timeline [0, makespan] splits into *busy* intervals (each
DISPATCH..COMPLETE pair) and *idle* gaps.  Every gap is attributed to
exactly one category by walking monotone breakpoints toward the dispatch
that ends the gap:

``warmup``
    the leading gap before the stage's first dispatch — pipeline fill.
``dependency_wait``
    producers of the next task were still executing: the gap up to the
    latest predecessor COMPLETE.  On precommitted (fixed-order) runs this
    also covers *schedule misalignment* — the order's next entry being
    unready while other work was ready — which is exactly the class
    readiness-driven consumption removes.
``starvation``
    all producers done but the input message not yet admitted: transport
    latency, chaos delay, reordering, fan-in branch skew — plus, on the
    thread substrate, actor wakeup latency (the residual between a task
    becoming ready and the dispatch committing).
``tp_gate``
    the input message arrived on some TP rank but the all-ranks admission
    barrier held it (first TP_HOLD .. ENQUEUE).
``backpressure``
    the stage sat idle at its App. C F/B imbalance limit, or the ending
    dispatch itself took the backpressure-drain path.
``recovery``
    idle time inside a fault-recovery window (FAIL .. RECOVERY_END of any
    stage): the outage itself plus the time survivors spent stalled on the
    dead stage.  Without this category a killed stage's gap would be
    misattributed to ``dependency_wait``/``starvation``.
``drain``
    the trailing gap after the stage's last COMPLETE — pipeline drain.

Within a gap the precedence is dependency_wait -> starvation -> tp_gate ->
(backpressure | starvation); breakpoints are clamped monotone, and the last
segment absorbs the float residue, so per-stage categories sum *exactly* to
the stage's idle time (makespan - busy) — the invariant the acceptance
tests pin down.  Each interior segment's overlap with the run's (merged)
recovery windows is carved out into ``recovery``, which moves time between
categories without changing the total, so the exact-attribution invariant
survives recovered traces.  On such traces each task's DISPATCH/COMPLETE
pair is taken from its *highest-epoch* incarnation (a doomed dispatch that
never completed must not make the outage look busy).  ``warmup`` and
``drain`` are reported separately but form one paper-level category
(fill/drain bubbles).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.taskgraph import Kind, PipelineSpec, StageGraph, Task

from repro_torch.runtime.rrfp import trace as _tr

#: attribution categories, report order (warmup/drain = the paper's
#: fill/drain class, split so leading and trailing bubbles stay visible)
CATEGORIES = ("warmup", "dependency_wait", "starvation", "tp_gate",
              "backpressure", "recovery", "drain")


def spec_from_meta(meta: dict) -> PipelineSpec:
    """Rebuild the :class:`PipelineSpec` a trace was recorded against."""
    graph = None
    edges = meta.get("graph")
    if edges:
        graph = StageGraph(num_stages=int(meta["num_stages"]),
                           edges=tuple(tuple(e) for e in edges))
    return PipelineSpec(
        num_stages=int(meta["num_stages"]),
        num_microbatches=int(meta["num_microbatches"]),
        num_chunks=int(meta.get("num_chunks", 1)),
        split_backward=bool(meta.get("split_backward", False)),
        graph=graph)


@dataclasses.dataclass
class StageBubbles:
    """One stage's idle-time attribution."""

    stage: int
    busy: float
    idle: float
    bubbles: dict[str, float]

    @property
    def attributed(self) -> float:
        return sum(self.bubbles.values())

    @property
    def residual(self) -> float:
        """Unattributed idle time; ~0 up to float rounding by construction."""
        return self.idle - self.attributed


@dataclasses.dataclass
class BubbleReport:
    """Per-stage decomposition + run-level aggregates."""

    makespan: float
    stages: list[StageBubbles]
    meta: dict

    def category_totals(self) -> dict[str, float]:
        out = {c: 0.0 for c in CATEGORIES}
        for sb in self.stages:
            for c, v in sb.bubbles.items():
                out[c] += v
        return out

    def total_idle(self) -> float:
        return sum(sb.idle for sb in self.stages)

    def idle_fully_attributed(self, rel_tol: float = 1e-9,
                              abs_tol: float = 1e-12) -> bool:
        """100%-accounting check: every stage's categories sum to its idle."""
        return all(
            math.isclose(sb.attributed, sb.idle, rel_tol=rel_tol,
                         abs_tol=max(abs_tol, rel_tol * self.makespan))
            for sb in self.stages)

    def table(self) -> str:
        """Per-stage attribution table (seconds)."""
        cols = ["stage", "busy", "idle"] + list(CATEGORIES)
        hdr = " ".join(f"{c:>12}" for c in cols)
        lines = [hdr, "-" * len(hdr)]
        for sb in self.stages:
            row = [f"{sb.stage:>12}", f"{sb.busy:>12.6f}", f"{sb.idle:>12.6f}"]
            row += [f"{sb.bubbles[c]:>12.6f}" for c in CATEGORIES]
            lines.append(" ".join(row))
        tot = self.category_totals()
        lines.append("-" * len(hdr))
        lines.append(" ".join(
            [f"{'total':>12}", f"{sum(s.busy for s in self.stages):>12.6f}",
             f"{self.total_idle():>12.6f}"]
            + [f"{tot[c]:>12.6f}" for c in CATEGORIES]))
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {
            "makespan": self.makespan,
            "idle_fully_attributed": self.idle_fully_attributed(),
            "stages": [
                {"stage": sb.stage, "busy": sb.busy, "idle": sb.idle,
                 "bubbles": dict(sb.bubbles), "residual": sb.residual}
                for sb in self.stages],
            "category_totals": self.category_totals(),
        }


def decompose(trace: _tr.Trace, spec: PipelineSpec | None = None,
              buffer_limit: int | None = None) -> BubbleReport:
    """Attribute every stage's idle time to the :data:`CATEGORIES`.

    ``spec`` / ``buffer_limit`` default to the trace's recorded metadata;
    the trace must carry DISPATCH and COMPLETE events (i.e. be recorded
    with ``ActorConfig.record_trace``).
    """
    meta = trace.meta
    if spec is None:
        spec = spec_from_meta(meta)
    if buffer_limit is None:
        buffer_limit = int(meta.get("buffer_limit", 0) or 0)
    mode = meta.get("mode", "hint")
    S = spec.num_stages

    # Highest-epoch-first-occurrence projections: on a failure-free trace
    # (all epochs 0) this is plain first-event-wins (duplicate-tolerant);
    # on a recovered trace each task's dispatch/complete comes from its
    # final incarnation, so a doomed dispatch that never completed cannot
    # pair with its post-recovery completion and swallow the outage.
    best_disp: dict[Task, _tr.TraceEvent] = {}
    best_comp: dict[Task, _tr.TraceEvent] = {}
    enqueue_t: dict[Task, float] = {}
    tp_first_hold: dict[Task, float] = {}
    for ev in trace.events:
        if ev.kind == _tr.DISPATCH:
            cur = best_disp.get(ev.task)
            if cur is None or ev.epoch > cur.epoch:
                best_disp[ev.task] = ev
        elif ev.kind == _tr.COMPLETE:
            cur = best_comp.get(ev.task)
            if cur is None or ev.epoch > cur.epoch:
                best_comp[ev.task] = ev
        elif ev.kind == _tr.ENQUEUE:
            # last edge/rank admission = the task became consumable
            enqueue_t.setdefault(ev.task, ev.t)
        elif ev.kind == _tr.TP_HOLD:
            tp_first_hold.setdefault(ev.task, ev.t)
    dispatches: list[list[_tr.TraceEvent]] = [[] for _ in range(S)]
    for ev in sorted(best_disp.values(), key=lambda e: e.lc):
        dispatches[ev.stage].append(ev)
    complete_t: dict[Task, float] = {t: e.t for t, e in best_comp.items()}
    fb_completes: list[dict[Kind, list[float]]] = [
        {Kind.F: [], Kind.B: []} for _ in range(S)]
    for ev in sorted(best_comp.values(), key=lambda e: e.t):
        if ev.task.kind in (Kind.F, Kind.B):
            fb_completes[ev.stage][ev.task.kind].append(ev.t)

    # merged fault-recovery windows (FAIL .. RECOVERY_END), any stage
    rec_spans = sorted((w["t_fail"], w["t_end"])
                       for w in trace.recovery_windows())
    merged: list[tuple[float, float]] = []
    for w0, w1 in rec_spans:
        if merged and w0 <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], w1))
        else:
            merged.append((w0, w1))

    def rec_overlap(lo: float, hi: float) -> float:
        return sum(max(0.0, min(hi, w1) - max(lo, w0)) for w0, w1 in merged)

    makespan = float(meta.get("makespan") or
                     (max(complete_t.values()) if complete_t else 0.0))

    def fb_imbalance(stage: int, t: float) -> int:
        """n_f - n_b from completes at time <= t (the App. C counter)."""
        from bisect import bisect_right
        nf = bisect_right(fb_completes[stage][Kind.F], t)
        nb = bisect_right(fb_completes[stage][Kind.B], t)
        return nf - nb

    stages: list[StageBubbles] = []
    for s in range(S):
        bubbles = {c: 0.0 for c in CATEGORIES}
        evs = dispatches[s]
        busy = 0.0
        prev_end = 0.0
        first = True
        for ev in evs:
            a, b = prev_end, ev.t
            task = ev.task
            done_t = complete_t.get(task, b)
            busy += max(0.0, done_t - b)
            prev_end = max(prev_end, done_t)
            if b <= a:
                first = False
                continue
            gap = b - a
            if first:
                # an outage before the first dispatch is not pipeline fill
                ov = rec_overlap(a, b) if merged else 0.0
                bubbles["warmup"] += gap - ov
                bubbles["recovery"] += ov
                first = False
                continue
            # monotone breakpoints a <= p <= h <= r <= b
            preds = spec.message_predecessors(task)
            lp = spec.local_predecessor(task)
            p = a
            for q in preds:
                p = max(p, complete_t.get(q, a))
            if lp is not None:
                p = max(p, complete_t.get(lp, a))
            p = min(max(p, a), b)
            if preds:
                r = min(max(enqueue_t.get(task, p), p), b)
            else:
                r = p
            h = tp_first_hold.get(task)
            h = min(max(h, p), r) if h is not None else r
            dep = p - a
            starve = h - p
            tp = r - h
            tail = gap - dep - starve - tp  # exact residue: sums to gap
            if merged:
                # carve each segment's overlap with the recovery windows
                # out into "recovery": time moves between categories, the
                # total stays the gap, so exact attribution is preserved
                for seg, lo, hi in (("dep", a, p), ("starve", p, h),
                                    ("tp", h, r)):
                    ov = rec_overlap(lo, hi)
                    if seg == "dep":
                        dep -= ov
                    elif seg == "starve":
                        starve -= ov
                    else:
                        tp -= ov
                    bubbles["recovery"] += ov
            bubbles["dependency_wait"] += dep
            bubbles["starvation"] += starve
            bubbles["tp_gate"] += tp
            if tail > 0.0:
                if merged:
                    ov = min(rec_overlap(r, b), tail)
                    bubbles["recovery"] += ov
                    tail -= ov
                backpressured = (
                    ev.info.get("path") == "backpressure"
                    or (mode == "hint" and buffer_limit > 0
                        and fb_imbalance(s, a) >= buffer_limit))
                bubbles["backpressure" if backpressured
                        else "starvation"] += tail
        tail_gap = makespan - prev_end
        if evs and tail_gap > 0.0:
            ov = rec_overlap(prev_end, makespan) if merged else 0.0
            bubbles["drain"] += tail_gap - ov
            bubbles["recovery"] += ov
        elif not evs:
            # a stage that never dispatched is one long warmup bubble
            bubbles["warmup"] += makespan
        idle = makespan - busy
        stages.append(StageBubbles(stage=s, busy=busy, idle=idle,
                                   bubbles=bubbles))
    return BubbleReport(makespan=makespan, stages=stages, meta=dict(meta))


def compare(base: BubbleReport, other: BubbleReport) -> dict:
    """Category deltas ``base - other`` (what ``other`` removed)."""
    bt, ot = base.category_totals(), other.category_totals()
    removed = {c: bt[c] - ot[c] for c in CATEGORIES}
    top = max(removed, key=lambda c: removed[c])
    return {
        "base_makespan": base.makespan,
        "other_makespan": other.makespan,
        "speedup": (base.makespan / other.makespan
                    if other.makespan > 0 else math.inf),
        "removed": removed,
        "top_removed_category": top,
    }
