"""One-shot ``explain(trace)`` health report: name the bottleneck, rank
the fixes.

Pulls the observability stack together over a single recorded trace:

* **critical path** (``obs.critpath``) — which category of work bounded
  the makespan, decomposed to 100%;
* **what-if ranking** (``obs.whatif``) — predicted makespan gain of
  speeding up each op class, each stage, and the comm latency class, best
  first (Coz-style: predicted *without* re-running anything);
* **straggler flags** (``obs.cost_table``) — stages whose per-op duration
  EWMAs sit well above the fleet median (the same signal the adaptive
  loop's drift detector consumes);
* **bubble cross-check** (``obs.bubbles``) — the dominant *idle* class
  must be consistent with the critical path's binding category; given a
  baseline trace, checks that the class ``bubbles.compare`` says was
  removed is the one the critical path shifted off of.

CLI::

    PYTHONPATH=src python -m repro_torch.obs.report TRACE.jsonl \\
        [--baseline BASE.jsonl] [--factor 0.75] [--json] \\
        [--perfetto OUT.perfetto.json]

``launch.train --explain`` and ``benchmarks.run --explain`` print the same
report for their recorded runs.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from repro_torch.core.taskgraph import Kind, PipelineSpec

from repro_torch.obs import bubbles as _bub
from repro_torch.obs import whatif as _wi
from repro_torch.obs.cost_table import OnlineCostTable
from repro_torch.obs.critpath import CP_CATEGORIES, CritPathReport, ExecGraph
from repro_torch.runtime.rrfp import trace as _tr

#: critical-path category -> bubble classes it plausibly shows up as in
#: the per-stage idle decomposition (the cross-check's consistency map)
CP_TO_BUBBLE = {
    "compute": ("dependency_wait", "warmup", "drain"),
    "comm": ("starvation", "dependency_wait"),
    "gate": ("tp_gate", "starvation"),
    "dispatch": ("backpressure", "starvation"),
    "recovery": ("recovery",),
}

#: flag a stage when its per-op EWMA exceeds this multiple of the
#: cross-stage median for that op
STRAGGLER_RATIO = 1.5


@dataclasses.dataclass
class ExplainReport:
    """The assembled health report (see :func:`explain`)."""

    makespan: float
    meta: dict
    critpath: CritPathReport
    bottleneck: str              # human phrasing of the binding category
    ranking: list[dict]          # what-if gains, best first
    stragglers: list[dict]
    bubble_dominant: str         # dominant idle class across stages
    crosscheck: dict             # consistency of bubbles vs critical path
    whatif_factor: float

    def to_json(self) -> dict:
        return {
            "makespan": self.makespan,
            "meta": {k: self.meta.get(k) for k in
                     ("num_stages", "num_microbatches", "mode", "hint",
                      "split_backward", "substrate", "recoveries")},
            "critical_path": self.critpath.to_json(),
            "bottleneck": self.bottleneck,
            "whatif": {"factor": self.whatif_factor,
                       "ranking": self.ranking},
            "stragglers": self.stragglers,
            "bubble_dominant": self.bubble_dominant,
            "crosscheck": self.crosscheck,
        }

    def format(self, top: int = 5) -> str:
        m = self.meta
        lines = ["== makespan explained " + "=" * 42]
        lines.append(
            f"makespan {self.makespan:.6f}s — {m.get('num_stages', '?')} "
            f"stages x {m.get('num_microbatches', '?')} microbatches, "
            f"mode={m.get('mode', '?')}"
            + (f", hint={m.get('hint')}" if m.get("hint") else "")
            + (f", {self.critpath.recovery_windows} recovery window(s)"
               if self.critpath.recovery_windows else ""))
        lines.append(f"critical path: {self.critpath.path_nodes} nodes; "
                     f"binding bottleneck: {self.bottleneck}")
        lines.append(self.critpath.table())
        lines.append(f"-- what-if (virtual speedups, "
                     f"factor {self.whatif_factor:g}) " + "-" * 20)
        for r in self.ranking[:top]:
            lines.append(
                f"  {r['speedup']:<24} -> {r['predicted_makespan']:.6f}s "
                f"({-r['gain_frac']:+.1%})")
        if self.stragglers:
            lines.append("-- stragglers (per-op EWMA vs stage median) " +
                         "-" * 14)
            for s in self.stragglers:
                lines.append(
                    f"  stage {s['stage']} {s['op']}: {s['ewma']:.6f}s = "
                    f"{s['ratio']:.2f}x median ({s['median']:.6f}s)")
        else:
            lines.append("stragglers: none flagged "
                         f"(>{STRAGGLER_RATIO:g}x median)")
        cc = self.crosscheck
        verdict = ("consistent" if cc.get("consistent")
                   else "INCONSISTENT — inspect both reports")
        if cc.get("baseline"):
            lines.append(
                f"bubble cross-check vs baseline: compare() removed "
                f"'{cc['top_removed_bubble']}', critical path shifted off "
                f"'{cc['top_shifted_category']}' ({verdict})")
        else:
            lines.append(
                f"bubble cross-check: dominant idle class "
                f"'{self.bubble_dominant}' vs critical-path "
                f"'{self.critpath.top_category()}' ({verdict})")
        return "\n".join(lines)


def _stragglers(trace: _tr.Trace, spec: PipelineSpec) -> list[dict]:
    table = OnlineCostTable(spec.num_stages)
    table.update_from_trace(trace)
    kinds = [Kind.F, Kind.B] + ([Kind.W] if spec.split_backward else [])
    if spec.split_backward:
        labels = {Kind.F: "F", Kind.B: "dX", Kind.W: "dW"}
    else:
        labels = {Kind.F: "F", Kind.B: "B", Kind.W: "W"}
    out: list[dict] = []
    for kind in kinds:
        vals = {s: table.value(s, kind) for s in range(spec.num_stages)
                if table.samples(s, kind) > 0}
        if len(vals) < 2:
            continue
        ordered = sorted(vals.values())
        mid = len(ordered) // 2
        med = (ordered[mid] if len(ordered) % 2
               else 0.5 * (ordered[mid - 1] + ordered[mid]))
        if med <= 0:
            continue
        for s, v in sorted(vals.items()):
            if v > STRAGGLER_RATIO * med:
                out.append({
                    "stage": s, "op": labels[kind],
                    "ewma": v, "median": med, "ratio": v / med,
                })
    return out


def _bottleneck_phrase(rep: CritPathReport) -> str:
    top = rep.top_category()
    frac = rep.fractions()[top]
    if top == "compute" and rep.compute_by_stage:
        s = max(rep.compute_by_stage, key=lambda k: rep.compute_by_stage[k])
        ops = sorted(rep.compute_by_op,
                     key=lambda o: -rep.compute_by_op[o])
        return (f"compute ({frac:.0%} of makespan), heaviest on stage {s}"
                + (f" ({ops[0]})" if ops else ""))
    phrases = {
        "comm": "message latency (SEND->DELIVER hops)",
        "gate": "gate admission (TP all-ranks / fan-in skew / coordination)",
        "dispatch": "dispatch waits (backpressure / W-cap / arbitration)",
        "recovery": "fault recovery (MTTR inside FAIL..RECOVERY_END)",
    }
    return f"{phrases.get(top, top)} ({frac:.0%} of makespan)"


def explain(trace: _tr.Trace, spec: PipelineSpec | None = None, *,
            factor: float = 0.75,
            baseline: _tr.Trace | None = None) -> ExplainReport:
    """Assemble the one-shot health report for a recorded trace."""
    if spec is None:
        spec = _bub.spec_from_meta(trace.meta)
    graph = ExecGraph.build(trace, spec)
    rep = graph.decompose()
    ranking = _wi.rank(graph, factor=factor)
    bub = _bub.decompose(trace, spec)
    totals = bub.category_totals()
    bubble_dominant = max(totals, key=lambda c: totals[c])
    if baseline is not None:
        base_graph = ExecGraph.build(baseline)
        base_rep = base_graph.decompose()
        cmp = _bub.compare(_bub.decompose(baseline), bub)
        shift = {c: base_rep.categories[c] - rep.categories[c]
                 for c in CP_CATEGORIES}
        top_shift = max(shift, key=lambda c: shift[c])
        crosscheck = {
            "baseline": True,
            "top_removed_bubble": cmp["top_removed_category"],
            "top_shifted_category": top_shift,
            "speedup": cmp["speedup"],
            "consistent": cmp["top_removed_category"]
                          in CP_TO_BUBBLE.get(top_shift, ()),
        }
    else:
        crosscheck = {
            "baseline": False,
            "dominant_bubble": bubble_dominant,
            "cp_top": rep.top_category(),
            "consistent": bubble_dominant
                          in CP_TO_BUBBLE.get(rep.top_category(), ()),
        }
    return ExplainReport(
        makespan=graph.makespan, meta=dict(trace.meta), critpath=rep,
        bottleneck=_bottleneck_phrase(rep), ranking=ranking,
        stragglers=_stragglers(trace, spec),
        bubble_dominant=bubble_dominant, crosscheck=crosscheck,
        whatif_factor=factor)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Explain a recorded trace: critical path, what-if "
                    "ranking, stragglers, bubble cross-check.")
    ap.add_argument("trace", help="recorded trace (.jsonl, Trace.save)")
    ap.add_argument("--baseline", default=None,
                    help="baseline trace for the removed-bubble cross-check")
    ap.add_argument("--factor", type=float, default=0.75,
                    help="virtual speedup factor for the what-if ranking "
                         "(default 0.75)")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as JSON instead of text")
    ap.add_argument("--perfetto", default=None, metavar="PATH",
                    help="also export a Perfetto timeline with the "
                         "critical path highlighted and slices shaded by "
                         "slack")
    args = ap.parse_args(argv)
    trace = _tr.Trace.load(args.trace)
    baseline = _tr.Trace.load(args.baseline) if args.baseline else None
    rep = explain(trace, factor=args.factor, baseline=baseline)
    if args.json:
        json.dump(rep.to_json(), sys.stdout, indent=2)
        print()
    else:
        print(rep.format())
    if args.perfetto:
        from repro_torch.obs.export import export_perfetto

        export_perfetto(trace, args.perfetto, critical_path=True)
        print(f"highlighted perfetto timeline -> {args.perfetto} "
              f"(open at ui.perfetto.dev)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
