"""Critical-path engine: explain a recorded run's *makespan*, not its idle.

``bubbles.py`` attributes each stage's idle seconds locally; this module
answers the global question — which chain of task executions, message hops,
gate admissions and dispatch waits actually *bounded* the run.  It lowers
any recorded logical-clock :class:`~repro_torch.runtime.rrfp.trace.Trace` (chain
or DAG spec, chaos, fail-stop recovery windows, mid-run ``HINT_SWAP``) into
an execution DAG:

* **nodes** are task *executions* — one per DISPATCH..COMPLETE pair, so a
  task re-executed after a fail-stop recovery contributes one node per
  incarnation — plus a virtual ROOT (t=0) and one *recovery node* per
  completed FAIL..RECOVERY_END window (spanning the outage);
* **edges** are the run's observed happens-before constraints, each stamped
  with the *absolute recorded time* the constraint was satisfied
  (``arrival``): per-stage serialization order, same-stage local
  dependencies (B after F, W after B), message readiness chains
  (producer COMPLETE -> SEND -> DELIVER -> ENQUEUE, carrying the
  SEND->DELIVER latency as ``comm`` and the admission residual —
  TP all-ranks gate, DAG fan-in skew — as ``gate``), and recovery edges
  (replayed deliveries and post-outage re-dispatches depend on the
  window's RECOVERY_END).

The *binding* in-edge of a node is the candidate with the latest arrival;
whatever slice of the dispatch wait no candidate explains (App. C
backpressure, the W-deferral cap, hint-swap-triggered re-arbitration,
thread wakeup latency, remap co-host contention) lands in the node's
``residual``.  Because the walk uses recorded absolute times — not summed
edge weights, which IEEE float addition would smear — the longest path
reconstructs the sim trace's makespan **bit-exactly**: the sink's recorded
COMPLETE time *is* ``meta["makespan"]`` by construction, and
:meth:`ExecGraph.verify` separately checks that the generative recurrence
(max over in-edges, plus residual/coordination/duration) regenerates every
node's recorded completion to ~1e-9 relative.

:meth:`ExecGraph.decompose` folds the critical path into per-category
seconds — ``compute`` (by op: F / B / W, or F / dX / dW on split-backward
specs), ``comm``, ``gate``, ``dispatch``, ``recovery`` — that sum
*exactly* to the makespan (the float residue is folded into the largest
bucket, the same idiom ``bubbles.py`` uses for exact idle attribution).
:meth:`ExecGraph.slack` gives every node its scheduling slack (how much
later it could have finished without moving the makespan): ``0`` on the
critical path, ``>= 0`` everywhere.

The graph is also the substrate for ``obs.whatif``'s Coz-style virtual
speedups: the recurrence re-runs with scaled durations/latencies while
recovery nodes stay *pinned* at their recorded end time — MTTR is
attributed, never "sped up".
"""
from __future__ import annotations

import dataclasses
from bisect import bisect_left

from repro_torch.core.taskgraph import Kind, PipelineSpec, Task

from repro_torch.obs.bubbles import spec_from_meta
from repro_torch.runtime.rrfp import trace as _tr

#: critical-path decomposition categories (report order)
CP_CATEGORIES = ("compute", "comm", "gate", "dispatch", "recovery")

#: the virtual source node's key
ROOT_KEY = ("root",)

#: binding tie-break priority: at equal arrival prefer the edge that
#: carries the richest attribution (a message chain over a serialization
#: order over a fallback)
_EDGE_PRIORITY = {"msg": 4, "recovery": 3, "serial": 2, "local": 1, "root": 0}


def op_label(task: Task, split_backward: bool) -> str:
    """Human op-class label: F/B/W, or F/dX/dW on split-backward specs."""
    if split_backward:
        return {Kind.F: "F", Kind.B: "dX", Kind.W: "dW"}[task.kind]
    return {Kind.F: "F", Kind.B: "B", Kind.W: "W"}[task.kind]


@dataclasses.dataclass
class Edge:
    """One observed happens-before constraint into a node.

    ``arrival`` is the absolute recorded time the constraint was satisfied
    (producer completion + comm + gate for message edges; the predecessor's
    completion for serialization/local edges; RECOVERY_END for recovery
    edges) — by runtime construction ``arrival <= dst.dispatch_t``.
    """

    src: tuple            # key of the source node
    kind: str             # "msg" | "serial" | "local" | "recovery" | "root"
    arrival: float
    comm: float = 0.0     # SEND -> DELIVER latency (message edges)
    gate: float = 0.0     # admission residual: TP gate / fan-in skew


@dataclasses.dataclass
class Node:
    """One task execution (or the ROOT / a recovery window)."""

    key: tuple
    stage: int
    task: Task | None
    op: str               # "F"/"B"/"W"/"dX"/"dW", "recovery", "root"
    dispatch_t: float     # recorded DISPATCH time (FAIL time for recovery)
    end_t: float          # recorded COMPLETE time (RECOVERY_END for recovery)
    dur: float            # compute duration (outage span for recovery nodes)
    coord: float          # TP coordination / wakeup before compute starts
    residual: float = 0.0  # dispatch wait no candidate edge explains
    epoch: int = 0
    dispatch_lc: int = -1
    complete_lc: int = -1
    in_edges: list[Edge] = dataclasses.field(default_factory=list)
    binding: Edge | None = None


@dataclasses.dataclass
class CritPathReport:
    """Per-category critical-path decomposition; sums exactly to makespan."""

    makespan: float
    categories: dict[str, float]        # CP_CATEGORIES -> seconds (folded)
    compute_by_op: dict[str, float]     # op label -> seconds on the path
    compute_by_stage: dict[int, float]  # stage -> compute seconds on path
    fold: float                         # float residue folded (|fold| ~ ulp)
    path_nodes: int
    recovery_windows: int
    path: list[dict]                    # node summaries, root -> sink

    def fractions(self) -> dict[str, float]:
        if not self.makespan:
            return {c: 0.0 for c in CP_CATEGORIES}
        return {c: v / self.makespan for c, v in self.categories.items()}

    def top_category(self) -> str:
        return max(self.categories, key=lambda c: self.categories[c])

    def table(self) -> str:
        lines = [f"{'category':>12} {'seconds':>14} {'share':>8}"]
        lines.append("-" * len(lines[0]))
        for c in CP_CATEGORIES:
            v = self.categories[c]
            frac = v / self.makespan if self.makespan else 0.0
            lines.append(f"{c:>12} {v:>14.6f} {frac:>7.1%}")
            if c == "compute" and self.compute_by_op:
                for op in sorted(self.compute_by_op):
                    ov = self.compute_by_op[op]
                    of = ov / self.makespan if self.makespan else 0.0
                    lines.append(f"{'  ' + op:>12} {ov:>14.6f} {of:>7.1%}")
        lines.append("-" * len(lines[0]))
        lines.append(f"{'makespan':>12} {self.makespan:>14.6f} {1:>7.1%}")
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {
            "makespan": self.makespan,
            "categories": dict(self.categories),
            "fractions": self.fractions(),
            "compute_by_op": dict(self.compute_by_op),
            "compute_by_stage": {str(s): v
                                 for s, v in self.compute_by_stage.items()},
            "fold": self.fold,
            "path_nodes": self.path_nodes,
            "recovery_windows": self.recovery_windows,
            "top_category": self.top_category(),
        }


class ExecGraph:
    """The execution DAG lowered from one recorded trace."""

    def __init__(self, nodes: dict[tuple, Node], order: list[tuple],
                 sink_key: tuple, meta: dict, spec: PipelineSpec):
        self.nodes = nodes
        #: keys in topological (recorded completion) order, ROOT first
        self.order = order
        self.sink_key = sink_key
        self.meta = meta
        self.spec = spec

    # ------------------------------------------------------------------
    @property
    def makespan(self) -> float:
        """The sink's recorded completion — bit-identical to the recorded
        makespan on sim traces (it *is* the same float)."""
        return self.nodes[self.sink_key].end_t

    @property
    def num_recovery_windows(self) -> int:
        return sum(1 for k in self.nodes if k[0] == "recovery")

    # ------------------------------------------------------------------
    @staticmethod
    def build(trace: _tr.Trace, spec: PipelineSpec | None = None
              ) -> "ExecGraph":
        return _build(trace, spec)

    # ------------------------------------------------------------------
    def critical_path(self) -> list[tuple[Node, Edge | None]]:
        """Binding-edge walk sink -> ROOT, returned root-first.

        Each entry is (node, binding edge *into* that node); the ROOT (and
        any node whose only constraint is the ROOT seed) anchors the walk.
        """
        out: list[tuple[Node, Edge | None]] = []
        key = self.sink_key
        seen = set()
        while key is not None and key not in seen:
            seen.add(key)
            n = self.nodes[key]
            out.append((n, n.binding))
            key = n.binding.src if n.binding is not None else None
        out.reverse()
        return out

    def slack(self) -> dict[tuple, float]:
        """Per-node scheduling slack (seconds), clamped at 0.

        ``slack(n) = makespan - end(n) - tail(n)`` where ``tail`` is the
        longest downstream chain; exactly 0 along the critical path,
        ``>= 0`` everywhere by construction.
        """
        tail: dict[tuple, float] = {k: 0.0 for k in self.nodes}
        for key in reversed(self.order):
            n = self.nodes[key]
            for e in n.in_edges:
                if e is n.binding:
                    c = (n.end_t - self.nodes[e.src].end_t) + tail[key]
                else:
                    c = ((e.arrival - self.nodes[e.src].end_t)
                         + (n.end_t - n.dispatch_t) + tail[key])
                if c > tail[e.src]:
                    tail[e.src] = c
        mk = self.makespan
        out = {k: max(0.0, mk - self.nodes[k].end_t - tail[k])
               for k in self.nodes}
        # the binding chain has zero slack by definition; the backward
        # accumulation can leave an ulp of float residue there — pin it
        for node, _ in self.critical_path():
            out[node.key] = 0.0
        return out

    def verify(self) -> float:
        """Re-derive every completion from the generative recurrence.

        ``end(n) = max_e(end(src_e) + comm_e + gate_e) + residual + coord +
        dur``; returns the max relative error vs the recorded completion
        times (~1e-9 on sim traces — the float-sum view of the same
        identity the absolute-time walk states exactly).
        """
        new_end: dict[tuple, float] = {ROOT_KEY: 0.0}
        worst = 0.0
        scale = max(1.0, self.makespan)
        for key in self.order:
            if key == ROOT_KEY:
                continue
            n = self.nodes[key]
            arr = max((new_end.get(e.src, self.nodes[e.src].end_t)
                       + e.comm + e.gate for e in n.in_edges), default=0.0)
            ne = arr + n.residual + n.coord + n.dur
            new_end[key] = ne
            worst = max(worst, abs(ne - n.end_t) / scale)
        return worst

    def decompose(self) -> CritPathReport:
        """Fold the critical path into per-category seconds.

        The telescoping identity ``end(n) - end(prev) = comm + gate +
        residual + coord + dur`` holds per binding edge, so the category
        sums cover the whole makespan; the float-addition residue is folded
        into the largest bucket (``bubbles.py``'s exact-attribution idiom),
        making the reported categories sum *exactly* to the makespan.
        """
        path = self.critical_path()
        cats = {c: 0.0 for c in CP_CATEGORIES}
        by_op: dict[str, float] = {}
        by_stage: dict[int, float] = {}
        summary: list[dict] = []
        for node, edge in path:
            if node.key == ROOT_KEY:
                continue
            if edge is not None:
                cats["comm"] += edge.comm
                cats["gate"] += edge.gate
            cats["dispatch"] += node.residual
            if node.op == "recovery":
                cats["recovery"] += node.dur
            else:
                cats["gate"] += node.coord
                cats["compute"] += node.dur
                by_op[node.op] = by_op.get(node.op, 0.0) + node.dur
                by_stage[node.stage] = by_stage.get(node.stage, 0.0) + node.dur
            summary.append({
                "node": "recovery" if node.op == "recovery" else "exec",
                "stage": node.stage,
                "task": list(_tr.task_key(node.task))
                        if node.task is not None else None,
                "op": node.op,
                "start": node.dispatch_t,
                "end": node.end_t,
                "via": edge.kind if edge is not None else None,
            })
        fold = _fold_exact(cats, self.makespan)
        return CritPathReport(
            makespan=self.makespan, categories=cats, compute_by_op=by_op,
            compute_by_stage=by_stage, fold=fold, path_nodes=len(summary),
            recovery_windows=self.num_recovery_windows, path=summary)


def _fold_exact(cats: dict[str, float], makespan: float) -> float:
    """Fold the float residue so ``sum(cats.values()) == makespan`` exactly.

    A single ``makespan - sum`` correction can leave the re-summed
    left-fold an ulp off (float addition is non-associative), and nudging
    an arbitrary bucket cannot always help: round-to-even on the downstream
    additions can make the makespan unreachable from that bucket's grid.
    The robust move is the *last nonzero* bucket in fold order — every
    later addend is exactly ``0.0``, so the left-fold ends
    ``prefix + cats[target]`` and assigning ``makespan - prefix`` is exact
    by Sterbenz whenever ``prefix`` is close to the makespan (it always is:
    the residue being absorbed is a few ulps).  Earlier buckets serve as
    fallback targets, each with a coarse-correction loop plus a bounded ulp
    sweep, for the degenerate alignments.
    """
    import math

    def left_fold() -> float:
        s = 0.0
        for c in CP_CATEGORIES:
            s += cats[c]
        return s

    orig = dict(cats)
    nonzero = [c for c in CP_CATEGORIES if cats[c] != 0.0]
    if not nonzero:
        cats["compute"] = makespan
        return makespan
    for target in [nonzero[-1]] + nonzero[:-1][::-1]:
        cats.update(orig)
        if target == nonzero[-1]:
            prefix = 0.0
            for c in CP_CATEGORIES:
                if c == target:
                    break
                prefix += cats[c]
            cats[target] = makespan - prefix
        else:
            cats[target] += makespan - left_fold()
        for _ in range(8):  # coarse corrections
            if left_fold() == makespan:
                return cats[target] - orig[target]
            cats[target] += makespan - left_fold()
        for _ in range(64):  # last-resort ulp sweep
            s = left_fold()
            if s == makespan:
                return cats[target] - orig[target]
            cats[target] = math.nextafter(
                cats[target], math.inf if s < makespan else -math.inf)
    cats.update(orig)  # no target landed: leave the raw decomposition
    return makespan - left_fold()


# ---------------------------------------------------------------------------
# graph construction
# ---------------------------------------------------------------------------
def _build(trace: _tr.Trace, spec: PipelineSpec | None) -> ExecGraph:
    meta = trace.meta or {}
    if spec is None:
        spec = spec_from_meta(meta)
    split = bool(spec.split_backward)

    sends: dict[int, _tr.TraceEvent] = {}
    delivers: dict[Task, list[_tr.TraceEvent]] = {}
    enqueues: dict[Task, list[_tr.TraceEvent]] = {}
    pairs: dict[Task, list[list]] = {}  # task -> [[dispatch, complete|None]]
    windows: list[dict] = []            # {"fail": ev, "end": ev|None}
    open_by_stage: dict[int, dict] = {}
    for ev in trace.events:
        k = ev.kind
        if k == _tr.DISPATCH:
            pairs.setdefault(ev.task, []).append([ev, None])
        elif k == _tr.COMPLETE:
            lst = pairs.setdefault(ev.task, [])
            # pair with the *latest* unmatched dispatch before this
            # complete: an earlier doomed incarnation stays unmatched
            for pr in reversed(lst):
                if pr[1] is None and pr[0].lc < ev.lc:
                    pr[1] = ev
                    break
        elif k == _tr.SEND:
            seq = ev.info.get("seq")
            if seq is not None:
                sends.setdefault(int(seq), ev)
        elif k == _tr.DELIVER:
            delivers.setdefault(ev.task, []).append(ev)
        elif k == _tr.ENQUEUE:
            enqueues.setdefault(ev.task, []).append(ev)
        elif k == _tr.FAIL:
            w = {"fail": ev, "end": None}
            open_by_stage[ev.stage] = w
            windows.append(w)
        elif k == _tr.RECOVERY_END:
            w = open_by_stage.pop(ev.stage, None)
            if w is not None:
                w["end"] = ev

    nodes: dict[tuple, Node] = {ROOT_KEY: Node(
        key=ROOT_KEY, stage=-1, task=None, op="root", dispatch_t=0.0,
        end_t=0.0, dur=0.0, coord=0.0)}

    # recovery nodes: one per completed FAIL..RECOVERY_END window
    rec_by_epoch: dict[int, tuple] = {}
    rec_by_stage: dict[int, list[tuple]] = {}
    for wi, w in enumerate(windows):
        if w["end"] is None:
            continue
        fe, ee = w["fail"], w["end"]
        key = ("recovery", wi)
        nodes[key] = Node(
            key=key, stage=fe.stage, task=None, op="recovery",
            dispatch_t=fe.t, end_t=ee.t, dur=max(0.0, ee.t - fe.t),
            coord=0.0, epoch=ee.epoch, dispatch_lc=fe.lc, complete_lc=ee.lc)
        rec_by_epoch[ee.epoch] = key
        rec_by_stage.setdefault(fe.stage, []).append(key)

    # exec nodes: one per paired DISPATCH..COMPLETE incarnation
    exec_by_task: dict[Task, list[Node]] = {}
    stage_execs: dict[int, list[Node]] = {}
    doomed: dict[Task, list[_tr.TraceEvent]] = {}
    for task, lst in pairs.items():
        for i, (d, c) in enumerate(lst):
            if c is None:
                doomed.setdefault(task, []).append(d)
                continue
            dur = float(c.info.get("dur", c.t - d.t))
            coord = max(0.0, (c.t - d.t) - dur)
            key = ("exec", tuple(_tr.task_key(task)), i)
            n = Node(key=key, stage=task.stage, task=task,
                     op=op_label(task, split), dispatch_t=d.t, end_t=c.t,
                     dur=min(dur, max(0.0, c.t - d.t)), coord=coord,
                     epoch=d.epoch, dispatch_lc=d.lc, complete_lc=c.lc)
            nodes[key] = n
            exec_by_task.setdefault(task, []).append(n)
            stage_execs.setdefault(task.stage, []).append(n)
    for lst in exec_by_task.values():
        lst.sort(key=lambda n: n.dispatch_lc)
    stage_lcs: dict[int, list[int]] = {}
    for s, lst in stage_execs.items():
        lst.sort(key=lambda n: n.dispatch_lc)
        stage_lcs[s] = [n.dispatch_lc for n in lst]

    def latest_exec_before(task: Task, lc: int) -> Node | None:
        """Latest execution of ``task`` whose COMPLETE precedes ``lc``."""
        best = None
        for n in exec_by_task.get(task, ()):
            if n.complete_lc < lc:
                best = n
        return best

    def candidates(task: Task, stage: int, d_lc: int, d_epoch: int
                   ) -> list[Edge]:
        edges: list[Edge] = []
        # (a) per-stage serialization: the previous completed execution
        lst = stage_execs.get(stage, [])
        i = bisect_left(stage_lcs.get(stage, []), d_lc) - 1
        while i >= 0 and lst[i].complete_lc >= d_lc:
            i -= 1
        if i >= 0:
            edges.append(Edge(lst[i].key, "serial", arrival=lst[i].end_t))
        # (b) same-stage local dependency (B after F, W after B)
        lp = spec.local_predecessor(task)
        if lp is not None:
            pn = latest_exec_before(lp, d_lc)
            if pn is not None:
                edges.append(Edge(pn.key, "local", arrival=pn.end_t))
        # (c) readiness: the binding ENQUEUE and its delivery chain
        eqs = enqueues.get(task, [])
        j = -1
        for idx, eq in enumerate(eqs):
            if eq.lc < d_lc:
                j = idx
        if j >= 0:
            eq = eqs[j]
            lo = eqs[j - 1].lc if j > 0 else -1
            preds = spec.message_predecessors(task)
            if eq.info.get("src") == "local" or not preds:
                rk = rec_by_epoch.get(eq.epoch) if eq.epoch > 0 else None
                edges.append(Edge(rk if rk is not None else ROOT_KEY,
                                  "recovery" if rk is not None else "root",
                                  arrival=eq.t))
            else:
                msg_edges: list[Edge] = []
                first: dict[tuple, _tr.TraceEvent] = {}
                for dv in delivers.get(task, ()):
                    if lo < dv.lc < eq.lc:
                        # first copy per (src, rank) wins at the gate;
                        # chaos duplicates only re-deliver
                        first.setdefault(
                            (int(dv.info.get("src", -1)), dv.rank), dv)
                for (src_stage, _rank), dv in first.items():
                    seq = dv.info.get("seq")
                    sv = sends.get(int(seq)) if seq is not None else None
                    if sv is None:
                        # replayed delivery (recovery restores have fresh
                        # seqs and no SEND record): charge the window
                        rk = rec_by_epoch.get(dv.epoch)
                        msg_edges.append(Edge(
                            rk if rk is not None else ROOT_KEY,
                            "recovery" if rk is not None else "root",
                            arrival=dv.t))
                        continue
                    prod = next((p for p in preds if p.stage == sv.stage),
                                None)
                    pn = (latest_exec_before(prod, sv.lc)
                          if prod is not None else None)
                    if pn is None:
                        msg_edges.append(Edge(ROOT_KEY, "root", arrival=dv.t))
                    else:
                        msg_edges.append(Edge(
                            pn.key, "msg", arrival=dv.t,
                            comm=max(0.0, dv.t - sv.t)))
                if msg_edges:
                    # the admission residual (TP gate / fan-in skew) rides
                    # the last-arriving copy: ENQUEUE - max(DELIVER)
                    bind = max(msg_edges, key=lambda e: e.arrival)
                    bind.gate = max(0.0, eq.t - bind.arrival)
                    bind.arrival = eq.t
                    edges.extend(msg_edges)
                else:
                    edges.append(Edge(ROOT_KEY, "root", arrival=eq.t))
        # (d) a post-outage execution at the failed stage waits for the
        # window to close even if its inputs survived
        for rk in rec_by_stage.get(stage, ()):
            rn = nodes[rk]
            if rn.complete_lc < d_lc and d_epoch >= rn.epoch:
                edges.append(Edge(rk, "recovery", arrival=rn.end_t))
        return edges

    def attach(n: Node, edges: list[Edge]) -> None:
        # safety valve: a candidate arriving *after* the dispatch cannot
        # be a constraint (thread-substrate interleavings around recovery
        # re-seeds); drop it so residual stays >= 0
        tol = 1e-9 * max(1.0, abs(n.dispatch_t))
        edges = [e for e in edges if e.arrival <= n.dispatch_t + tol]
        if not edges:
            edges = [Edge(ROOT_KEY, "root", arrival=0.0)]
        n.in_edges = edges
        n.binding = max(edges, key=lambda e: (e.arrival,
                                              _EDGE_PRIORITY[e.kind]))
        n.residual = max(0.0, n.dispatch_t - n.binding.arrival)

    for key, n in nodes.items():
        if key[0] != "exec":
            continue
        attach(n, candidates(n.task, n.stage, n.dispatch_lc, n.epoch))

    # recovery node in-edges: the doomed dispatch's own constraints (the
    # outage starts where the doomed incarnation's inputs ended)
    for wi, w in enumerate(windows):
        key = ("recovery", wi)
        if key not in nodes:
            continue
        rn = nodes[key]
        fe = w["fail"]
        edges: list[Edge] = []
        if fe.task is not None:
            dd = None
            for d in doomed.get(fe.task, ()):
                if d.lc <= fe.lc:
                    dd = d
            if dd is not None:
                edges = candidates(fe.task, fe.stage, dd.lc, dd.epoch)
        if not edges:
            prev = None
            for n2 in stage_execs.get(fe.stage, ()):
                if n2.complete_lc < fe.lc:
                    prev = n2
            if prev is not None:
                edges = [Edge(prev.key, "serial", arrival=prev.end_t)]
        attach(rn, edges)

    # topological order: recorded completion order is a valid topological
    # sort (every edge's source completes strictly before its target's
    # dispatch commits, by logical-clock construction)
    order = sorted(nodes, key=lambda k: (nodes[k].complete_lc, k))
    sink_key = max(nodes, key=lambda k: (nodes[k].end_t, nodes[k].complete_lc))
    return ExecGraph(nodes=nodes, order=order, sink_key=sink_key,
                     meta=dict(meta), spec=spec)
