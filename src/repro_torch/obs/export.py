"""Chrome trace-event / Perfetto export of recorded runtime traces.

Renders a logical-clock :class:`~repro_torch.runtime.rrfp.trace.Trace` in the
Chrome trace-event JSON format (the JSON flavor Perfetto ingests directly —
open ``ui.perfetto.dev`` and drop the file, or ``chrome://tracing``):

* one *process* (track group) per pipeline stage, with complete-event
  (``ph: "X"``) slices named ``F``/``B``/``W`` (``dX``/``dW`` on
  split-backward specs) for every DISPATCH..COMPLETE pair;
* flow arrows (``ph: "s"`` / ``"f"``) from each SEND to its DELIVER,
  matched on envelope ``seq`` — chaos-duplicated copies each get their own
  arrow — visualizing the message weather the runtime is absorbing;
* counter tracks (``ph: "C"``): per-kind mailbox queue depth (from
  ENQUEUE/DEQUEUE) and the deferred-W backlog (from COMPLETE info), the two
  gauges backpressure and the W cap act on.

Timestamps are exported in microseconds (the format's unit); the sim
substrate's virtual seconds and the thread substrate's wall-clock seconds
both scale through unchanged.
"""
from __future__ import annotations

import json

from repro_torch.core.taskgraph import Kind

from repro_torch.runtime.rrfp import trace as _tr

_US = 1e6  # trace-event timestamps are microseconds


def _slice_name(task, split_backward: bool) -> str:
    if split_backward:
        labels = {Kind.F: "F", Kind.B: "dX", Kind.W: "dW"}
    else:
        labels = {Kind.F: "F", Kind.B: "B", Kind.W: "W"}
    name = f"{labels[task.kind]} m{task.mb}"
    if task.chunk:
        name += f" c{task.chunk}"
    return name


def to_perfetto(trace: _tr.Trace, critical_path: bool = False) -> dict:
    """Convert a recorded trace to a Chrome trace-event JSON object.

    With ``critical_path=True`` (opt-in: the default output stays
    byte-stable) the export additionally runs ``obs.critpath`` over the
    trace and (a) shades every task slice by its scheduling slack —
    critical-path slices red (``cname: terrible``), near-critical ones
    progressively lighter, with ``slack_s``/``critical`` in the slice args
    — and (b) appends a dedicated "critical path" track (one synthetic
    process after the per-stage ones) holding only the binding chain,
    recovery windows included, so the bounding sequence reads left-to-right
    at ui.perfetto.dev.
    """
    meta = trace.meta
    split = bool(meta.get("split_backward", False))
    num_stages = int(meta.get("num_stages", 0) or
                     1 + max((ev.stage for ev in trace.events), default=0))
    cp_by_dlc: dict[int, tuple[float, bool]] = {}
    cp_path: list = []
    if critical_path:
        # lazy import: export must stay loadable without the engine
        from repro_torch.obs.critpath import ROOT_KEY, ExecGraph

        graph = ExecGraph.build(trace)
        slacks = graph.slack()
        mk = max(graph.makespan, 1e-300)
        on_path = {n.key for n, _ in graph.critical_path()}
        for key, node in graph.nodes.items():
            if key == ROOT_KEY or node.dispatch_lc < 0:
                continue
            cp_by_dlc[node.dispatch_lc] = (slacks[key], key in on_path)
        cp_path = [(n, e) for n, e in graph.critical_path()
                   if n.key != ROOT_KEY]

        def _shade(slack: float, critical: bool) -> str | None:
            if critical:
                return "terrible"
            if slack < 0.05 * mk:
                return "bad"
            if slack < 0.20 * mk:
                return "generally_bad"
            return None
    events: list[dict] = []
    for s in range(num_stages):
        events.append({"ph": "M", "name": "process_name", "pid": s, "tid": 0,
                       "args": {"name": f"stage {s}"}})
        events.append({"ph": "M", "name": "process_sort_index", "pid": s,
                       "tid": 0, "args": {"sort_index": s}})
        events.append({"ph": "M", "name": "thread_name", "pid": s, "tid": 0,
                       "args": {"name": "exec"}})

    dispatch_ev: dict = {}
    send_t: dict[int, tuple[int, float]] = {}  # seq -> (src stage, t)
    depth: dict[int, dict[Kind, int]] = {}
    backlog_seen: set[int] = set()
    for ev in trace.events:
        ts = ev.t * _US
        if ev.kind == _tr.DISPATCH:
            dispatch_ev.setdefault(ev.task, ev)
        elif ev.kind == _tr.COMPLETE:
            d = dispatch_ev.pop(ev.task, None)
            if d is not None:
                args = {"lc": ev.lc, "mb": ev.task.mb, "chunk": ev.task.chunk}
                path = d.info.get("path")
                if path:
                    args["path"] = path
                if "dur" in ev.info:
                    args["dur_s"] = ev.info["dur"]
                slice_ev = {
                    "ph": "X", "name": _slice_name(ev.task, split),
                    "cat": "task", "pid": ev.stage, "tid": 0,
                    "ts": d.t * _US, "dur": max(0.0, (ev.t - d.t) * _US),
                    "args": args}
                if d.lc in cp_by_dlc:
                    slack, critical = cp_by_dlc[d.lc]
                    args["slack_s"] = slack
                    args["critical"] = critical
                    shade = _shade(slack, critical)
                    if shade is not None:
                        slice_ev["cname"] = shade
                events.append(slice_ev)
            wb = ev.info.get("w_backlog")
            if wb is not None:
                backlog_seen.add(ev.stage)
                events.append({
                    "ph": "C", "name": "w_backlog", "pid": ev.stage,
                    "ts": ts, "args": {"deferred W": wb}})
        elif ev.kind == _tr.SEND:
            seq = ev.info.get("seq")
            if seq is not None:
                send_t[int(seq)] = (ev.stage, ev.t)
        elif ev.kind == _tr.DELIVER:
            seq = ev.info.get("seq")
            src = send_t.get(int(seq)) if seq is not None else None
            if src is not None:
                name = _slice_name(ev.task, split)
                flow = {"cat": "msg", "name": name, "id": int(seq)}
                events.append({"ph": "s", "pid": src[0], "tid": 0,
                               "ts": src[1] * _US, **flow})
                events.append({"ph": "f", "bp": "e", "pid": ev.stage,
                               "tid": 0, "ts": max(ts, src[1] * _US), **flow})
        elif ev.kind in (_tr.ENQUEUE, _tr.DEQUEUE):
            d = depth.setdefault(ev.stage, {k: 0 for k in Kind})
            d[ev.task.kind] += 1 if ev.kind == _tr.ENQUEUE else -1
            events.append({
                "ph": "C", "name": "queue_depth", "pid": ev.stage, "ts": ts,
                "args": {k.name: d[k] for k in Kind}})
        elif ev.kind == _tr.STALL:
            events.append({
                "ph": "X", "name": "chaos stall", "cat": "chaos",
                "pid": ev.stage, "tid": 0, "ts": ts,
                "dur": float(ev.info.get("dur", 0.0)) * _US,
                "args": {"lc": ev.lc}})
    if cp_path:
        cp_pid = num_stages  # one synthetic process after the stage tracks
        events.append({"ph": "M", "name": "process_name", "pid": cp_pid,
                       "tid": 0, "args": {"name": "critical path"}})
        events.append({"ph": "M", "name": "process_sort_index", "pid": cp_pid,
                       "tid": 0, "args": {"sort_index": cp_pid}})
        events.append({"ph": "M", "name": "thread_name", "pid": cp_pid,
                       "tid": 0, "args": {"name": "binding chain"}})
        for node, edge in cp_path:
            if node.op == "recovery":
                name = f"recovery s{node.stage}"
            else:
                name = f"{_slice_name(node.task, split)} s{node.stage}"
            events.append({
                "ph": "X", "name": name, "cat": "critical_path",
                "pid": cp_pid, "tid": 0, "ts": node.dispatch_t * _US,
                "dur": max(0.0, (node.end_t - node.dispatch_t) * _US),
                "cname": "terrible",
                "args": {"stage": node.stage, "op": node.op,
                         "via": edge.kind if edge is not None else "root",
                         "slack_s": 0.0, "critical": True}})
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {k: v for k, v in meta.items() if v is not None},
    }


def export_perfetto(trace: _tr.Trace, path: str,
                    critical_path: bool = False) -> None:
    """Write the Chrome trace-event JSON for ``trace`` to ``path``."""
    with open(path, "w") as f:
        json.dump(to_perfetto(trace, critical_path=critical_path), f)


# ---- schema validation (used by tests and the conformance harness) --------
_PH_REQUIRED: dict[str, tuple[str, ...]] = {
    "X": ("name", "pid", "tid", "ts", "dur"),
    "M": ("name", "pid", "args"),
    "C": ("name", "pid", "ts", "args"),
    "s": ("name", "pid", "tid", "ts", "id"),
    "f": ("name", "pid", "tid", "ts", "id"),
}


def validate_chrome_trace(doc: dict) -> None:
    """Assert ``doc`` is structurally valid Chrome trace-event JSON.

    Checks the subset of the format the exporter emits: required fields per
    phase type, numeric non-negative timestamps/durations, int pid/tid, and
    that every flow-start ``s`` has a matching finish ``f`` (same id) at an
    equal-or-later timestamp.  Raises :class:`AssertionError` on violation.
    """
    assert isinstance(doc, dict), "top level must be a JSON object"
    evs = doc.get("traceEvents")
    assert isinstance(evs, list) and evs, "traceEvents must be non-empty list"
    flows: dict[int, list[float]] = {}
    finishes: dict[int, list[float]] = {}
    for i, ev in enumerate(evs):
        assert isinstance(ev, dict), f"event {i} not an object"
        ph = ev.get("ph")
        assert ph in _PH_REQUIRED, f"event {i}: unknown phase {ph!r}"
        for field in _PH_REQUIRED[ph]:
            assert field in ev, f"event {i} (ph={ph}) missing {field!r}"
        if "pid" in ev:
            assert isinstance(ev["pid"], int), f"event {i}: pid must be int"
        if "tid" in ev:
            assert isinstance(ev["tid"], int), f"event {i}: tid must be int"
        if "ts" in ev:
            assert isinstance(ev["ts"], (int, float)) and ev["ts"] >= 0, (
                f"event {i}: bad ts {ev.get('ts')!r}")
        if ph == "X":
            assert isinstance(ev["dur"], (int, float)) and ev["dur"] >= 0, (
                f"event {i}: bad dur {ev.get('dur')!r}")
        if ph == "s":
            flows.setdefault(ev["id"], []).append(ev["ts"])
        elif ph == "f":
            finishes.setdefault(ev["id"], []).append(ev["ts"])
    for fid, starts in flows.items():
        ends = finishes.get(fid)
        assert ends, f"flow id {fid} started but never finished"
        assert min(ends) >= min(starts), (
            f"flow id {fid} finishes before it starts")
    json.dumps(doc)  # must be serializable end-to-end
