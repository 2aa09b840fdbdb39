"""Runtime-conformance invariants, checked against recorded event traces.

The single source of truth for what "the runtime behaved correctly" means —
shared by the conformance test suite (``tests/conformance``) and the chaos
benchmark (``benchmarks.chaos_sweep``), so the invariants CI enforces and
the invariants the committed ``BENCH_chaos.json`` reports are the same
code.

Each checker raises :class:`AssertionError` with a diagnostic message on
violation; :func:`holds` wraps a full check into a bool for reporting.

The invariants (schedule-independent — they hold for *any* consumption
mode under *any* variability, which is the paper's §3 correctness claim):

* **exactly-once** — every task in the spec is dispatched and completed
  exactly once, even when chaos duplicates every envelope;
* **dependency order** — by logical clock, all of a task's predecessors
  (including every DAG fan-in predecessor) complete before the task is
  dispatched;
* **fan-in admission** — a multi-predecessor task is enqueued only after a
  delivery from *every* incoming edge on *every* TP rank: the mailbox's
  edge gate never admits a task on a partial branch set;
* **w_defer_cap** — the backlog of un-executed W tasks (each holding a
  stashed activation pair) never exceeds the cap (hint mode);
* **backpressure** — the App. C F/B imbalance never exceeds
  ``buffer_limit`` + 1 (Thm C.1; non-interleaved hint mode);
* **hint faithfulness** — a hint-path dispatch deviates from the hint
  order only when the hinted task is unready: no ready task of a preferred
  direction is skipped, and within a direction the App. A minimum ready
  candidate is picked;
* **table faithfulness** — under an (adaptively re-synthesized) rank
  table, each table-path dispatch serves the minimum-rank ready task of
  the table active at that logical clock (initial table from trace meta,
  mid-run swaps replayed from ``HINT_SWAP`` events);
* **wcap path** — dispatches forced by the W cap actually retire a W;
* **recovery exactly-once** — on a trace with recovery windows
  (:meth:`Trace.recovery_windows`), no microbatch is lost or doubled across
  the recovery boundary: every task still completes, repeats occur only on
  a failed stage with each completion in a distinct recovery epoch (one per
  incarnation — re-execution, never duplication), and every fenced envelope
  was genuinely stale.  ``check_all`` dispatches between the plain and the
  recovery-aware exactly-once form automatically.

Deadlock-freedom is checked by construction: a run either completes or
raises :class:`~repro_torch.core.engine.DeadlockError`.
"""
from __future__ import annotations

from collections import Counter

from repro_torch.core.hints import pick
from repro_torch.core.taskgraph import Kind, PipelineSpec

from repro_torch.runtime.rrfp import trace as tr


def check_exactly_once(trace: tr.Trace, spec: PipelineSpec) -> None:
    """Every task dispatched and completed exactly once (dup-proof)."""
    want = set(spec.tasks())
    dispatched = Counter(ev.task for ev in trace.select(tr.DISPATCH))
    completed = Counter(ev.task for ev in trace.select(tr.COMPLETE))
    assert set(dispatched) == want, (
        f"dispatch set mismatch: missing={want - set(dispatched)} "
        f"extra={set(dispatched) - want}")
    assert set(completed) == want, (
        f"complete set mismatch: missing={want - set(completed)}")
    multi = {t: n for t, n in dispatched.items() if n != 1}
    assert not multi, f"tasks dispatched != once: {multi}"
    multi = {t: n for t, n in completed.items() if n != 1}
    assert not multi, f"tasks completed != once: {multi}"


def check_dependency_order(trace: tr.Trace, spec: PipelineSpec) -> None:
    """By logical clock, predecessors complete before a task dispatches.

    Every dispatch of a task (a recovered stage may dispatch a task once
    per incarnation) must come after the *first* completion of each
    predecessor: data a re-execution consumes was produced no later than
    that."""
    first_complete: dict = {}
    for ev in trace.select(tr.COMPLETE):
        first_complete.setdefault(ev.task, ev.lc)
    preds = {t: spec.predecessors(t) for t in spec.tasks()}
    for ev in trace.select(tr.DISPATCH):
        for p in preds[ev.task]:
            assert first_complete[p] < ev.lc, (
                f"{ev.task} dispatched (lc={ev.lc}) before predecessor "
                f"{p} completed (lc={first_complete[p]})")


def check_recovery_exactly_once(trace: tr.Trace, spec: PipelineSpec) -> None:
    """Recovery-aware exactly-once: nothing lost, nothing doubled.

    On a trace with recovery windows: (1) every spec task completes at
    least once — the failure lost no microbatch; (2) a task completes more
    than once only on a stage that failed, with every completion in a
    distinct recovery epoch — one execution per incarnation (the thread
    substrate re-executes from scratch; duplicated *effects* are dropped by
    the TP admission gate and idempotent per-task slots, so one completion
    per incarnation is re-execution, not double application); (3) repeat
    dispatches likewise only on failed stages; (4) every fenced envelope
    carried an epoch strictly older than its mailbox's — fencing never
    drops a live message."""
    want = set(spec.tasks())
    failed_stages = {w["stage"] for w in trace.recovery_windows()}
    completes: dict = {}
    for ev in trace.select(tr.COMPLETE):
        completes.setdefault(ev.task, []).append(ev)
    missing = want - set(completes)
    assert not missing, (
        f"{len(missing)} task(s) lost across recovery: "
        f"{sorted(missing)[:6]}")
    extra = set(completes) - want
    assert not extra, f"completed tasks outside the spec: {sorted(extra)[:6]}"
    for t, evs in completes.items():
        if len(evs) == 1:
            continue
        assert t.stage in failed_stages, (
            f"{t} completed {len(evs)}x on a stage that never failed")
        epochs = [e.epoch for e in evs]
        assert len(set(epochs)) == len(epochs), (
            f"{t} completed twice within one incarnation "
            f"(epochs={epochs}): a genuine duplicate, not a re-execution")
    dispatched = Counter(ev.task for ev in trace.select(tr.DISPATCH))
    missing = want - set(dispatched)
    assert not missing, f"tasks never dispatched: {sorted(missing)[:6]}"
    for t, n in dispatched.items():
        assert n == 1 or t.stage in failed_stages, (
            f"{t} dispatched {n}x on a stage that never failed")
    for ev in trace.select(tr.FENCE):
        assert ev.info["env_epoch"] < ev.info["mailbox_epoch"], (
            f"lc={ev.lc}: fenced a live envelope for {ev.task} "
            f"(env_epoch={ev.info['env_epoch']} >= "
            f"mailbox_epoch={ev.info['mailbox_epoch']})")


def check_fanin_admission(trace: tr.Trace, spec: PipelineSpec,
                          tp_degree: int = 1) -> None:
    """DAG fan-in: enqueue strictly after every edge's (per-rank) delivery."""
    enqueue_lc = {
        ev.task: ev.lc for ev in trace.select(tr.ENQUEUE)
        if ev.info.get("src") == "message"}
    first_deliver: dict[tuple, int] = {}
    for ev in trace.select(tr.DELIVER):
        key = (ev.task, int(ev.info.get("src", -1)), ev.rank)
        first_deliver.setdefault(key, ev.lc)
    for t in spec.tasks():
        mps = spec.message_predecessors(t)
        if len(mps) < 2:
            continue
        assert t in enqueue_lc, f"fan-in task {t} never enqueued"
        for p in mps:
            for rank in range(max(1, tp_degree)):
                key = (t, p.stage, rank)
                assert key in first_deliver, (
                    f"{t} enqueued with no delivery from edge "
                    f"{p.stage}->{t.stage} rank {rank}")
                assert first_deliver[key] < enqueue_lc[t], (
                    f"{t} enqueued (lc={enqueue_lc[t]}) before edge "
                    f"{p.stage}->{t.stage} rank {rank} delivered "
                    f"(lc={first_deliver[key]})")


def check_w_cap(trace: tr.Trace, cap: int, mode: str) -> None:
    """Deferred-W backlog (stashed activation pairs) never exceeds the cap."""
    if mode != "hint" or cap <= 0:
        return
    for ev in trace.select(tr.COMPLETE):
        backlog = ev.info.get("w_backlog")
        if backlog is not None:
            assert backlog <= cap, (
                f"w_defer_cap={cap} exceeded: backlog={backlog} after "
                f"{ev.task} (lc={ev.lc})")


def check_backpressure(trace: tr.Trace, spec: PipelineSpec, limit: int,
                       mode: str) -> None:
    """App. C: per-stage F/B imbalance bounded by buffer_limit (+1 in
    flight) — non-interleaved hint mode (Thm C.1)."""
    if mode != "hint" or spec.num_chunks != 1:
        return
    depth: Counter = Counter()
    for ev in trace.events:
        if ev.kind == tr.RECOVERY_BEGIN:
            # a respawned incarnation starts from a clean F/B ledger; its
            # completions are a fresh consistent sequence, so summing them
            # onto the dead incarnation's would double count
            depth[ev.stage] = 0
            continue
        if ev.kind != tr.COMPLETE:
            continue
        if ev.task.kind == Kind.F:
            depth[ev.stage] += 1
        elif ev.task.kind == Kind.B:
            depth[ev.stage] -= 1
        assert depth[ev.stage] <= limit + 1, (
            f"stage {ev.stage} F/B imbalance {depth[ev.stage]} > "
            f"limit+1={limit + 1} at lc={ev.lc}")


def check_hint_faithful(trace: tr.Trace, spec: PipelineSpec) -> None:
    """Hint-path dispatches deviate from the hint only through unreadiness.

    For each dispatch on the ``hint`` arbitration path, with the recorded
    kind-preference order (k1, k2, ...): no task of a kind preferred over
    the dispatched kind may be in the recorded ready snapshot, and the
    dispatched task must be the App. A minimum among ready tasks of its own
    kind.  Together these imply the paper-level property: whenever the
    dispatch differs from the hint's global preference over the stage's
    remaining tasks, that preferred task was unready.

    Ready snapshots come from :meth:`Trace.ready_sets`, which decodes both
    the verbose per-dispatch ``ready`` lists and the default incremental
    ``radd`` diff encoding.
    """
    snapshots = trace.ready_sets()
    for ev in trace.select(tr.DISPATCH):
        if ev.info.get("path") != "hint":
            continue
        order = [Kind(k) for k in ev.info["order"]]
        ready = snapshots[ev.lc]
        kind = ev.task.kind
        assert kind in order, (ev.task, order)
        for k in order[:order.index(kind)]:
            skipped = pick(ready, k)
            assert skipped is None, (
                f"lc={ev.lc}: dispatched {ev.task} while preferred-direction "
                f"task {skipped} was ready (order={order})")
        best = pick(ready, kind)
        assert best == ev.task, (
            f"lc={ev.lc}: dispatched {ev.task} but within-direction "
            f"priority prefers ready {best}")


def check_table_faithful(trace: tr.Trace, spec: PipelineSpec) -> None:
    """Table-path dispatches serve the minimum-rank ready task.

    The active rank table is reconstructed from the trace itself: the
    meta-recorded initial ``hint_table`` plus every HINT_SWAP event (each
    carries the stage's full new order), applied in logical-clock
    sequence — so the check is exact across mid-run hot-swaps and
    recovery re-adoptions.  For each dispatch on the ``table`` path the
    dispatched task must be the minimum of the recorded ready snapshot
    under the active table's total order (ranked tasks by position,
    unranked ones after, by the App. A key) — i.e. the table, like the
    directional hints, is deviated from only through unreadiness.
    """
    from repro_torch.core.hints import _table_key, table_ranks

    active: dict[int, dict] = {}
    meta_tbl = trace.meta.get("hint_table")
    if meta_tbl is not None:
        for s, order in enumerate(meta_tbl):
            active[s] = table_ranks([tr.task_from_key(k) for k in order])
    snapshots = None
    for ev in trace.events:
        if ev.kind == tr.HINT_SWAP:
            active[ev.stage] = table_ranks(
                [tr.task_from_key(k) for k in ev.info["order"]])
            continue
        if ev.kind != tr.DISPATCH or ev.info.get("path") != "table":
            continue
        ranks = active.get(ev.stage)
        assert ranks is not None, (
            f"lc={ev.lc}: table-path dispatch on stage {ev.stage} with no "
            f"active table (no meta hint_table, no prior HINT_SWAP)")
        if snapshots is None:
            snapshots = trace.ready_sets()
        ready = snapshots[ev.lc]
        best = min(ready, key=lambda t: _table_key(ranks, t))
        assert best == ev.task, (
            f"lc={ev.lc}: dispatched {ev.task} but the active rank table "
            f"(version {ev.info.get('tv')}) prefers ready {best}")


def check_wcap_path(trace: tr.Trace) -> None:
    """Dispatches forced by the W cap must actually retire a W task."""
    for ev in trace.select(tr.DISPATCH):
        if ev.info.get("path") == "wcap":
            assert ev.task.kind == Kind.W, (
                f"lc={ev.lc}: wcap path dispatched non-W task {ev.task}")


def check_reliable_delivery(trace: tr.Trace, spec: PipelineSpec) -> None:
    """Exactly-once delivery under a lossy wire (reliable transport on).

    Keys on the per-edge sequence number (``eseq``) the reliable channel
    stamps into SEND / DELIVER / FENCE / RDUP records; recovery *replay*
    envelopes carry no eseq and are governed by the epoch-fencing checks
    instead.  Asserts:

    1. **dedup** — each (src, dst, eseq) reaches the destination mailbox at
       most once (DELIVER + FENCE combined): redundant transmissions never
       survive past the channel's dedup set;
    2. **completeness** — every reliable SEND reaches the mailbox exactly
       once, unless its edge escalated to LINK_FAIL or its destination
       stage failed (recovery replay re-covers those);
    3. **retransmit sanity** — RETRANSMIT records carry attempt >= 1;
    4. **dup sanity** — every RDUP names a key that was first admitted;
    5. **escalation** — every LINK_FAIL's destination stage has a FAIL
       record (the fault was handed to recovery, not swallowed).
    """
    landed = Counter()
    for kind in (tr.DELIVER, tr.FENCE):
        for ev in trace.select(kind):
            if "eseq" in ev.info:
                landed[(int(ev.info["src"]), ev.stage,
                        int(ev.info["eseq"]))] += 1
    dups = {k: n for k, n in landed.items() if n > 1}
    assert not dups, (
        f"reliable dedup violated: {len(dups)} eseq key(s) reached a "
        f"mailbox more than once: {sorted(dups)[:6]}")

    failed_stages = {ev.stage for ev in trace.select(tr.FAIL)}
    dead_edges = {(int(ev.info["src"]) if "src" in ev.info else ev.stage,
                   int(ev.info["dst"]))
                  for ev in trace.select(tr.LINK_FAIL)}
    for ev in trace.select(tr.SEND):
        if "eseq" not in ev.info:
            continue
        key = (ev.stage, ev.task.stage, int(ev.info["eseq"]))
        if key in landed:
            continue
        assert (ev.stage, ev.task.stage) in dead_edges \
            or ev.task.stage in failed_stages, (
            f"reliable send lost: {key} ({ev.task}) never reached the "
            f"mailbox and its edge never escalated")

    for ev in trace.select(tr.RETRANSMIT):
        assert int(ev.info["attempt"]) >= 1, (
            f"lc={ev.lc}: RETRANSMIT with attempt "
            f"{ev.info['attempt']} (first attempts are not retransmits)")
    for ev in trace.select(tr.RDUP):
        key = (int(ev.info["src"]), ev.stage, int(ev.info["eseq"]))
        assert key in landed, (
            f"lc={ev.lc}: duplicate {key} dropped but the key was never "
            f"admitted in the first place")
    for ev in trace.select(tr.LINK_FAIL):
        assert int(ev.info["dst"]) in failed_stages, (
            f"lc={ev.lc}: edge {ev.stage}->{ev.info['dst']} declared "
            f"unhealable but stage {ev.info['dst']} has no FAIL record")


def check_all(trace: tr.Trace, spec: PipelineSpec, config) -> None:
    """Every invariant, against one run's trace.  ``config`` is any object
    with ``mode`` / ``w_defer_cap`` / ``buffer_limit`` attributes
    (``ActorConfig`` in practice; kept duck-typed to avoid a driver
    dependency).  Traces containing recovery windows get the
    recovery-aware exactly-once form; every other invariant applies
    unchanged across the recovery boundary."""
    if trace.recovery_windows():
        check_recovery_exactly_once(trace, spec)
    else:
        check_exactly_once(trace, spec)
    check_dependency_order(trace, spec)
    check_fanin_admission(trace, spec, getattr(config, "tp_degree", 1))
    check_w_cap(trace, config.w_defer_cap, config.mode)
    check_backpressure(trace, spec, config.buffer_limit, config.mode)
    check_hint_faithful(trace, spec)
    check_table_faithful(trace, spec)
    check_wcap_path(trace)
    if trace.meta.get("reliable"):
        check_reliable_delivery(trace, spec)


def holds(trace: tr.Trace, spec: PipelineSpec, config) -> bool:
    """Bool wrapper over :func:`check_all` for reporting/benchmarks."""
    try:
        check_all(trace, spec, config)
    except AssertionError:
        return False
    return True
