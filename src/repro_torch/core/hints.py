"""Hint orders (§5, Appendix A) and fixed pre-committed execution orders.

A hint order ranks *currently ready* candidates; it never forces waiting.  The
same objects can also be consumed in ``PRECOMMITTED`` mode by the engine, which
is how the 1F1B / GPipe / ZeroBubble baselines are expressed: an explicit
per-stage task sequence that the stage must follow in order, waiting on any
not-yet-ready entry.  That "one schedule, two consumption modes" contrast is
the paper's central claim.
"""
from __future__ import annotations

import dataclasses
import enum
import heapq
from typing import Iterable, Iterator, Sequence

from repro_torch.core.taskgraph import Kind, PipelineSpec, Task


class HintKind(enum.Enum):
    BF = "bf"              # default: backward, then forward, each round
    FB = "fb"              # forward, then backward, each round
    B_PRIORITY = "b_priority"  # backward whenever any backward is ready
    F_PRIORITY = "f_priority"  # forward whenever any forward is ready
    BFW = "bfw"            # BF + weight-update tasks fill empty rounds


def _within_direction_key(t: Task):
    """Appendix A within-direction priority.

    Forward prefers the *smaller* model-chunk index, backward the *larger*;
    ties break on the smaller microbatch index.  (W inherits backward's rule.)
    """
    if t.kind == Kind.F:
        return (t.chunk, t.mb)
    return (-t.chunk, t.mb)


def pick(ready: "Sequence[Task] | ReadySet", kind: Kind) -> Task | None:
    """NextByPriority(L_r, Pi) restricted to one direction.

    Accepts either a plain task sequence (the reference sort-then-rank
    path) or a :class:`ReadySet` (O(1) peek at the precomputed per-kind
    minimum).  Both resolve ties identically: the within-direction key is
    injective over distinct tasks of one stage, and the ReadySet heap
    falls back to the Task total order on the (cross-stage-only) ties the
    reference resolves via the callers' sorted presentation order.
    """
    if isinstance(ready, ReadySet):
        return ready.peek(kind)
    cands = [t for t in ready if t.kind == kind]
    if not cands:
        return None
    return min(cands, key=_within_direction_key)


def table_ranks(order: Sequence[Task]) -> dict[Task, int]:
    """A synthesized per-stage order as a rank table (task -> position).

    The adaptive runtime consumes re-synthesized schedules this way:
    the table *ranks* ready work, it never forces waiting on an unready
    entry — the same non-binding contract as the directional hints.
    """
    return {t: i for i, t in enumerate(order)}


def _table_key(ranks: dict[Task, int], t: Task) -> tuple:
    """Total order under a rank table: ranked tasks first (by rank), then
    unranked ones by the Appendix A within-direction key (injective per
    stage), so a stale table still dispatches everything deterministically."""
    r = ranks.get(t)
    if r is not None:
        return (0, r)
    return (1, int(t.kind)) + _within_direction_key(t)


class ReadySet:
    """Incremental ready-set index: lazy-deletion heap per task kind.

    The sort-then-rank dispatch path cost O(n log n) per decision:
    ``arbiter.select(sorted(ready))`` re-sorted and re-scanned the whole
    ready set on *every* arbitration attempt.  This index keeps one binary
    heap per kind, keyed by the precomputed Appendix A within-direction
    priority, so the hot path becomes O(log n) insert / amortized-O(1)
    peek — with the exact same tie-break total order (heap entries carry
    ``(key, task)``; the key is injective over distinct tasks of one
    stage, and `Task`'s own total order resolves anything beyond that,
    matching ``min`` over a sorted presentation).

    Removals are lazy: ``discard`` only drops the task from the live set;
    stale heap heads are popped at the next ``peek``.  Each task is pushed
    at most once per ``add``, and the runtime dispatches each task exactly
    once, so heap garbage is bounded by the number of dispatches.

    Set-like surface (``in``, ``len``, iteration, ``add``/``discard``)
    keeps every cold-path consumer (trace snapshots, drains, diagnostics)
    working unchanged.
    """

    __slots__ = ("_live", "_heaps", "_table", "_theap")

    def __init__(self, tasks: Iterable[Task] = (),
                 table: dict[Task, int] | None = None):
        self._live: set[Task] = set()
        self._heaps: dict[Kind, list[tuple[tuple[int, int], Task]]] = {
            k: [] for k in Kind}
        #: optional rank table (task -> priority); maintains one extra
        #: cross-kind heap so ``peek_table`` stays amortized O(1)
        self._table: dict[Task, int] | None = table
        self._theap: list[tuple[tuple, Task]] = []
        for t in tasks:
            self.add(t)

    # ---- mutation ---------------------------------------------------------
    def add(self, t: Task) -> None:
        if t in self._live:
            return
        self._live.add(t)
        heapq.heappush(self._heaps[t.kind], (_within_direction_key(t), t))
        if self._table is not None:
            heapq.heappush(self._theap, (_table_key(self._table, t), t))

    def discard(self, t: Task) -> None:
        # Lazy: the heap entry stays until it surfaces at a peek.
        self._live.discard(t)

    def set_table(self, ranks: dict[Task, int] | None) -> None:
        """Install (or drop) a rank table — the hot-swap point.

        Rebuilds the cross-kind heap from the live set: O(n) for n ready
        tasks, paid once per swap (iteration boundaries), never on the
        dispatch hot path."""
        self._table = ranks
        if ranks is None:
            self._theap = []
            return
        self._theap = [(_table_key(ranks, t), t) for t in self._live]
        heapq.heapify(self._theap)

    # ---- queries ----------------------------------------------------------
    def peek(self, kind: Kind) -> Task | None:
        """The within-direction minimum ready task of ``kind`` (or None)."""
        heap = self._heaps[kind]
        while heap and heap[0][1] not in self._live:
            heapq.heappop(heap)
        return heap[0][1] if heap else None

    def peek_table(self) -> Task | None:
        """The rank-table minimum over *all* ready tasks (or None)."""
        heap = self._theap
        while heap and heap[0][1] not in self._live:
            heapq.heappop(heap)
        return heap[0][1] if heap else None

    def __contains__(self, t: Task) -> bool:
        return t in self._live

    def __len__(self) -> int:
        return len(self._live)

    def __bool__(self) -> bool:
        return bool(self._live)

    def __iter__(self) -> Iterator[Task]:
        return iter(self._live)

    def __repr__(self) -> str:  # diagnostics only
        return f"ReadySet({sorted(self._live)!r})"


@dataclasses.dataclass
class HintArbiter:
    """Algorithm 1's arbitration: stateful round structure per stage.

    ``last_dir`` implements the round alternation of the BF/FB hints: after a
    B executes, the same round's F check runs next (and vice versa for FB).
    """

    hint: HintKind = HintKind.BF
    last_dir: Kind | None = None
    #: optional rank table (task -> priority).  When set, ``select``
    #: serves the minimum-rank ready task instead of the directional
    #: round structure — same non-binding contract, finer priorities.
    #: Swapped at runtime via :meth:`set_table` (adaptive re-synthesis).
    table: dict[Task, int] | None = None

    def try_order(self) -> tuple[Kind, ...]:
        """The kind preference the *next* ``select`` will scan, in order.

        Exposed so the runtime can record each dispatch's arbitration order
        in the event trace: the conformance checker replays it against the
        stage's remaining tasks to verify that the hint order is violated
        only when the hinted task is unready.
        """
        return self.order_given(self.last_dir)

    def order_given(self, prev: Kind | None) -> tuple[Kind, ...]:
        """``try_order`` as of a captured pre-``select`` ``last_dir`` —
        lets a caller reconstruct the order a dispatch actually scanned
        after the select has already advanced the round alternation."""
        if self.hint == HintKind.B_PRIORITY:
            order: tuple[Kind, ...] = (Kind.B, Kind.F)
        elif self.hint == HintKind.F_PRIORITY:
            order = (Kind.F, Kind.B)
        elif self.hint == HintKind.FB:
            order = (Kind.B, Kind.F) if prev == Kind.F else (Kind.F, Kind.B)
        elif self.hint in (HintKind.BF, HintKind.BFW):
            order = (Kind.F, Kind.B) if prev == Kind.B else (Kind.B, Kind.F)
        else:  # pragma: no cover
            raise ValueError(self.hint)
        if self.hint == HintKind.BFW:
            # Weight-update tasks fill rounds with no ready compute direction.
            order += (Kind.W,)
        return order

    def rank_given(self, kind: Kind, prev: Kind | None) -> int:
        """``order_given(prev).index(kind)`` without building the tuple —
        the hint-divergence slot on the metrics hot path (0 = the hinted
        direction was served)."""
        if kind == Kind.W:
            return 2  # only BFW appends W, always last
        if self.hint == HintKind.B_PRIORITY:
            first = Kind.B
        elif self.hint == HintKind.F_PRIORITY:
            first = Kind.F
        elif self.hint == HintKind.FB:
            first = Kind.B if prev == Kind.F else Kind.F
        else:
            first = Kind.F if prev == Kind.B else Kind.B
        return 0 if kind == first else 1

    def select(self, ready: Sequence[Task] | ReadySet) -> Task | None:
        """Return the dispatched task for the current ready set (or None).

        With a :class:`ReadySet` each direction probe is an O(1) heap peek
        (the production hot path); with a plain sequence it is the
        reference linear scan.  Decisions are identical either way.
        """
        if self.table is not None:
            if isinstance(ready, ReadySet):
                return ready.peek_table()
            if not ready:
                return None
            ranks = self.table
            return min(ready, key=lambda t: _table_key(ranks, t))
        for k in self.try_order():
            t = pick(ready, k)
            if t is not None:
                # A W dispatch fills an empty round without consuming it:
                # round alternation tracks compute directions only.
                if k != Kind.W and self.hint in (
                        HintKind.BF, HintKind.FB, HintKind.BFW):
                    self.last_dir = t.kind
                return t
        return None

    def reset(self) -> None:
        self.last_dir = None

    def set_table(self, ranks: dict[Task, int] | None) -> None:
        """Hot-swap the rank table (None reverts to the directional hint)."""
        self.table = ranks


def backpressure_drain(
    spec: PipelineSpec,
    stage: int,
    ready: Sequence[Task] | ReadySet,
    done: set[Task],
    drain_focus: int,
) -> tuple[Task | None, int]:
    """Appendix C drain orders, shared by the DES engine and the actor runtime.

    Non-interleaved pipelines drain backward-only; interleaved pipelines
    follow the deterministic per-microbatch completion order
    F_0..F_{C-1}, B_{C-1}..B_0 focused on microbatches in index order.
    Returns (task-or-None, updated drain focus).  A :class:`ReadySet`
    serves the backward-only pick in O(1) and the interleaved membership
    probes in O(1); a plain sequence takes the reference linear path.
    """
    if spec.num_chunks == 1:
        return pick(ready, Kind.B), drain_focus
    C = spec.num_chunks
    ready_set = ready if isinstance(ready, ReadySet) else set(ready)
    j = drain_focus
    while j < spec.num_microbatches:
        seq_order = [Task(Kind.F, stage, j, c) for c in range(C)] + [
            Task(Kind.B, stage, j, c) for c in reversed(range(C))
        ]
        for t in seq_order:
            if t in done:
                continue
            return (t if t in ready_set else None), j
        j += 1
    return None, j


# --------------------------------------------------------------------------
# Fixed per-stage execution orders (pre-committed baselines + synthesis grid).
# --------------------------------------------------------------------------

def gpipe_order(spec: PipelineSpec, stage: int) -> list[Task]:
    """All forwards, then all backwards (GPipe; also the DeepSpeed-like mode)."""
    fs = [
        Task(Kind.F, stage, j, c)
        for c in range(spec.num_chunks)
        for j in range(spec.num_microbatches)
    ]
    bs = [
        Task(Kind.B, stage, j, c)
        for c in reversed(range(spec.num_chunks))
        for j in range(spec.num_microbatches)
    ]
    out = fs + bs
    if spec.split_backward:
        out += [
            Task(Kind.W, stage, j, c)
            for c in reversed(range(spec.num_chunks))
            for j in range(spec.num_microbatches)
        ]
    return out


def one_f_one_b_order(spec: PipelineSpec, stage: int) -> list[Task]:
    """Standard non-interleaved 1F1B (PipeDream-flush / Megatron default).

    Warmup: dist-to-sink forwards (S-1-s on a chain; the longest forward
    path to a loss stage on a DAG); steady state: alternate 1F/1B;
    cooldown: drain backwards.  Only defined for num_chunks == 1.
    """
    if spec.num_chunks != 1:
        raise NotImplementedError("interleaved 1F1B handled by synthesis")
    M = spec.num_microbatches
    warmup = min(spec.dist_to_sink(stage), M)
    order: list[Task] = [Task(Kind.F, stage, j) for j in range(warmup)]
    nf, nb = warmup, 0
    while nb < M:
        if nf < M:
            order.append(Task(Kind.F, stage, nf))
            nf += 1
        order.append(Task(Kind.B, stage, nb))
        nb += 1
    if spec.split_backward:
        raise NotImplementedError("use zero_bubble_order for split backward")
    return order


def zero_bubble_order(spec: PipelineSpec, stage: int) -> list[Task]:
    """ZB-H1-style fixed order: 1F1B over (F, B-dX) with W deferred.

    W for microbatch j is scheduled as late as the memory argument allows:
    early W fill the warmup-asymmetry bubbles, the rest drain in the cooldown.
    This is the representative fixed-order ZB baseline of §7 (not a full ILP
    ZB-V reimplementation).
    """
    if spec.num_chunks != 1:
        raise NotImplementedError
    if not spec.split_backward:
        raise ValueError("zero_bubble_order requires split_backward=True")
    M = spec.num_microbatches
    depth = spec.dist_to_sink(stage)
    warmup = min(depth, M)
    order: list[Task] = [Task(Kind.F, stage, j) for j in range(warmup)]
    nf, nb, nw = warmup, 0, 0
    while nb < M:
        if nf < M:
            order.append(Task(Kind.F, stage, nf))
            nf += 1
        order.append(Task(Kind.B, stage, nb))
        nb += 1
        # ZB: defer W unless we've run out of F's to issue (cooldown), in
        # which case W fills what would otherwise be a bubble slot.
        if nf >= M and nw < nb - depth:
            order.append(Task(Kind.W, stage, nw))
            nw += 1
    while nw < M:
        order.append(Task(Kind.W, stage, nw))
        nw += 1
    return order


def modality_balanced_order(
    spec: PipelineSpec, stage: int, stage_cost: Sequence[float]
) -> list[Task]:
    """Cornstarch-like baseline: cost-aware warmup depth, still pre-committed.

    Uses per-stage relative cost to shift the warmup depth (heavier stages get
    fewer in-flight microbatches), emulating a modality-aware planner that
    still commits to its order ahead of execution.  On a DAG the base depth
    is the stage's longest forward path to the loss stage, so encoder-branch
    stages (cheap, far from the sink) warm up deep while decoder stages stay
    shallow — the planner's view of the modality imbalance.

    Feasibility: with asynchronous sends, a set of per-stage 1F1B-style
    orders is deadlock-free iff every forward edge (s -> u) satisfies
    ``warmup(s) >= warmup(u) + 1`` (a stage must stay a microbatch ahead of
    each consumer before it starts waiting on backwards).  The cost-aware
    depths are therefore clamped by a reverse-topological pass; a stage
    pinned at ``M`` (GPipe-like, all forwards first) releases its
    predecessors from the constraint only if they are pinned at ``M`` too.
    """
    if spec.num_chunks != 1:
        raise NotImplementedError
    S, M = spec.num_stages, spec.num_microbatches

    def desired(s: int) -> int:
        rel = stage_cost[s] / max(max(stage_cost), 1e-12)
        return min(max(1, round(spec.dist_to_sink(s) * (1.5 - rel))), M, S)

    warmups: dict[int, int] = {}
    order_rev = (spec.graph.topological_order() if spec.graph is not None
                 else tuple(range(S)))
    for s in reversed(order_rev):
        need = max((warmups[u] + 1 for u in spec.stage_successors(s)),
                   default=0)
        warmups[s] = min(M, max(desired(s), need))
    warmup = warmups[stage]
    order: list[Task] = [Task(Kind.F, stage, j) for j in range(warmup)]
    nf, nb = warmup, 0
    while nb < M:
        if nf < M:
            order.append(Task(Kind.F, stage, nf))
            nf += 1
        order.append(Task(Kind.B, stage, nb))
        nb += 1
    if spec.split_backward:
        order += [Task(Kind.W, stage, j) for j in range(M)]
    return order


FIXED_ORDERS = {
    "gpipe": gpipe_order,
    "1f1b": one_f_one_b_order,
    "zb": zero_bubble_order,
}
