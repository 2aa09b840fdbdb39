"""Pipeline task graph: the dependency-constrained execution process of §3.1.

Tasks are forward (F), backward (B) and — under BFW decomposition — weight-update
(W) units at (stage, microbatch, chunk) granularity.  Edges are the paper's
inter-stage dependencies (F needs upstream activation, B needs downstream
gradient) and intra-stage dependencies (B needs the local F; W needs the local
B).  Interleaved (multi-chunk) pipelines wrap forward from the last stage back
to stage 0 at chunk boundaries.

Stage topology is a DAG, not just a chain: a :class:`StageGraph` carries
forward activation edges between stages, so heterogeneous multimodal
pipelines — a vision-encoder branch fanning into a fusion stage that feeds
the LM-decoder chain — are first-class.  A forward task at a fan-in stage
has one *message* predecessor per incoming edge (all must arrive before it
is ready); a backward task at a fan-out stage mirrors this with one
gradient message per outgoing forward edge.  ``graph=None`` keeps the
classic linear chain (including interleaved chunk wrap, which is only
defined for chains).
"""
from __future__ import annotations

import dataclasses
import enum
import functools
from typing import Iterator


class Kind(enum.IntEnum):
    F = 0
    B = 1
    W = 2


@dataclasses.dataclass(frozen=True)
class StageGraph:
    """Forward activation edges between pipeline stages (a DAG).

    ``edges`` are (src, dst) pairs meaning stage ``dst``'s forward consumes
    stage ``src``'s forward output (and, symmetrically, ``src``'s backward
    consumes ``dst``'s input gradient).  Stages without incoming edges are
    *sources* (their forward input is locally available: token/patch
    embeddings); stages without outgoing edges are *sinks* (their loss
    gradient is locally available).
    """

    num_stages: int
    edges: tuple[tuple[int, int], ...]

    def __post_init__(self) -> None:
        object.__setattr__(self, "edges",
                           tuple((int(a), int(b)) for a, b in self.edges))
        seen = set()
        for a, b in self.edges:
            if not (0 <= a < self.num_stages and 0 <= b < self.num_stages):
                raise ValueError(f"edge ({a},{b}) out of range")
            if a == b:
                raise ValueError(f"self-edge ({a},{b})")
            if (a, b) in seen:
                raise ValueError(f"duplicate edge ({a},{b})")
            seen.add((a, b))
        # acyclicity (and compute longest-path depths while at it)
        order = self.topological_order()
        if len(order) != self.num_stages:
            raise ValueError("stage graph has a cycle")

    # ---- construction ------------------------------------------------------
    @staticmethod
    def linear(num_stages: int) -> "StageGraph":
        return StageGraph(num_stages,
                          tuple((s, s + 1) for s in range(num_stages - 1)))

    # ---- structure ---------------------------------------------------------
    @functools.cached_property
    def _preds(self) -> tuple[tuple[int, ...], ...]:
        p: list[list[int]] = [[] for _ in range(self.num_stages)]
        for a, b in self.edges:
            p[b].append(a)
        return tuple(tuple(sorted(x)) for x in p)

    @functools.cached_property
    def _succs(self) -> tuple[tuple[int, ...], ...]:
        s: list[list[int]] = [[] for _ in range(self.num_stages)]
        for a, b in self.edges:
            s[a].append(b)
        return tuple(tuple(sorted(x)) for x in s)

    def preds(self, stage: int) -> tuple[int, ...]:
        return self._preds[stage]

    def succs(self, stage: int) -> tuple[int, ...]:
        return self._succs[stage]

    def sources(self) -> tuple[int, ...]:
        return tuple(s for s in range(self.num_stages) if not self._preds[s])

    def sinks(self) -> tuple[int, ...]:
        return tuple(s for s in range(self.num_stages) if not self._succs[s])

    def topological_order(self) -> tuple[int, ...]:
        """Kahn order (stable by stage index); shorter than S iff cyclic."""
        indeg = [0] * self.num_stages
        for _, b in self.edges:
            indeg[b] += 1
        frontier = [s for s in range(self.num_stages) if indeg[s] == 0]
        out: list[int] = []
        while frontier:
            s = frontier.pop(0)
            out.append(s)
            for t in self._succs[s]:
                indeg[t] -= 1
                if indeg[t] == 0:
                    frontier.append(t)
        return tuple(out)

    @functools.cached_property
    def _depth(self) -> tuple[int, ...]:
        """Longest path from any source (sources have depth 0)."""
        d = [0] * self.num_stages
        for s in self.topological_order():
            for t in self._succs[s]:
                d[t] = max(d[t], d[s] + 1)
        return tuple(d)

    @functools.cached_property
    def _dist_to_sink(self) -> tuple[int, ...]:
        """Longest path to any sink (sinks have distance 0)."""
        d = [0] * self.num_stages
        for s in reversed(self.topological_order()):
            for t in self._succs[s]:
                d[s] = max(d[s], d[t] + 1)
        return tuple(d)

    def depth(self, stage: int) -> int:
        return self._depth[stage]

    def dist_to_sink(self, stage: int) -> int:
        return self._dist_to_sink[stage]

    def is_linear(self) -> bool:
        return self.edges == tuple(
            (s, s + 1) for s in range(self.num_stages - 1))


@dataclasses.dataclass(frozen=True, order=True)
class Task:
    """One schedulable unit of pipeline work."""

    kind: Kind
    stage: int
    mb: int
    chunk: int = 0

    def __repr__(self) -> str:  # compact traces: F[s2,m5,c0]
        return f"{self.kind.name}[s{self.stage},m{self.mb},c{self.chunk}]"


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """Static description of one training iteration's task graph.

    ``graph=None`` is the classic linear chain.  A non-linear
    :class:`StageGraph` generalizes inter-stage dependencies to DAGs
    (multimodal branch + fusion pipelines); interleaved chunks are only
    defined for chains.
    """

    num_stages: int
    num_microbatches: int
    num_chunks: int = 1
    split_backward: bool = False  # BFW: B computes dX only, W updates weights
    graph: StageGraph | None = None  # None = linear chain

    def __post_init__(self) -> None:
        if self.num_stages < 1 or self.num_microbatches < 1 or self.num_chunks < 1:
            raise ValueError(f"invalid spec {self}")
        if self.graph is not None:
            if self.graph.num_stages != self.num_stages:
                raise ValueError(
                    f"graph has {self.graph.num_stages} stages, spec has "
                    f"{self.num_stages}")
            if self.graph.is_linear():
                # normalize: a linear graph IS the default chain (so specs
                # compare equal and the chunk-wrap fast path stays exact)
                object.__setattr__(self, "graph", None)
            elif self.num_chunks != 1:
                raise ValueError(
                    "interleaved chunks are only defined for linear chains")

    # ---- topology ----------------------------------------------------------
    def is_dag(self) -> bool:
        """True when the stage topology is a non-linear DAG."""
        return self.graph is not None

    def source_stages(self) -> tuple[int, ...]:
        """Stages whose chunk-0 forward input is locally available at t=0."""
        if self.graph is None:
            return (0,)
        return self.graph.sources()

    def sink_stages(self) -> tuple[int, ...]:
        """Stages whose last-chunk loss gradient is locally available."""
        if self.graph is None:
            return (self.num_stages - 1,)
        return self.graph.sinks()

    def dist_to_sink(self, stage: int) -> int:
        """Longest forward path from ``stage`` to a sink (chain: S-1-stage).

        The warmup depth of 1F1B-style orders: how many forwards a stage
        must issue before its first backward can possibly be ready.
        """
        if self.graph is None:
            return self.num_stages - 1 - stage
        return self.graph.dist_to_sink(stage)

    def stage_depth(self, stage: int) -> int:
        """Longest path from a source to ``stage`` (chain: stage index)."""
        if self.graph is None:
            return stage
        return self.graph.depth(stage)

    def stage_successors(self, stage: int) -> tuple[int, ...]:
        """Forward-edge successor stages (chain: (stage+1,) or ())."""
        if self.graph is None:
            return (stage + 1,) if stage < self.num_stages - 1 else ()
        return self.graph.succs(stage)

    # ---- enumeration -------------------------------------------------------
    def tasks(self) -> Iterator[Task]:
        for s in range(self.num_stages):
            for j in range(self.num_microbatches):
                for c in range(self.num_chunks):
                    yield Task(Kind.F, s, j, c)
                    yield Task(Kind.B, s, j, c)
                    if self.split_backward:
                        yield Task(Kind.W, s, j, c)

    def num_tasks_per_stage(self) -> int:
        per = 2 + (1 if self.split_backward else 0)
        return per * self.num_microbatches * self.num_chunks

    # ---- dependencies ------------------------------------------------------
    def message_predecessors(self, t: Task) -> tuple[Task, ...]:
        """The remote tasks whose *messages* make ``t`` ready (may be empty).

        On a chain, forward activations flow s-1 -> s (wrapping S-1 -> 0
        across chunks) and backward gradients flow s+1 -> s (wrapping 0 ->
        S-1); at most one predecessor.  On a DAG, a fan-in stage's F waits
        on one activation per incoming edge, and a fan-out stage's B waits
        on one gradient per outgoing edge — *all* must arrive.
        """
        if self.graph is not None:
            if t.kind == Kind.F:
                return tuple(Task(Kind.F, p, t.mb, t.chunk)
                             for p in self.graph.preds(t.stage))
            if t.kind == Kind.B:
                return tuple(Task(Kind.B, q, t.mb, t.chunk)
                             for q in self.graph.succs(t.stage))
            return ()  # W depends only on the local B
        s_last = self.num_stages - 1
        if t.kind == Kind.F:
            if t.stage > 0:
                return (Task(Kind.F, t.stage - 1, t.mb, t.chunk),)
            if t.chunk > 0:  # interleaved wrap
                return (Task(Kind.F, s_last, t.mb, t.chunk - 1),)
            return ()  # stage 0, chunk 0: data is locally available
        if t.kind == Kind.B:
            if t.stage < s_last:
                return (Task(Kind.B, t.stage + 1, t.mb, t.chunk),)
            if t.chunk < self.num_chunks - 1:  # interleaved wrap
                return (Task(Kind.B, 0, t.mb, t.chunk + 1),)
            return ()  # last stage, last chunk: loss gradient is local
        # W depends only on the local B.
        return ()

    def message_successors(self, t: Task) -> tuple[Task, ...]:
        """The remote tasks whose readiness ``t``'s completion messages feed.

        Inverse of :meth:`message_predecessors`; shared by the DES engine
        and the host actor runtime so both route messages identically.  W is
        stage-local: its weight gradient feeds no other stage, so it never
        emits a message and never passes a TP admission gate.
        """
        if self.graph is not None:
            if t.kind == Kind.F:
                return tuple(Task(Kind.F, q, t.mb, t.chunk)
                             for q in self.graph.succs(t.stage))
            if t.kind == Kind.B:
                return tuple(Task(Kind.B, p, t.mb, t.chunk)
                             for p in self.graph.preds(t.stage))
            return ()
        s_last = self.num_stages - 1
        if t.kind == Kind.F:
            if t.stage < s_last:
                return (Task(Kind.F, t.stage + 1, t.mb, t.chunk),)
            if t.chunk < self.num_chunks - 1:  # interleaved wrap
                return (Task(Kind.F, 0, t.mb, t.chunk + 1),)
            return ()  # last stage: loss grad is local (B enabled locally)
        if t.kind == Kind.B:
            if t.stage > 0:
                return (Task(Kind.B, t.stage - 1, t.mb, t.chunk),)
            if t.chunk > 0:  # interleaved wrap
                return (Task(Kind.B, s_last, t.mb, t.chunk - 1),)
            return ()
        return ()

    def fan_in(self, t: Task) -> int:
        """Number of distinct messages ``t`` needs before it can be ready."""
        return len(self.message_predecessors(t))

    # Singular forms, kept for the linear-chain consumers (schedule-table
    # executor, old tests).  They raise on a true fan-in/fan-out task so a
    # chain-only code path can never silently drop a DAG dependency.
    def message_predecessor(self, t: Task) -> Task | None:
        mps = self.message_predecessors(t)
        if len(mps) > 1:
            raise ValueError(
                f"{t!r} has {len(mps)} message predecessors (DAG fan-in); "
                f"use message_predecessors()")
        return mps[0] if mps else None

    def message_successor(self, t: Task) -> Task | None:
        mss = self.message_successors(t)
        if len(mss) > 1:
            raise ValueError(
                f"{t!r} has {len(mss)} message successors (DAG fan-out); "
                f"use message_successors()")
        return mss[0] if mss else None

    def local_predecessor(self, t: Task) -> Task | None:
        """Same-stage dependency that must have *executed* before ``t``."""
        if t.kind == Kind.B:
            return Task(Kind.F, t.stage, t.mb, t.chunk)
        if t.kind == Kind.W:
            return Task(Kind.B, t.stage, t.mb, t.chunk)
        return None

    def predecessors(self, t: Task) -> list[Task]:
        out = list(self.message_predecessors(t))
        l = self.local_predecessor(t)
        if l is not None:
            out.append(l)
        return out

    def total_tasks(self) -> int:
        return self.num_stages * self.num_tasks_per_stage()
