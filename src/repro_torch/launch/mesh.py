"""Device meshes of the port: an in-process ``(pod ×) data × model`` mesh.

Counterpart of ``repro.launch.mesh``.  JAX runs the schedule-table executor
as one ``shard_map`` over a device mesh; the port runs it on a
:class:`Mesh` of *ranks* inside one process, one Python thread per rank,
each running the same rank-local program (the ``shard_map`` body).  A rank
reads its coordinates with :meth:`Mesh.axis_index` and talks to the ranks
of an axis group through the collectives, whose names and semantics are
JAX's: ``ppermute``, ``psum``, ``pmax``, ``psum_scatter`` (``tiled=False``,
over dimension 0), ``all_gather`` (``tiled=True`` by default, or stacked along a
new dimension 0) and ``all_to_all`` (``split_axis=0, concat_axis=0,
tiled=False``) over one axis or a tuple of them.

What the mesh guarantees:

* every rank holds its own tensors: a collective's result is a new tensor
  of the receiving rank, never a view of another rank's, so a data replica
  is a copy as on its own device (a wrong all-gather shows up as replicas
  that differ);
* every reduction sums in ascending rank order, with no atomics, so a run
  is bitwise reproducible (``pmax``, an elementwise max, is exact in any
  order);
* all ranks issue onto the one default CUDA stream of ``device``: a
  collective returns only after every rank of its group has enqueued its
  reads of the others' tensors (a second rendezvous), so an owner's later
  in-place write is ordered after them, and a tensor received was issued
  before the receiver uses it;
* every rendezvous waits at most ``timeout`` seconds (120 s, the actor
  runtime's deadlock guard).  A rank that calls a collective the others
  never reach raises :class:`CollectiveError` naming the rank, the axes and
  the collective; a rank whose group holds a rank that already returned
  raises at once; when any rank raises, the others' pending and later
  rendezvous abort, and :meth:`Mesh.run` re-raises the first error in the
  caller;
* a collective is called by its rank's own thread, never inside an
  autograd backward: there, on CUDA tensors, PyTorch's engine runs the
  nodes on its own device thread, which has no rank and which every rank's
  backward queues on, so a rendezvous would wait for ranks queued behind
  it.  ``_exchange`` raises :class:`CollectiveError` whenever autograd is
  executing a graph task (a checkpoint's recompute, an
  ``autograd.Function.backward``), on the CPU as well, where the engine
  would run the node on the calling rank's thread and a wrong design would
  pass.  A differentiated stage that exchanges is cut at its collectives
  instead (``models/phases.py``).

Rank ``r``'s coordinates are row-major over the axes, the last (``model``)
fastest, as ``jax.make_mesh`` lays out devices.  :class:`MeshBase` holds
what does not depend on how ranks talk (coordinates, groups, argument
checks, the backward guard, the counters), once for both meshes:
:class:`Mesh` here, and ``launch/procs.ProcessMesh``, which runs the same
methods over ``torch.distributed``, one process per rank, with the same
bits.  A rank program loops over :attr:`MeshBase.local_ranks` (every rank
here, the process's own rank there) to build its per-rank state.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

#: seconds a rank waits at a rendezvous (the actor runtime's deadlock guard)
DEFAULT_TIMEOUT = 120.0


class CollectiveError(RuntimeError):
    """A collective that cannot complete: timed out, a group member
    returned without reaching it, or the ranks called different ones."""


class MeshAborted(CollectiveError):
    """A rank's rendezvous abandoned because another rank raised."""


class _Group:
    """Rendezvous point of one axis group (members in ascending rank)."""

    def __init__(self, members: tuple[int, ...]):
        self.members = members
        self.cond = threading.Condition()
        self.gen = 0
        self.arrived: dict[int, tuple[str, Any]] = {}
        self.published: tuple[int, list] | None = None


class MeshBase:
    """What both meshes share: the ``(pod ×) data × model`` coordinates,
    the axis groups, the collectives' argument checks, the backward guard
    and the counters.  A subclass gives :attr:`rank`, :attr:`local_ranks`,
    :meth:`run` and the collectives."""

    def __init__(self, shape: dict[str, int], *, device="cpu",
                 timeout: float = DEFAULT_TIMEOUT):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)
        self.device = torch.device(device)
        self.timeout = timeout
        self.size = int(np.prod(list(shape.values())))
        self._count_lock = threading.Lock()
        #: collective name -> calls and host seconds inside them (the
        #: rendezvous or the exchange, and the copies), summed over this
        #: process's ranks (each rank's call counts once);
        #: :meth:`reset_counts` zeroes them, :meth:`counts_over_ranks` sums
        #: them over every rank
        self.counts: dict[str, int] = {}
        self.seconds: dict[str, float] = {}

    # ---- coordinates ---------------------------------------------------
    def coords(self, rank: int) -> dict[str, int]:
        idx = np.unravel_index(rank, tuple(self.shape.values()))
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def rank_of(self, **coords: int) -> int:
        return int(np.ravel_multi_index(
            tuple(coords.get(a, 0) for a in self.axis_names),
            tuple(self.shape.values())))

    @property
    def rank(self) -> int:
        raise NotImplementedError

    @property
    def local_ranks(self) -> tuple[int, ...]:
        """The ranks whose state this process holds, ascending."""
        raise NotImplementedError

    def per_rank(self, fn: Callable[[int], Any]) -> list:
        """``[fn(r) if r is local else None for r in range(size)]``: the
        per-rank argument list of :meth:`run`, built for the local ranks."""
        local = set(self.local_ranks)
        return [fn(r) if r in local else None for r in range(self.size)]

    def axis_index(self, axis: str) -> int:
        return self.coords(self.rank)[axis]

    def _axes(self, axes) -> tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"no axis {a!r} in mesh {self.shape}")
        return axes

    def group_index(self, axes, rank: int | None = None) -> int:
        """The index of ``rank`` (default: the calling rank) in its group
        over ``axes``: row-major over ``axes`` in the order given
        (``jax.lax.axis_index`` of a tuple)."""
        c = self.coords(self.rank if rank is None else rank)
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.shape[a] + c[a]
        return idx

    def group_size(self, axes) -> int:
        return int(np.prod([self.shape[a] for a in self._axes(axes)]))

    def group_members(self, axes, rank: int) -> tuple[int, ...]:
        """The ranks of ``rank``'s group over ``axes``, ascending."""
        axes = self._axes(axes)
        c = self.coords(rank)
        ranges = [range(self.shape[a]) if a in axes else (c[a],)
                  for a in self.axis_names]
        return tuple(sorted(self.rank_of(**dict(zip(self.axis_names, p)))
                            for p in itertools.product(*ranges)))

    # ---- shared parts of the collectives -------------------------------
    def _current_rank(self):
        return self.rank

    def _guard(self, name: str, axes: tuple[str, ...]) -> None:
        """No collective inside an autograd backward (module docstring)."""
        if torch._C._current_graph_task_id() != -1:
            raise CollectiveError(
                f"rank {self._current_rank()}: {name} over "
                f"{'/'.join(axes)} inside an autograd backward (a "
                f"checkpoint's recompute or a Function.backward): call "
                f"collectives from the rank thread, between autograd calls")

    def _check_rows(self, name: str, x: torch.Tensor, axes) -> int:
        """``x``'s first dimension must be the group's size (returned)."""
        n = self.group_size(axes)
        if x.shape[0] != n:
            raise ValueError(f"{name} over {axes}: dimension 0 of "
                             f"{tuple(x.shape)} is not the group size {n}")
        return n

    def _count(self, name: str, t0: float) -> None:
        with self._count_lock:
            self.counts[name] = self.counts.get(name, 0) + 1
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)

    def reset_counts(self) -> None:
        with self._count_lock:
            self.counts, self.seconds = {}, {}

    def sync(self) -> None:
        """Wait until every process of the mesh gets here (nothing for the
        one process of a thread mesh): a timed loop starts together."""

    def local_counts(self) -> dict[str, tuple[int, float]]:
        """Collective name -> (calls, host seconds inside them), summed
        over this process's ranks (every rank of a thread mesh)."""
        with self._count_lock:
            return {k: (n, self.seconds[k])
                    for k, n in sorted(self.counts.items())}

    def counts_over_ranks(self) -> dict[str, tuple[int, float]]:
        """Collective name -> (calls, host seconds inside them), summed
        over every rank of the mesh."""
        return self.local_counts()

    def exchange_over(self, axes) -> Callable[[str, torch.Tensor],
                                              torch.Tensor]:
        """``exchange(name, x)``: the collective ``name`` (``all_to_all``,
        ``all_gather`` stacked, ``psum_scatter``) over ``axes``, the form a
        stage cut at its exchanges takes (``models/phases.py``)."""
        axes = self._axes(axes)

        def exchange(name: str, x: torch.Tensor) -> torch.Tensor:
            if name == "all_gather":
                return self.all_gather(x, axes, tiled=False)
            if name not in ("all_to_all", "psum_scatter"):
                raise ValueError(f"no exchange {name!r}")
            return getattr(self, name)(x, axes)

        return exchange

    def axis_group(self, axes) -> "AxisGroup":
        """The calling rank's view of its group over ``axes``: its index,
        the group's size, ``psum`` and ``pmax`` (what a layer that the
        reference gives an ``axis_name`` needs; inside :meth:`run`)."""
        axes = self._axes(axes)
        return AxisGroup(self, axes, self.group_index(axes),
                         self.group_size(axes))


class Mesh(MeshBase):
    """A ``(pod ×) data × model`` mesh of ranks in one process."""

    def __init__(self, shape: dict[str, int], *, device="cpu",
                 timeout: float = DEFAULT_TIMEOUT):
        super().__init__(shape, device=device, timeout=timeout)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._groups: dict[tuple, _Group] = {}
        self._failed: tuple[int, BaseException] | None = None
        self._finished: set[int] = set()

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"

    @property
    def rank(self) -> int:
        """The calling thread's rank (inside :meth:`run` only)."""
        r = getattr(self._local, "rank", None)
        if r is None:
            raise RuntimeError("a collective or axis_index outside "
                               "Mesh.run: only rank threads have a rank")
        return r

    @property
    def local_ranks(self) -> tuple[int, ...]:
        return tuple(range(self.size))

    def _current_rank(self):
        return getattr(self._local, "rank", None)

    def _group(self, axes: tuple[str, ...]) -> _Group:
        c = self.coords(self.rank)
        fixed = tuple((a, c[a]) for a in self.axis_names if a not in axes)
        key = (tuple(sorted(axes)), fixed)
        with self._lock:
            g = self._groups.get(key)
            if g is None:
                g = self._groups[key] = _Group(
                    self.group_members(axes, self.rank))
        return g

    # ---- rendezvous ----------------------------------------------------
    def _exchange(self, name: str, axes: tuple[str, ...], payload=None
                  ) -> dict[int, Any]:
        """Deposit ``payload`` and wait for every member of the group's
        deposit; returns rank -> payload."""
        self._guard(name, axes)
        rank, g = self.rank, self._group(axes)
        where = (f"rank {rank} {self.coords(rank)}: {name} over "
                 f"{'/'.join(axes)}")
        deadline = time.monotonic() + self.timeout
        with g.cond:
            gen = g.gen
            g.arrived[rank] = (name, payload)
            if len(g.arrived) == len(g.members):
                g.published = (gen, [g.arrived[m] for m in g.members])
                g.arrived = {}
                g.gen += 1
                g.cond.notify_all()
            while g.gen == gen:
                if self._failed is not None:
                    g.arrived.pop(rank, None)
                    raise MeshAborted(f"{where} abandoned: rank "
                                      f"{self._failed[0]} raised")
                gone = sorted(self._finished & (set(g.members)
                                                - set(g.arrived)))
                if gone:
                    g.arrived.pop(rank, None)
                    raise CollectiveError(
                        f"{where}: rank(s) {gone} returned without "
                        f"reaching it")
                left = deadline - time.monotonic()
                if left <= 0:
                    missing = sorted(set(g.members) - set(g.arrived))
                    g.arrived.pop(rank, None)
                    raise CollectiveError(
                        f"{where} timed out after {self.timeout:g} s "
                        f"waiting for rank(s) {missing}")
                g.cond.wait(min(left, 1.0))
            _, entries = g.published
        names = {n for n, _ in entries}
        if len(names) > 1:
            raise CollectiveError(f"{where}: the group's ranks called "
                                  f"different collectives {sorted(names)}")
        return {m: p for m, (_, p) in zip(g.members, entries)}

    def _collective(self, name: str, axes, payload, combine):
        """Rendezvous, ``combine(rank -> payload)`` on this rank, then a
        second rendezvous so that no owner writes a tensor in place before
        every rank of the group has enqueued its reads."""
        axes = self._axes(axes)
        t0 = time.perf_counter()
        got = self._exchange(name, axes, payload)
        out = combine(got)
        self._exchange(name + " (release)", axes)
        self._count(name, t0)
        return out

    # ---- collectives ---------------------------------------------------
    def ppermute(self, x, axis: str, perm: Sequence[tuple[int, int]]):
        """``x`` from the rank whose ``axis`` index ``i`` has ``(i, mine)``
        in ``perm``; zeros (0, False) where none sends to this rank.  ``x``
        is a tensor or a tuple of tensors and host scalars; tensors arrive
        as copies."""
        mine = self.axis_index(axis)
        src = [i for i, j in perm if j == mine]
        c = self.coords(self.rank)

        def take(got):
            if not src:
                return _zeros_like(x)
            return _copy(got[self.rank_of(**{**c, axis: src[0]})])

        return self._collective("ppermute", axis, x, take)

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Sum over the group, in ascending rank order."""
        return self._collective("psum", axes, x, _sum_in_rank_order)

    def pmax(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Elementwise maximum over the group (exact in any order)."""
        return self._collective("pmax", axes, x, _elementwise_max)

    def psum_scatter(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Row ``group_index`` of the group's sum of ``x``, whose first
        dimension is the group's size, summed in ascending rank order (JAX's
        ``psum_scatter(scatter_dimension=0, tiled=False)``)."""
        axes = self._axes(axes)
        self._check_rows("psum_scatter", x, axes)
        i = self.group_index(axes)
        return self._collective(
            "psum_scatter", axes, x,
            lambda got: _sum_in_rank_order({r: v[i] for r, v in got.items()}))

    def all_gather(self, x: torch.Tensor, axes, tiled: bool = True
                   ) -> torch.Tensor:
        """The group's ``x`` in group-index order, concatenated along
        dimension 0 (JAX's ``all_gather(tiled=True)``) or, with
        ``tiled=False``, stacked along a new dimension 0."""
        axes = self._axes(axes)
        join = torch.cat if tiled else torch.stack

        def gather(got):
            by_index = {self.group_index(axes, r): v for r, v in got.items()}
            return join([by_index[i] for i in sorted(by_index)])

        return self._collective("all_gather", axes, x, gather)

    def all_to_all(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Row ``i`` of the result is row ``group_index`` of group member
        ``i``'s ``x``, whose first dimension is the group's size (JAX's
        ``all_to_all(split_axis=0, concat_axis=0, tiled=False)``)."""
        axes = self._axes(axes)
        n = self._check_rows("all_to_all", x, axes)
        i = self.group_index(axes)

        def swap(got):
            by_index = {self.group_index(axes, r): v for r, v in got.items()}
            return torch.stack([by_index[j][i] for j in range(n)])

        return self._collective("all_to_all", axes, x, swap)

    # ---- running a rank program ----------------------------------------
    def run(self, fn: Callable, per_rank_args: Sequence[tuple]) -> list:
        """Run ``fn(*per_rank_args[r])`` on every rank ``r``, one thread
        each (the ``shard_map`` counterpart); returns the per-rank results.
        The first error a rank raises is re-raised here, after every thread
        ended."""
        if len(per_rank_args) != self.size:
            raise ValueError(f"{len(per_rank_args)} argument tuples for "
                             f"{self.size} ranks")
        with self._lock:
            self._groups.clear()
            self._failed = None
            self._finished = set()
        results: list = [None] * self.size

        def body(rank: int, args: tuple):
            self._local.rank = rank
            try:
                results[rank] = fn(*args)
            except BaseException as e:  # recorded; re-raised by run
                e.add_note(f"(in rank {rank} {self.coords(rank)} of "
                           f"{self!r})")
                with self._lock:
                    if self._failed is None or (
                            isinstance(self._failed[1], MeshAborted)
                            and not isinstance(e, MeshAborted)):
                        self._failed = (rank, e)
                self._wake()
            else:
                with self._lock:
                    self._finished.add(rank)
                self._wake()
            finally:
                self._local.rank = None

        threads = [threading.Thread(target=body, args=(r, tuple(a)),
                                    name=f"mesh-rank-{r}", daemon=True)
                   for r, a in enumerate(per_rank_args)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if self._failed is not None:
            raise self._failed[1]
        return results

    def _wake(self) -> None:
        with self._lock:
            groups = list(self._groups.values())
        for g in groups:
            with g.cond:
                g.cond.notify_all()


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """One rank's group over ``axes`` (:meth:`Mesh.axis_group`): the
    counterpart of a JAX ``axis_name`` inside ``shard_map``, whose
    ``axis_index`` is :attr:`index`."""

    mesh: MeshBase
    axes: tuple[str, ...]
    index: int
    size: int

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self.mesh.psum(x, self.axes)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self.mesh.pmax(x, self.axes)


def _elementwise_max(got: dict[int, torch.Tensor]) -> torch.Tensor:
    """A new tensor: the values' elementwise maximum."""
    ranks = sorted(got)
    acc = got[ranks[0]].clone()
    for r in ranks[1:]:
        torch.maximum(acc, got[r], out=acc)
    return acc


def _sum_in_rank_order(got: dict[int, torch.Tensor]) -> torch.Tensor:
    """A new tensor: the values summed in ascending rank order, rounded to
    their dtype at every add."""
    ranks = sorted(got)
    acc = got[ranks[0]].clone()
    for r in ranks[1:]:
        acc += got[r]
    return acc


def _zeros_like(x):
    if isinstance(x, torch.Tensor):
        return torch.zeros_like(x)
    if isinstance(x, tuple):
        return tuple(_zeros_like(v) for v in x)
    return type(x)(0)


def _copy(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        return tuple(_copy(v) for v in x)
    return x


def make_mesh(data: int, model: int, pods: int = 1, *, device="cuda",
              timeout: float = DEFAULT_TIMEOUT) -> Mesh:
    """Arbitrary (pod ×) data × model mesh for tests / reduced runs."""
    if pods > 1:
        return Mesh({"pod": pods, "data": data, "model": model},
                    device=device, timeout=timeout)
    return Mesh({"data": data, "model": model}, device=device,
                timeout=timeout)


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """The reference's production layout: 16 × 16 (× 2 pods) ranks."""
    return make_mesh(16, 16, 2 if multi_pod else 1, device=device)
