"""The mesh over ``torch.distributed``: one process per rank.

:class:`ProcessMesh` has :class:`~repro_torch.launch.mesh.Mesh`'s methods
and semantics, bit for bit, for ranks that are processes: the counterpart
of the reference's ``shard_map`` over a device mesh whose devices are
separate.  The rank programs of the table runtime
(``pipeline/executor.make_train_fn``, ``optim/adamw.make_optimizer``, the
phased MoE stages) and of serving (``pipeline/decode.make_serve_fn``) run
on it unchanged; the code that makes per-rank state loops over
:attr:`ProcessMesh.local_ranks`, which holds the process's own rank
only.

Collective by collective:

* ``psum`` is a rank-ordered reduce-scatter followed by an all-gather: the
  flat tensor padded to a multiple of the group size, its chunks swapped
  by ``all_to_all_single``, each member's chunk summed over the members in
  ascending global rank, rounded at every add in the tensor's dtype (the
  thread mesh's ``_sum_in_rank_order``, element by element), and the sums
  gathered back.  The bytes moved are a ring all-reduce's; ``all_reduce``
  (``SUM``) is not used, because its order is the library's;
* ``psum_scatter`` is the first half of that, on the rows of ``x``;
* ``pmax`` is ``all_reduce(MAX)``, exact in any order;
* ``all_gather`` is the list form of ``dist.all_gather``;
* ``all_to_all`` is ``all_to_all_single`` on the stacked rows;
* ``ppermute`` is ``batch_isend_irecv``, zeros (``0``, ``False``) where no
  rank sends to this one; the host scalars of a tuple payload travel in
  the header (below) and come back as Python ``int`` and ``bool``.

A process group orders its members by ascending global rank, while JAX's
group index is row-major over the axes in the order given
(``MeshBase.group_index``): the two differ for ``("model", "data")``, so
every gather and all-to-all places its rows by group index.

Before its payload every collective exchanges a small int64 header over
its group (the collective, and each payload item's dtype and shape, or a
host scalar's value): ranks that called different collectives raise
:class:`~repro_torch.launch.mesh.CollectiveError` naming them, as the
thread mesh does, where the two calls would otherwise pair silently (a
``psum_scatter`` and an ``all_to_all`` are both ``all_to_all_single``).
The header's host time counts into :attr:`seconds`.

Host transfers.  A table checkpoint moves every rank's state through rank
0's host: :meth:`ProcessMesh.move` carries one host tensor from one rank
to another, and :meth:`ProcessMesh.share` gives every rank one rank's host
integer.  Every rank of the world calls each, in the same order, and
exchanges the header first, so a rank that called something else, or
expects another dtype or shape, raises ``CollectiveError`` on every rank;
the payload travels over the headers' gloo group, under ``nccl`` too.
Neither is a collective of the rank programs: they count into no
:attr:`counts`.

Backends.  ``gloo`` on CUDA tensors stages every payload through host
memory (a copy to the host, the gloo op, a copy back to the rank's
device); the run's header says so.  ``nccl`` passes device tensors
directly; it does not put two ranks of one communicator on one GPU, so
asking for more ranks than ``torch.cuda.device_count()`` stops before
``init_process_group``.  Nothing falls back from one to the other.  The
headers and :meth:`ProcessMesh.counts_over_ranks` always go over gloo.

Errors.  A collective that times out (``timeout``, 120 s by default) or
whose peer process ended raises ``CollectiveError`` (``MeshAborted`` for a
peer that ended) naming the rank, its coordinates, the axes and the
collective; the autograd guard is the thread mesh's.  :func:`spawn_world`
starts one process per rank and joins them with a deadline: a child that
raises makes the parent raise that error, naming the child's rank and
holding its traceback, and the other children are terminated; a child
that outlives the deadline is killed and the parent raises.

    from repro_torch.launch.procs import spawn_world
    results = spawn_world(fn, (arg,), 4, shape={"data": 2, "model": 2},
                          device="cpu", deadline=60)

runs ``fn(mesh, arg)`` in four processes (``fn`` importable by its module
path) and returns their results by rank.  Under ``torchrun``,
:func:`join_world` joins the world that its variables describe.
"""
from __future__ import annotations

import contextlib
import datetime
import hashlib
import itertools
import os
import tempfile
import time
import traceback
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.launch.mesh import (
    DEFAULT_TIMEOUT,
    CollectiveError,
    MeshAborted,
    MeshBase,
    _copy,
    _zeros_like,
)

#: the environment variable holding the ``init_method`` of a world that
#: :func:`spawn_world` starts (a ``file://`` store); without it
#: :func:`join_world` uses ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``)
INIT_METHOD_ENV = "REPRO_TORCH_INIT_METHOD"
BACKENDS = ("gloo", "nccl")

_NAMES = ("ppermute", "psum", "pmax", "psum_scatter", "all_gather",
          "all_to_all", "move", "share")
#: the calls whose ranks give different payloads by design
_UNEQUAL = ("ppermute", "move", "share")
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
           torch.bool)
_TENSOR, _INT, _BOOL = 1, 2, 3
_HEADER_LEN = 32


def check_backend(backend: str, device, ranks: int) -> None:
    """Stop before a world starts when ``backend`` cannot serve ``ranks``
    ranks on ``device`` (no fallback to another backend)."""
    if backend not in BACKENDS:
        raise SystemExit(f"--dist-backend {backend!r}: one of {BACKENDS}")
    if backend != "nccl":
        return
    if torch.device(device).type != "cuda":
        raise SystemExit("--dist-backend nccl passes CUDA tensors; "
                         "--device cpu takes gloo")
    cards = torch.cuda.device_count()
    if ranks > cards:
        raise SystemExit(
            f"--dist-backend nccl: {ranks} ranks on {cards} card(s): NCCL "
            f"puts no two ranks of one communicator on one GPU; use gloo "
            f"(payloads staged through the host) or one card per rank")


def _encode(name: str, payload) -> torch.Tensor:
    """The header of ``payload`` (a tensor, or a tuple of tensors and host
    ints and bools) for collective ``name``."""
    items = payload if isinstance(payload, tuple) else (payload,)
    ints = [_NAMES.index(name), len(items)]
    for v in items:
        if isinstance(v, torch.Tensor):
            ints += [_TENSOR, _DTYPES.index(v.dtype), v.dim(), *v.shape]
        elif isinstance(v, bool):
            ints += [_BOOL, int(v)]
        elif isinstance(v, int):
            ints += [_INT, v]
        else:
            raise TypeError(f"{name}: a payload item of type "
                            f"{type(v).__name__}; tensors, ints and bools "
                            f"travel")
    if len(ints) > _HEADER_LEN:
        raise ValueError(f"{name}: a header of {len(ints)} > {_HEADER_LEN} "
                         f"entries")
    return torch.tensor(ints + [0] * (_HEADER_LEN - len(ints)),
                        dtype=torch.int64)


def _decode(header: torch.Tensor) -> tuple[str, tuple]:
    """(collective name, items): a tensor item as ``(dtype, shape)``, a
    host scalar as its ``int`` or ``bool``."""
    h = header.tolist()
    name, n, i, items = _NAMES[h[0]], h[1], 2, []
    for _ in range(n):
        kind = h[i]
        if kind == _TENSOR:
            ndim = h[i + 2]
            items.append((_DTYPES[h[i + 1]], tuple(h[i + 3:i + 3 + ndim])))
            i += 3 + ndim
        else:
            items.append(bool(h[i + 1]) if kind == _BOOL else h[i + 1])
            i += 2
    return name, tuple(items)


class _ProcGroup:
    """One axis group of the calling process: its members (ascending global
    rank: the process group's rank order), the payload process group and
    the gloo group of the headers (None for a group of one)."""

    def __init__(self, members, pg, header_pg):
        self.members = members
        self.pg = pg
        self.header_pg = header_pg


class ProcessMesh(MeshBase):
    """A ``(pod ×) data × model`` mesh whose ranks are the processes of the
    ``torch.distributed`` world (``dist.get_rank()`` is the rank).  The
    world must be initialised (:func:`join_world`) with ``size`` processes;
    the constructor creates every axis group's process group, on every
    process in the same order."""

    def __init__(self, shape: dict[str, int], *, device="cuda",
                 backend: str = "gloo", timeout: float = DEFAULT_TIMEOUT):
        super().__init__(shape, device="cpu", timeout=timeout)
        if not dist.is_initialized():
            raise RuntimeError("ProcessMesh: no torch.distributed world "
                               "(join_world or spawn_world first)")
        if dist.get_world_size() != self.size:
            raise ValueError(f"ProcessMesh {self.shape}: {self.size} ranks "
                             f"in a world of {dist.get_world_size()}")
        self.backend = backend
        self._rank = dist.get_rank()
        dev = torch.device(device)
        if dev.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", self._rank))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        self.device = dev
        #: gloo on CUDA tensors: every payload is copied to the host and back
        self.staged = backend == "gloo" and dev.type == "cuda"
        td = datetime.timedelta(seconds=timeout)
        by_members: dict[tuple, tuple] = {}
        self._groups: dict[frozenset, _ProcGroup] = {}
        # every axis subset's groups, in one order on every process:
        # new_group is collective over the whole world
        for k in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, k):
                for r in range(self.size):
                    members = self.group_members(axes, r)
                    if members[0] != r:
                        continue  # each group once, from its lowest rank
                    if members not in by_members:
                        by_members[members] = self._new_groups(members, td)
                    if self._rank in members:
                        self._groups[frozenset(axes)] = _ProcGroup(
                            members, *by_members[members])
        self._host = (None if backend == "gloo" else
                      dist.new_group(list(range(self.size)), timeout=td,
                                     backend="gloo"))
        #: the whole world's group (its headers' gloo group carries the
        #: host transfers)
        self._world = self._groups[frozenset(self.axis_names)]

    def _new_groups(self, members: tuple, td) -> tuple:
        if len(members) == 1:
            return None, None
        pg = dist.new_group(list(members), timeout=td)
        if self.backend == "gloo":
            return pg, pg
        return pg, dist.new_group(list(members), timeout=td, backend="gloo")

    def __repr__(self) -> str:
        return (f"ProcessMesh({self.shape}, rank={self._rank}, "
                f"device={self.device}, backend={self.backend}"
                + (", staged through the host" if self.staged else "") + ")")

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def local_ranks(self) -> tuple[int, ...]:
        return (self._rank,)

    def run(self, fn: Callable, per_rank_args: Sequence[tuple]) -> list:
        """Run ``fn(*per_rank_args[rank])`` for this process's rank; the
        list returned has that rank's slot filled (the others None)."""
        if len(per_rank_args) != self.size:
            raise ValueError(f"{len(per_rank_args)} argument tuples for "
                             f"{self.size} ranks")
        out: list = [None] * self.size
        try:
            out[self._rank] = fn(*per_rank_args[self._rank])
        except BaseException as e:
            e.add_note(f"(in rank {self._rank} {self.coords(self._rank)} of "
                       f"{self!r})")
            raise
        return out

    def sync(self) -> None:
        dist.barrier(group=self._host)

    def counts_over_ranks(self) -> dict[str, tuple[int, float]]:
        """Collective name -> (calls, host seconds inside them), summed over
        every process (a collective over the whole world: every rank calls
        it)."""
        return sum_counts(self.all_objects(self.local_counts()))

    def all_objects(self, obj) -> list:
        """Every process's picklable host object ``obj``, by rank (a
        collective over the whole world, on the headers' gloo group: every
        rank calls it; not a collective of the rank programs, counted in no
        :attr:`counts`)."""
        got: list = [None] * self.size
        dist.all_gather_object(got, obj, group=self._host)
        return got

    # ---- host transfers (checkpoints) -----------------------------------
    def move(self, x: torch.Tensor | None, src: int, dst: int,
             like: torch.Tensor | None = None) -> torch.Tensor | None:
        """Rank ``src``'s host tensor ``x`` on rank ``dst`` (a new tensor
        there, ``x`` itself when ``src == dst``; None on every other
        rank).  Every rank of the world calls it with the same ``src`` and
        ``dst``; ``x`` is read on ``src`` only.  ``like`` on ``dst`` is the
        tensor it expects (dtype and shape): another one on ``src`` raises
        ``CollectiveError`` on every rank."""
        me, where = self._rank, self._where("move", self.axis_names)
        if me == src and not isinstance(x, torch.Tensor):
            raise TypeError(f"{where}: rank {src} sends no tensor")
        item = x if me == src else like if me == dst else None
        heads = self._host_heads("move", (src, dst) + (
            () if item is None else (item,)))
        if heads is not None:
            pairs = {h[:2] for h in heads}
            if len(pairs) > 1:
                raise CollectiveError(f"{where}: the ranks move between "
                                      f"{sorted(pairs)}")
            sent, want = heads[src][2:], heads[dst][2:]
            if want and want != sent:
                raise CollectiveError(f"{where}: rank {src} sends {sent}, "
                                      f"rank {dst} expects {want}")
        if src == dst or me not in (src, dst):
            return x if me == src else None
        pg = self._world.header_pg
        if me == src:
            with self._talking("move", self.axis_names):
                dist.send(x.detach().cpu().contiguous(), dst, group=pg)
            return None
        dtype, shape = heads[src][2]
        buf = torch.empty(shape, dtype=dtype)
        with self._talking("move", self.axis_names):
            dist.recv(buf, src, group=pg)
        return buf

    def share(self, value: int | None, root: int = 0) -> int | None:
        """Rank ``root``'s host integer (or None) on every rank: it travels
        in the header.  Every rank calls it; ``value`` is read on ``root``
        only."""
        if value is not None and value < 0:
            raise ValueError(f"share: {value} (a count or None)")
        heads = self._host_heads("share", (
            root, -1 if value is None else int(value)))
        if heads is None:
            return value
        if len({h[0] for h in heads}) > 1:
            raise CollectiveError(f"{self._where('share', self.axis_names)}"
                                  f": the ranks name other roots")
        got = heads[root][1]
        return None if got == -1 else got

    def _host_heads(self, name: str, payload: tuple) -> list | None:
        """Every rank's decoded header items of a host transfer, by rank
        (None in a world of one)."""
        self._guard(name, self.axis_names)
        if self._world.header_pg is None:
            return None
        mine = _encode(name, payload)
        got = [torch.empty_like(mine) for _ in self._world.members]
        with self._talking(name, self.axis_names):
            dist.all_gather(got, mine, group=self._world.header_pg)
        heads = [_decode(h) for h in got]
        names = sorted({n for n, _ in heads})
        if names != [name]:
            raise CollectiveError(f"{self._where(name, self.axis_names)}: "
                                  f"the ranks called different collectives "
                                  f"{names}")
        return [items for _, items in heads]

    # ---- the exchange ----------------------------------------------------
    def _where(self, name: str, axes: tuple[str, ...]) -> str:
        return (f"rank {self._rank} {self.coords(self._rank)}: {name} over "
                f"{'/'.join(axes)}")

    @contextlib.contextmanager
    def _talking(self, name: str, axes: tuple[str, ...]):
        """A ``torch.distributed`` call's failure as a CollectiveError."""
        try:
            yield
        except CollectiveError:
            raise
        except RuntimeError as e:
            msg = str(e)
            where = self._where(name, axes)
            if "timed out" in msg.lower():
                raise CollectiveError(f"{where} timed out after "
                                      f"{self.timeout:g} s: {msg}") from e
            if "connection" in msg.lower() or "closed" in msg.lower():
                raise MeshAborted(f"{where} abandoned: a peer process "
                                  f"ended ({msg})") from e
            raise CollectiveError(f"{where}: {msg}") from e

    def _begin(self, name: str, axes, payload) -> tuple:
        """The guard, the group, and every member's decoded header (in
        member order; None for a group of one)."""
        axes = self._axes(axes)
        self._guard(name, axes)
        g = self._groups[frozenset(axes)]
        if g.pg is None:
            return axes, g, None
        mine = _encode(name, payload)
        got = [torch.empty_like(mine) for _ in g.members]
        with self._talking(name, axes):
            dist.all_gather(got, mine, group=g.header_pg)
        heads = [_decode(h) for h in got]
        names = {n for n, _ in heads}
        if len(names) > 1:
            raise CollectiveError(f"{self._where(name, axes)}: the group's "
                                  f"ranks called different collectives "
                                  f"{sorted(names)}")
        if name not in _UNEQUAL and len({items for _, items in heads}) > 1:
            raise CollectiveError(
                f"{self._where(name, axes)}: the group's ranks gave "
                f"different payloads "
                f"{dict(zip(g.members, (i for _, i in heads)))}")
        return axes, g, heads

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """A payload as the backend takes it (gloo: on the host)."""
        return (t.cpu() if self.staged else t).contiguous()

    def _back(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self.staged else t

    def _swap_rows(self, name, axes, g, rows: torch.Tensor) -> torch.Tensor:
        """``all_to_all_single`` of ``rows`` [n, ...] (row k to the member
        of process-group rank k); row k of the result is member k's."""
        send = self._out(rows)
        recv = torch.empty_like(send)
        with self._talking(name, axes):
            dist.all_to_all_single(recv, send, group=g.pg)
        return self._back(recv)

    def _gather(self, name, axes, g, x: torch.Tensor) -> list:
        """Every member's ``x``, in member order."""
        send = self._out(x)
        got = [torch.empty_like(send) for _ in g.members]
        with self._talking(name, axes):
            dist.all_gather(got, send, group=g.pg)
        return [self._back(t) for t in got]

    def _index_order(self, axes, g) -> list[int]:
        """Each member's group index (row-major over ``axes``)."""
        return [self.group_index(axes, m) for m in g.members]

    # ---- collectives -----------------------------------------------------
    def ppermute(self, x, axis: str, perm: Sequence[tuple[int, int]]):
        """``x`` from the rank whose ``axis`` index ``i`` has ``(i, mine)``
        in ``perm``; zeros (0, False) where none sends to this rank."""
        t0 = time.perf_counter()
        axes, g, heads = self._begin("ppermute", axis, x)
        mine = self.axis_index(axis)
        src = [i for i, j in perm if j == mine]
        dst = [j for i, j in perm if i == mine]
        c = self.coords(self._rank)
        items = x if isinstance(x, tuple) else (x,)
        if heads is None:  # a group of one: only (0, 0) can send
            out = _copy(x) if src else _zeros_like(x)
            self._count("ppermute", t0)
            return out
        ops, keep = [], []
        for j in dst:
            peer = self.rank_of(**{**c, axis: j})
            for v in items:
                if isinstance(v, torch.Tensor):
                    keep.append(self._out(v))
                    ops.append(dist.P2POp(dist.isend, keep[-1], peer,
                                          group=g.pg))
        recv: list = []
        if src:
            peer = self.rank_of(**{**c, axis: src[0]})
            for spec in heads[g.members.index(peer)][1]:
                if isinstance(spec, tuple):
                    dtype, shape = spec
                    buf = torch.empty(shape, dtype=dtype, device=(
                        "cpu" if self.staged else self.device))
                    ops.append(dist.P2POp(dist.irecv, buf, peer, group=g.pg))
                    recv.append(buf)
                else:
                    recv.append(spec)
        if ops:
            with self._talking("ppermute", axes):
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
        if not src:
            out = _zeros_like(x)
        else:
            vals = tuple(self._back(v) if isinstance(v, torch.Tensor) else v
                         for v in recv)
            out = vals if isinstance(x, tuple) else vals[0]
        self._count("ppermute", t0)
        return out

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Sum over the group, in ascending rank order (module docstring)."""
        t0 = time.perf_counter()
        axes, g, heads = self._begin("psum", axes, x)
        if heads is None:
            out = x.clone()
        else:
            n = len(g.members)
            flat = x.reshape(-1)
            pad = (-flat.numel()) % n
            if pad:
                flat = torch.cat([flat, flat.new_zeros(pad)])
            parts = self._swap_rows("psum", axes, g, flat.view(n, -1))
            acc = _sum_rows(parts)
            out = torch.cat(self._gather("psum", axes, g, acc))
            out = out[:x.numel()].view(x.shape)
        self._count("psum", t0)
        return out

    def pmax(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Elementwise maximum over the group (exact in any order)."""
        t0 = time.perf_counter()
        axes, g, heads = self._begin("pmax", axes, x)
        out = self._out(x).clone()
        if heads is not None:
            with self._talking("pmax", axes):
                dist.all_reduce(out, op=dist.ReduceOp.MAX, group=g.pg)
        out = self._back(out)
        self._count("pmax", t0)
        return out

    def psum_scatter(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Row ``group_index`` of the group's sum of ``x``, whose first
        dimension is the group's size, summed in ascending rank order."""
        t0 = time.perf_counter()
        self._check_rows("psum_scatter", x, self._axes(axes))
        axes, g, heads = self._begin("psum_scatter", axes, x)
        if heads is None:
            out = x[0].clone()
        else:
            order = torch.tensor(self._index_order(axes, g),
                                 device=x.device)
            out = _sum_rows(self._swap_rows("psum_scatter", axes, g,
                                            x.index_select(0, order)))
        self._count("psum_scatter", t0)
        return out

    def all_gather(self, x: torch.Tensor, axes, tiled: bool = True
                   ) -> torch.Tensor:
        """The group's ``x`` in group-index order, concatenated along
        dimension 0 or, with ``tiled=False``, stacked along a new one."""
        t0 = time.perf_counter()
        axes, g, heads = self._begin("all_gather", axes, x)
        join = torch.cat if tiled else torch.stack
        if heads is None:
            out = join([x])
        else:
            got = self._gather("all_gather", axes, g, x)
            by_index = dict(zip(self._index_order(axes, g), got))
            out = join([by_index[i] for i in range(len(got))])
        self._count("all_gather", t0)
        return out

    def all_to_all(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Row ``i`` of the result is row ``group_index`` of group member
        ``i``'s ``x``, whose first dimension is the group's size."""
        t0 = time.perf_counter()
        self._check_rows("all_to_all", x, self._axes(axes))
        axes, g, heads = self._begin("all_to_all", axes, x)
        if heads is None:
            out = torch.stack([x[0]])
        else:
            idx = self._index_order(axes, g)
            recv = self._swap_rows("all_to_all", axes, g, x.index_select(
                0, torch.tensor(idx, device=x.device)))
            out = recv.index_select(0, torch.tensor(
                np.argsort(idx), device=recv.device))
        self._count("all_to_all", t0)
        return out


def sum_counts(counts: Sequence[dict]) -> dict[str, tuple[int, float]]:
    """Several ranks' ``local_counts()`` summed: name -> (calls, host
    seconds)."""
    out: dict[str, tuple[int, float]] = {}
    for c in counts:
        for k, (n, sec) in c.items():
            m, t = out.get(k, (0, 0.0))
            out[k] = (m + n, t + sec)
    return dict(sorted(out.items()))


def _sum_rows(rows: torch.Tensor) -> torch.Tensor:
    """A new tensor: ``rows[0] + rows[1] + ...`` in that order, rounded to
    the dtype at every add (``mesh._sum_in_rank_order``)."""
    acc = rows[0].clone()
    for k in range(1, rows.shape[0]):
        acc += rows[k]
    return acc


def leaf_digests(partition, stage_params) -> dict[str, list[str]]:
    """Each replicated stage leaf's slots as sha256 digests of their bytes
    (the data-sharded expert leaves left out): what a process sends back
    so that replicas in other processes can be compared bit for bit."""
    out = {}
    leaves = partition.stage_leaves(stage_params.parameters())
    for k in partition.stage_keys:
        if partition.stage_data_sharded[k]:
            continue
        out[k] = [hashlib.sha256(p.detach().cpu().contiguous().view(
            torch.uint8).numpy().tobytes()).hexdigest() for p in leaves[k]]
    return out


# ---------------------------------------------------------------------------
# the world's entry and exit
# ---------------------------------------------------------------------------
def in_world() -> bool:
    """Whether ``torchrun`` (or :func:`spawn_world`) set this process's
    rank and world size."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def join_world(shape: dict[str, int], *, device="cuda",
               backend: str = "gloo",
               timeout: float = DEFAULT_TIMEOUT) -> ProcessMesh:
    """Initialise this process's ``torch.distributed`` world from
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR`` /
    ``MASTER_PORT`` (or the ``file://`` store in ``INIT_METHOD_ENV``) and
    return its :class:`ProcessMesh` of ``shape``."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    size = int(np.prod(list(shape.values())))
    if world != size:
        raise SystemExit(f"a world of {world} processes for a mesh "
                         f"{shape} of {size} ranks")
    check_backend(backend, device, size)
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: the port runs on the "
                               "GPU unless it is asked for the CPU "
                               "(--device cpu)")
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=os.environ.get(INIT_METHOD_ENV, "env://"),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout))
    return ProcessMesh(shape, device=device, backend=backend,
                       timeout=timeout)


def leave_world() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _child(rank: int, nprocs: int, d: str, fn, args: tuple, shape: dict,
           device: str, backend: str, timeout: float,
           threads: int | None) -> None:
    """One spawned rank: join the world, run ``fn(mesh, *args)``, save the
    result (or the error and its traceback) for the parent."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(nprocs),
                      LOCAL_RANK=str(rank),
                      **{INIT_METHOD_ENV: "file://" + os.path.join(
                          d, "store")})
    if threads:
        torch.set_num_threads(threads)
    try:
        mesh = join_world(shape, device=device, backend=backend,
                          timeout=timeout)
        try:
            out = fn(mesh, *args)
        finally:
            leave_world()
    except BaseException as e:
        with contextlib.suppress(Exception):
            torch.save({"error": e, "traceback": traceback.format_exc()},
                       os.path.join(d, f"error{rank}.pt"))
        raise
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))


class WorldError(RuntimeError):
    """A spawned rank failed in a way that has no exception of its own
    (killed, exited, past the deadline, or an error that did not pickle)."""


def _child_error(d: str, first: int, msg: str) -> BaseException:
    """The error to raise for a failed world: a rank's own error over a
    MeshAborted that it caused in its peers, the first rank to fail
    otherwise; with the failed rank and its traceback attached."""
    saved = {}
    for f in os.listdir(d):
        if f.startswith("error"):
            with contextlib.suppress(Exception):
                saved[int(f[5:-3])] = torch.load(os.path.join(d, f),
                                                 weights_only=False)
    order = sorted(saved, key=lambda r: (
        isinstance(saved[r]["error"], MeshAborted), r != first, r))
    if not order:
        return WorldError(f"rank {first} of the world failed:{msg}")
    r = order[0]
    err = saved[r]["error"]
    err.add_note(f"(raised by rank {r} of the spawned world; its "
                 f"traceback:)\n{saved[r]['traceback']}")
    return err


def spawn_world(fn: Callable, args: tuple, nprocs: int, *,
                shape: dict[str, int], device="cuda", backend: str = "gloo",
                timeout: float = DEFAULT_TIMEOUT,
                deadline: float | None = None,
                threads: int | None = None) -> list[Any]:
    """Run ``fn(mesh, *args)`` in ``nprocs`` new processes, one rank each
    (``start_method="spawn"``; ``fn`` must be importable by its module
    path), on a :class:`ProcessMesh` of ``shape``; returns the results by
    rank.  The parent joins them for at most ``deadline`` seconds (None:
    no limit beyond each collective's ``timeout``); ``threads`` sets each
    child's ``torch.set_num_threads``."""
    if int(np.prod(list(shape.values()))) != nprocs:
        raise ValueError(f"{nprocs} processes for a mesh {shape}")
    check_backend(backend, device, nprocs)
    with tempfile.TemporaryDirectory(prefix="repro-world-") as d:
        ctx = mp.start_processes(
            _child, args=(nprocs, d, fn, args, shape, str(device), backend,
                          timeout, threads),
            nprocs=nprocs, join=False, start_method="spawn")
        end = None if deadline is None else time.monotonic() + deadline
        try:
            while not ctx.join(timeout=1.0):
                if end is not None and time.monotonic() > end:
                    alive = [r for r, p in enumerate(ctx.processes)
                             if p.is_alive()]
                    raise WorldError(
                        f"rank(s) {alive} of a world of {nprocs} still "
                        f"ran after the deadline of {deadline:g} s: killed")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raise _child_error(d, e.error_index, str(e)) from None
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join()
        return [torch.load(os.path.join(d, f"rank{r}.pt"),
                           weights_only=False) for r in range(nprocs)]
