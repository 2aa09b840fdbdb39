"""Load the reference package's parameters into the port's modules.

The reference keeps parameters as nested dicts of arrays: stage parameters
stacked ``[num_stages, l_max, ...]`` per leaf, IO parameters unstacked.
The port's module names map onto those paths one-to-one:

    stage s, ``slots.{i}.blk.attn.wq``    <->  ``stage['blk']['attn']['wq'][s, i]``
    stage s, ``slots.{i}.mamba.in_proj``  <->  ``stage['mamba']['in_proj'][s, i]``
    ``embed``                            <->  ``io['embed']``
    ``shared_blk.attn.wq``               <->  ``io['shared_blk']['attn']['wq']``

so both frameworks can compute on identical weights.  The multimodal
DAG's per-stage trees load the same way, one module per stage
(:func:`multimodal_params_from_reference`: ``layers.{i}.attn.wq`` of stage
``s`` is ``params[s]['layers'][i]['attn']['wq']``).  Decode caches map the
same way: the reference's stacked ``[num_stages, l_max, ...]`` cache tree
becomes one tree per stage with ``[l_max, ...]`` leaves
(:func:`cache_from_reference`; each rank's shard of it on a serve
mesh: :func:`rank_caches_from_reference` and back).  Arrays arrive as
numpy (bfloat16 arrays as numpy's ``bfloat16`` extension dtype) or as CPU
tensors (a checkpoint restored into :func:`reference_layout`).  A leaf
whose dtype differs from the port parameter's raises instead of being cast
(the float32 leaves of a bfloat16 model, e.g. a Mamba layer's ``a_log``,
must stay float32 on both sides).

The schedule-table executor's ranks each hold their stage's module (with
their shard of the MoE layouts' experts) and their own io module
(:func:`rank_params_from_reference`; back, the shards concatenated:
:func:`rank_params_to_reference`), and its ZeRO-1
optimizer state converts to the reference's global layout and back
(:func:`zero1_state_to_reference`: per-leaf shards ``[S, dp_total * n]``,
expert moments ``[S, l_max, ...]``).

The other direction, :func:`params_to_reference` (and
:func:`state_to_reference` for the optimizer's ``m``/``v`` lists), gives
the reference's numpy trees, which is what the checkpoint store writes: a
checkpoint of either package restores in the other.  Every stage has all
``l_max`` slots in both packages, disabled ones (``type_ids == -1``)
included, so the stacked shapes agree.  numpy has no bfloat16 without the
JAX stack, so bfloat16 leaves come out as float32 (lossless, as the store
writes them anyway).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.build import ArchModel, IOParams, StageParams, tree_map
from repro_torch.models.moe import take_shard


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A tensor of ``a`` on ``device``; on the CPU it may share a writable,
    contiguous ``a``'s memory (a copy of any other)."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.require(a, requirements=("C", "W"))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _leaf(tree: dict, dotted: str):
    node = tree
    for part in dotted.split("."):
        node = node[int(part)] if isinstance(node, list) else node[part]
    return node


def _load(p: torch.Tensor, a, name: str, device) -> None:
    t = tensor_from_numpy(a, device)
    if t.dtype != p.dtype or t.shape != p.shape:
        raise TypeError(f"{name}: reference leaf {t.dtype} {tuple(t.shape)} "
                        f"does not match the port's {p.dtype} "
                        f"{tuple(p.shape)}")
    p.copy_(t)


def _stage_leaf(tree: dict, name: str, s: int):
    """Stage ``s``'s slice of the stacked reference leaf of module
    parameter ``name`` (``slots.{i}.<path>`` -> ``tree[<path>][s, i]``)."""
    _, slot, path = name.split(".", 2)  # "slots", i, rest
    a = _leaf(tree, path)
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a)
    return a[s, int(slot)]


def params_from_reference(model: ArchModel, stage_params_np: dict,
                          io_params_np: dict, device, stages=None
                          ) -> tuple[list[StageParams], IOParams]:
    """Build the port's per-stage modules (of ``stages``, every stage by
    default) and IO module holding the reference's weights (dtypes and
    values unchanged)."""
    out = []
    with torch.no_grad():
        for s in range(model.num_stages) if stages is None else stages:
            sp = model.init_stage_params(s, seed=None, device=device)
            for name, p in sp.named_parameters():
                _load(p, _stage_leaf(stage_params_np, name, s),
                      f"stage {s} {name}", device)
            out.append(sp)
        io = model.init_io_params(seed=None, device=device)
        for name, p in io.named_parameters():
            _load(p, _leaf(io_params_np, name), name, device)
    return out, io


def _split_flat(stage_params, io_params, flat) -> tuple[list[list], list]:
    """A flat list parallel to every stage's parameters, then the IO
    module's (the launcher's ``m``/``v``), split per module."""
    flat = list(flat)
    per_stage, i = [], 0
    for sp in stage_params:
        n = len(list(sp.parameters()))
        per_stage.append(flat[i:i + n])
        i += n
    io_values = flat[i:]
    if len(io_values) != len(list(io_params.parameters())):
        raise TypeError(f"{len(flat)} values for {i} stage and "
                        f"{len(list(io_params.parameters()))} IO parameters")
    return per_stage, io_values


def _insert(tree: dict, dotted: str, value) -> None:
    *parents, last = dotted.split(".")
    for part in parents:
        tree = tree.setdefault(part, {})
    tree[last] = value


def _to_reference(model: ArchModel, stage_params, io_params, stage_values,
                  io_values, leaf) -> tuple[dict, dict]:
    """The reference's (stage, IO) trees of per-parameter values: stage
    leaves stacked ``[num_stages, l_max, ...]``, each passed to ``leaf``."""
    if len(stage_params) != model.num_stages:
        raise TypeError(f"{len(stage_params)} stage modules for "
                        f"{model.num_stages} stages")
    rows: dict[str, list[list]] = {}
    for s, (sp, values) in enumerate(zip(stage_params, stage_values,
                                         strict=True)):
        for (name, _), t in zip(sp.named_parameters(), values, strict=True):
            _, slot, path = name.split(".", 2)
            rows.setdefault(path, [[None] * model.l_max
                                   for _ in range(model.num_stages)])
            rows[path][s][int(slot)] = t
    sp_tree: dict = {}
    for path, per_stage in rows.items():
        _insert(sp_tree, path,
                leaf(torch.stack([torch.stack(r) for r in per_stage])))
    io_tree: dict = {}
    for (name, _), t in zip(io_params.named_parameters(), io_values,
                            strict=True):
        _insert(io_tree, name, leaf(t))
    return sp_tree, io_tree


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


@torch.no_grad()
def params_to_reference(model: ArchModel, stage_params, io_params
                        ) -> tuple[dict, dict]:
    """The inverse of :func:`params_from_reference`: the reference's numpy
    (stage, IO) parameter trees of the port's modules."""
    return _to_reference(model, stage_params, io_params,
                         [list(sp.parameters()) for sp in stage_params],
                         list(io_params.parameters()), _host)


@torch.no_grad()
def state_to_reference(model: ArchModel, stage_params, io_params, flat
                       ) -> tuple[dict, dict]:
    """The reference's numpy (stage, IO) trees of a flat list parallel to
    the parameters (the launcher's float32 ``m`` or ``v``)."""
    stage_values, io_values = _split_flat(stage_params, io_params, flat)
    return _to_reference(model, stage_params, io_params, stage_values,
                         io_values, _host)


def state_from_reference(model: ArchModel, stage_params, io_params,
                         sp_tree: dict, io_tree: dict, device
                         ) -> list[torch.Tensor]:
    """The inverse of :func:`state_to_reference`: a flat list parallel to
    the parameters, each entry the shape of its parameter."""
    out = []
    for s, sp in enumerate(stage_params):
        for name, p in sp.named_parameters():
            out.append(_checked(p, _stage_leaf(sp_tree, name, s),
                                f"stage {s} {name}", device))
    for name, p in io_params.named_parameters():
        out.append(_checked(p, _leaf(io_tree, name), name, device))
    return out


def _checked(p: torch.Tensor, a, name: str, device) -> torch.Tensor:
    t = tensor_from_numpy(a, device)
    if t.shape != p.shape:
        raise TypeError(f"{name}: reference leaf {tuple(t.shape)} does not "
                        f"match the port's {tuple(p.shape)}")
    return t


def reference_layout(model: ArchModel, stage_params, io_params,
                     dtype: torch.dtype | None = None) -> tuple[dict, dict]:
    """The reference's (stage, IO) trees as ``meta`` tensors of the
    parameters' dtypes (or ``dtype``): the restore target of a checkpoint,
    which carries shapes and dtypes and holds no data."""
    def meta(p):
        return torch.empty(p.shape, dtype=dtype or p.dtype, device="meta")

    return _to_reference(
        model, stage_params, io_params,
        [[meta(p) for p in sp.parameters()] for sp in stage_params],
        [meta(p) for p in io_params.parameters()], lambda t: t)


def cache_from_reference(model: ArchModel, cache_np: dict, device
                         ) -> list[dict]:
    """The port's per-stage decode caches holding the reference's stacked
    ``[num_stages, l_max, batch, ...]`` cache tree, numpy arrays or tensors
    (keys, dtypes and shapes must be the port's ``init_stage_cache``'s; a
    mismatch raises)."""
    # leaves are [S, l_max, batch, ...]; only k/v (attention) carry the
    # sequence (xLSTM's recurrent states have none) and xk/xv enc_len
    leaves: list = []
    tree_map(leaves.append, cache_np)
    batch = np.shape(leaves[0])[2]
    seq = np.shape(cache_np["k"])[3] if "k" in cache_np else 0
    enc_len = np.shape(cache_np["xk"])[3] if "xk" in cache_np else 0
    stages = []
    for s in range(model.num_stages):
        cache = model.init_stage_cache(batch, seq, enc_len, device=device)
        if set(cache) != set(cache_np):
            raise TypeError(f"reference cache keys {sorted(cache_np)} are "
                            f"not the port's {sorted(cache)}")
        tree_map(lambda t, a: _load(
            t, a[s] if isinstance(a, torch.Tensor) else np.asarray(a)[s],
            f"stage {s} cache", device), cache, cache_np)
        stages.append(cache)
    return stages


def rank_caches_from_reference(model: ArchModel, mesh, cache: dict,
                               specs: dict, device) -> list[dict]:
    """Every rank's own decode cache holding its shard of the reference's
    stacked ``[num_stages, l_max, batch, ...]`` cache tree (numpy arrays or
    tensors) under ``specs`` (``pipeline.decode.cache_specs``: a leaf's
    ``(dim, axes)`` in a rank's ``[l_max, ...]`` leaf, or None for a copy
    on every data rank): rank ``r`` holds stage ``coords(r)["model"]`` and,
    of a sharded leaf, part ``group_index(axes, r)``; a list by rank, of
    the mesh's local ranks (None for a rank of another process).  Keys,
    dtypes and shapes must be ``init_stage_cache``'s (a mismatch raises)."""
    out: list = [None] * mesh.size
    for r in mesh.local_ranks:
        s = mesh.coords(r)["model"]

        def shard(a, spec):
            a = a[s] if isinstance(a, torch.Tensor) else np.asarray(a)[s]
            if spec is None:
                return a
            dim, axes = spec
            return take_shard(a, dim, mesh.group_size(axes),
                              mesh.group_index(axes, r))

        part = tree_map(shard, cache, specs)
        kv = (part["k"].shape[2] if "k" in part else 0,
              part["xk"].shape[2] if "xk" in part else 0)
        leaves: list = []
        tree_map(leaves.append, part)
        local = model.init_stage_cache(leaves[0].shape[1], *kv,
                                       device=device)
        if set(local) != set(part):
            raise TypeError(f"reference cache keys {sorted(part)} are not "
                            f"the port's {sorted(local)}")
        with torch.no_grad():
            tree_map(lambda t, a: _load(t, a, f"rank {r} cache", device),
                     local, part)
        out[r] = local
    return out


@torch.no_grad()
def rank_caches_to_reference(model: ArchModel, mesh, caches: list[dict],
                             specs: dict) -> dict:
    """The reference's stacked numpy cache tree of per-rank caches (the
    inverse of :func:`rank_caches_from_reference`): a sharded leaf's parts
    concatenated in group-index order, a replicated one from the stage's
    rank of data index 0."""
    _every_rank_local(mesh, "rank_caches_to_reference")

    def stage_leaf(s, spec, *leaves):
        if spec is None:
            return leaves[mesh.rank_of(model=s)]
        dim, axes = spec
        ranks = sorted((r for r in range(mesh.size)
                        if mesh.coords(r)["model"] == s),
                       key=lambda r: mesh.group_index(axes, r))
        return torch.cat([leaves[r] for r in ranks], dim=dim)

    return tree_map(
        lambda spec, *leaves: np.stack([
            _host(stage_leaf(s, spec, *leaves))
            for s in range(model.num_stages)]), specs, *caches)


def multimodal_params_from_reference(model, stage_params_np: list[dict],
                                     device) -> list:
    """The port's per-stage modules of a ``MultimodalModel`` holding the
    reference's per-stage parameter trees (dtypes and values unchanged; a
    leaf of another dtype or shape raises)."""
    stages = model.init_stage_params(seed=None, device=device)
    with torch.no_grad():
        for s, (sp, tree) in enumerate(zip(stages, stage_params_np,
                                           strict=True)):
            params = list(sp.named_parameters())
            if len(params) != _count_leaves(tree):
                raise TypeError(f"stage {s}: the reference tree has "
                                f"{_count_leaves(tree)} leaves, the port's "
                                f"module {len(params)} parameters")
            for name, p in params:
                _load(p, np.asarray(_leaf(tree, name)), f"stage {s} {name}",
                      device)
    return stages


def _count_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count_leaves(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_count_leaves(v) for v in tree)
    return 1


# ---------------------------------------------------------------------------
# the schedule-table executor's per-rank parameters and ZeRO-1 state
# ---------------------------------------------------------------------------
def rank_params_from_reference(model: ArchModel, mesh, stage_params_np: dict,
                               io_params_np: dict, device, ranks=None
                               ) -> tuple[list[StageParams], list[IOParams]]:
    """Every rank's own stage module (its ``model`` index's stage) and io
    module holding the reference's stacked ``[S, ...]`` weights: each rank
    gets its own copy, as each device holds its own, and of a leaf sharded
    over ``data`` (the MoE layouts' experts) its data index's shard; lists
    by rank, of ``ranks`` (by default the mesh's local ranks; None for the
    others)."""
    data = mesh.shape["data"]
    stage_params: list = [None] * mesh.size
    io_params: list = [None] * mesh.size
    with torch.no_grad():
        for r in mesh.local_ranks if ranks is None else ranks:
            c = mesh.coords(r)
            s = c["model"]
            sp = model.init_stage_params(s, seed=None, device=device,
                                         data_size=data)
            for name, p in sp.named_parameters():
                a = _stage_leaf(stage_params_np, name, s)
                dim = model.expert_shard_dim(name, data)
                if dim is not None:
                    a = take_shard(a, dim, data, c["data"])
                _load(p, a, f"stage {s} {name}", device)
            io = model.init_io_params(seed=None, device=device)
            for name, p in io.named_parameters():
                _load(p, _leaf(io_params_np, name), name, device)
            stage_params[r], io_params[r] = sp, io
    return stage_params, io_params


def _every_rank_local(mesh, what: str) -> None:
    """A conversion to the reference's global layout reads every rank's
    state: on a mesh of processes the other ranks' are elsewhere."""
    if len(mesh.local_ranks) != mesh.size:
        raise ValueError(f"{what} reads every rank's state; {mesh!r} holds "
                         f"rank(s) {list(mesh.local_ranks)} only")


def _every_rank_given(per_rank: list, what: str) -> None:
    """A conversion to the global layout needs an entry for every rank (on
    a mesh of processes: gathered to one host, as ``launch/train.py``'s
    table checkpoint gathers them)."""
    missing = [r for r, v in enumerate(per_rank) if v is None]
    if missing:
        raise ValueError(f"{what} reads every rank's state; rank(s) "
                         f"{missing} are not in this process")


def _gathered(model: ArchModel, mesh, stage_params, value):
    """Per stage, ``value(p)`` of each parameter of its data-index-0 rank,
    a leaf sharded over ``data`` concatenated over the data ranks."""
    _every_rank_given(stage_params, "the reference's global layout")
    data = mesh.shape["data"]
    out = []
    for s in range(model.num_stages):
        mods = [stage_params[mesh.rank_of(data=i, model=s)]
                for i in range(data)]
        params = [list(m.parameters()) for m in mods]
        row = []
        for j, (name, p) in enumerate(mods[0].named_parameters()):
            dim = model.expert_shard_dim(name, data)
            row.append(value(p) if dim is None else torch.cat(
                [value(ps[j]) for ps in params], dim=dim))
        out.append(row)
    return out


@torch.no_grad()
def rank_params_to_reference(model: ArchModel, mesh, stage_params,
                             io_params) -> tuple[dict, dict]:
    """The reference's numpy (stage, IO) trees of per-rank modules: the
    ranks of data index 0 (the data replicas hold the same values), the
    data ranks' shards of a data-sharded leaf concatenated."""
    row0 = [stage_params[mesh.rank_of(model=s)]
            for s in range(model.num_stages)]
    return _to_reference(model, row0, io_params[0],
                         _gathered(model, mesh, stage_params, lambda p: p),
                         list(io_params[0].parameters()), _host)


def rank_reference_layout(model: ArchModel, mesh, stage_params, io_params
                          ) -> tuple[dict, dict]:
    """:func:`reference_layout` of per-rank modules: the global shapes of
    :func:`rank_params_to_reference`'s trees, as ``meta`` tensors."""
    def meta(p):
        return torch.empty(p.shape, dtype=p.dtype, device="meta")

    row0 = [stage_params[mesh.rank_of(model=s)]
            for s in range(model.num_stages)]
    return _to_reference(model, row0, io_params[0],
                         _gathered(model, mesh, stage_params, meta),
                         [meta(p) for p in io_params[0].parameters()],
                         lambda t: t)


def _data_dim(spec: tuple) -> int | None:
    """The dim of a rank's ``[l_max, ...]`` leaf sharded over ``data``."""
    return spec.index("data") - 1 if "data" in spec else None


def zero1_state_to_reference(model: ArchModel, mesh, partition,
                             opt_states: list[dict],
                             dp_axes: tuple = ("data",)) -> dict:
    """The reference's global ZeRO-1 state of per-rank states (numpy):
    ``["shards"][leaf]["master"|"m"|"v"]`` ``[S, dp_total * n]`` (row
    ``s``, columns ``i * n`` to ``(i + 1) * n``: the shard of the rank of
    stage ``s`` and dp index ``i``; the reference's ``P("model",
    dp_axes)`` of its ``[1, n]`` rank shards) and
    ``["experts"][leaf]["m"|"v"]`` ``[S, l_max, ...]`` (data shards
    concatenated along their spec's ``data`` dim).  Each rank's tensor is
    copied once, from its device, into its place in the global array
    (bf16 widened to float32)."""
    _every_rank_given(opt_states, "zero1_state_to_reference")
    S, dp = model.num_stages, mesh.group_size(dp_axes)
    where: dict[tuple[int, int], int] = {}
    for r in range(mesh.size):
        where.setdefault((mesh.coords(r)["model"],
                          mesh.group_index(dp_axes, r)), r)

    def place(kind, k, name, parts: int, dim: int):
        """The global array of leaf ``k``'s ``name``: stage ``s``'s
        ``parts`` tensors (dp index ``i``'s at part ``i``) side by side
        along ``dim`` of its row."""
        first = opt_states[where[0, 0]][kind][k][name]
        shape = list(first.shape)
        size = shape[dim]
        shape[dim] *= parts
        out = np.empty((S, *shape), dtype=_host_dtype(first))
        for s in range(S):
            for i in range(parts):
                t = opt_states[where[s, i]][kind][k][name]
                if t.shape != first.shape:
                    raise ValueError(f"{kind} {k} {name}: stage {s} dp "
                                     f"{i} holds {tuple(t.shape)}, stage 0 "
                                     f"{tuple(first.shape)}")
                idx = (s,) + (slice(None),) * dim + (
                    slice(i * size, (i + 1) * size),)
                torch.from_numpy(out[idx]).copy_(t.detach())
        return out

    out: dict = {"shards": {}, "experts": {}}
    for k, st in opt_states[0]["shards"].items():
        out["shards"][k] = {name: place("shards", k, name, dp, 0)
                            for name in st}
    for k, st in opt_states[0]["experts"].items():
        dim = _data_dim(partition.stage_specs[k])
        out["experts"][k] = {
            name: place("experts", k, name, 1, 0) if dim is None
            else place("experts", k, name, dp, dim) for name in st}
    return out


def _host_dtype(t: torch.Tensor) -> np.dtype:
    """The numpy dtype :func:`_host` gives ``t`` (bf16 widened)."""
    if t.dtype == torch.bfloat16:
        return np.dtype(np.float32)
    return torch.empty((), dtype=t.dtype).numpy().dtype


def zero1_state_from_reference(model: ArchModel, mesh, partition,
                               tree: dict, device,
                               dp_axes: tuple = ("data",),
                               expert_dtype=torch.float32,
                               ranks=None) -> list[dict]:
    """The inverse of :func:`zero1_state_to_reference`: the state of each
    rank of ``ranks`` (by default the mesh's local ranks; shards float32,
    expert state in ``expert_dtype``), in a list by rank (None for the
    others)."""
    dp = mesh.group_size(dp_axes)
    states: list = [None] * mesh.size
    for r in mesh.local_ranks if ranks is None else ranks:
        s = mesh.coords(r)["model"]
        i = mesh.group_index(dp_axes, r)
        shards = {k: {name: tensor_from_numpy(
            np.split(np.asarray(a)[s], dp)[i], device).float()
            for name, a in st.items()} for k, st in tree["shards"].items()}
        experts = {}
        for k, st in tree["experts"].items():
            dim = _data_dim(partition.stage_specs[k])
            experts[k] = {}
            for name, a in st.items():
                a = np.asarray(a)[s]
                if dim is not None:
                    a = np.array_split(a, mesh.shape["data"], axis=dim)[
                        mesh.coords(r)["data"]]
                experts[k][name] = tensor_from_numpy(a, device).to(
                    expert_dtype)
        states[r] = {"shards": shards, "experts": experts}
    return states


def zero1_state_layout(model: ArchModel, mesh, partition, opt_state: dict,
                       dp_axes: tuple = ("data",)) -> dict:
    """The global ZeRO-1 state's ``meta`` tensors (shapes and dtypes, no
    data): a checkpoint's restore target, from one rank's state."""
    S, dp = model.num_stages, mesh.group_size(dp_axes)

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    def expert_shape(k, t):
        shape = list(t.shape)
        dim = _data_dim(partition.stage_specs[k])
        if dim is not None:
            shape[dim] *= mesh.shape["data"]
        return (S, *shape)

    return {
        "shards": {k: {n: meta((S, dp * t.shape[0]), t.dtype)
                       for n, t in st.items()}
                   for k, st in opt_state["shards"].items()},
        "experts": {k: {n: meta(expert_shape(k, t), t.dtype)
                        for n, t in st.items()}
                    for k, st in opt_state["experts"].items()},
    }
