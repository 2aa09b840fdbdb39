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
(:func:`cache_from_reference`).  Arrays arrive as
numpy (bfloat16 arrays as numpy's ``bfloat16`` extension dtype) or as CPU
tensors (a checkpoint restored into :func:`reference_layout`).  A leaf
whose dtype differs from the port parameter's raises instead of being cast
(the float32 leaves of a bfloat16 model, e.g. a Mamba layer's ``a_log``,
must stay float32 on both sides).

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


def tensor_from_numpy(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.array(a)  # writable, contiguous copy
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
    ``[num_stages, l_max, batch, ...]`` cache tree (keys, dtypes and shapes
    must be the port's ``init_stage_cache``'s; a mismatch raises)."""
    # every ported arch has an attention (or shared-block) k/v cache
    _, _, batch, seq = np.shape(cache_np["k"])[:4]
    enc_len = np.shape(cache_np["xk"])[3] if "xk" in cache_np else 0
    stages = []
    for s in range(model.num_stages):
        cache = model.init_stage_cache(batch, seq, enc_len, device=device)
        if set(cache) != set(cache_np):
            raise TypeError(f"reference cache keys {sorted(cache_np)} are "
                            f"not the port's {sorted(cache)}")
        tree_map(lambda t, a: _load(t, np.asarray(a)[s], f"stage {s} cache",
                                    device), cache, cache_np)
        stages.append(cache)
    return stages


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
