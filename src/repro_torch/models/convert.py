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
numpy (bfloat16 arrays as numpy's ``bfloat16`` extension dtype).  A leaf
whose dtype differs from the port parameter's raises instead of being cast
(the float32 leaves of a bfloat16 model, e.g. a Mamba layer's ``a_log``,
must stay float32 on both sides).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.build import ArchModel, IOParams, StageParams, tree_map


def tensor_from_numpy(a, device) -> torch.Tensor:
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


def params_from_reference(model: ArchModel, stage_params_np: dict,
                          io_params_np: dict, device
                          ) -> tuple[list[StageParams], IOParams]:
    """Build the port's per-stage modules and IO module holding the
    reference's weights (dtypes and values unchanged)."""
    stages = []
    with torch.no_grad():
        for s in range(model.num_stages):
            sp = model.init_stage_params(s, seed=None, device=device)
            for name, p in sp.named_parameters():
                _, slot, path = name.split(".", 2)  # "slots", i, rest
                _load(p, np.asarray(_leaf(stage_params_np, path))[s, int(slot)],
                      f"stage {s} {name}", device)
            stages.append(sp)
        io = model.init_io_params(seed=None, device=device)
        for name, p in io.named_parameters():
            _load(p, np.asarray(_leaf(io_params_np, name)), name, device)
    return stages, io


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
