"""Load the reference package's parameters into the port's modules.

The reference keeps parameters as nested dicts of arrays: stage parameters
stacked ``[num_stages, l_max, ...]`` per leaf, IO parameters unstacked.
The port's module names map onto those paths one-to-one:

    stage s, ``slots.{i}.blk.attn.wq``  <->  ``stage['blk']['attn']['wq'][s, i]``
    ``embed``                          <->  ``io['embed']``

so both frameworks can compute on identical weights.  Arrays arrive as
numpy (bfloat16 arrays as numpy's ``bfloat16`` extension dtype).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.build import ArchModel, IOParams, StageParams


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.array(a)  # writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _leaf(tree: dict, dotted: str):
    node = tree
    for part in dotted.split("."):
        node = node[part]
    return node


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
                p.copy_(tensor_from_numpy(
                    np.asarray(_leaf(stage_params_np, path))[s, int(slot)],
                    device))
            stages.append(sp)
        io = model.init_io_params(seed=None, device=device)
        for name, p in io.named_parameters():
            p.copy_(tensor_from_numpy(np.asarray(_leaf(io_params_np, name)),
                                      device))
    return stages, io
