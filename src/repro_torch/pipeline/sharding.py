"""Parameter partition policy: leaf names, layouts and reduction groups.

Port of ``repro.pipeline.sharding`` on the port's modules.  The reference
keeps stage parameters as one pytree whose leaves are stacked ``[S, l_max,
...]``; the port keeps one :class:`~repro_torch.models.build.StageParams`
per stage whose slot ``i`` holds parameter ``slots.{i}.<path>``.  A *leaf*
here is the reference's: the ``l_max`` slot parameters of one ``<path>``,
named by the reference's ``jax.tree_util.keystr`` of its path
(``['blk']['attn']['wq']``) and taken in the reference's leaf order (dict
keys sorted), as ``ckpt/store.py`` names checkpoint leaves.  Flattening a
leaf concatenates its slots in slot order, which is the reference's
row-major flattening of the stacked ``[l_max, ...]`` leaf.

Layout (DESIGN §3):
* stage layer params — stage ``s`` on the ranks of ``model`` index ``s``;
  MoE routed-expert leaves additionally sharded over ``data`` (EP on the
  expert dim for deepseek-moe, TP on d_ff for grok); everything else
  data-replicated with ZeRO-1 optimizer-state sharding over (pod, data).
* io params (embed / head / final_ln / shared block) — replicated; their
  grads are psum'd over ``model`` (stage-masked contributions) and enter the
  same ZeRO-1 per-leaf shards as the data-replicated stage grads.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.ckpt.store import _leaves_with_path
from repro_torch.models.build import ArchModel, IOParams, StageParams
from repro_torch.models.moe import expert_shard_dim


@dataclasses.dataclass(frozen=True)
class ParamPartition:
    #: stage leaf names, in the reference's leaf order
    stage_keys: tuple[str, ...]
    #: leaf -> indices into ``list(stage_params.parameters())``, slot order
    stage_slots: dict[str, tuple[int, ...]]
    #: leaf -> the mesh axis of each dim of its global ``[S, l_max, ...]``
    #: array (the reference's PartitionSpec)
    stage_specs: dict[str, tuple]
    #: leaf -> True if sharded over data (EP/TP experts): never DP-reduced
    stage_data_sharded: dict[str, bool]
    #: io leaf names and their indices into ``list(io.parameters())``
    io_keys: tuple[str, ...]
    io_index: dict[str, int]

    def stage_leaves(self, values) -> dict[str, list]:
        """Group a list parallel to a stage module's parameters by leaf."""
        values = list(values)
        return {k: [values[i] for i in self.stage_slots[k]]
                for k in self.stage_keys}

    def io_leaves(self, values) -> dict[str, object]:
        values = list(values)
        return {k: values[self.io_index[k]] for k in self.io_keys}


def _keyed(names) -> list[tuple[str, str]]:
    """(keystr, dotted name) of dotted parameter names, in the reference's
    leaf order."""
    tree: dict = {}
    for name in names:
        *parents, last = name.split(".")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = name
    return list(_leaves_with_path(tree))


def partition_for(model: ArchModel, stage_params: StageParams,
                  io_params: IOParams) -> ParamPartition:
    """The partition of ``model``'s parameters (``stage_params``: any one
    stage's module; every stage has the same names)."""
    layout = model.moe_layout
    slots: dict[str, list[tuple[int, int]]] = {}
    ndim: dict[str, int] = {}
    for idx, (name, p) in enumerate(stage_params.named_parameters()):
        _, slot, path = name.split(".", 2)  # "slots", i, rest
        slots.setdefault(path, []).append((int(slot), idx))
        ndim[path] = p.dim() + 2  # the global [S, l_max, ...] leaf
    stage_keys, stage_slots, specs, flags = [], {}, {}, {}
    for key, path in _keyed(slots):
        names = path.split(".")
        # routed expert leaves live DIRECTLY under "moe" (shared experts
        # are nested one level deeper: moe/shared<i>/wi); the layout
        # shards the dim moe.expert_shard_dim names (E under ep, f under
        # tp) of the leaf [S, l_max, E, d, f]
        dim = (expert_shard_dim(names[-1], layout)
               if len(names) >= 2 and names[-2] == "moe" else None)
        extra = [None] * (ndim[path] - 1)
        if dim is not None:
            extra[1 + dim] = "data"
        stage_keys.append(key)
        stage_slots[key] = tuple(i for _, i in sorted(slots[path]))
        specs[key] = ("model", *extra)
        flags[key] = dim is not None
    io_names = {name: i for i, (name, _) in
                enumerate(io_params.named_parameters())}
    io_keyed = _keyed(io_names)
    return ParamPartition(
        stage_keys=tuple(stage_keys), stage_slots=stage_slots,
        stage_specs=specs, stage_data_sharded=flags,
        io_keys=tuple(k for k, _ in io_keyed),
        io_index={k: io_names[n] for k, n in io_keyed})


def flat_leaf(slot_tensors, dtype=None) -> torch.Tensor:
    """One leaf's slots flattened and concatenated (the stacked leaf's
    row-major flattening), optionally cast."""
    vec = torch.cat([t.reshape(-1) for t in slot_tensors])
    return vec if dtype is None else vec.to(dtype)


# ---------------------------------------------------------------------------
# flat ZeRO-1 shard helpers
# ---------------------------------------------------------------------------
def flatten_replicated(leaves: dict, flags: dict, pad_to: int,
                       dtype=torch.float32) -> torch.Tensor:
    """Concat flattened data-replicated leaves into one padded vector
    (``leaves``: key -> tensor, in leaf order; ``flags``: key -> bool)."""
    parts = [t.to(dtype).reshape(-1) for k, t in leaves.items()
             if not flags.get(k, False)]
    vec = (torch.cat(parts) if parts else torch.zeros((0,), dtype=dtype))
    return F.pad(vec, (0, (-vec.numel()) % pad_to))


def unflatten_replicated(vec: torch.Tensor, leaves: dict, flags: dict
                         ) -> dict:
    """Inverse of flatten_replicated: fill the replicated leaves from vec
    (each in its own shape and dtype); data-sharded leaves pass through."""
    out, off = {}, 0
    for k, t in leaves.items():
        if flags.get(k, False):
            out[k] = t
        else:
            n = t.numel()
            out[k] = vec[off:off + n].reshape(t.shape).to(t.dtype)
            off += n
    return out


def replicated_size(leaves: dict, flags: dict) -> int:
    return sum(t.numel() for k, t in leaves.items()
               if not flags.get(k, False))
