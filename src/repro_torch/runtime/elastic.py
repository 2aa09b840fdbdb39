"""Elastic re-mapping: the actor runtime's recovery path and stage re-layout.

The port's counterpart of the reference ``runtime/elastic.py``:
``plan_remesh`` (the largest feasible (data x model) grid) and
``remap_stages`` (fold dead stages onto their nearest survivors), which the
runtime driver's remap path calls, and ``relayout_stage_params``, which
redistributes the layers of a checkpoint's host tree over a new stage
count (no launcher calls it, as none of the reference's does).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.models.build import ArchModel, build
from repro_torch.models.common import global_layer_index


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    data: int
    model: int

    @property
    def devices(self) -> int:
        return self.data * self.model


def plan_remesh(alive_devices: int, prefer_model: int = 16,
                min_model: int = 2) -> MeshPlan:
    """Largest (data × model) grid fitting the surviving devices, preferring
    deep pipelines, then data width."""
    best = None
    m = prefer_model
    while m >= min_model:
        d = alive_devices // m
        if d >= 1:
            plan = MeshPlan(data=d, model=m)
            if best is None or plan.devices > best.devices:
                best = plan
        m //= 2
    if best is None:
        raise ValueError(f"cannot build a mesh from {alive_devices} devices")
    return best


def remap_stages(num_stages: int, dead) -> list[int]:
    """Host assignment after losing the device(s) hosting ``dead`` stage(s).

    Every stage keeps its logical identity; each dead stage's actor is
    re-hosted on the nearest *surviving* neighbor's device (ties toward the
    lower index).  ``plan_remesh`` validates that the surviving device set
    still admits a mesh at all.  Returns ``host_of``: stage index -> hosting
    device (device ids are the original stage indices).
    """
    dead_set = {dead} if isinstance(dead, int) else set(dead)
    for d in dead_set:
        if not (0 <= d < num_stages):
            raise ValueError(f"dead stage {d} outside 0..{num_stages - 1}")
    alive = num_stages - len(dead_set)
    if alive < 1 or num_stages < 2:
        raise ValueError(
            f"cannot re-map {num_stages}-stage pipeline with "
            f"{len(dead_set)} dead stages")
    plan_remesh(alive, prefer_model=alive, min_model=1)
    survivors = [s for s in range(num_stages) if s not in dead_set]
    host_of = list(range(num_stages))
    for d in dead_set:
        host_of[d] = min(survivors, key=lambda s: (abs(s - d), s))
    return host_of


def relayout_stage_params(old_model: ArchModel, new_num_stages: int,
                          stage_params_host):
    """Re-distribute per-layer params [S_old, l_max_old, ...] onto a new
    stage count (host-side).  ``stage_params_host`` is the reference-layout
    tree of numpy leaves that the port's checkpoints hold
    (``convert.params_to_reference``); returns ``(new ArchModel, tree)``,
    the tree in the new ``[S_new, l_max_new, ...]`` layout (zeros in
    disabled slots), for ``convert.params_from_reference``."""
    cfg = old_model.cfg
    new_model = build(cfg, num_stages=new_num_stages)
    old_gli = global_layer_index(old_model.counts)
    new_gli = global_layer_index(new_model.counts)
    # map: global layer -> (old stage, old slot)
    where_old = {}
    for s in range(old_model.num_stages):
        for i in range(old_model.l_max):
            g = old_gli[s, i]
            if g >= 0:
                where_old[g] = (s, i)

    def remap(leaf):
        leaf = np.asarray(leaf)
        out = np.zeros((new_model.num_stages, new_model.l_max) + leaf.shape[2:],
                       leaf.dtype)
        for s in range(new_model.num_stages):
            for i in range(new_model.l_max):
                g = new_gli[s, i]
                if g >= 0:
                    so, io_ = where_old[g]
                    out[s, i] = leaf[so, io_]
        return out

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return remap(tree)

    return new_model, walk(stage_params_host)
