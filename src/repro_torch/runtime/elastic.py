"""Elastic re-mapping for the actor runtime's recovery path (numpy only).

The port's counterpart of the reference ``runtime/elastic.py`` keeps only
what the runtime driver needs on its remap path: ``plan_remesh`` (the
largest feasible (data x model) grid) and ``remap_stages`` (fold dead
stages onto their nearest survivors).  ``relayout_stage_params`` moves
with a later multi-device slice (ROADMAP queue 1, item 18d).
"""
from __future__ import annotations

import dataclasses


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
