"""AdamW: the host actor runtime's, and ZeRO-1 on a mesh (PyTorch port).

Port of ``repro.optim.adamw``: float32 m/v and update arithmetic,
parameters cast back to their own dtype.  ``make_host_update`` serves the
actor runtime (one device, unsharded).  ``make_optimizer`` is the
schedule-table executor's ZeRO-1 optimizer (DESIGN §3): data-replicated
parameters keep float32 master/m/v only on their per-leaf reduce-scatter
shard; the executor emits per-leaf grad shards, the optimizer updates each
shard and all-gathers the refreshed leaf.  Data-sharded leaves (EP/TP
experts) update locally with their own m/v (``expert_state_dtype``).
Unlike the reference (pure functions returning new pytrees) the port
updates parameters and optimizer state in place, which halves the
optimizer's peak memory.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.pipeline.sharding import ParamPartition, flat_leaf


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    expert_state_dtype: Any = torch.float32


def lr_at(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup then cosine decay to ``min_lr_frac`` (float32 math)."""
    f = np.float32
    s = f(step)
    warm = min(f(1.0), (s + f(1.0)) / f(max(cfg.warmup_steps, 1)))
    prog = np.clip((s - f(cfg.warmup_steps))
                   / f(max(cfg.total_steps - cfg.warmup_steps, 1)),
                   f(0.0), f(1.0))
    cos = f(cfg.min_lr_frac) + (f(1.0) - f(cfg.min_lr_frac)) * f(0.5) * (
        f(1.0) + np.cos(f(np.pi) * prog))
    return float(f(cfg.lr) * warm * cos)


def _adamw_update(cfg: AdamWConfig, p, g, m, v, step: int, lr: float,
                  scale: float = 1.0):
    """One AdamW step on float32 tensors; returns new (p, m, v) and leaves
    the inputs as they are.

    The reference's expression, one operation at a time in its order, each
    on a tensor this function made (the same bits): a leaf's update holds
    at most four leaf-sized temporaries at once where the single expression
    held eight, which decides whether the four ranks of a 1 x 4 mesh on one
    card can update their copies of a 256 k-vocab embedding together.
    """
    f = np.float32
    g = g.float() * scale
    m = m * cfg.beta1
    m.add_(g * (1 - cfg.beta1))
    gg = g * (1 - cfg.beta2)
    gg.mul_(g)
    del g
    v = v * cfg.beta2
    v.add_(gg)
    del gg
    upd = m / float(f(1.0) - f(cfg.beta1) ** f(step + 1))
    vh = v / float(f(1.0) - f(cfg.beta2) ** f(step + 1))
    upd.div_(vh.sqrt_().add_(cfg.eps))
    del vh
    upd.add_(p * cfg.weight_decay)
    return p - upd.mul_(lr), m, v


def make_host_update(opt_cfg: AdamWConfig):
    """``apply_update(params, grads, m, v, step) -> lr`` over parallel lists.

    Updates ``params`` (their own dtype) and the float32 ``m``/``v`` in
    place.  A ``None`` gradient is a zero gradient (weight decay and the
    moment decay still apply, as for the reference's zero cotangents).
    """

    @torch.no_grad()
    def apply_update(params, grads, m, v, step: int) -> float:
        lr = lr_at(opt_cfg, step)
        for p, g, m_, v_ in zip(params, grads, m, v, strict=True):
            if g is None:
                g = torch.zeros_like(p)
            p32, m2, v2 = _adamw_update(opt_cfg, p.float(), g, m_, v_, step,
                                        lr)
            p.copy_(p32.to(p.dtype))
            m_.copy_(m2)
            v_.copy_(v2)
        return lr

    return apply_update


# ---------------------------------------------------------------------------
def make_optimizer(model, mesh, partition: ParamPartition,
                   opt_cfg: AdamWConfig, dp_axes: tuple = ("data",)):
    """Returns ``(init_fn, update_fn)``, the per-leaf ZeRO-1 optimizer's
    rank programs (run on every rank by ``mesh.run``, the reference's
    ``shard_map``):

    * ``init_fn(stage_params, io) -> opt_state``: ``{"shards": {leaf:
      {"master", "m", "v"}}, "experts": {leaf: {"m", "v"}}}``, a shard a
      float32 vector of ``ceil(leaf size / dp_total)`` (this rank's slice of
      the padded flat leaf), an expert state the stacked ``[l_max, ...]``
      leaf in ``expert_state_dtype``;
    * ``update_fn(stage_params, io, opt_state, grad_shards, expert_grads,
      step) -> stats`` (``gnorm``, ``lr``): global-norm clipping, AdamW on
      each shard, then the all-gathered leaf written into the parameters;
      parameters and ``opt_state`` are updated in place.
    """
    dp_axes = tuple(dp_axes)
    dp_total = mesh.group_size(dp_axes)
    S = model.num_stages
    flags = partition.stage_data_sharded
    shard_keys = [k for k in partition.stage_keys if not flags[k]]
    shard_keys += ["io:" + k for k in partition.io_keys]
    expert_keys = [k for k in partition.stage_keys if flags[k]]

    def _my_shard(vec):
        v = F.pad(vec.float(), (0, (-vec.numel()) % dp_total))
        return v.reshape(dp_total, -1)[mesh.group_index(dp_axes)].clone()

    def _leaf_items(sp, io):
        """(key, slot parameters) in executor grad-shard order."""
        items = [(k, slots) for k, slots in
                 partition.stage_leaves(sp.parameters()).items()
                 if not flags[k]]
        items += [("io:" + k, [p]) for k, p in
                  partition.io_leaves(io.parameters()).items()]
        return items

    def _expert_items(sp):
        return [(k, slots) for k, slots in
                partition.stage_leaves(sp.parameters()).items() if flags[k]]

    # ---------------- init --------------------------------------------
    @torch.no_grad()
    def init_fn(stage_params, io) -> dict:
        shards = {}
        for k, slots in _leaf_items(stage_params, io):
            m0 = _my_shard(flat_leaf(slots))
            shards[k] = {"master": m0, "m": torch.zeros_like(m0),
                         "v": torch.zeros_like(m0)}
        experts = {}
        for k, slots in _expert_items(stage_params):
            shape = (len(slots),) + tuple(slots[0].shape)
            experts[k] = {
                "m": torch.zeros(shape, dtype=opt_cfg.expert_state_dtype,
                                 device=slots[0].device),
                "v": torch.zeros(shape, dtype=opt_cfg.expert_state_dtype,
                                 device=slots[0].device),
            }
        return {"shards": shards, "experts": experts}

    # ---------------- update ------------------------------------------
    @torch.no_grad()
    def update_fn(stage_params, io, opt_state, grad_shards, expert_grads,
                  step: int) -> dict:
        lr = lr_at(opt_cfg, step)
        device = next(io.parameters()).device

        # global grad norm: stage segments distinct across model rows; io
        # segments replicated across rows (weight 1/S).
        sq = torch.zeros((), dtype=torch.float32, device=device)
        for k in shard_keys:
            g = grad_shards[k].float()
            w = 1.0 / S if k.startswith("io:") else 1.0
            sq = sq + w * torch.sum(g * g)
        for k in expert_keys:
            eg = expert_grads[k].float()
            sq = sq + torch.sum(eg * eg)
        gnorm = torch.sqrt(mesh.psum(sq, ("model",) + dp_axes))
        scale = torch.clamp(opt_cfg.grad_clip / (gnorm + 1e-12), max=1.0)

        # per-leaf shard update + all-gather of the refreshed leaves
        for k, slots in _leaf_items(stage_params, io):
            st = opt_state["shards"][k]
            st["master"], st["m"], st["v"] = _adamw_update(
                opt_cfg, st["master"], grad_shards[k], st["m"], st["v"],
                step, lr, scale)
            full = mesh.all_gather(st["master"].to(slots[0].dtype), dp_axes)
            off = 0
            for p in slots:
                p.copy_(full[off:off + p.numel()].view(p.shape))
                off += p.numel()

        # slot by slot (elementwise: the same bits as the stacked leaf),
        # so that the temporaries are one slot's, not the leaf's: four
        # ranks of a full-width MoE mesh update their experts together
        for k, slots in _expert_items(stage_params):
            st = opt_state["experts"][k]
            for i, p in enumerate(slots):
                pn, mn, vn = _adamw_update(
                    opt_cfg, p.float(), expert_grads[k][i],
                    st["m"][i].float(), st["v"][i].float(), step, lr, scale)
                p.copy_(pn.to(p.dtype))
                st["m"][i].copy_(mn)
                st["v"][i].copy_(vn)
                del pn, mn, vn
        return {"gnorm": gnorm, "lr": lr}

    return init_fn, update_fn
