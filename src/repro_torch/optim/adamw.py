"""AdamW for the host actor runtime (PyTorch port, single device).

Port of ``AdamWConfig``, ``lr_at``, ``_adamw_update`` and
``make_host_update`` of ``repro.optim.adamw``: float32 m/v and update
arithmetic, parameters cast back to their own dtype.  Unlike the reference
(pure functions returning new pytrees) the port updates parameters and
optimizer state in place, which halves the optimizer's peak memory.  The
ZeRO-1 sharded ``make_optimizer`` moves with the multi-device slice, with
the config fields only it reads (``grad_clip``, ``expert_state_dtype``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


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
    """One AdamW step on float32 tensors; returns (p, m, v)."""
    f = np.float32
    g = g.float() * scale
    m = cfg.beta1 * m + (1 - cfg.beta1) * g
    v = cfg.beta2 * v + (1 - cfg.beta2) * g * g
    mh = m / float(f(1.0) - f(cfg.beta1) ** f(step + 1))
    vh = v / float(f(1.0) - f(cfg.beta2) ** f(step + 1))
    upd = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p
    return p - lr * upd, m, v


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
