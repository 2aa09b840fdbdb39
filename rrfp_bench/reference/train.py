"""The reference's training steps and the readings a run is judged by.

``train`` follows the program's first steps from the same weights
(:mod:`rrfp_bench.harness.weights`) and the same batches
(:mod:`rrfp_bench.reference.data`; supplied embeddings rounded to the
model's dtype, as the program takes them): the mean token cross-entropy of
the whole step, its float32 gradient summed over the microbatches, and AdamW
as the configuration states it (float32 moments and arithmetic, the
parameters kept in their own dtype between steps).  AdamW and its
learning-rate schedule are frozen copies of ``lr_at`` and
``_adamw_update`` (``src/repro_torch/optim/adamw.py:41-84``), with the
defaults of its ``AdamWConfig`` and the schedule the actor launcher gives
it (``src/repro_torch/launch/train.py:428``: warm-up over ``min(20,
steps)`` steps, cosine over ``steps``); the actor path does not clip.

The model is the configuration's family's ``Reference``.  Matrix
products run in float32 with TF32 off (``precision="fp64"``: the whole
reference in float64, a witness for tests at toy sizes).  The rows run one
at a time (the sum is the same), or a microbatch at a time where the
family says the model needs it (a MoE model: an expert's capacity is
counted over one microbatch's tokens).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rrfp_bench.harness import manifest
from rrfp_bench.harness.weights import (DTYPES, draw, draw_all, leaf_key,
                                        leaves)
from rrfp_bench.reference import data
from rrfp_bench.yardstick.flops import padded_vocab

BETA1, BETA2, EPS, WEIGHT_DECAY, MIN_LR_FRAC = 0.9, 0.95, 1e-8, 0.1, 0.1


@dataclasses.dataclass
class Readings:
    """What one side of a comparison reports of the first steps."""
    losses: list[float]
    #: step 0's gradient norm per leaf slice, as the optimizer gets it
    grad_norms: dict[str, float]
    #: the norm of each leaf slice's change over the steps run
    change_norms: dict[str, float]


def lr_at(lr: float, step: int, warmup: int, total: int) -> float:
    f = np.float32
    s = f(step)
    warm = min(f(1.0), (s + f(1.0)) / f(max(warmup, 1)))
    prog = np.clip((s - f(warmup)) / f(max(total - warmup, 1)),
                   f(0.0), f(1.0))
    cos = f(MIN_LR_FRAC) + (f(1.0) - f(MIN_LR_FRAC)) * f(0.5) * (
        f(1.0) + np.cos(f(np.pi) * prog))
    return float(f(lr) * warm * cos)


@torch.no_grad()
def adamw(p: torch.Tensor, g, m, v, step: int, lr: float) -> torch.Tensor:
    """One AdamW step of float32 ``p`` (returned) and ``m``, ``v`` (in
    place)."""
    f = np.float32
    m.mul_(BETA1).add_(g * (1 - BETA1))
    v.mul_(BETA2).add_(g * (1 - BETA2) * g)
    upd = m / float(f(1.0) - f(BETA1) ** f(step + 1))
    vh = v / float(f(1.0) - f(BETA2) ** f(step + 1))
    upd.div_(vh.sqrt_().add_(EPS))
    upd.add_(p * WEIGHT_DECAY)
    return p - upd.mul_(lr)


def _norm(t: torch.Tensor) -> torch.dtype:
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def slice_norms(leaf, t: torch.Tensor) -> dict[str, torch.Tensor]:
    """Float32 norm of each layer's slice of a stacked leaf (of the whole
    of an IO leaf), as device scalars."""
    if leaf.layers is None:
        return {leaf.path: torch.linalg.vector_norm(t, dtype=_norm(t))}
    n = torch.linalg.vector_norm(t.flatten(1), dim=1, dtype=_norm(t))
    return {leaf_key(leaf.path, g): n[r] for r, g in enumerate(leaf.layers)}


def to_host(norms: dict[str, torch.Tensor]) -> dict[str, float]:
    keys = list(norms)
    vals = torch.stack([norms[k] for k in keys]).cpu().tolist()
    return dict(zip(keys, vals))


def halve(arrays: dict) -> dict:
    """The batch's second half of rows replaced by its first, in each of
    its arrays: the step's mean is then the mean over half of the batch (a
    planted fault)."""
    out = {}
    for k, a in arrays.items():
        half, a = a.shape[0] // 2, a.copy()
        a[half:2 * half] = a[:half]
        out[k] = a
    return out


def _zero_if_none(g, p):
    return torch.zeros_like(p) if g is None else g


def train(c: dict, traffic: dict, *, seed: int, device, lr: float,
          total_steps: int, steps: int = 3, precision: str = "fp32",
          fault: str | None = None) -> Readings:
    """``steps`` reference training steps from the seed's weights."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    #: the arithmetic's type: float32, or float64 for a witness of how far
    #: float32's own rounding reaches
    work = torch.float64 if precision == "fp64" else torch.float32
    specs = leaves(c)
    stored = draw_all(c, seed, device)
    rows = {lf.path: {g: r for r, g in enumerate(lf.layers)}
            for lf in specs if lf.layers is not None}
    m = {k: torch.zeros(t.shape, dtype=work, device=device)
         for k, t in stored.items()}
    v = {k: torch.zeros_like(t) for k, t in m.items()}
    batch = traffic["microbatches"] * traffic["mb_rows"]
    seq = traffic["seq"]
    fam = manifest.family(c)
    block = traffic["mb_rows"] if fam.per_microbatch(c) else 1
    warmup = min(20, total_steps)
    losses, grad_norms = [], {}
    for step in range(steps):
        params = {k: t.to(work).requires_grad_()
                  for k, t in stored.items()}
        model = fam.Reference(c, params, rows, precision)
        arrays = data.batch(padded_vocab(c), batch, seq, seed=seed,
                            step=step,
                            embed_d=c["d_model"] if c.get("embed_input")
                            else 0)
        if fault == "half_batch":
            arrays = halve(arrays)
        tokens = torch.from_numpy(arrays["tokens"]).to(device)
        labels = torch.from_numpy(arrays["labels"]).to(device)
        embeds = None
        if "embeds" in arrays:
            # the inputs as the model takes them: in its dtype
            embeds = (torch.from_numpy(arrays["embeds"]).to(device)
                      .to(DTYPES[c["dtype"]]).to(work))
        total = torch.zeros((), dtype=work, device=device)
        for r in range(0, batch, block):
            part = model.loss_sum(
                tokens[r:r + block], labels[r:r + block],
                None if embeds is None else embeds[r:r + block])
            (part / (batch * seq)).backward()
            total += part.detach()
        losses.append(float(total) / (batch * seq))
        if step == 0:
            grad_norms = to_host({k: n for lf in specs for k, n in
                                  slice_norms(lf, _zero_if_none(
                                      params[lf.path].grad,
                                      params[lf.path])).items()})
        lr_step = lr_at(lr, step, warmup, total_steps)
        for k in stored:
            g = _zero_if_none(params[k].grad, params[k])
            new = adamw(params[k].detach(), g, m[k], v[k], step, lr_step)
            stored[k] = new.to(stored[k].dtype)
        del params, model
    change = {}
    for i, lf in enumerate(specs):
        start = draw(lf, i, seed, device)
        change.update(slice_norms(lf, stored[lf.path].to(work)
                                  - start.to(work)))
        del start
    return Readings(losses, grad_norms, to_host(change))
