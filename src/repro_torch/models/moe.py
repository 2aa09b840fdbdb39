"""Mixture-of-Experts FFN with static-capacity dispatch (PyTorch port).

Port of ``repro.models.moe`` on one device.  Tokens are routed to their
top-k experts (softmax over the k router logits), scattered into
``[E, C, d]`` expert buffers by their position in the expert (a cumsum of
the one-hot assignment, never a one-hot matmul, so dispatch stays linear in
tokens), run through every expert's FFN as batched products, and gathered
back weighted by the router.  Tokens past an expert's capacity ``C`` are
dropped.  Shared experts (deepseek-moe) are plain FFNs every token takes.

The dispatch keeps the reference's structure so that its sums are exact
whatever order the card's atomics take: every valid ``(expert, slot)`` is
written once, and a dropped token adds zeros into its expert's last slot;
in the backward of the combine, a dropped token's gradient row is zero
(router weight 0).  So split = fused and chaotic = fixed order stay bitwise
with an MoE stage.

The reference's expert-parallel (``ep``) and expert-tensor-parallel
(``tp``) layouts exchange tokens between devices; on one device
(``axis_size == 1``) both compute the layout ``none`` function, and more
devices move with the ``torch.distributed`` mesh backend (ROADMAP.md queue
1, item 18a).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import ArchConfig
from repro_torch.models.layers import FFN, dense_param, ffn_block


class MoEFFN(nn.Module):
    """Router (float32 in every model dtype), per-expert ``wi``/``wo`` (and
    ``wg`` for GLU acts) ``[E, d, f]`` / ``[E, f, d]``, and ``shared{i}``
    FFNs: the reference's ``init_moe_ffn`` leaves."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator | None, device):
        super().__init__()
        moe = cfg.moe
        d, f, e = cfg.d_model, cfg.d_ff, moe.num_experts
        self.router = dense_param(gen, (d, e), torch.float32, device)
        self.wi = dense_param(gen, (e, d, f), cfg.dtype, device)
        self.wo = dense_param(gen, (e, f, d), cfg.dtype, device)
        if cfg.act in ("swiglu", "geglu"):
            self.wg = dense_param(gen, (e, d, f), cfg.dtype, device)
        for i in range(moe.num_shared):
            setattr(self, f"shared{i}", FFN(cfg, gen, device))


def _route(x2, router, top_k: int):
    """x2: [T, d] -> (weights [T, k] float32, experts [T, k]) with the
    softmax over the top-k logits, largest first (``lax.top_k``'s order)."""
    logits = x2.float() @ router  # [T, E]
    w, idx = torch.topk(logits, top_k, dim=-1, sorted=True)
    return torch.softmax(w, dim=-1), idx


def _dispatch(x2, idx, capacity: int, num_experts: int):
    """Scatter tokens into ``[E, C, d]`` expert buffers.

    Returns (buffers, slot [T, k], valid [T, k]).  Over-capacity tokens are
    dropped: they add zeros into slot ``C - 1`` (exact in any order).
    """
    T, k = idx.shape
    flat_e = idx.reshape(-1)  # [T*k]
    onehot = F.one_hot(flat_e, num_experts)  # [T*k, E]
    pos = torch.cumsum(onehot, dim=0) - 1  # position within expert
    slot = torch.gather(pos, 1, flat_e[:, None])[:, 0]
    valid = slot < capacity
    slot_c = torch.where(valid, slot, capacity - 1)
    tok = torch.arange(T, device=x2.device).repeat_interleave(k)
    src = torch.where(valid[:, None], x2[tok], 0).to(x2.dtype)
    buffers = x2.new_zeros((num_experts, capacity, x2.shape[1]))
    buffers = buffers.index_put((flat_e, slot_c), src, accumulate=True)
    return buffers, slot_c.reshape(T, k), valid.reshape(T, k)


def _combine(out_buffers, idx, slot, valid, weights):
    """Gather expert outputs back to tokens and mix with router weights."""
    T, k = idx.shape
    gathered = out_buffers[idx.reshape(-1), slot.reshape(-1)]  # [T*k, d]
    gathered = gathered.reshape(T, k, -1)
    w = (weights * valid).to(gathered.dtype)
    return torch.einsum("tkd,tk->td", gathered, w)


def _expert_ffn(p: MoEFFN, buffers, act: str):
    """buffers: [E, C, d] -> [E, C, d] through each expert's FFN (GELU in
    its tanh form, ``jax.nn.gelu``'s default, as ``ffn_block``)."""
    h = torch.bmm(buffers, p.wi)
    if hasattr(p, "wg"):
        g = torch.bmm(buffers, p.wg)
        h = (F.silu(g) if act == "swiglu"
             else F.gelu(g, approximate="tanh")) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, p.wo)


def moe_ffn(p: MoEFFN, x, cfg: ArchConfig, *, layout: str = "none",
            axis_size: int = 1):
    """x: [b, s, d] -> [b, s, d].

    ``layout`` ``ep``/``tp`` with ``axis_size > 1`` spread the experts over
    devices and raise; over one device they are the ``none`` function (the
    exchanges are identities with the same capacity).
    """
    if layout not in ("none", "ep", "tp"):
        raise ValueError(layout)
    if layout != "none" and axis_size > 1:
        raise NotImplementedError(
            f"MoE layout {layout!r} over {axis_size} devices moves with the "
            f"torch.distributed mesh backend (ROADMAP.md queue 1, item 18a)")
    moe = cfg.moe
    b, s, d = x.shape
    x2 = x.reshape(-1, d)
    T = x2.shape[0]
    w, idx = _route(x2, p.router, moe.top_k)
    capacity = max(1, int(T * moe.top_k / moe.num_experts
                          * moe.capacity_factor))
    buffers, slot, valid = _dispatch(x2, idx, capacity, moe.num_experts)
    y = _combine(_expert_ffn(p, buffers, cfg.act), idx, slot, valid, w)
    for i in range(moe.num_shared):
        y = y + ffn_block(getattr(p, f"shared{i}"), x2, cfg.act)
    return y.reshape(b, s, d).to(x.dtype)
