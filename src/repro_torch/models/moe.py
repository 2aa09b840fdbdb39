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
(``tp``) layouts spread the routed experts over the ``data`` axis: under
``ep`` a rank holds ``E / A`` whole experts (``A`` the axis size) and
tokens travel both ways by ``all_to_all``; under ``tp`` it holds every
expert's ``f / A`` slice, gathers every rank's buffers (``all_gather``)
and reduce-scatters the partial outputs (``psum_scatter``).  Over one rank
both compute the layout ``none`` function.  A layer over more ranks is
three phases cut at its two exchanges (:func:`moe_phases`, for
``models/phases.py``), so that the exchanges and their transposes are
called by the rank's thread, never inside an autograd backward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import ArchConfig
from repro_torch.models.layers import FFN, dense_param, ffn_block
from repro_torch.models.phases import Cut

#: the routed-expert leaves a layout shards over the data axis
EXPERT_KEYS = ("wi", "wg", "wo")
#: each layout's two exchanges (the dispatch's, then the combine's)
CUTS = {"ep": (Cut("buf", "all_to_all"), Cut("buf", "all_to_all")),
        "tp": (Cut("buf", "all_gather"), Cut("buf", "psum_scatter"))}


def sharded(layout: str, axis_size: int) -> bool:
    """Whether ``layout`` over ``axis_size`` ranks spreads the experts."""
    if layout not in ("none", "ep", "tp"):
        raise ValueError(layout)
    return layout != "none" and axis_size > 1


def expert_shard_dim(name: str, layout: str) -> int | None:
    """The dim of an expert leaf (``wi``/``wg`` ``[E, d, f]``, ``wo`` ``[E,
    f, d]``) that ``layout`` shards: E under ``ep``, f under ``tp``."""
    if name not in EXPERT_KEYS or layout == "none":
        return None
    if layout == "ep":
        return 0
    return 2 if name in ("wi", "wg") else 1


def take_shard(a, dim: int, parts: int, index: int):
    """Part ``index`` of ``parts`` equal parts of ``a`` (a tensor or a
    numpy array) along ``dim``."""
    n = a.shape[dim] // parts
    sl = [slice(None)] * len(a.shape)
    sl[dim] = slice(index * n, (index + 1) * n)
    return a[tuple(sl)]


class MoEFFN(nn.Module):
    """Router (float32 in every model dtype), per-expert ``wi``/``wo`` (and
    ``wg`` for GLU acts) ``[E, d, f]`` / ``[E, f, d]``, and ``shared{i}``
    FFNs: the reference's ``init_moe_ffn`` leaves.

    With ``layout`` ``ep``/``tp`` over ``data_size > 1`` ranks the module
    holds one rank's shard: ``wi``/``wg``/``wo`` of ``[E / data_size, d,
    f]`` / ``[E / data_size, f, d]`` under ``ep``, ``[E, d, f /
    data_size]`` / ``[E, f / data_size, d]`` under ``tp``.  A seeded init
    draws the whole layer, so a shard is allocated (``gen`` None) and
    loaded from one (``ArchModel.shard_stage_params``)."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator | None, device,
                 *, layout: str = "none", data_size: int = 1):
        super().__init__()
        moe = cfg.moe
        d, f, e = cfg.d_model, cfg.d_ff, moe.num_experts
        shapes = {"wi": [e, d, f], "wo": [e, f, d]}
        if cfg.act in ("swiglu", "geglu"):
            shapes["wg"] = [e, d, f]
        if sharded(layout, data_size):
            if gen is not None:
                raise ValueError("a seeded init draws the whole layer: "
                                 "allocate the shard (gen=None) and load it")
            for name, shape in shapes.items():
                dim = expert_shard_dim(name, layout)
                if shape[dim] % data_size:
                    raise ValueError(
                        f"MoE layout {layout!r} over {data_size} data "
                        f"ranks: {'num_experts' if dim == 0 else 'd_ff'} "
                        f"{shape[dim]} does not divide by {data_size}")
                shape[dim] //= data_size
        self.router = dense_param(gen, (d, moe.num_experts), torch.float32,
                                  device)
        for name, shape in shapes.items():  # wi, wo, wg: the draw order
            setattr(self, name, dense_param(gen, tuple(shape), cfg.dtype,
                                            device))
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


def _capacity(T: int, cfg: ArchConfig) -> int:
    """Slots per expert from this rank's ``T`` tokens (every layout)."""
    moe = cfg.moe
    return max(1, int(T * moe.top_k / moe.num_experts * moe.capacity_factor))


def moe_dispatch(p: MoEFFN, x, cfg: ArchConfig, layout: str,
                 axis_size: int) -> dict:
    """The first phase of an exchanging layer, x: [b, s, d] -> the state
    entries ``w`` (router weights), the integer ``idx``/``slot``/``valid``,
    ``shared{i}`` (the shared experts' outputs) and ``buf``, the payload
    of the first exchange: ``[A, E / A, C, d]`` under ``ep`` (row ``i``
    for rank ``i``'s experts), the ``[E, C, d]`` buffers under ``tp``."""
    moe = cfg.moe
    x2 = x.reshape(-1, x.shape[-1])
    w, idx = _route(x2, p.router, moe.top_k)
    capacity = _capacity(x2.shape[0], cfg)
    buffers, slot, valid = _dispatch(x2, idx, capacity, moe.num_experts)
    if layout == "ep":
        buffers = buffers.reshape(axis_size, moe.num_experts // axis_size,
                                  capacity, x2.shape[1])
    st = {"w": w, "idx": idx, "slot": slot, "valid": valid, "buf": buffers}
    for i in range(moe.num_shared):
        st[f"shared{i}"] = ffn_block(getattr(p, f"shared{i}"), x2, cfg.act)
    return st


def moe_experts(p: MoEFFN, recv, cfg: ArchConfig, layout: str):
    """The middle phase: this rank's experts over every rank's tokens.
    ``recv`` is ``[A, E / A, C, d]`` (row ``i`` from rank ``i``) under
    ``ep``, ``[A, E, C, d]`` under ``tp``; the result has the same layout,
    the second exchange's payload (under ``tp`` partial sums over this
    rank's ``f`` slice)."""
    a, e, c, d = recv.shape
    eb = recv.movedim(0, 1).reshape(e, a * c, d)
    out = _expert_ffn(p, eb, cfg.act)
    return out.reshape(e, a, c, d).movedim(1, 0)


def moe_combine(st: dict, cfg: ArchConfig, shape, dtype):
    """The last phase: the exchanged-back ``buf`` (``[A, E / A, C, d]``
    under ``ep``, ``[E, C, d]`` under ``tp``) gathered to the tokens,
    weighted by the router, plus the shared experts: ``[b, s, d]``."""
    moe = cfg.moe
    back = st["buf"]
    out_buf = back.reshape(moe.num_experts, back.shape[-2], back.shape[-1])
    y = _combine(out_buf, st["idx"], st["slot"], st["valid"], st["w"])
    for i in range(moe.num_shared):
        y = y + st[f"shared{i}"]
    return y.reshape(shape).to(dtype)


def moe_ffn(p: MoEFFN, x, cfg: ArchConfig, *, layout: str = "none",
            axis_size: int = 1):
    """x: [b, s, d] -> [b, s, d].  Over one rank every layout is the
    ``none`` function; ``ep``/``tp`` over ``axis_size > 1`` ranks
    exchange tokens over the data group and run cut at the exchanges,
    :func:`moe_phases`, so this raises."""
    if sharded(layout, axis_size):
        raise ValueError(f"MoE layout {layout!r} over {axis_size} ranks "
                         f"exchanges tokens over the data group: run it "
                         f"cut at its exchanges (moe_phases, "
                         f"models/phases.py)")
    moe = cfg.moe
    b, s, d = x.shape
    x2 = x.reshape(-1, d)
    w, idx = _route(x2, p.router, moe.top_k)
    buffers, slot, valid = _dispatch(x2, idx, _capacity(x2.shape[0], cfg),
                                     moe.num_experts)
    y = _combine(_expert_ffn(p, buffers, cfg.act), idx, slot, valid, w)
    for i in range(moe.num_shared):
        y = y + ffn_block(getattr(p, f"shared{i}"), x2, cfg.act)
    return y.reshape(b, s, d).to(x.dtype)


def moe_phases(p: MoEFFN, cfg: ArchConfig, layout: str, axis_size: int):
    """``(phases, cuts)`` of one exchanging layer (``models/phases.py``):
    three phases on states whose entry ``h`` is the layer's input ``[b, s,
    d]`` and, after the last, its output; every other entry passes
    through (a caller's residual stream)."""
    carried = ("w", "idx", "slot", "valid", "buf",
               *(f"shared{i}" for i in range(cfg.moe.num_shared)))

    def dispatch(st):
        return {**st, **moe_dispatch(p, st["h"], cfg, layout, axis_size)}

    def experts(st):
        return {**st, "buf": moe_experts(p, st["buf"], cfg, layout)}

    def combine(st):
        h = st["h"]
        y = moe_combine(st, cfg, h.shape, h.dtype)
        return {**{k: v for k, v in st.items() if k not in carried}, "h": y}

    return [dispatch, experts, combine], CUTS[layout]
