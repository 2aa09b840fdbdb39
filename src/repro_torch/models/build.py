"""Arch registry: ArchConfig -> ArchModel.

Port of ``repro.models.build``.  The layout is the reference's: layers
spread over stages by ``stage_layout``, per-slot ``type_ids`` (-1 =
disabled slot of an uneven stage) and the ``rows`` an executor consumes.
Parameters are ``nn.Module``s: one :class:`StageParams` per stage and one
:class:`IOParams`, named so that they map one-to-one onto the reference's
stacked pytree, e.g. ``slots.{i}.blk.attn.wq`` of stage ``s`` is
``stage_params['blk']['attn']['wq'][s, i]`` (see ``models/convert.py``).

The port runs every layer kind of the reference forward and decode: the
attention kinds (``attn``, ``attn_local``, ``attn_global``), the MoE
families' ``moe`` and ``dense`` layers (attention, then routed experts or
a dense FFN), Mamba-2 layers (``mamba``) with zamba2's shared attention
block (``io.shared_blk``, applied before every ``shared_attn_period``-th
layer), xLSTM's ``mlstm`` and ``slstm`` blocks, and the enc-dec kinds: an
activation is ``concat(dec, enc)`` along the sequence, split at
``aux["dec_len"]``; ``enc`` runs a non-causal decoder layer over the
encoder frames, ``dec`` causal self-attention, cross-attention against
the frames (non-causal, no RoPE) and the FFN over the decoder tokens.  The
MoE layouts over more than one data rank (``moe_layout`` ``ep``/``tp``;
one rank computes them as ``none``): a stage's modules hold its rank's
expert shard (``init_stage_params(data_size=...)``,
:meth:`ArchModel.shard_stage_params`), and the stage, forward and
backward, runs cut at its exchanges (:meth:`ArchModel.stage_phases`,
``models/phases.py``); :meth:`ArchModel.stage_forward` refuses it.

Decode caches are trees of nested dicts, one per stage, each leaf stacked
``[l_max, batch, ...]`` (the reference's ``[S, l_max, ...]`` tree holds one
per stage), and ``stage_decode`` updates them in place.  At decode (no
autograd) an MoE layer under an expert layout over more than one data rank
runs its phases with ``aux["exchange"]`` in between, and the attention
kinds take ``aux["sp_axis"]``, the rank's group over a sequence-sharded
cache (``pipeline/decode.py``).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models.common import (
    ArchConfig,
    ShapeCell,
    global_layer_index,
    stage_layout,
)
from repro_torch.models.layers import (
    FFN,
    Attention,
    DecoderLayer,
    arange_positions,
    attention_block,
    decode_attention_block,
    decoder_layer,
    decoder_layer_decode,
    dense_param,
    ffn_block,
    rmsnorm,
    zeros_param,
)
from repro_torch.models.moe import (
    MoEFFN,
    expert_shard_dim,
    moe_ffn,
    moe_phases,
    sharded,
    take_shard,
)
from repro_torch.models.phases import chain, run_forward
from repro_torch.models.ssm import (
    MambaLayer,
    init_mamba_cache,
    mamba_layer,
    mamba_layer_decode,
)
from repro_torch.models.xlstm import (
    MLSTMLayer,
    SLSTMLayer,
    init_mlstm_cache,
    init_slstm_cache,
    mlstm_layer,
    mlstm_layer_decode,
    slstm_layer,
    slstm_layer_decode,
)

ATTN_KINDS = ("attn", "attn_local", "attn_global")
MOE_KINDS = ("moe", "dense")


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (the decode cache trees)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def make_generator(seed: int, salt: int, device) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(seed * 1_000_003 + salt)
    return gen


class LayerSlot(nn.Module):
    """Union parameters of one layer slot over the arch's layer kinds (the
    reference's ``init_layer_params``): ``blk`` for the attention and
    enc-dec kinds, ``cross_ln`` and ``cross`` (cross-attention, no biases)
    for ``dec``; ``ln1``, ``attn``, ``ln2`` and ``moe`` (routed experts)
    and/or ``dense_ffn`` (``moe.dense_d_ff`` wide) for ``moe``/``dense``;
    ``mamba``, ``mlstm`` and ``slstm`` for their kinds.  ``layout`` and
    ``data_size`` size the routed experts as one rank's shard
    (:class:`~repro_torch.models.moe.MoEFFN`)."""

    def __init__(self, cfg: ArchConfig, layer_types, gen, device, *,
                 layout: str = "none", data_size: int = 1):
        super().__init__()
        types = set(layer_types)
        if types & {*ATTN_KINDS, "enc", "dec"}:
            self.blk = DecoderLayer(cfg, gen, device)
        if "dec" in types:
            self.cross_ln = zeros_param((cfg.d_model,), cfg.dtype, device)
            self.cross = Attention(cfg, gen, device, cross=True)
        if types & set(MOE_KINDS):
            self.ln1 = zeros_param((cfg.d_model,), cfg.dtype, device)
            self.attn = Attention(cfg, gen, device)
            self.ln2 = zeros_param((cfg.d_model,), cfg.dtype, device)
            if "moe" in types:
                self.moe = MoEFFN(cfg, gen, device, layout=layout,
                                  data_size=data_size)
            if "dense" in types:
                self.dense_ffn = FFN(cfg, gen, device, cfg.moe.dense_d_ff)
        if "mamba" in types:
            self.mamba = MambaLayer(cfg, gen, device)
        if "mlstm" in types:
            self.mlstm = MLSTMLayer(cfg, gen, device)
        if "slstm" in types:
            self.slstm = SLSTMLayer(cfg, gen, device)


class StageParams(nn.Module):
    """One stage's ``l_max`` layer slots (routed experts: one rank's shard
    of ``data_size``)."""

    def __init__(self, model: "ArchModel", gen_for_slot, device,
                 data_size: int = 1):
        super().__init__()
        self.slots = nn.ModuleList(
            LayerSlot(model.cfg, model.layer_types, gen_for_slot(i), device,
                      layout=model.moe_layout, data_size=data_size)
            for i in range(model.l_max))


class IOParams(nn.Module):
    """Embedding, LM head, final norm and, for zamba2, the shared attention
    block (outside the stage stacking)."""

    def __init__(self, cfg: ArchConfig, gen, device):
        super().__init__()
        v = cfg.padded_vocab()
        self.embed = dense_param(gen, (v, cfg.d_model), cfg.dtype, device,
                                 scale=0.02)
        self.head = dense_param(gen, (v, cfg.d_model), cfg.dtype, device)
        self.final_ln = zeros_param((cfg.d_model,), cfg.dtype, device)
        if cfg.shared_attn_period:
            self.shared_blk = DecoderLayer(cfg, gen, device)


@dataclasses.dataclass
class ArchModel:
    cfg: ArchConfig
    num_stages: int
    counts: np.ndarray  # [S] true layers per stage
    l_max: int
    type_ids: np.ndarray  # [S, l_max] index into layer_types, -1 disabled
    shared_flags: np.ndarray  # [S, l_max] apply-shared-block-before-slot
    layer_types: tuple[str, ...]
    #: the reference's expert layout over its data axis (none | ep | tp);
    #: the port's single-device paths pass ``"none"`` in their aux
    moe_layout: str = "none"

    def rows(self, stage: int) -> dict[str, np.ndarray]:
        return {
            "type_id": np.maximum(self.type_ids[stage], 0),
            "enabled": (self.type_ids[stage] >= 0).astype(np.int32),
            "shared": self.shared_flags[stage].astype(np.int32),
        }

    # ------------------------------------------------------------------
    # params (``seed=None`` allocates without initialising, for loading)
    # ------------------------------------------------------------------
    def init_stage_params(self, stage: int, *, seed: int | None = 0,
                          device="cuda", data_size: int = 1) -> StageParams:
        """Stage ``stage``'s module; with ``data_size > 1`` and an expert
        layout, one rank's shard (allocated only: ``seed`` None)."""
        def gen_for_slot(i):
            if seed is None:
                return None
            return make_generator(seed, stage * 1000 + i, device)

        return StageParams(self, gen_for_slot, device, data_size)

    def expert_shard_dim(self, name: str, data_size: int) -> int | None:
        """The dim of stage parameter ``name`` (``slots.{i}.<path>``) that
        ``data_size`` ranks shard, or None (replicated)."""
        parts = name.split(".")
        if len(parts) < 2 or parts[-2] != "moe" or not sharded(
                self.moe_layout, data_size):
            return None
        return expert_shard_dim(parts[-1], self.moe_layout)

    @torch.no_grad()
    def shard_stage_params(self, full: StageParams, data_size: int,
                           index: int) -> StageParams:
        """Data rank ``index``'s copy of the stage module ``full``: its
        shard of every routed-expert leaf and a clone of the rest."""
        device = next(full.parameters()).device
        sp = StageParams(self, lambda i: None, device, data_size)
        for (name, p), (_, q) in zip(sp.named_parameters(),
                                     full.named_parameters(), strict=True):
            dim = self.expert_shard_dim(name, data_size)
            p.copy_(q if dim is None else take_shard(q, dim, data_size,
                                                     index))
        return sp

    def init_io_params(self, *, seed: int | None = 0,
                       device="cuda") -> IOParams:
        gen = None if seed is None else make_generator(seed, 1_000_000, device)
        return IOParams(self.cfg, gen, device)

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def _window(self, kind: str) -> int:
        """Sliding window of an attention kind (0 = none)."""
        if kind == "attn":
            return self.cfg.sliding_window
        if kind == "attn_local":
            return self.cfg.sliding_window or 1024
        return 0

    def _moe_attn(self, slot: LayerSlot, x, aux):
        """The attention half of a ``moe``/``dense`` layer: (the residual
        stream, the FFN's input)."""
        cfg = self.cfg
        h = rmsnorm(x, slot.ln1, cfg.norm_eps)
        x = x + attention_block(slot.attn, h, aux["positions"], cfg)
        return x, rmsnorm(x, slot.ln2, cfg.norm_eps)

    def _moe_ffn(self, slot: LayerSlot, kind: str, h, aux):
        """The FFN half of a ``moe``/``dense`` layer."""
        if kind == "dense":
            return ffn_block(slot.dense_ffn, h, self.cfg.act)
        return moe_ffn(slot.moe, h, self.cfg,
                       layout=aux.get("moe_layout", "none"),
                       axis_size=aux.get("data_size", 1))

    def _branch(self, kind: str):
        cfg = self.cfg
        if kind == "mamba":
            return lambda slot, io, x, aux: mamba_layer(slot.mamba, x, cfg)
        if kind == "mlstm":
            return lambda slot, io, x, aux: mlstm_layer(slot.mlstm, x, cfg)
        if kind == "slstm":
            return lambda slot, io, x, aux: slstm_layer(slot.slstm, x, cfg)
        if kind in MOE_KINDS:

            def moe_fn(slot: LayerSlot, io, x, aux):
                x, h = self._moe_attn(slot, x, aux)
                return x + self._moe_ffn(slot, kind, h, aux)

            return moe_fn
        if kind == "enc":

            def enc_fn(slot: LayerSlot, io, x, aux):
                # x = concat(dec, enc): the encoder transforms the enc part
                dec_len = aux["dec_len"]
                enc = x[:, dec_len:]
                pos = arange_positions(enc)
                enc = decoder_layer(slot.blk, enc, pos, cfg, causal=False)
                return torch.cat([x[:, :dec_len], enc], dim=1)

            return enc_fn
        if kind == "dec":

            def dec_fn(slot: LayerSlot, io, x, aux):
                dec_len = aux["dec_len"]
                dec, enc = x[:, :dec_len], x[:, dec_len:]
                pos = arange_positions(dec)
                h = rmsnorm(dec, slot.blk.ln1, cfg.norm_eps)
                dec = dec + attention_block(slot.blk.attn, h, pos, cfg)
                h = rmsnorm(dec, slot.cross_ln, cfg.norm_eps)
                dec = dec + attention_block(slot.cross, h, pos, cfg,
                                            causal=False, kv_src=enc,
                                            rope=False)
                h = rmsnorm(dec, slot.blk.ln2, cfg.norm_eps)
                dec = dec + ffn_block(slot.blk.ffn, h, cfg.act)
                return torch.cat([dec, enc], dim=1)

            return dec_fn
        if kind not in ATTN_KINDS:
            raise ValueError(kind)
        window = self._window(kind)

        def attn_like(slot: LayerSlot, io, x, aux):
            return decoder_layer(slot.blk, x, aux["positions"], cfg,
                                 window=window, mrope_pos=aux.get("mrope"))

        return attn_like

    def stage_forward(self, stage_params: StageParams, io: IOParams, x, aux,
                      rows, remat: bool = True):
        """Apply this stage's enabled layer slots.

        Under autograd each slot is checkpointed (``remat``): the backward
        keeps one activation per slot and recomputes the slot's internals,
        the reference's ``jax.checkpoint`` per slot.  A slot flagged
        ``shared`` applies ``io.shared_blk`` before its own layer, inside
        the same checkpoint.
        """
        for i, slot in enumerate(stage_params.slots):
            if not rows["enabled"][i]:
                continue
            x = _remat(self._slot_fn(i, rows), remat, slot, io, x, aux)
        return x

    def _slot_fn(self, i: int, rows, branch=None):
        """Slot ``i``'s function (``branch``, else its kind's), behind the
        shared block where the slot is flagged."""
        fn = branch or self._branch(self.layer_types[int(rows["type_id"][i])])
        if self.cfg.shared_attn_period and rows["shared"][i]:
            fn = functools.partial(self._shared_then, fn)
        return fn

    def exchanges(self, rows, aux) -> bool:
        """Whether this stage's forward exchanges tokens over its data
        group: an enabled ``moe`` slot under an expert layout over more
        than one data rank."""
        if not sharded(aux.get("moe_layout", "none"),
                       aux.get("data_size", 1)):
            return False
        return any(rows["enabled"][i] and self.layer_types[
            int(rows["type_id"][i])] == "moe" for i in range(self.l_max))

    def stage_phases(self, stage_params: StageParams, io: IOParams, aux,
                     rows, remat: bool = True):
        """``(phases, cuts)`` of an exchanging stage on states ``{"x":
        ...}`` -> ``{"x": ...}`` (``models/phases.py``), its one
        definition: F runs it with :func:`~repro_torch.models.phases.
        run_forward`, B and W differentiate it.  A ``moe`` slot is
        :func:`~repro_torch.models.moe.moe_phases`' three pieces, cut
        before and after its experts, the first behind the slot's
        shared block (if flagged) and attention half, the last followed
        by the residual add; every other slot is one piece, as in
        :meth:`stage_forward`.  Under autograd (``remat``) each piece is
        checkpointed on its own.  A phase is the pieces between two
        cuts."""
        layout, data_size = aux["moe_layout"], aux["data_size"]

        def remat_piece(fn):
            return lambda st: _remat(fn, remat, st)

        pieces: list[list] = [[]]
        cuts: list = []
        for i, slot in enumerate(stage_params.slots):
            if not rows["enabled"][i]:
                continue
            if self.layer_types[int(rows["type_id"][i])] != "moe":
                fn = self._slot_fn(i, rows)
                pieces[-1].append(remat_piece(
                    lambda st, fn=fn, slot=slot: {
                        **st, "x": fn(slot, io, st["x"], aux)}))
                continue
            (dispatch, experts, combine), slot_cuts = moe_phases(
                slot.moe, self.cfg, layout, data_size)
            # the slot's branch up to its FFN: the shared block (if
            # flagged), then the attention half
            attn = self._slot_fn(i, rows, lambda sl, _io, x, a:
                                 self._moe_attn(sl, x, a))

            def enter(st, attn=attn, slot=slot, dispatch=dispatch):
                x, h = attn(slot, io, st["x"], aux)
                return dispatch({"x": x, "h": h})

            def leave(st, combine=combine):
                st = combine(st)
                return {"x": st["x"] + st["h"]}

            pieces[-1].append(remat_piece(enter))
            pieces.append([remat_piece(experts)])
            pieces.append([remat_piece(leave)])
            cuts.extend(slot_cuts)
        return [chain(p) for p in pieces], cuts

    def _shared_then(self, fn, slot, io: IOParams, x, aux):
        x = decoder_layer(io.shared_blk, x, aux["positions"], self.cfg)
        return fn(slot, io, x, aux)

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def init_layer_cache(self, batch: int, seq: int, enc_len: int = 0, *,
                         device="cuda") -> dict:
        """Union cache of one layer slot (the reference's): ``k``/``v`` for
        the attention kinds, ``dec``, ``moe``/``dense`` and the shared
        block, ``xk``/``xv`` (the encoder's keys and values) when the arch
        has ``dec``, ``mamba``'s (conv, ssm) pair, the mLSTM's (C, n, m)
        and the sLSTM's (c, n, h, m) states."""
        cfg = self.cfg
        types = set(self.layer_types)
        shape = (batch, seq, cfg.num_kv_heads, cfg.resolved_head_dim)
        xshape = (batch, enc_len) + shape[2:]
        c: dict = {}
        if types & {*ATTN_KINDS, "dec", *MOE_KINDS} or cfg.shared_attn_period:
            c["k"] = torch.zeros(shape, dtype=cfg.dtype, device=device)
            c["v"] = torch.zeros(shape, dtype=cfg.dtype, device=device)
        if "dec" in types:
            c["xk"] = torch.zeros(xshape, dtype=cfg.dtype, device=device)
            c["xv"] = torch.zeros(xshape, dtype=cfg.dtype, device=device)
        if "mamba" in types:
            c["mamba"] = init_mamba_cache(batch, cfg, device=device)
        if "mlstm" in types:
            c["mlstm"] = init_mlstm_cache(batch, cfg, device=device)
        if "slstm" in types:
            c["slstm"] = init_slstm_cache(batch, cfg, device=device)
        return c

    def init_stage_cache(self, batch: int, seq: int, enc_len: int = 0, *,
                         device="cuda") -> dict:
        """One stage's cache: each leaf of ``init_layer_cache`` repeated
        ``[l_max, ...]`` (zeros, but the mLSTM's ``m`` of -inf and the
        sLSTM's ``n`` of ones)."""
        one = self.init_layer_cache(batch, seq, enc_len, device=device)
        return tree_map(lambda t: t.unsqueeze(0).repeat(
            (self.l_max,) + (1,) * t.dim()), one)

    def _decode_branch(self, kind: str):
        """fn(slot, io, x [b, 1, d], cache, pos, aux) -> y; ``cache`` is the
        slot's cache tree, updated in place."""
        cfg = self.cfg
        if kind in ATTN_KINDS:
            window = self._window(kind)

            def attn_like(slot: LayerSlot, io, x, cache, pos, aux):
                return decoder_layer_decode(
                    slot.blk, x, cache, pos, cfg, window=window,
                    axis=aux.get("sp_axis"))[0]

            return attn_like
        if kind == "enc":
            # encoder layers are inert at decode time (context pre-filled)
            return lambda slot, io, x, cache, pos, aux: x
        if kind == "dec":

            def dec_fn(slot: LayerSlot, io, x, cache, pos, aux):
                h = rmsnorm(x, slot.blk.ln1, cfg.norm_eps)
                x = x + decode_attention_block(slot.blk.attn, h, cache, pos,
                                               cfg)[0]
                # cross attention against the encoder's keys and values:
                # kernel K3, over all enc_len of them
                h = rmsnorm(x, slot.cross_ln, cfg.norm_eps)
                b = x.shape[0]
                q = (h @ slot.cross.wq).reshape(b, 1, cfg.num_heads,
                                                cfg.resolved_head_dim)
                o = ops.decode_attention(q, cache["xk"], cache["xv"],
                                         cache["xk"].shape[1])
                x = x + o.reshape(b, 1, -1) @ slot.cross.wo
                h = rmsnorm(x, slot.blk.ln2, cfg.norm_eps)
                return x + ffn_block(slot.blk.ffn, h, cfg.act)

            return dec_fn
        if kind in MOE_KINDS:

            def moe_fn(slot: LayerSlot, io, x, cache, pos, aux):
                h = rmsnorm(x, slot.ln1, cfg.norm_eps)
                x = x + decode_attention_block(slot.attn, h, cache, pos,
                                               cfg)[0]
                h = rmsnorm(x, slot.ln2, cfg.norm_eps)
                layout = aux.get("moe_layout", "none")
                data_size = aux.get("data_size", 1)
                if kind == "moe" and sharded(layout, data_size):
                    if aux.get("exchange") is None:
                        raise ValueError(
                            f"MoE layout {layout!r} over {data_size} data "
                            f"ranks exchanges tokens at decode: "
                            f"aux['exchange'] (the data group's, "
                            f"Mesh.exchange_over) is not set")
                    # no autograd at decode: the phases run with the data
                    # group's exchanges in between
                    phases, cuts = moe_phases(slot.moe, cfg, layout,
                                              data_size)
                    return x + run_forward(phases, cuts, {"h": h},
                                           aux["exchange"])["h"]
                return x + self._moe_ffn(slot, kind, h, aux)

            return moe_fn
        if kind == "mamba":
            return lambda slot, io, x, cache, pos, aux: mamba_layer_decode(
                slot.mamba, x, cache["mamba"], cfg)[0]
        if kind == "mlstm":
            return lambda slot, io, x, cache, pos, aux: mlstm_layer_decode(
                slot.mlstm, x, cache["mlstm"], cfg)[0]
        if kind == "slstm":
            return lambda slot, io, x, cache, pos, aux: slstm_layer_decode(
                slot.slstm, x, cache["slstm"], cfg)[0]
        raise ValueError(kind)

    def stage_decode(self, stage_params: StageParams, io: IOParams, x,
                     stage_cache: dict, pos: int, aux: dict, rows):
        """One token through this stage's enabled slots.

        x: [b, 1, d]; stage_cache: leaves [l_max, b, ...] (a view of the
        batch rows being decoded); pos: the current position.  The caches
        are updated in place, a disabled slot's left as it is (the
        reference's ``where(en, new, old)``).  Returns ``(x, stage_cache)``.
        A slot flagged ``shared`` first applies ``io.shared_blk``, whose KV
        cache rides in the slot's ``k``/``v``.
        """
        branches = {k: self._decode_branch(k) for k in self.layer_types}
        for i, slot in enumerate(stage_params.slots):
            if not rows["enabled"][i]:
                continue
            cache = tree_map(lambda c: c[i], stage_cache)
            if self.cfg.shared_attn_period and rows["shared"][i]:
                x = decoder_layer_decode(io.shared_blk, x, cache, pos,
                                         self.cfg)[0]
            x = branches[self.layer_types[int(rows["type_id"][i])]](
                slot, io, x, cache, pos, aux)
        return x, stage_cache

    # ------------------------------------------------------------------
    # embedding / head
    # ------------------------------------------------------------------
    def embed(self, io: IOParams, batch: dict):
        if self.cfg.embed_input:
            return batch["embeds"].to(self.cfg.dtype)
        return io.embed[batch["tokens"]]

    def head_logits(self, io: IOParams, x):
        h = rmsnorm(x, io.final_ln, self.cfg.norm_eps)
        return h @ io.head.T

    def reference_forward(self, stage_params, io: IOParams, batch: dict,
                          aux: dict):
        """Single-device forward through every stage (tests)."""
        x = self.embed(io, batch)
        for s in range(self.num_stages):
            x = self.stage_forward(stage_params[s], io, x, aux, self.rows(s))
        return self.head_logits(io, x)

    # ------------------------------------------------------------------
    # analytic accounting
    # ------------------------------------------------------------------
    def model_flops(self, cell: ShapeCell) -> dict[str, float]:
        """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE), N excl. embed,
        plus the attention context FLOPs (not in 6ND) of every attention
        layer and shared-block application."""
        cfg = self.cfg
        tokens = (cell.seq_len * cell.global_batch if cell.step == "train"
                  else cell.global_batch)
        n_active = cfg.active_param_count() + cfg.padded_vocab() * cfg.d_model
        n_total = (cfg.param_count(include_embed=False)
                   + cfg.padded_vocab() * cfg.d_model)
        mult = 6 if cell.step == "train" else 2
        attn_layers = sum(
            1 for k in cfg.pattern
            if k in ("attn", "attn_global", "moe", "dense", "dec", "enc")
        ) + (int(np.count_nonzero(self.shared_flags))
             if cfg.shared_attn_period else 0)
        local_layers = sum(1 for k in cfg.pattern if k == "attn_local")
        hq, hd = cfg.num_heads, cfg.resolved_head_dim
        local_ctx = cfg.sliding_window or 1024
        if cell.step == "train":
            ctx = cell.seq_len / 2
            attn_flops = mult * cell.global_batch * cell.seq_len * (
                attn_layers * ctx + local_layers * min(local_ctx, ctx)
            ) * 2 * hq * hd
        else:
            ctx = cell.seq_len
            attn_flops = mult * cell.global_batch * (
                attn_layers * ctx + local_layers * min(local_ctx, ctx)
            ) * 2 * hq * hd
        return {
            "model_flops": mult * n_active * tokens + attn_flops,
            "model_flops_total_params": mult * n_total * tokens + attn_flops,
            "tokens": tokens,
            "n_active": n_active,
            "n_total": n_total,
        }


def _remat(fn, remat: bool, *args):
    """``fn(*args)``, checkpointed under autograd when ``remat``."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def build(cfg: ArchConfig, num_stages: int = 16) -> ArchModel:
    counts, l_max = stage_layout(cfg.num_layers, num_stages)
    gli = global_layer_index(counts)  # [S, l_max], -1 disabled
    pattern = cfg.pattern
    types = cfg.layer_types()
    type_ids = np.full((num_stages, l_max), -1, dtype=np.int64)
    shared = np.zeros((num_stages, l_max), dtype=np.int64)
    for s in range(num_stages):
        for i in range(l_max):
            g = gli[s, i]
            if g >= 0:
                type_ids[s, i] = types.index(pattern[g])
                if cfg.shared_attn_period and g % cfg.shared_attn_period == 0:
                    shared[s, i] = 1
    layout = "none"
    if cfg.family == "moe":
        layout = "ep" if cfg.moe.num_experts >= 16 else "tp"
    return ArchModel(
        cfg=cfg,
        num_stages=num_stages,
        counts=counts,
        l_max=l_max,
        type_ids=type_ids,
        shared_flags=shared,
        layer_types=types,
        moe_layout=layout,
    )
