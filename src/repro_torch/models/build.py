"""Arch registry: ArchConfig -> ArchModel (dense slice of the port).

Port of ``repro.models.build``.  The layout is the reference's: layers
spread over stages by ``stage_layout``, per-slot ``type_ids`` (-1 =
disabled slot of an uneven stage) and the ``rows`` an executor consumes.
Parameters are ``nn.Module``s: one :class:`StageParams` per stage and one
:class:`IOParams`, named so that they map one-to-one onto the reference's
stacked pytree, e.g. ``slots.{i}.blk.attn.wq`` of stage ``s`` is
``stage_params['blk']['attn']['wq'][s, i]`` (see ``models/convert.py``).

This slice runs the attention layer kinds (``attn``, ``attn_local``,
``attn_global``); the others raise ``NotImplementedError`` naming the
ROADMAP slice they move with.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import ArchConfig, global_layer_index, stage_layout
from repro_torch.models.layers import (
    DecoderLayer,
    dense_param,
    decoder_layer,
    rmsnorm,
    zeros_param,
)

ATTN_KINDS = ("attn", "attn_local", "attn_global")
#: layer kind -> the ROADMAP queue-1 slice that ports it
LATER_SLICES = {
    "enc": "other families (seamless enc-dec)",
    "dec": "other families (seamless enc-dec)",
    "moe": "other families (MoE)",
    "dense": "other families (MoE)",
    "mamba": "SSM slice (zamba2)",
    "mlstm": "other families (xLSTM)",
    "slstm": "other families (xLSTM)",
}


def _not_ported(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not in the port yet: it moves with the {slice_name} "
        f"slice (ROADMAP.md queue 1)")


def make_generator(seed: int, salt: int, device) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(seed * 1_000_003 + salt)
    return gen


class LayerSlot(nn.Module):
    """Union parameters of one layer slot (this slice: the decoder block)."""

    def __init__(self, cfg: ArchConfig, layer_types, gen, device):
        super().__init__()
        for kind in layer_types:
            if kind not in ATTN_KINDS:
                raise _not_ported(f"layer kind {kind!r}", LATER_SLICES[kind])
        self.blk = DecoderLayer(cfg, gen, device)


class StageParams(nn.Module):
    """One stage's ``l_max`` layer slots."""

    def __init__(self, model: "ArchModel", gen_for_slot, device):
        super().__init__()
        self.slots = nn.ModuleList(
            LayerSlot(model.cfg, model.layer_types, gen_for_slot(i), device)
            for i in range(model.l_max))


class IOParams(nn.Module):
    """Embedding, LM head and final norm (outside the stage stacking)."""

    def __init__(self, cfg: ArchConfig, gen, device):
        super().__init__()
        v = cfg.padded_vocab()
        self.embed = dense_param(gen, (v, cfg.d_model), cfg.dtype, device,
                                 scale=0.02)
        self.head = dense_param(gen, (v, cfg.d_model), cfg.dtype, device)
        self.final_ln = zeros_param((cfg.d_model,), cfg.dtype, device)


@dataclasses.dataclass
class ArchModel:
    cfg: ArchConfig
    num_stages: int
    counts: np.ndarray  # [S] true layers per stage
    l_max: int
    type_ids: np.ndarray  # [S, l_max] index into layer_types, -1 disabled
    shared_flags: np.ndarray  # [S, l_max] apply-shared-block-before-slot
    layer_types: tuple[str, ...]

    def rows(self, stage: int) -> dict[str, np.ndarray]:
        return {
            "type_id": np.maximum(self.type_ids[stage], 0),
            "enabled": (self.type_ids[stage] >= 0).astype(np.int32),
            "shared": self.shared_flags[stage].astype(np.int32),
        }

    # ------------------------------------------------------------------
    # params (``seed=None`` allocates without initialising, for loading)
    # ------------------------------------------------------------------
    def _check_ported(self) -> None:
        if self.cfg.shared_attn_period:
            raise _not_ported("the shared attention block", "SSM slice (zamba2)")

    def init_stage_params(self, stage: int, *, seed: int | None = 0,
                          device="cuda") -> StageParams:
        self._check_ported()

        def gen_for_slot(i):
            if seed is None:
                return None
            return make_generator(seed, stage * 1000 + i, device)

        return StageParams(self, gen_for_slot, device)

    def init_io_params(self, *, seed: int | None = 0,
                       device="cuda") -> IOParams:
        self._check_ported()
        gen = None if seed is None else make_generator(seed, 1_000_000, device)
        return IOParams(self.cfg, gen, device)

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def _branch(self, kind: str):
        cfg = self.cfg
        if kind == "attn":
            window = cfg.sliding_window
        elif kind == "attn_local":
            window = cfg.sliding_window or 1024
        elif kind == "attn_global":
            window = 0
        else:
            raise _not_ported(f"layer kind {kind!r}", LATER_SLICES[kind])

        def attn_like(slot: LayerSlot, io, x, aux):
            return decoder_layer(slot.blk, x, aux["positions"], cfg,
                                 window=window)

        return attn_like

    def stage_forward(self, stage_params: StageParams, io: IOParams, x, aux,
                      rows, remat: bool = True):
        """Apply this stage's enabled layer slots.

        Under autograd each slot is checkpointed (``remat``): the backward
        keeps one activation per slot and recomputes the slot's internals,
        the reference's ``jax.checkpoint`` per slot.
        """
        for i, slot in enumerate(stage_params.slots):
            if not rows["enabled"][i]:
                continue
            fn = self._branch(self.layer_types[int(rows["type_id"][i])])
            if remat and torch.is_grad_enabled():
                x = checkpoint(fn, slot, io, x, aux, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = fn(slot, io, x, aux)
        return x

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
    return ArchModel(
        cfg=cfg,
        num_stages=num_stages,
        counts=counts,
        l_max=l_max,
        type_ids=type_ids,
        shared_flags=shared,
        layer_types=types,
    )
