"""Serve-path executor: pipelined single-token decode with stage-local caches.

Port of ``repro.pipeline.decode`` on one device.  ``serve_step`` advances
every sequence of the batch by one token: M micro-groups of ``mb_rows``
rows staircase through the S stages (the F-only table: at tick t stage s
runs group t - s), each stage updating its own cache rows in place, and
the last stage takes the greedy next token from ``rmsnorm(h, final_ln) @
head.T`` in float32.  Sequence-parallel caches (``sp_mode``), data-parallel
axes and multi-pod meshes move with a later multi-device slice
(ROADMAP.md queue 1, item 18c).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.build import ArchModel, tree_map
from repro_torch.models.layers import rmsnorm


@dataclasses.dataclass(frozen=True)
class DecodeOptions:
    mb_rows: int        # rows per micro-group
    cache_len: int      # max KV length
    enc_len: int = 0


def make_serve_fn(model: ArchModel, opts: DecodeOptions, num_groups: int):
    """Returns fn(stage_params, io, caches, batch, pos) -> next_tokens.

    ``stage_params`` and ``caches`` are per-stage lists (caches as made by
    ``ArchModel.init_stage_cache``, leaves ``[l_max, B, ...]``); ``batch``
    carries ``tokens`` [B] (or ``embeds`` [B, 1, d] for embed_input archs)
    with B = num_groups * mb_rows; ``pos`` is the current position (an
    int).  Returns the greedy next tokens [B] (int64) and updates
    ``caches`` in place.  Runs under ``torch.inference_mode()``.
    """
    cfg = model.cfg
    S = model.num_stages
    M = num_groups
    r = opts.mb_rows
    rows = [model.rows(s) for s in range(S)]
    aux = {"data_size": 1, "moe_layout": "none"}  # experts computed locally

    def embed_group(io, batch, mb):
        if cfg.embed_input:
            return batch["embeds"][mb * r:(mb + 1) * r].to(cfg.dtype)
        return io.embed[batch["tokens"][mb * r:(mb + 1) * r]][:, None]

    def serve_step(stage_params, io, caches, batch, pos):
        with torch.inference_mode():
            acts = {}  # micro-group -> its activation after the last stage run
            out = []
            for t in range(M + S - 1):
                for s in range(S):
                    mb = t - s
                    if not 0 <= mb < M:
                        continue
                    x = embed_group(io, batch, mb) if s == 0 else acts[mb]
                    cache_mb = tree_map(lambda c: c[:, mb * r:(mb + 1) * r],
                                        caches[s])
                    acts[mb], _ = model.stage_decode(
                        stage_params[s], io, x, cache_mb, pos, aux, rows[s])
                    if s == S - 1:
                        h = rmsnorm(acts.pop(mb), io.final_ln, cfg.norm_eps)
                        logits = (h @ io.head.T).float()
                        out.append(torch.argmax(logits[:, 0], dim=-1))
            return torch.cat(out)

    return serve_step
