"""Serve-path executor: pipelined single-token decode with stage-local caches.

Port of ``repro.pipeline.decode``.  ``serve_step`` advances every sequence
of the batch by one token: M micro-groups of ``mb_rows`` rows staircase
through the S stages (the F-only table: at tick t stage s runs group
t - s), each stage updating its own cache rows in place, and the last
stage takes the greedy next token from ``rmsnorm(h, final_ln) @ head.T``
in float32.

Two executors compute it:

* :func:`make_serve_fn`, the reference's rank program on a ``(data x
  model)`` :class:`~repro_torch.launch.mesh.Mesh`: the batch is sharded
  over the data ranks, activations move one stage a tick by ``ppermute``
  over ``model``, the MoE layouts exchange tokens over ``data``, and under
  ``sp_mode`` (long_500k, batch 1) the attention caches are sharded over
  ``data`` on their sequence dimension and combined with the distributed
  flash-decode (``models/layers.decode_attention_block``);
* :func:`make_staircase_fn`, the same staircase on one thread over
  per-stage lists, for one data rank (the launcher's default; no
  rendezvous per tick).  On a ``1 x S`` mesh both give the same bits.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.build import ArchModel, tree_map
from repro_torch.models.layers import rmsnorm

#: the decode paths that the reference runs unsharded under ``sp_mode``
#: although their caches are sharded (``src/repro/models/build.py``): each
#: rank decodes against its own shard alone, so the data ranks disagree
SP_GAPS = {"dec": "build.py:336 (self-attention) and :348 (K3 "
                  "cross-attention)",
           "moe": "build.py:363", "dense": "build.py:363",
           "shared": "build.py:408 (zamba2's shared block)"}


@dataclasses.dataclass(frozen=True)
class DecodeOptions:
    mb_rows: int          # rows per micro-group per data shard
    cache_len: int        # max KV length
    enc_len: int = 0
    sp_mode: bool = False  # sequence-parallel caches (long_500k, batch=1)
    dp_axes: tuple = ("data",)
    multi_pod: bool = False

    @property
    def all_dp_axes(self) -> tuple:
        return (("pod",) + self.dp_axes) if self.multi_pod else self.dp_axes


def cache_specs(model: ArchModel, opts: DecodeOptions) -> dict:
    """Each cache leaf's layout over the mesh (the reference's
    ``cache_specs``), as a tree of ``init_layer_cache``'s keys: ``(dim,
    axes)``, the dim of a rank's ``[l_max, batch, ...]`` leaf sharded over
    ``axes``, or None (replicated over the data ranks).  A rank holds its
    ``model`` index's stage (the reference's leading ``[S]``).  Under
    ``sp_mode`` ``k``/``v``/``xk``/``xv`` are sharded on their sequence
    dimension and the recurrent states replicated; otherwise every leaf
    is sharded on the batch."""
    one = model.init_layer_cache(1, 2, enc_len=max(1, opts.enc_len),
                                 device="meta")
    axes = opts.all_dp_axes

    def spec_for(path, leaf):
        if opts.sp_mode:
            return (2, axes) if path[-1] in ("k", "v", "xk", "xv") else None
        return (1, axes)

    def walk(tree, path):
        return {k: walk(v, path + (k,)) if isinstance(v, dict)
                else spec_for(path + (k,), v) for k, v in tree.items()}

    return walk(one, ())


def check_sp_mode(model: ArchModel, opts: DecodeOptions) -> None:
    """Refuse the ``sp_mode`` combinations where the reference's data ranks
    disagree (ROADMAP §3, "Reference gaps"): a layer kind whose decode
    ignores the sequence axis (:data:`SP_GAPS`), and ``multi_pod``, whose
    caches are sharded over ``("pod", "data")`` but combined over
    ``data`` alone."""
    if not opts.sp_mode:
        return
    if opts.multi_pod:
        raise ValueError(
            "sp_mode with multi_pod: the reference shards the caches over "
            "('pod', 'data') (src/repro/pipeline/decode.py:50) but combines "
            "and indexes them over 'data' alone (decode.py:82, "
            "src/repro/models/layers.py:365), so its pods disagree")
    kinds = set(model.type_ids[model.type_ids >= 0].ravel().tolist())
    held = [model.layer_types[k] for k in sorted(kinds)]
    if model.cfg.shared_attn_period and model.shared_flags.any():
        held.append("shared")
    gaps = [f"{k} (src/repro/models/{SP_GAPS[k]})" for k in held
            if k in SP_GAPS]
    if gaps:
        raise ValueError(
            f"sp_mode on {model.cfg.name}: the reference decodes "
            f"{', '.join(gaps)} without the sequence axis although their "
            f"caches are sharded over it, so its data ranks disagree")


def _greedy(io, y, cfg):
    """The float32 logits' argmax of the last stage's output y [r, 1, d]."""
    h = rmsnorm(y, io.final_ln, cfg.norm_eps)
    return torch.argmax((h @ io.head.T).float()[:, 0], dim=-1)


def _embed_group(cfg, io, batch, mb: int, r: int):
    if cfg.embed_input:
        return batch["embeds"][mb * r:(mb + 1) * r].to(cfg.dtype)
    return io.embed[batch["tokens"][mb * r:(mb + 1) * r]][:, None]


def make_serve_fn(model: ArchModel, mesh, opts: DecodeOptions,
                  num_groups: int):
    """Returns ``(fn, cache_specs, batch_specs)``: the rank program
    ``fn(stage_params, io, caches, batch, pos) -> (tokens, hidden)``, run
    on every rank by ``mesh.run`` (the reference's ``device_fn``), and the
    layouts of the caches (:func:`cache_specs`) and of the batch over the
    mesh (``{key: (dim, axes)}``, None replicated; for
    ``executor.shard_batch``).

    A rank holds its stage's module, its own io copy and its own cache
    shard (leaves ``[l_max, B_loc, ...]``, updated in place), and its
    data shard of the batch: ``tokens`` [B_loc] (or ``embeds`` [B_loc, 1,
    d]) with B_loc = num_groups * mb_rows; under ``sp_mode`` the whole
    batch of one row.  It ticks ``T = M + S - 1`` times; each tick issues
    one ``ppermute`` over ``model`` carrying (activation, group, valid),
    then runs its group's F when ``0 <= t - stage < M``, on the group's
    cache rows (under ``sp_mode`` the whole local cache).  ``tokens`` [B_loc]
    (int64) are the last stage's greedy tokens, on every rank (a ``psum``
    over ``model`` of the masked tokens); ``hidden`` is the last stage's
    output [B_loc, 1, d] there, None elsewhere.  Every rank of a data
    group issues the same collectives at the same tick: whether a rank
    runs depends on its stage and the tick only.  Runs under
    ``torch.inference_mode()``.
    """
    cfg = model.cfg
    S = model.num_stages
    M = num_groups
    r = opts.mb_rows
    if mesh.shape["model"] != S:
        raise ValueError(f"{S} stages on a model axis of "
                         f"{mesh.shape['model']}")
    check_sp_mode(model, opts)
    dp_axes = opts.all_dp_axes
    fwd_perm = [(i, i + 1) for i in range(S - 1)]
    rows = [model.rows(s) for s in range(S)]
    rank_aux = _rank_aux(model, mesh, opts)

    def fn(stage_params, io, caches, batch, pos):
        stage = mesh.axis_index("model")
        aux = rank_aux()
        with torch.inference_mode():
            device = io.embed.device
            recv: dict = {}  # group -> its activation from the last stage
            send = (torch.zeros((r, 1, cfg.d_model), dtype=cfg.dtype,
                                device=device), 0, False)
            out, hidden = [], []
            for t in range(M + S - 1):
                act, mb, valid = mesh.ppermute(send, "model", fwd_perm)
                if valid:
                    recv[mb] = act
                send = (send[0], send[1], False)
                mb = t - stage
                if not 0 <= mb < M:
                    continue
                x = (_embed_group(cfg, io, batch, mb, r) if stage == 0
                     else recv.pop(mb))
                cache_mb = caches if opts.sp_mode else tree_map(
                    lambda c: c[:, mb * r:(mb + 1) * r], caches)
                y, _ = model.stage_decode(stage_params, io, x, cache_mb, pos,
                                          aux, rows[stage])
                if stage == S - 1:
                    hidden.append(y)
                    out.append(_greedy(io, y, cfg))
                send = (y, mb, stage < S - 1)
            tokens = (torch.cat(out) if stage == S - 1 else torch.zeros(
                (M * r,), dtype=torch.int64, device=device))
            tokens = mesh.psum(tokens, "model")
            return tokens, (torch.cat(hidden) if hidden else None)

    key = "embeds" if cfg.embed_input else "tokens"
    batch_specs = {key: None if opts.sp_mode else (0, dp_axes)}
    return fn, cache_specs(model, opts), batch_specs


def _rank_aux(model: ArchModel, mesh, opts: DecodeOptions):
    """``aux()``: a rank's ``stage_decode`` aux on ``mesh`` (call it inside
    ``mesh.run``): the MoE layouts' exchange over ``data``, and under
    ``sp_mode`` the rank's ``data`` group."""
    data_size = mesh.shape["data"]
    exchange = mesh.exchange_over("data")

    def aux() -> dict:
        out = {"data_size": data_size, "moe_layout": model.moe_layout,
               "exchange": exchange}
        if opts.sp_mode:
            out["sp_axis"] = mesh.axis_group("data")
        return out

    return aux


def make_warm_fn(model: ArchModel, mesh, opts: DecodeOptions):
    """The rank program ``warm(stage_params, io) -> None`` for ``mesh.run``:
    each rank decodes one group of ``mb_rows`` rows through its stage once
    (the last stage also takes its greedy tokens) at position 0, against a
    throwaway cache of those rows, and keeps nothing.  A rank that is a
    process of its own pays its first calls here (CUDA modules loaded at
    first launch, cuBLAS handles), every rank at once, where the first
    serve step would add them up stage after stage; the served caches and
    positions are not touched.  Stage 0 embeds token 0 (zero embeddings
    for an embed-input config), the others take zeros; an MoE layout's
    exchanges run over every rank of the data group, in the same order.
    Runs under ``torch.inference_mode()``."""
    if opts.sp_mode:
        raise ValueError("make_warm_fn: no throwaway cache shard under "
                         "sp_mode")
    cfg = model.cfg
    S = model.num_stages
    r = opts.mb_rows
    rank_aux = _rank_aux(model, mesh, opts)

    def warm(stage_params, io):
        stage = mesh.axis_index("model")
        device = io.embed.device
        with torch.inference_mode():
            cache = model.init_stage_cache(r, opts.cache_len, opts.enc_len,
                                           device=device)
            x = torch.zeros((r, 1, cfg.d_model), dtype=cfg.dtype,
                            device=device)
            if stage == 0 and not cfg.embed_input:
                x = io.embed[torch.zeros((r,), dtype=torch.int64,
                                         device=device)][:, None]
            y, _ = model.stage_decode(stage_params, io, x, cache, 0,
                                      rank_aux(), model.rows(stage))
            if stage == S - 1:
                _greedy(io, y, cfg)

    return warm


def make_staircase_fn(model: ArchModel, opts: DecodeOptions,
                      num_groups: int):
    """Returns fn(stage_params, io, caches, batch, pos) -> next_tokens: the
    serve step of one data rank on one thread.

    ``stage_params`` and ``caches`` are per-stage lists (caches as made by
    ``ArchModel.init_stage_cache``, leaves ``[l_max, B, ...]``); ``batch``
    carries ``tokens`` [B] (or ``embeds`` [B, 1, d] for embed_input archs)
    with B = num_groups * mb_rows; ``pos`` is the current position (an
    int).  Returns the greedy next tokens [B] (int64) and updates
    ``caches`` in place.  Runs under ``torch.inference_mode()``.
    """
    if opts.sp_mode:
        raise ValueError("sp_mode shards the caches over data ranks: "
                         "use make_serve_fn on a mesh")
    cfg = model.cfg
    S = model.num_stages
    M = num_groups
    r = opts.mb_rows
    rows = [model.rows(s) for s in range(S)]
    aux = {"data_size": 1, "moe_layout": "none"}  # experts computed locally

    def serve_step(stage_params, io, caches, batch, pos):
        with torch.inference_mode():
            acts = {}  # micro-group -> its activation after the last stage run
            out = []
            for t in range(M + S - 1):
                for s in range(S):
                    mb = t - s
                    if not 0 <= mb < M:
                        continue
                    x = (_embed_group(cfg, io, batch, mb, r) if s == 0
                         else acts[mb])
                    cache_mb = tree_map(lambda c: c[:, mb * r:(mb + 1) * r],
                                        caches[s])
                    acts[mb], _ = model.stage_decode(
                        stage_params[s], io, x, cache_mb, pos, aux, rows[s])
                    if s == S - 1:
                        out.append(_greedy(io, acts.pop(mb), cfg))
            return torch.cat(out)

    return serve_step
