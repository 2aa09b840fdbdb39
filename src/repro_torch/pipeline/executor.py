"""Schedule-table-driven SPMD pipeline executor (DESIGN §2), PyTorch port.

Port of ``repro.pipeline.executor``.  One rank program executes ANY valid
ScheduleTable (1F1B, GPipe, ZB-lite, RRFP-synthesized): per tick each
stage looks up its (op, microbatch) entry and runs F / B / W / idle.
Activations and gradients move on ring permutes (one hop per tick) into
slotted per-rank buffers — the analog of the paper's four per-stage
message buffers; buffer capacities come from the table validator (= the
App. C limit).

The reference runs the program as one ``shard_map`` over a ``(data,
model)`` device mesh; the port runs it on a
:class:`~repro_torch.launch.mesh.Mesh` of ranks, one thread per rank
(``mesh.run(fn, per_rank_args)``).  The table is host data, so the
per-tick ``switch`` is a host branch and the microbatch of a message is a
host integer.

Backward is remat-based, on the actor runtime's per-stage callables
(``pipeline/stagefn.py``): B re-runs the stage forward under autograd of a
scalarized objective (CE at the last stage, <y, g_in> elsewhere), so no
activation stack is kept beyond each microbatch's stage input.  An enc-dec
config (``encoder_layers``) carries ``ExecOptions.enc_len`` encoder frames
after the decoder tokens of every row: buffers and messages are
``seq_len + enc_len`` long (the reference's ``_eff_seq``), stage 0 appends
the batch's ``enc_embeds`` to the token embeddings, and the loss reads the
decoder positions.  Under the MoE ``ep``/``tp`` layouts over more than
one data rank a rank holds its shard of the routed experts: its stage
callables exchange tokens over the ``data`` group (the reference's
``axis_name="data"``) between the phases of the stage cut at its
exchanges, in F and in B/W (``pipeline/stagefn.py``), and the experts'
grads stay local.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.build import ArchModel
from repro_torch.pipeline.sharding import ParamPartition, flat_leaf
from repro_torch.pipeline.spec import OP_B, OP_F, OP_IDLE, OP_W, ScheduleTable
from repro_torch.pipeline.stagefn import StageFnOptions, StageFns, microbatch


@dataclasses.dataclass(frozen=True)
class ExecOptions:
    mb_rows: int            # microbatch rows per data shard
    seq_len: int            # decoder/self-attn token length per row
    enc_len: int = 0        # encoder frames (enc-dec archs)
    grad_dtype: Any = torch.float32   # stage-grad accumulators
    io_grad_dtype: Any = torch.bfloat16  # embed/head accumulators (huge)
    flat_dtype: Any = torch.bfloat16  # ZeRO-1 reduce-scatter payload
    ce_chunk: int = 0       # 0 -> auto from vocab size
    loss_scale: float = 1.0  # applied to the backward seed
    dp_axes: tuple = ("data",)
    multi_pod: bool = False

    @property
    def all_dp_axes(self) -> tuple:
        return (("pod",) + self.dp_axes) if self.multi_pod else self.dp_axes


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------
def make_train_fn(model: ArchModel, table: ScheduleTable, mesh,
                  opts: ExecOptions, partition: ParamPartition):
    """Returns ``(fn, batch_specs)``: the rank program ``fn(stage_params,
    io_params, batch) -> (metrics, grad_shards, expert_grads)``, run on
    every rank by ``mesh.run`` (the reference's ``shard_map``), and the
    batch's layout over the mesh (:func:`shard_batch`).

    A rank holds its stage's module, its own copy of the io module and its
    data shard of the batch.  ``grad_shards`` maps each data-replicated
    leaf (stage leaves, then ``io:`` leaves) to this rank's ZeRO-1
    reduce-scattered ``flat_dtype`` shard; ``expert_grads`` holds the
    data-sharded leaves (EP/TP experts) stacked ``[l_max, ...]``, locally
    reduced by construction.  ``metrics`` (``loss_sum``, ``loss``) is the
    same on every rank.
    """
    cfg = model.cfg
    S = model.num_stages
    if mesh.shape["model"] != S:
        raise ValueError(f"{S} stages on a model axis of "
                         f"{mesh.shape['model']}")
    occ = table.validate()
    K_act = max(1, occ["act_span"])
    K_res = max(1, occ["res_span"])
    K_grad = max(1, occ["grad_span"])
    M = table.spec.num_microbatches
    T = table.num_ticks
    split = table.spec.split_backward
    d = cfg.d_model
    mb_rows, seq = opts.mb_rows, opts.seq_len
    dp_axes = opts.all_dp_axes
    dp_total = mesh.group_size(dp_axes)
    fwd_perm = [(i, i + 1) for i in range(S - 1)]
    bwd_perm = [(i, i - 1) for i in range(1, S)]
    ops_arr = np.asarray(table.ops)
    mbs_arr = np.asarray(table.mbs)
    fns = stage_fns(model, mesh, opts)
    eff_seq = fns.eff_seq
    flags = partition.stage_data_sharded

    def fn(stage_params, io, batch):
        stage = mesh.axis_index("model")
        last = stage == S - 1
        device = batch["labels"].device
        dt = cfg.dtype
        forward = fns.forward(stage)
        backward = fns.backward(stage)
        backward_dx = fns.backward_dx(stage)
        weight_grad = fns.weight_grad(stage)

        def zeros():
            return torch.zeros((mb_rows, eff_seq, d), dtype=dt,
                               device=device)

        act_buf = [zeros() for _ in range(K_act)]
        grad_buf = [zeros() for _ in range(K_grad)]
        # stage 0's input is its microbatch's tokens: B and W embed again
        res_buf: list = [None] * K_res
        send_act = (zeros(), 0, False)
        send_grad = (zeros(), 0, False)
        # a data-sharded (expert) leaf accumulates in one stacked [l_max,
        # ...] tensor whose slots are views: it leaves as is, no copy
        params = list(stage_params.parameters())
        d_stage: list = [None] * len(params)
        expert_acc: dict[str, torch.Tensor] = {}
        for k, idx in partition.stage_slots.items():
            if flags[k]:
                acc = expert_acc[k] = torch.zeros(
                    (len(idx),) + tuple(params[idx[0]].shape),
                    dtype=opts.grad_dtype, device=device)
                for j, i in enumerate(idx):
                    d_stage[i] = acc[j]
        d_stage = [torch.zeros(p.shape, dtype=opts.grad_dtype, device=device)
                   if acc is None else acc for p, acc in zip(params, d_stage)]
        d_io = [torch.zeros(p.shape, dtype=opts.io_grad_dtype, device=device)
                for p in io.parameters()]
        loss = torch.zeros((), dtype=torch.float32, device=device)

        def accumulate(dsp, dio):
            for acc, g in zip(d_stage, dsp):
                if g is not None:
                    acc.add_(g.to(opts.grad_dtype))
            for acc, g in zip(d_io, dio):
                if g is not None:  # rounded at every add (bf16 default)
                    acc.add_(g.to(opts.io_grad_dtype))

        for t in range(T):
            # deliver messages sent at t-1 (one ring hop per direction)
            ra, rm, rv = mesh.ppermute(send_act, "model", fwd_perm)
            if rv:
                act_buf[rm % K_act] = ra
            rga, rgm, rgv = mesh.ppermute(send_grad, "model", bwd_perm)
            if rgv:
                grad_buf[rgm % K_grad] = rga
            send_act = (send_act[0], send_act[1], False)
            send_grad = (send_grad[0], send_grad[1], False)
            op, mb = int(ops_arr[stage, t]), int(mbs_arr[stage, t])
            if op == OP_IDLE:
                continue
            bm = microbatch(batch, mb, mb_rows)
            if op == OP_F:
                x_in = None if stage == 0 else act_buf[mb % K_act]
                y, loss_inc = forward(stage_params, io, x_in, bm)
                res_buf[mb % K_res] = x_in
                loss = loss + loss_inc
                send_act = (y, mb, not last)
                continue
            g_in = grad_buf[mb % K_grad]
            x_in = res_buf[mb % K_res]
            if op == OP_B and split:
                # stage 0's input gradient has no receiver: not computed
                if stage > 0:
                    send_grad = (backward_dx(stage_params, io, x_in, g_in,
                                             bm).to(dt), mb, True)
            elif op == OP_B:
                dx, dsp, dio = backward(stage_params, io, x_in, g_in, bm)
                accumulate(dsp, dio)
                if stage > 0:
                    send_grad = (dx.to(dt), mb, True)
            elif op == OP_W and split:
                accumulate(*weight_grad(stage_params, io, x_in, g_in, bm))
            elif op != OP_W:
                raise ValueError(f"tick {t}: unknown op {op}")

        # ---- reductions -----------------------------------------------
        loss_sum = mesh.psum(loss, ("model",) + dp_axes)

        def rs(vec):
            """Per-leaf ZeRO-1 reduce-scatter over the DP axes."""
            v = vec.to(opts.flat_dtype)
            v = F.pad(v, (0, (-v.numel()) % dp_total))
            return mesh.psum_scatter(v.reshape(dp_total, -1), dp_axes)

        grad_shards: dict[str, torch.Tensor] = {}
        expert_grads: dict[str, torch.Tensor] = {}
        for k, slots in partition.stage_leaves(d_stage).items():
            if flags[k]:
                # expert (data-sharded) grads stay local
                expert_grads[k] = expert_acc[k]
            else:
                grad_shards[k] = rs(flat_leaf(slots))
        for k, leaf in partition.io_leaves(d_io).items():
            # io grads: stage-masked contributions -> sum over model first
            grad_shards["io:" + k] = rs(mesh.psum(leaf, "model").reshape(-1))
        metrics = {
            "loss_sum": loss_sum,
            "loss": loss_sum / (M * mb_rows * seq * dp_total),
        }
        return metrics, grad_shards, expert_grads

    return fn, make_batch_specs(model, opts)


def stage_fns(model: ArchModel, mesh, opts: ExecOptions) -> StageFns:
    """The stage callables of :func:`make_train_fn`'s rank program (a
    stage that exchanges MoE tokens does so over the ``data`` group)."""
    return StageFns(model, StageFnOptions(
        mb_rows=opts.mb_rows, seq_len=opts.seq_len, ce_chunk=opts.ce_chunk,
        loss_scale=opts.loss_scale, data_size=mesh.shape["data"],
        moe_layout=model.moe_layout, enc_len=opts.enc_len,
        exchange=mesh.exchange_over("data")))


def grad_shard_specs(model: ArchModel, partition: ParamPartition,
                     opts: ExecOptions) -> dict[str, tuple]:
    """Leaf -> the global layout of its per-leaf ZeRO-1 grad shards: the
    reference's ``P("model", dp_axes)``, i.e. ``[S, dp_total * n]``."""
    spec = ("model", opts.all_dp_axes)
    out = {k: spec for k in partition.stage_keys
           if not partition.stage_data_sharded[k]}
    out.update({"io:" + k: spec for k in partition.io_keys})
    return out


def make_batch_specs(model: ArchModel, opts: ExecOptions
                     ) -> dict[str, tuple[int, tuple]]:
    """Batch key -> (its row dimension, the axes that dimension is split
    over): the reference's ``P(dp_axes)`` (``P(None, dp_axes)`` for the
    ``[3, rows, seq]`` M-RoPE positions)."""
    cfg = model.cfg
    axes = opts.all_dp_axes
    specs = {"tokens": (0, axes), "labels": (0, axes)}
    if cfg.embed_input:
        specs["embeds"] = (0, axes)
    if cfg.mrope:
        specs["mrope"] = (1, axes)
    if cfg.encoder_layers:
        specs["enc_embeds"] = (0, axes)
    return specs


def shard_batch(mesh, batch: dict, specs: dict) -> list:
    """Each local rank's copy of its data shard of a global batch (rows
    split evenly over the spec's axes, in group-index order; a spec None
    copies the whole entry), in a list by rank (None for a rank of another
    process)."""
    return mesh.per_rank(lambda r: _shard(mesh, batch, specs, r))


def _shard(mesh, batch: dict, specs: dict, r: int) -> dict:
    shard = {}
    for k, spec in specs.items():
        v = batch[k]
        if spec is None:
            shard[k] = v.clone()
            continue
        dim, axes = spec
        n = v.shape[dim] // mesh.group_size(axes)
        i = mesh.group_index(axes, r)
        shard[k] = v.narrow(dim, i * n, n).clone()
    return shard
