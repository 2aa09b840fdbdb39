"""Per-stage callables + actor-runtime adapter for the DAG pipeline (port).

Port of ``repro.multimodal.stagefn``.  ``MultimodalStageFns`` mirrors
``pipeline.stagefn.StageFns`` for the branch+fusion topology: one callable
per (stage, op) that a host thread runs the moment the stage's message set
arrives.  F runs under ``torch.no_grad()``; the backward re-runs the stage
forward under autograd and differentiates a scalar objective (CE at the
sink, ``<y, g_in>`` elsewhere); under the BFW decomposition it splits into
a dX-only B and a deferrable W, as on the linear chain.  Gradients come
from ``torch.autograd.grad(..., inputs=...)`` (stage actors run on
threads); per-parameter gradients are tuples in ``module.parameters()``
order, ``None`` where the objective does not reach a parameter.

The port runs eagerly, so a new encoder bucket costs no compilation and
there is no counterpart of the reference's ``compile_cache_sizes``.

``MultimodalStageProgram`` adapts the callables to the actor runtime's
``work_fn(task, payload)`` protocol, with the DAG payload routing: the
fusion stage's F consumes a ``{src_stage: payload}`` dict (one activation
per incoming edge) and its B returns ``EdgePayloads`` (one input gradient
per branch).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.taskgraph import Kind, Task
from repro_torch.multimodal.model import MultimodalModel
from repro_torch.pipeline.stagefn import accumulate
from repro_torch.runtime.rrfp.messages import EdgePayloads


@dataclasses.dataclass(frozen=True)
class MultimodalStageOptions:
    mb_rows: int             # microbatch rows
    loss_scale: float = 1.0  # applied to the CE objective


class MultimodalStageFns:
    """Forward/backward per stage of the branch+fusion pipeline."""

    def __init__(self, model: MultimodalModel, opts: MultimodalStageOptions):
        self.model = model
        self.cfg = model.cfg
        self.opts = opts

    # ---- shared scalarized objective -----------------------------------
    def _objective(self, stage: int, p, inputs: tuple, g_in, labels):
        """CE at the sink stage; <y, g_in> elsewhere.  ``inputs`` is the
        stage's input tuple (see ``_forward_y``)."""
        y = self._forward_y(stage, p, inputs)
        if stage == self.cfg.num_stages - 1:
            return self.model.loss_sum(p, y, labels) * self.opts.loss_scale
        return torch.sum(y.float() * g_in.float())

    def _forward_y(self, stage: int, p, inputs: tuple):
        role = self.cfg.role_of(stage)
        if role == "encoder":
            x, length = inputs
            return self.model.encoder_forward(stage, p, x, length)
        if role == "text":
            (tokens,) = inputs
            return self.model.text_forward(p, tokens)
        if role == "fusion":
            x_enc, x_txt, length = inputs
            return self.model.fusion_forward(p, x_enc, length, x_txt)
        (x,) = inputs
        return self.model.lm_forward(p, x)

    def _diff_index(self, stage: int) -> tuple[int, ...]:
        """Positions in ``inputs`` that carry input gradients (not the
        integer length or token operands)."""
        return {"encoder": (0,), "text": (), "fusion": (0, 1),
                "lm": (0,)}[self.cfg.role_of(stage)]

    def _grads(self, stage: int, p, inputs: tuple, g_in, labels, *,
               want_x: bool, want_params: bool):
        """(dxs, dp) of the objective for the requested inputs."""
        inputs = list(inputs)
        xs = []
        if want_x:
            for i in self._diff_index(stage):
                inputs[i] = inputs[i].detach().requires_grad_()
                xs.append(inputs[i])
        params = tuple(p.parameters()) if want_params else ()
        with torch.enable_grad():
            obj = self._objective(stage, p, tuple(inputs), g_in, labels)
            grads = torch.autograd.grad(obj, params + tuple(xs),
                                        allow_unused=True)
        return tuple(grads[len(params):]), grads[:len(params)]

    # ---- public ops ----------------------------------------------------
    def forward(self, stage: int):
        """f(p, inputs, labels) -> (y, loss_sum) — loss nonzero at sink."""
        last = stage == self.cfg.num_stages - 1

        def f(p, inputs, labels):
            with torch.no_grad():
                y = self._forward_y(stage, p, inputs)
                # unscaled CE sum (loss_scale seeds the backward only, like
                # the linear-chain StageFns)
                loss = (self.model.loss_sum(p, y, labels) if last else
                        torch.zeros((), dtype=torch.float32, device=y.device))
            return y, loss

        return f

    def backward(self, stage: int):
        """Fused backward: f(p, inputs, g_in, labels) -> (dxs, dp)."""
        def b(p, inputs, g_in, labels):
            return self._grads(stage, p, inputs, g_in, labels, want_x=True,
                               want_params=True)

        return b

    def backward_dx(self, stage: int):
        """dX-only backward (the B task of the BFW decomposition)."""
        def b(p, inputs, g_in, labels):
            return self._grads(stage, p, inputs, g_in, labels, want_x=True,
                               want_params=False)[0]

        return b

    def weight_grad(self, stage: int):
        """Per-microbatch weight gradient (the deferrable W task)."""
        def w(p, inputs, g_in, labels):
            return self._grads(stage, p, inputs, g_in, labels, want_x=False,
                               want_params=True)[1]

        return w


# ---------------------------------------------------------------------------
# actor-runtime adapter
# ---------------------------------------------------------------------------
class MultimodalStageProgram:
    """``work_fn(task, payload)`` for one DAG stage driving real callables.

    Payload protocol (set by the runtime's fan-in/fan-out rules):

    * single-predecessor F tasks receive the upstream activation tensor;
      the fusion stage's F receives ``{src_stage: activation}``;
    * the fusion stage's B returns ``EdgePayloads`` with one input
      gradient per incoming branch; every other B returns its dx (or None
      at branch roots, whose input gradient nobody consumes);
    * W is stage-local and returns None.

    ``batch``: ``tokens``/``labels`` tensors ``[M*mb_rows, text_seq]`` on
    the device, ``enc_embeds`` (M tensors ``[mb_rows, padded_len, d_enc]``)
    and ``enc_lens`` (M valid counts, host integers).

    With ``deterministic_reduction=True`` per-microbatch loss/grad
    contributions are stashed and :meth:`finalize` folds them in microbatch
    order, making the final bits independent of the runtime's dispatch
    order.
    """

    def __init__(self, fns: MultimodalStageFns, stage: int, params,
                 batch: dict, *, split_backward: bool = False,
                 deterministic_reduction: bool = False):
        self.fns = fns
        self.cfg = fns.cfg
        self.stage = stage
        self.params = params
        self.batch = batch
        self.split_backward = split_backward
        self.deterministic_reduction = deterministic_reduction
        self.residual: dict[int, tuple] = {}   # mb -> stage input tuple
        #: BFW: mb -> (inputs, g_in) held from B-time until W fires
        self.w_pending: dict[int, tuple] = {}
        self.w_high_water = 0
        self.d_params: list = [None] * len(tuple(params.parameters()))
        self.loss_acc = torch.zeros((), dtype=torch.float32,
                                    device=batch["labels"].device)
        self._mb_loss: dict[int, Any] = {}
        self._mb_grads: dict[int, Any] = {}
        self._loss_folded: int | None = None
        self._grads_folded: int | None = None

    # ---- batch slicing -------------------------------------------------
    def _mb_tokens(self, mb: int):
        r = self.fns.opts.mb_rows
        return self.batch["tokens"][mb * r:(mb + 1) * r]

    def _mb_labels(self, mb: int):
        r = self.fns.opts.mb_rows
        return self.batch["labels"][mb * r:(mb + 1) * r]

    def _mb_enc(self, mb: int):
        return self.batch["enc_embeds"][mb]

    def _mb_len(self, mb: int) -> int:
        return int(self.batch["enc_lens"][mb])

    # ---- inputs per role -----------------------------------------------
    def _f_inputs(self, mb: int, payload) -> tuple:
        role = self.cfg.role_of(self.stage)
        if role == "encoder":
            x = payload if self.stage > 0 else self._mb_enc(mb)
            return (x, self._mb_len(mb))
        if role == "text":
            return (self._mb_tokens(mb),)
        if role == "fusion":
            enc_src = self.cfg.enc_stages - 1
            return (payload[enc_src], payload[self.cfg.text_stage],
                    self._mb_len(mb))
        return (payload,)

    # ---- accumulation ---------------------------------------------------
    def _add_grads(self, mb: int, dp) -> None:
        if self.deterministic_reduction:
            self._mb_grads[mb] = dp
            return
        accumulate(self.d_params, dp)

    def finalize(self) -> "MultimodalStageProgram":
        """Fold stashed contributions in microbatch order (idempotent; a
        fold below an already-folded microbatch raises — see
        ``ActorStageProgram.finalize`` for why mid-run folds are unsafe)."""
        def fold_guard(kind: str, folded: int | None, keys) -> int | None:
            if folded is not None and keys and min(keys) < folded:
                raise RuntimeError(
                    f"stage {self.stage}: deterministic {kind} fold of "
                    f"microbatch {min(keys)} after microbatch {folded} was "
                    f"already folded — finalize()/loss_sum was read mid-run")
            return max(keys, default=folded) if keys else folded

        self._loss_folded = fold_guard(
            "loss", self._loss_folded, list(self._mb_loss))
        for mb in sorted(self._mb_loss):
            self.loss_acc = self.loss_acc + self._mb_loss[mb]
        self._mb_loss.clear()
        self._grads_folded = fold_guard(
            "grad", self._grads_folded, list(self._mb_grads))
        for mb in sorted(self._mb_grads):
            accumulate(self.d_params, self._mb_grads[mb])
        self._mb_grads.clear()
        return self

    @property
    def loss_sum(self) -> float:
        """Materialized loss total (forces one device sync per read)."""
        self.finalize()
        return float(self.loss_acc)

    def w_outstanding(self) -> int:
        return len(self.w_pending)

    # ---- work_fn ---------------------------------------------------------
    def __call__(self, task: Task, payload: Any) -> Any:
        cfg, fns = self.cfg, self.fns
        last = self.stage == cfg.num_stages - 1
        labels = self._mb_labels(task.mb) if last else None
        if task.kind == Kind.F:
            inputs = self._f_inputs(task.mb, payload)
            y, loss = fns.forward(self.stage)(self.params, inputs, labels)
            self.residual[task.mb] = inputs
            if last:
                if self.deterministic_reduction:
                    self._mb_loss[task.mb] = loss
                else:
                    self.loss_acc = self.loss_acc + loss
            return y
        if task.kind == Kind.B:
            inputs = self.residual.pop(task.mb)
            g_in = payload  # None at the sink: the loss is the seed
            if self.split_backward:
                self.w_pending[task.mb] = (inputs, g_in)
                self.w_high_water = max(self.w_high_water,
                                        len(self.w_pending))
                return self._emit_dx(task, inputs, g_in, labels)
            dxs, dp = fns.backward(self.stage)(
                self.params, inputs, g_in, labels)
            self._add_grads(task.mb, dp)
            return self._route_dx(dxs)
        if task.kind == Kind.W:
            if not self.split_backward:
                raise ValueError(
                    f"{task!r} dispatched to a fused-backward stage program")
            inputs, g_in = self.w_pending.pop(task.mb)
            dp = fns.weight_grad(self.stage)(
                self.params, inputs, g_in, labels)
            self._add_grads(task.mb, dp)
            return None
        raise ValueError(f"multimodal stage program cannot run {task!r}")

    def _emit_dx(self, task: Task, inputs, g_in, labels):
        """Split-backward B: dX only (skipped at branch roots — nobody
        consumes a source stage's input gradient)."""
        role = self.cfg.role_of(self.stage)
        if role == "text" or (role == "encoder" and self.stage == 0):
            return None
        dxs = self.fns.backward_dx(self.stage)(
            self.params, inputs, g_in, labels)
        return self._route_dx(dxs)

    def _route_dx(self, dxs: tuple):
        """Map the dX tuple onto the outgoing-edge payload protocol."""
        role = self.cfg.role_of(self.stage)
        if role == "fusion":
            return EdgePayloads({
                self.cfg.enc_stages - 1: dxs[0],
                self.cfg.text_stage: dxs[1],
            })
        if role == "text" or not dxs:
            return None
        return dxs[0]
