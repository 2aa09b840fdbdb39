"""Per-stage callables for the actor runtime (PyTorch port).

Port of ``repro.pipeline.stagefn``.  One independently callable function
per (stage, op) that a host thread runs the moment the stage's message
arrives, and :class:`ActorStageProgram`, the ``work_fn(task, payload)`` a
stage actor drives.  The backward recipe is the reference's remat recipe:
F runs under ``torch.no_grad()`` and stashes its input; B (and W) re-run
the stage forward from that input and differentiate a scalar objective
(the CE loss at the last stage, ``<y, g_in>`` elsewhere).

Gradients come from ``torch.autograd.grad(..., inputs=...)``, never
``.backward()``: the stage actors run on threads and share the IO
parameters, so accumulating into ``.grad`` would race and make the fold
order depend on thread timing.  Per-parameter gradients are tuples in
``module.parameters()`` order; ``None`` marks a parameter the objective
does not reach (the embedding at a middle stage, a disabled slot).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.taskgraph import Kind, Task
from repro_torch.models.build import ArchModel
from repro_torch.models.layers import rmsnorm


@dataclasses.dataclass(frozen=True)
class StageFnOptions:
    mb_rows: int             # microbatch rows
    seq_len: int             # tokens per row
    ce_chunk: int = 0        # 0 -> auto from vocab size
    loss_scale: float = 1.0  # applied to the backward seed


def default_ce_chunk(cfg, requested: int = 0) -> int:
    if requested:
        return requested
    v = cfg.padded_vocab()
    return max(64, min(2048, (1 << 24) // v * 4))


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------
def _ce_chunk_sum(h_c, l_c, head):
    logits = (h_c @ head.T).float()
    lse = torch.logsumexp(logits, dim=-1)
    pick = torch.gather(logits, 1, l_c.clamp_min(0)[:, None])[:, 0]
    w = (l_c >= 0).float()
    return torch.sum((lse - pick) * w)


def chunked_ce_sum(model: ArchModel, io, y, labels, chunk: int):
    """Sum of token cross-entropies over token chunks (bounded logits
    working set; each chunk checkpointed so backward recomputes it)."""
    cfg = model.cfg
    h = rmsnorm(y, io.final_ln, cfg.norm_eps)
    d = h.shape[-1]
    h2 = h.reshape(-1, d)
    l2 = labels.reshape(-1)
    pad = (-h2.shape[0]) % chunk
    if pad:
        h2 = F.pad(h2, (0, 0, 0, pad))
        l2 = F.pad(l2, (0, pad), value=-1)
    total = torch.zeros((), dtype=torch.float32, device=y.device)
    for c in range(0, h2.shape[0], chunk):
        args = (h2[c:c + chunk], l2[c:c + chunk], io.head)
        if torch.is_grad_enabled():
            part = checkpoint(_ce_chunk_sum, *args, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            part = _ce_chunk_sum(*args)
        total = total + part
    return total


# ---------------------------------------------------------------------------
# per-stage callables
# ---------------------------------------------------------------------------
class StageFns:
    """Forward/backward per stage of a single-process pipeline.

    ``forward(s)(sp_s, io, x, bm) -> (y, loss_sum)`` — loss_sum nonzero only
    at the last stage.  ``backward(s)(sp_s, io, x, g_in, bm) ->
    (dx, d_stage, d_io)`` — g_in ignored at the last stage.  Under the BFW
    decomposition: ``backward_dx(s)(...) -> dx`` (the B task) and
    ``weight_grad(s)(...) -> (d_stage, d_io)`` (the deferrable W task),
    both over the same objective as the fused backward.
    """

    def __init__(self, model: ArchModel, opts: StageFnOptions):
        self.model = model
        self.opts = opts
        self.ce_chunk = default_ce_chunk(model.cfg, opts.ce_chunk)

    # ---- helpers -------------------------------------------------------
    def _aux(self, bm: dict) -> dict:
        seq = self.opts.seq_len
        device = bm["labels"].device
        pos = torch.arange(seq, dtype=torch.int32, device=device)
        a = {"positions": pos[None].expand(self.opts.mb_rows, seq)}
        if "mrope" in bm:
            a["mrope"] = bm["mrope"]
        return a

    def _embed(self, io, bm: dict):
        cfg = self.model.cfg
        if cfg.embed_input:
            return bm["embeds"].to(cfg.dtype)
        return io.embed[bm["tokens"]]

    def _stage_out(self, stage: int, sp_s, io, x, bm):
        model = self.model
        x0 = self._embed(io, bm).to(model.cfg.dtype) if stage == 0 else x
        return model.stage_forward(sp_s, io, x0, self._aux(bm),
                                   model.rows(stage))

    def _objective(self, stage: int, sp_s, io, x, g_in, bm):
        y = self._stage_out(stage, sp_s, io, x, bm)
        if stage == self.model.num_stages - 1:
            return chunked_ce_sum(self.model, io, y, bm["labels"],
                                  self.ce_chunk) * self.opts.loss_scale
        return torch.sum(y.float() * g_in.float())

    def _grads(self, stage, sp_s, io, x, g_in, bm, *, want_x: bool,
               want_params: bool):
        """(dx, d_stage, d_io) of the objective for the requested inputs."""
        xg = x.detach().requires_grad_() if (want_x and x is not None) else x
        sp_p = tuple(sp_s.parameters()) if want_params else ()
        io_p = tuple(io.parameters()) if want_params else ()
        inputs = sp_p + io_p + ((xg,) if want_x and x is not None else ())
        with torch.enable_grad():
            obj = self._objective(stage, sp_s, io, xg, g_in, bm)
            grads = torch.autograd.grad(obj, inputs, allow_unused=True)
        n = len(sp_p)
        dx = grads[-1] if want_x and x is not None else None
        return dx, grads[:n], grads[n:n + len(io_p)]

    # ---- public --------------------------------------------------------
    def forward(self, stage: int):
        last = stage == self.model.num_stages - 1

        def f(sp_s, io, x, bm):
            with torch.no_grad():
                y = self._stage_out(stage, sp_s, io, x, bm)
                loss = (chunked_ce_sum(self.model, io, y, bm["labels"],
                                       self.ce_chunk)
                        if last else torch.zeros((), dtype=torch.float32,
                                                 device=y.device))
            return y, loss

        return f

    def backward(self, stage: int):
        def b(sp_s, io, x, g_in, bm):
            return self._grads(stage, sp_s, io, x, g_in, bm, want_x=True,
                               want_params=True)

        return b

    def backward_dx(self, stage: int):
        """dX-only backward (the B task of the BFW decomposition)."""
        def b_dx(sp_s, io, x, g_in, bm):
            return self._grads(stage, sp_s, io, x, g_in, bm, want_x=True,
                               want_params=False)[0]

        return b_dx

    def weight_grad(self, stage: int):
        """Per-microbatch weight gradient (the deferrable W task)."""
        def w(sp_s, io, x, g_in, bm):
            _, dsp, dio = self._grads(stage, sp_s, io, x, g_in, bm,
                                      want_x=False, want_params=True)
            return dsp, dio

        return w


def microbatch(batch: dict, mb: int, mb_rows: int) -> dict:
    """Microbatch slice of a [M*mb_rows, ...] batch dict."""
    lo, hi = mb * mb_rows, (mb + 1) * mb_rows
    out = {}
    for k, v in batch.items():
        if k == "mrope":
            out[k] = v[:, lo:hi]
        else:
            out[k] = v[lo:hi]
    return out


def accumulate(acc: list, grads) -> None:
    """``acc[i] += grads[i]`` in place; ``None`` entries are zero (an
    accumulator is created on its first gradient)."""
    for i, g in enumerate(grads):
        if g is None:
            continue
        if acc[i] is None:
            acc[i] = torch.zeros_like(g)
        acc[i].add_(g)


# ---------------------------------------------------------------------------
# actor-runtime adapter
# ---------------------------------------------------------------------------
class ActorStageProgram:
    """``work_fn(task, payload)`` for one stage actor driving real callables.

    F: consume the upstream activation payload (None at stage 0), run the
    forward without autograd, stash the stage input, emit y.  B (fused):
    consume the downstream gradient payload (None at the last stage),
    re-run the forward under autograd, accumulate parameter grads, emit dx.

    With ``split_backward=True`` (the BFW decomposition) B computes only dx
    and stashes (x, g_in) for its W task (stage 0 skips dx: nobody consumes
    it); W computes and accumulates the parameter grads and emits nothing.

    The running loss is kept as a device tensor — reading ``loss_sum``
    materializes it (one sync), so F never blocks on the device.

    With ``deterministic_reduction=True`` per-microbatch loss and grad
    contributions are stashed and :meth:`finalize` folds them in
    microbatch order, so the final bits do not depend on the dispatch
    order of the same task set.
    """

    def __init__(self, fns: StageFns, stage: int, sp_s, io, batch: dict,
                 *, split_backward: bool = False,
                 deterministic_reduction: bool = False):
        self.fns = fns
        self.stage = stage
        self.sp_s = sp_s
        self.io = io
        self.batch = batch
        self.split_backward = split_backward
        self.deterministic_reduction = deterministic_reduction
        self.residual: dict[int, Any] = {}  # mb -> stage input
        #: BFW: mb -> (x, g_in) held from B-time until the W task fires
        self.w_pending: dict[int, tuple[Any, Any]] = {}
        self.w_high_water = 0  # max outstanding W stashes (memory bound)
        self.d_stage: list = [None] * len(tuple(sp_s.parameters()))
        self.d_io: list = [None] * len(tuple(io.parameters()))
        self.loss_acc = torch.zeros((), dtype=torch.float32,
                                    device=batch["labels"].device)
        #: deterministic mode: mb -> stashed contributions, folded by finalize
        self._mb_loss: dict[int, Any] = {}
        self._mb_grads: dict[int, tuple[Any, Any]] = {}
        #: highest microbatch already folded — guards against mid-run folds
        self._loss_folded: int | None = None
        self._grads_folded: int | None = None

    def _add_grads(self, mb: int, dsp, dio) -> None:
        if self.deterministic_reduction:
            self._mb_grads[mb] = (dsp, dio)
            return
        accumulate(self.d_stage, dsp)
        accumulate(self.d_io, dio)

    def finalize(self) -> "ActorStageProgram":
        """Fold stashed per-microbatch contributions in microbatch order.

        Idempotent; a no-op under eager accumulation.  Folding a microbatch
        below an already-folded one raises: a mid-run read would otherwise
        pin the early microbatches' place in the reduction order.
        """
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
            dsp, dio = self._mb_grads[mb]
            accumulate(self.d_stage, dsp)
            accumulate(self.d_io, dio)
        self._mb_grads.clear()
        return self

    @property
    def loss_sum(self) -> float:
        """Materialized loss total (forces one device sync per read)."""
        self.finalize()
        return float(self.loss_acc)

    def w_outstanding(self) -> int:
        """Un-executed W tasks currently holding activation memory."""
        return len(self.w_pending)

    def __call__(self, task: Task, payload: Any) -> Any:
        bm = microbatch(self.batch, task.mb, self.fns.opts.mb_rows)
        if task.kind == Kind.F:
            x = None if payload is None else payload.detach()
            y, loss = self.fns.forward(self.stage)(self.sp_s, self.io, x, bm)
            self.residual[task.mb] = x
            if self.deterministic_reduction:
                self._mb_loss[task.mb] = loss
            else:
                self.loss_acc = self.loss_acc + loss
            return y
        if task.kind == Kind.B:
            x = self.residual.pop(task.mb)
            g_in = payload  # None at the last stage: the loss is the seed
            if self.split_backward:
                self.w_pending[task.mb] = (x, g_in)
                self.w_high_water = max(self.w_high_water,
                                        len(self.w_pending))
                if self.stage == 0:
                    return None  # nobody consumes stage 0's input gradient
                return self.fns.backward_dx(self.stage)(
                    self.sp_s, self.io, x, g_in, bm)
            dx, dsp, dio = self.fns.backward(self.stage)(
                self.sp_s, self.io, x, g_in, bm)
            self._add_grads(task.mb, dsp, dio)
            return dx
        if task.kind == Kind.W:
            if not self.split_backward:
                raise ValueError(
                    f"{task!r} dispatched to a fused-backward stage program "
                    f"(construct ActorStageProgram with split_backward=True)")
            x, g_in = self.w_pending.pop(task.mb)
            dsp, dio = self.fns.weight_grad(self.stage)(
                self.sp_s, self.io, x, g_in, bm)
            self._add_grads(task.mb, dsp, dio)
            return None  # stage-local: no outgoing envelope
        raise ValueError(f"actor stage program cannot run {task!r}")
