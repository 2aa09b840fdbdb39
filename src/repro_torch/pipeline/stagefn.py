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
order depend on thread timing.  A stage whose forward exchanges MoE
tokens over its data group (``ArchModel.exchanges``: the ``ep``/``tp``
layouts over more than one data rank, on the table runtime's mesh) takes
the data group's collectives as ``StageFnOptions.exchange`` and runs
cut at them (``ArchModel.stage_phases``, ``models/phases.py``): F runs
the phases with the exchanges in between, and B, the dX-only B and W
differentiate them phase by phase, so that every exchange and its
transpose is called by the rank's thread, between autograd calls.
Per-parameter gradients are tuples in ``module.parameters()`` order;
``None`` marks a parameter the objective does not reach (the embedding at
a middle stage, a disabled slot).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.taskgraph import Kind, Task
from repro_torch.models.build import ArchModel
from repro_torch.models.layers import rmsnorm
from repro_torch.models.phases import chain, phased_grads, run_forward
from repro_torch.obs.spans import profiled


@dataclasses.dataclass(frozen=True)
class StageFnOptions:
    mb_rows: int             # microbatch rows
    seq_len: int             # tokens per row
    ce_chunk: int = 0        # 0 -> auto from vocab size
    loss_scale: float = 1.0  # applied to the backward seed
    data_size: int = 1       # the mesh's data axis (the MoE layouts')
    moe_layout: str = "none"  # none | ep | tp (one device: none)
    enc_len: int = 0         # encoder frames per row (enc-dec archs)
    #: ``exchange(name, x)`` over the data group (``Mesh.exchange_over``):
    #: the MoE layouts' collectives when ``data_size > 1``
    exchange: Callable | None = None


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

    An enc-dec config (``encoder_layers``) takes ``opts.enc_len`` encoder
    frames per row, as the reference's table executor does: stage 0
    embeds the tokens and appends the frames (``bm["enc_embeds"]``), every
    activation is ``seq_len + enc_len`` long, ``aux["dec_len"]`` splits it,
    and the loss reads the first ``seq_len`` positions.  (The reference's
    actor callables give no ``dec_len``; the port's actor launcher stops
    on an enc-dec config, and only the table executor passes ``enc_len``.)
    """

    def __init__(self, model: ArchModel, opts: StageFnOptions):
        self.model = model
        self.opts = opts
        self.ce_chunk = default_ce_chunk(model.cfg, opts.ce_chunk)
        self.enc_dec = bool(model.cfg.encoder_layers)
        if self.enc_dec and opts.enc_len <= 0:
            raise ValueError(
                f"{model.cfg.name} is an enc-dec config: its stage "
                f"callables need enc_len > 0 (encoder frames per row)")
        #: the stage activation's length: the decoder tokens, then (enc-dec
        #: archs) the encoder frames (the reference executor's ``_eff_seq``)
        self.eff_seq = opts.seq_len + (opts.enc_len if self.enc_dec else 0)
        #: the stages whose forward exchanges MoE tokens (phased B and W)
        layout = {"moe_layout": opts.moe_layout, "data_size": opts.data_size}
        self.exchanging = [model.exchanges(model.rows(s), layout)
                           for s in range(model.num_stages)]

    # ---- helpers -------------------------------------------------------
    def _aux(self, bm: dict) -> dict:
        seq = self.eff_seq
        device = bm["labels"].device
        pos = torch.arange(seq, dtype=torch.int32, device=device)
        a = {"positions": pos[None].expand(self.opts.mb_rows, seq),
             "data_size": self.opts.data_size,
             "moe_layout": self.opts.moe_layout}
        if self.enc_dec:
            a["dec_len"] = self.opts.seq_len
        if "mrope" in bm:
            a["mrope"] = bm["mrope"]
        return a

    def _embed(self, io, bm: dict):
        cfg = self.model.cfg
        if cfg.embed_input:
            x = bm["embeds"].to(cfg.dtype)
        else:
            x = io.embed[bm["tokens"]]
        if self.enc_dec:
            x = torch.cat([x, bm["enc_embeds"].to(cfg.dtype)], dim=1)
        return x

    def _loss(self, io, y, bm: dict):
        """The CE sum over the decoder tokens of the last stage's output."""
        if self.enc_dec:
            y = y[:, :self.opts.seq_len]
        return chunked_ce_sum(self.model, io, y, bm["labels"], self.ce_chunk)

    def _stage_in(self, stage: int, io, x, bm):
        """The stage's input: the embedding at stage 0, else ``x``."""
        if stage == 0:
            return self._embed(io, bm).to(self.model.cfg.dtype)
        return x

    def _exchange(self, stage: int):
        if self.opts.exchange is None:
            raise ValueError(f"stage {stage} exchanges MoE tokens over "
                             f"{self.opts.data_size} data ranks: "
                             f"StageFnOptions.exchange is not set")
        return self.opts.exchange

    def _stage_out(self, stage: int, sp_s, io, x, bm):
        model, aux, rows = self.model, self._aux(bm), self.model.rows(stage)
        x0 = self._stage_in(stage, io, x, bm)
        if self.exchanging[stage]:
            phases, cuts = model.stage_phases(sp_s, io, aux, rows,
                                              remat=False)
            return run_forward(phases, cuts, {"x": x0},
                               self._exchange(stage))["x"]
        return model.stage_forward(sp_s, io, x0, aux, rows)

    def _objective_of(self, stage: int, io, y, g_in, bm):
        """The scalar B differentiates from the stage's output ``y``: the
        scaled loss at the last stage, else ``<y, g_in>``."""
        if stage == self.model.num_stages - 1:
            return self._loss(io, y, bm) * self.opts.loss_scale
        return torch.sum(y.float() * g_in.float())

    def _grads(self, stage, sp_s, io, x, g_in, bm, *, want_x: bool,
               want_params: bool):
        """(dx, d_stage, d_io) of the objective for the requested inputs."""
        if self.exchanging[stage]:
            return self._phased_grads(stage, sp_s, io, x, g_in, bm,
                                      want_x=want_x, want_params=want_params)
        xg = x.detach().requires_grad_() if (want_x and x is not None) else x
        sp_p = tuple(sp_s.parameters()) if want_params else ()
        io_p = tuple(io.parameters()) if want_params else ()
        inputs = sp_p + io_p + ((xg,) if want_x and x is not None else ())
        with torch.enable_grad():
            y = self._stage_out(stage, sp_s, io, xg, bm)
            obj = self._objective_of(stage, io, y, g_in, bm)
            grads = torch.autograd.grad(obj, inputs, allow_unused=True)
        n = len(sp_p)
        dx = grads[-1] if want_x and x is not None else None
        return dx, grads[:n], grads[n:n + len(io_p)]

    def _phased_grads(self, stage, sp_s, io, x, g_in, bm, *, want_x: bool,
                      want_params: bool):
        """:meth:`_grads` of an exchanging stage: its phases, stage 0's
        embedding in the first and the objective in the last,
        differentiated phase by phase with the transposed exchanges in
        between (``models/phases.py``)."""
        model = self.model
        exchange = self._exchange(stage)
        phases, cuts = model.stage_phases(sp_s, io, self._aux(bm),
                                          model.rows(stage))
        phases[0] = chain([lambda st: {"x": self._stage_in(
            stage, io, st.get("x"), bm)}, phases[0]])
        phases[-1] = chain([phases[-1], lambda st: {"obj": self._objective_of(
            stage, io, st["x"], g_in, bm)}])
        sp_p = tuple(sp_s.parameters()) if want_params else ()
        io_p = tuple(io.parameters()) if want_params else ()
        with_x = want_x and x is not None
        gx, grads, _ = phased_grads(
            phases, cuts, {} if x is None else {"x": x}, exchange,
            sp_p + io_p, {"obj": None}, ("x",) if with_x else ())
        n = len(sp_p)
        return gx.get("x"), tuple(grads[:n]), tuple(grads[n:])

    # ---- public --------------------------------------------------------
    def forward(self, stage: int):
        last = stage == self.model.num_stages - 1

        def f(sp_s, io, x, bm):
            with torch.no_grad():
                y = self._stage_out(stage, sp_s, io, x, bm)
                loss = (self._loss(io, y, bm) if last else
                        torch.zeros((), dtype=torch.float32,
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
_TASK_RANGES = {k: f"rrfp.task.{k.name}" for k in Kind}


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
        # a profiler range only: under a profiler that records every
        # thread, the stage thread's operators sit under their task
        with profiled(_TASK_RANGES[task.kind]):
            return self._run(task, payload)

    def _run(self, task: Task, payload: Any) -> Any:
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
