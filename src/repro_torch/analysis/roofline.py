"""Three-term roofline analysis per (arch × shape × mesh) cell, priced for
one NVIDIA H100.

Port of ``repro.analysis.roofline``.  Terms (per device, seconds):

  compute    = FLOPs / PEAK_FLOPS      (989 TFLOP/s dense bf16)
  memory     = bytes / HBM_BW          (3.35 TB/s)
  collective = wire_bytes / LINK_BW    (50 GB/s: one NDR InfiniBand rail)

The reference counts each schedule op by lowering its body with XLA and
reading ``HloCostAnalysis``.  PyTorch has no lowered program to read, so
:func:`per_op_costs` runs the same op bodies (the executor's F and B at
per-device local shapes) once on ``meta`` tensors, which carry shapes and
no storage, under one counting dispatch mode:

* FLOPs: ``torch.utils.flop_counter``'s registered formula of each aten op
  that has one (matmuls, convolutions, attention), plus one FLOP per output
  element of each pointwise op, as ``HloCostAnalysis`` counts elementwise
  work;
* bytes: the input plus output bytes of each aten op but the views (a
  broadcast dimension stored once).  This is eager code with no fusion,
  so it counts more bytes than XLA's fused program does.

The kernel wrappers route a meta tensor to their plain versions
(``kernels/_build.PLAIN_DEVICES``), which carry the shapes.  By default a
wrapper's call counts as its kernel's own work (:data:`KERNEL_WORK`: K1
and its backward score only the unmasked pairs, and each kernel reads its
inputs and writes its outputs once), since the card runs the kernel there
(K1's backward there runs only in bf16, the plain route in float32); with
``kernels=False`` it counts as the aten ops of the plain version, the
composition the reference counts (its default backend is ``"xla"``, not
the Pallas kernel), and the tests hold those counts against the
reference's.

Collective bytes follow the executor's issue pattern analytically (the
reference's model, unchanged).  The static step-time estimate sums over
ticks the slowest stage's op time (plus the non-overlapped reduction and
optimizer tails), giving the projected MFU.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.launch.cells import CellPlan, plan_cell
from repro_torch.pipeline.executor import ExecOptions
from repro_torch.pipeline.spec import OP_B, OP_F, ScheduleTable
from repro_torch.pipeline.stagefn import chunked_ce_sum, default_ce_chunk

#: dense bf16 tensor-core peak of one H100 SXM (NVIDIA H100 data sheet, 700 W)
PEAK_FLOPS = 989e12
#: HBM3 bandwidth of one H100 SXM 80 GB (NVIDIA H100 data sheet)
HBM_BW = 3.35e12
#: one 400 Gb/s NDR InfiniBand rail per GPU (ConnectX-7 data sheet): the
#: 16 x 16 mesh is 32 eight-GPU nodes, so the data ring and the stage
#: permutes cross nodes; NVLink's 450 GB/s a direction holds within a node
LINK_BW = 50e9
CHIPS = 256  # single-pod roofline (16×16)


# ---------------------------------------------------------------------------
# per-op counting on meta tensors
# ---------------------------------------------------------------------------
def _aliases(func) -> bool:
    """An op whose output aliases an input (a view, or an op that writes
    an input): it must run, and a view moves no bytes."""
    return (func._schema.is_mutable
            or any(r.alias_info is not None for r in func._schema.returns))


def _writes(func) -> bool:
    return any(r.alias_info is not None and r.alias_info.is_write
               for r in func._schema.returns) or func._schema.is_mutable


def _stored(t: torch.Tensor) -> int:
    """Bytes a tensor's elements occupy: a broadcast (stride-0) dim is
    stored once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def _nbytes(tree) -> int:
    return sum(_stored(t) for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _key(x):
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_key(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _key(v)) for k, v in x.items()))
    return x


def _fresh(x):
    """A new meta tensor of ``x``'s shape, strides and dtype."""
    if isinstance(x, torch.Tensor):
        return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                   device="meta")
    if isinstance(x, (list, tuple)):
        return type(x)(_fresh(v) for v in x)
    return x


class CostCounter(TorchDispatchMode):
    """FLOPs and bytes of the aten ops run under it (see the module
    docstring); ``by_op`` holds each op's (calls, FLOPs, bytes).

    Meta only: an op that neither views nor writes an input is run once
    per signature (op, input shapes, strides and dtypes, other arguments);
    a repeat gets fresh meta outputs of the recorded layout and the
    recorded counts.  A Python time loop (the sLSTM's) repeats one
    signature per step."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.by_op: dict[str, list] = {}
        self._seen: dict = {}
        #: while set, ops run uncounted (a kernel's plain route)
        self.paused = False

    def add(self, name: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes += nbytes
        rec = self.by_op.setdefault(name, [0, 0.0, 0.0])
        rec[0] += 1
        rec[1] += flops
        rec[2] += nbytes

    def _count(self, func, args, kwargs, out) -> tuple[float, float]:
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            flops = float(formula(*args, **kwargs, out_val=out))
        elif torch.Tag.pointwise in func.tags:
            flops = float(sum(t.numel() for t in tree_leaves(out)
                              if isinstance(t, torch.Tensor)))
        else:
            flops = 0.0
        moves = not _aliases(func) or _writes(func)
        nbytes = float(_nbytes((args, kwargs)) + _nbytes(out)) if moves \
            else 0.0
        return flops, nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.paused:
            return func(*args, **kwargs)
        key = None
        if not _aliases(func):
            try:
                key = (func, _key(args), _key(kwargs))
                hash(key)
            except TypeError:
                key = None
        if key is not None and key in self._seen:
            layout, flops, nbytes = self._seen[key]
            out = _fresh(layout)
        else:
            out = func(*args, **kwargs)
            flops, nbytes = self._count(func, args, kwargs, out)
            if key is not None:
                self._seen[key] = (out, flops, nbytes)
        self.add(str(func.overloadpacket), flops, nbytes)
        return out


# ---------------------------------------------------------------------------
# the kernels' own work (what the card runs in place of the plain route)
# ---------------------------------------------------------------------------
def _pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs a K1 call scores: every pair, or under
    ``causal`` those within ``window`` (0: all) of the diagonal."""
    if not causal:
        return sq * sk
    cap = min(window or sk, sk)
    if sq <= cap:
        return sq * (sq + 1) // 2
    return cap * (cap + 1) // 2 + (sq - cap) * cap


def _k1_work(q, k, v, *, causal=True, window=0):
    b, hq, sq, hd = q.shape
    flops = 4 * b * hq * _pairs(sq, k.shape[2], causal, window) * hd
    nbytes = 2 * _stored(q) + _stored(k) + _stored(v) + b * hq * sq * 4
    return flops, nbytes


def _k1b_work(q, k, v, out, lse, dout, *, causal=True, window=0,
              dq_scale=1.0):
    """K1's backward: five products over the unmasked pairs (the dq pass's
    recompute of S and dP not counted); q, k, v, out, dout and lse read,
    dq, dk and dv written once.  None in float32, which the card runs as
    the plain backward."""
    if q.dtype != torch.bfloat16:
        return None
    b, hq, sq, hd = q.shape
    flops = 10 * b * hq * _pairs(sq, k.shape[2], causal, window) * hd
    nbytes = (2 * _stored(q) + 2 * _stored(k) + 2 * _stored(v)
              + _stored(out) + _stored(dout) + _stored(lse))
    return flops, nbytes


def _k2_work(x, scale, eps=1e-5):
    return 4 * x.numel(), 2 * _stored(x) + _stored(scale)


def _k3_work(q, k_cache, v_cache, length, *, window=0):
    b, hq, _, hd = q.shape
    n = k_cache.shape[2]
    if isinstance(length, int):
        n = min(n, length)
    if window:
        n = min(n, window)
    kv = (_stored(k_cache) + _stored(v_cache)) * n // k_cache.shape[2]
    return 4 * b * hq * n * hd, kv + 2 * _stored(q)


def _k4_work(x, dt, A, B, C, D, *, chunk):
    b, s, nh, hd = x.shape
    ds = B.shape[-1]
    nc = s // chunk
    flops = 2 * b * nh * nc * (chunk * chunk * ds + chunk * chunk * hd
                               + 2 * chunk * ds * hd)
    nbytes = 2 * _stored(x) + sum(_stored(t) for t in (dt, A, B, C, D))
    return flops, nbytes


#: each kernel wrapper the models call (through ``kernels/ops.py``), with
#: its kernel's work: FLOPs (K1 the unmasked pairs only) and the bytes of
#: each input read once and each output written once, as ``chip_smoke.py``
#: bounds each kernel
KERNEL_WORK = {("flash_attention", "flash_attention_fwd"): _k1_work,
               ("flash_attention", "flash_attention_bwd"): _k1b_work,
               ("rmsnorm", "rmsnorm"): _k2_work,
               ("flash_decode", "flash_decode"): _k3_work,
               ("ssd_scan", "ssd_scan"): _k4_work}


@contextlib.contextmanager
def _as_kernels(counter: CostCounter):
    """Count each kernel wrapper's call as its kernel's work (its plain
    route on meta tensors runs uncounted, for the shapes); a call whose
    work is None runs its plain route on the card too, and counts as that.
    The wrappers are replaced on their modules while the block runs."""
    saved = []

    def counted(name, fn, work):
        def call(*args, **kwargs):
            cost = work(*args, **kwargs)
            if cost is None:
                return fn(*args, **kwargs)
            flops, nbytes = cost
            counter.paused = True
            try:
                out = fn(*args, **kwargs)
            finally:
                counter.paused = False
            counter.add(f"kernel {name}", float(flops), float(nbytes))
            return out
        return call

    try:
        for (mod, name), work in KERNEL_WORK.items():
            module = importlib.import_module(f"repro_torch.kernels.{mod}")
            saved.append((module, name, getattr(module, name)))
            setattr(module, name, counted(name, saved[-1][2], work))
        yield
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def _cost(fn, *args, kernels: bool = True) -> dict[str, float]:
    with CostCounter() as c, (_as_kernels(c) if kernels
                              else contextlib.nullcontext()):
        fn(*args)
    return {"flops": c.flops, "bytes": c.bytes}


def per_op_costs(plan: CellPlan, opts: ExecOptions | None = None, *,
                 kernels: bool = True) -> dict:
    """FLOPs/bytes of each schedule-op body at per-device local shapes.

    Stage archetypes: first (embed+layers), mid (layers), last (layers+CE).
    MoE collectives are replaced by their local-compute equivalents for
    costing (collective FLOPs are ~0; wire bytes are modeled separately).
    Every op body is built on meta tensors, so a shape error in any cell's
    op raises here.  ``kernels``: a kernel wrapper's call counts as its
    kernel's work (:data:`KERNEL_WORK`), what the card runs; else as the
    aten ops of its plain version, the composition the reference counts.
    """
    model = plan.model
    cfg = model.cfg
    eff_seq = plan.seq_len + (plan.enc_len if cfg.encoder_layers else 0)
    mb = plan.mb_rows
    d = cfg.d_model
    meta = torch.device("meta")
    sp1 = model.init_stage_params(0, seed=None, device=meta)
    io = model.init_io_params(seed=None, device=meta)
    x = torch.empty((mb, eff_seq, d), dtype=cfg.dtype, device=meta)
    g = torch.empty((mb, eff_seq, d), dtype=cfg.dtype, device=meta)
    tokens = torch.empty((mb, plan.seq_len), dtype=torch.int64, device=meta)
    aux = {
        "positions": torch.arange(eff_seq, dtype=torch.int32,
                                  device=meta)[None].expand(mb, eff_seq),
        "data_size": 16,
        "moe_layout": "none",  # collectives modeled analytically
    }
    if cfg.mrope:
        aux["mrope"] = torch.arange(eff_seq, dtype=torch.int32, device=meta)[
            None, None].expand(3, mb, eff_seq)
    if cfg.encoder_layers:
        aux["dec_len"] = plan.seq_len
    rows_first = model.rows(0)
    rows_last = model.rows(model.num_stages - 1)
    ce_chunk = default_ce_chunk(cfg, opts.ce_chunk if opts else 0)
    params = list(sp1.parameters()) + list(io.parameters())

    def fwd(sp, io_, x):
        with torch.no_grad():
            return model.stage_forward(sp, io_, x, aux, rows_first)

    def embed(io_, tokens):
        with torch.no_grad():
            e = io_.embed[tokens]
            if cfg.encoder_layers:
                e = torch.cat([e, torch.zeros((mb, plan.enc_len, d),
                                              dtype=cfg.dtype, device=meta)],
                              dim=1)
            return e

    def ce_sum(io_, y, labels):
        if cfg.encoder_layers:
            y = y[:, : plan.seq_len]
        return chunked_ce_sum(model, io_, y, labels, ce_chunk)

    def ce(io_, y, labels):
        with torch.no_grad():
            return ce_sum(io_, y, labels)

    out: dict[str, dict] = {}
    out["F"] = _cost(fwd, sp1, io, x, kernels=kernels)
    out["embed"] = _cost(embed, io, tokens, kernels=kernels)
    out["ce"] = _cost(ce, io, x, tokens, kernels=kernels)

    if plan.step == "train":
        def grads(objective, x):
            x = x.detach().requires_grad_()
            with torch.enable_grad():
                return torch.autograd.grad(objective(x), params + [x],
                                           allow_unused=True)

        def bwd_mid(sp, io_, x, g):
            def s(x):
                y = model.stage_forward(sp, io_, x, aux, rows_first)
                return torch.sum(y.float() * g.float())
            return grads(s, x)

        def bwd_last(sp, io_, x, labels):
            def s(x):
                y = model.stage_forward(sp, io_, x, aux, rows_last)
                return ce_sum(io_, y, labels)
            return grads(s, x)

        out["B"] = _cost(bwd_mid, sp1, io, x, g, kernels=kernels)
        out["B_last"] = _cost(bwd_last, sp1, io, x, tokens, kernels=kernels)
    else:
        x1 = torch.empty((mb, 1, d), dtype=cfg.dtype, device=meta)
        cache = model.init_stage_cache(
            mb if not plan.sp_mode else plan.cell.global_batch,
            plan.cell.seq_len // (plan.dp_total if plan.sp_mode else 1),
            enc_len=max(1, plan.enc_len), device=meta)
        daux = {"data_size": 16, "moe_layout": "none"}

        def dec(sp, io_, x, cache):
            with torch.no_grad():
                return model.stage_decode(sp, io_, x, cache, 0, daux,
                                          rows_first)

        out["F_dec"] = _cost(dec, sp1, io, x1, cache, kernels=kernels)
    return out


# ---------------------------------------------------------------------------
# collective model (wire bytes per device per step)
# ---------------------------------------------------------------------------
def collective_bytes(plan: CellPlan, table: ScheduleTable | None) -> dict:
    cfg = plan.model.cfg
    model = plan.model
    d = cfg.d_model
    n = 16  # data ring
    eff_seq = plan.seq_len + (plan.enc_len if cfg.encoder_layers else 0)
    mb_bytes = plan.mb_rows * (eff_seq if plan.step == "train" else 1) * d * 2
    out = {"permute": 0.0, "grad_rs": 0.0, "param_ag": 0.0, "io_ar": 0.0,
           "moe": 0.0, "sp": 0.0}
    if plan.step == "train":
        T = table.num_ticks
        out["permute"] = 2.0 * T * mb_bytes  # act fwd + grad bwd rings
        n_stage = (cfg.param_count(include_embed=False) - d) / model.num_stages
        n_io = 2 * cfg.padded_vocab() * d
        expert = 0.0
        if cfg.moe is not None:
            moe_layers = sum(1 for k in cfg.pattern if k == "moe")
            expert = (moe_layers / cfg.num_layers) * n_stage * 0.9
        repl = n_stage - expert
        out["grad_rs"] = (repl + n_io) * 2 * (n - 1) / n
        out["param_ag"] = (repl + n_io) * 2 * (n - 1) / n
        out["io_ar"] = n_io * 2 * 2 * (n - 1) / n  # psum over model of io grads
        if cfg.moe is not None:
            M = table.spec.num_microbatches
            tokens = plan.mb_rows * plan.seq_len
            cap_bytes = (tokens * cfg.moe.top_k * cfg.moe.capacity_factor
                         * d * 2)
            moe_layers_per_stage = sum(
                1 for k in cfg.pattern if k == "moe") / model.num_stages
            per_op = 2 * cap_bytes * (n - 1) / n  # a2a there+back / AG+RS
            # F issues the pair once; B only transposes it (the dispatched
            # buffers are checkpoint-policy-saved, so remat re-issues none)
            out["moe"] = M * moe_layers_per_stage * per_op * 2
    else:
        T = plan.num_microbatches + model.num_stages - 1
        out["permute"] = T * mb_bytes
        if plan.sp_mode:
            # distributed flash-decode psums per attention layer
            attn_slots = int((model.type_ids >= 0).sum()) / model.num_stages
            kv = cfg.num_kv_heads * cfg.resolved_head_dim
            out["sp"] = attn_slots * 2 * (n - 1) / n * (
                plan.cell.global_batch * cfg.num_heads
                * cfg.resolved_head_dim * 4)
    out["total"] = sum(out.values())
    return out


# ---------------------------------------------------------------------------
# cell roofline
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CellRoofline:
    arch: str
    shape: str
    schedule: str
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops_device: float
    useful_ratio: float
    est_step_s: float
    projected_mfu: float
    notes: str = ""

    def as_dict(self):
        return dataclasses.asdict(self)


class ProductionMeshShape:
    """Lightweight stand-in: plan_cell only reads ``mesh.shape`` — the
    roofline never allocates devices."""

    def __init__(self, multi_pod: bool = False):
        self.shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
                      else {"data": 16, "model": 16})


def roofline_cell(arch: str, shape: str, mesh=None, schedule: str = "1f1b",
                  table: ScheduleTable | None = None,
                  op_costs: dict | None = None) -> CellRoofline:
    """The cell's three terms and static step estimate.  ``hlo_flops_device``
    keeps the reference's field name; here it is the counted FLOPs of
    :func:`per_op_costs`."""
    from repro_torch.pipeline import schedules
    from repro_torch.core.taskgraph import PipelineSpec

    mesh = mesh or ProductionMeshShape()
    plan = plan_cell(arch, shape, mesh)
    model = plan.model
    S = model.num_stages
    M = plan.num_microbatches
    if plan.step == "train" and table is None:
        spec = PipelineSpec(S, M)
        table = schedules.BUILDERS[schedule](spec)
    oc = op_costs or per_op_costs(plan)

    worst = step_costs(plan, oc)
    hlo_flops, hlo_bytes = worst["flops"], worst["bytes"]
    if plan.step == "train":
        # static tick timing: slowest stage per tick
        f_t = {
            "first": _t(oc["F"], oc["embed"]),
            "mid": _t(oc["F"]),
            "last": _t(oc["F"], oc["ce"]),
        }
        b_t = {
            "first": _t(oc["B"], oc["embed"], oc["embed"]),
            "mid": _t(oc["B"]),
            "last": _t(oc["B_last"]),
        }
        arch_of = lambda s: ("first" if s == 0 else
                             "last" if s == S - 1 else "mid")
        permute_t = 2 * plan.mb_rows * (plan.seq_len + plan.enc_len) \
            * model.cfg.d_model * 2 / LINK_BW
        est = 0.0
        for t in range(table.num_ticks):
            tick_max = permute_t
            for s in range(S):
                op = int(table.ops[s, t])
                if op == OP_F:
                    tick_max = max(tick_max, f_t[arch_of(s)])
                elif op == OP_B:
                    tick_max = max(tick_max, b_t[arch_of(s)])
            est += tick_max
        colls = collective_bytes(plan, table)
        est += (colls["grad_rs"] + colls["param_ag"] + colls["io_ar"]) / LINK_BW
        coll_s = colls["total"] / LINK_BW
    else:
        table_t = plan.num_microbatches + S - 1
        colls = collective_bytes(plan, None)
        coll_s = colls["total"] / LINK_BW
        est = table_t * max(_t(oc["F_dec"]),
                            plan.mb_rows * model.cfg.d_model * 2 / LINK_BW)

    mf = model.model_flops(plan.cell)
    compute_s = hlo_flops / PEAK_FLOPS
    memory_s = hlo_bytes / HBM_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    dominant = max(terms, key=terms.get)
    useful = mf["model_flops"] / CHIPS / max(hlo_flops, 1.0)
    mfu = mf["model_flops"] / (CHIPS * PEAK_FLOPS * max(est, 1e-12))
    return CellRoofline(
        arch=arch, shape=shape, schedule=schedule,
        compute_s=compute_s, memory_s=memory_s, collective_s=coll_s,
        dominant=dominant, model_flops=mf["model_flops"],
        hlo_flops_device=hlo_flops, useful_ratio=useful,
        est_step_s=est, projected_mfu=mfu,
    )


def step_costs(plan: CellPlan, oc: dict) -> dict[str, float]:
    """FLOPs and bytes of the busiest stage's step from the per-op counts
    ``oc``: a train stage runs M F and M B (the first also embeds, once in
    F and twice in B; the last adds the CE to F and runs ``B_last``), the
    stage archetype with the most FLOPs counts; a decode stage runs M
    ``F_dec``."""
    M = plan.num_microbatches
    if plan.step != "train":
        return {k: M * oc["F_dec"][k] for k in ("flops", "bytes")}
    # per-stage totals (first / mid / last archetypes)
    totals = {}
    for name, extra_f, extra_b in (
        ("first", oc["embed"], {"flops": oc["embed"]["flops"] * 2,
                                "bytes": oc["embed"]["bytes"] * 2}),
        ("mid", {"flops": 0.0, "bytes": 0.0}, {"flops": 0.0, "bytes": 0.0}),
        ("last", oc["ce"], None),
    ):
        f = {k: oc["F"][k] + extra_f[k] for k in ("flops", "bytes")}
        if name == "last":
            b = oc["B_last"]
        else:
            b = {k: oc["B"][k] + extra_b[k] for k in ("flops", "bytes")}
        totals[name] = {k: M * (f[k] + b[k]) for k in ("flops", "bytes")}
    return max(totals.values(), key=lambda t: t["flops"])


def _t(*costs) -> float:
    f = sum(c["flops"] for c in costs)
    b = sum(c["bytes"] for c in costs)
    return max(f / PEAK_FLOPS, b / HBM_BW)
