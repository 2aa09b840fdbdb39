"""The (architecture × shape) dry-run matrix: input specs + step builders.

Port of ``repro.launch.cells``.  ``input_specs`` and ``cache_struct``
return meta tensors (shape and dtype, no storage) where the reference
returns ``ShapeDtypeStruct``s; ``build_cell`` wires model, schedule table,
executor options and specs for one cell on a given mesh, with the
parameter structures drawn by the port's own init on the ``meta`` device.

Shape semantics (DESIGN §4):
  train_4k / prefill_32k -> train_step;  decode_32k / long_500k -> serve_step
  (one token against a seq_len KV cache).  long_500k runs only for
  sub-quadratic archs (gemma3 local:global, zamba2, xlstm).  seamless
  train splits the cell's seq_len into dec seq/2 + enc frames seq/2;
  its decode uses an enc cross-cache of seq_len.

The port refuses one plan the reference makes: ``zamba2-1.2b`` ×
``long_500k`` under ``sp_mode`` (its shared block decodes without the
sequence axis, ROADMAP §3 gap (a)); ``build_cell`` raises the ``ValueError``
of ``pipeline/decode.check_sp_mode``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs import registry
from repro_torch.core.taskgraph import PipelineSpec
from repro_torch.models.build import ArchModel, build
from repro_torch.models.common import SHAPES, ShapeCell
from repro_torch.pipeline import schedules
from repro_torch.pipeline.decode import DecodeOptions, make_serve_fn
from repro_torch.pipeline.executor import ExecOptions, make_train_fn
from repro_torch.pipeline.sharding import partition_for

#: archs whose optimizer/grad state must stay in bf16 to fit HBM
_BF16_GRAD_ARCHS = {"grok-1-314b", "granite-34b", "qwen1.5-32b"}

#: the dtype of each model input in the port's batch: the reference's
#: int32 token ids and labels are int64 here (they index the embedding,
#: ``launch/train._device_batch``); M-RoPE positions stay int32 and the
#: precomputed embeddings float32; the decode step's position ``pos`` is a
#: host int, whose stand-in is a 0-d int64 tensor
BATCH_DTYPES = {"tokens": torch.int64, "labels": torch.int64,
                "mrope": torch.int32, "embeds": torch.float32,
                "enc_embeds": torch.float32, "pos": torch.int64}


def cell_is_runnable(arch: str, shape: str) -> tuple[bool, str]:
    cfg = registry.get_arch(arch)
    cell = SHAPES[shape]
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: 524k context excluded (DESIGN §4)"
    return True, ""


def all_cells() -> list[tuple[str, str]]:
    out = []
    for arch in registry.ARCHS:
        if arch.startswith("paper-"):
            continue
        for shape in SHAPES:
            ok, _ = cell_is_runnable(arch, shape)
            if ok:
                out.append((arch, shape))
    return out


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CellPlan:
    arch: str
    shape: str
    model: ArchModel
    cell: ShapeCell
    step: str              # train | decode
    dp_total: int
    mb_rows: int
    num_microbatches: int
    seq_len: int           # decoder-token length per row
    enc_len: int
    sp_mode: bool
    multi_pod: bool

    @property
    def tokens_per_step(self) -> int:
        return self.cell.global_batch * (
            self.seq_len if self.step == "train" else 1)


def plan_cell(arch: str, shape: str, mesh, num_stages: int = 16) -> CellPlan:
    cfg = registry.get_arch(arch)
    cell = SHAPES[shape]
    model = build(cfg, num_stages=num_stages)
    multi_pod = "pod" in mesh.shape
    dp_total = mesh.shape["data"] * (mesh.shape["pod"] if multi_pod else 1)
    seq = cell.seq_len
    enc_len = 0
    if cfg.encoder_layers:
        if cell.step == "train":
            seq = cell.seq_len // 2
            enc_len = cell.seq_len // 2
        else:
            seq = cell.seq_len
            enc_len = cell.seq_len
    if cell.step == "train":
        rows = max(1, cell.global_batch // dp_total)
        # microbatch rows of 1 maximize pipeline overlap (M = rows)
        mb_rows = 1
        M = rows
        sp_mode = False
    else:
        sp_mode = cell.global_batch < dp_total  # long_500k: batch 1
        if sp_mode:
            mb_rows, M = cell.global_batch, 1
        else:
            rows = max(1, cell.global_batch // dp_total)
            mb_rows = 1
            M = rows
    return CellPlan(
        arch=arch, shape=shape, model=model, cell=cell, step=cell.step,
        dp_total=dp_total, mb_rows=mb_rows, num_microbatches=M,
        seq_len=seq, enc_len=enc_len, sp_mode=sp_mode, multi_pod=multi_pod,
    )


# ---------------------------------------------------------------------------
def _meta(shape, key: str | torch.dtype) -> torch.Tensor:
    dtype = BATCH_DTYPES[key] if isinstance(key, str) else key
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(plan: CellPlan) -> dict[str, Any]:
    """Meta stand-ins for the global batch (train) or the decode step
    inputs (decode)."""
    cfg = plan.model.cfg
    gb = plan.cell.global_batch
    d = cfg.d_model
    if plan.step == "train":
        out = {
            "tokens": _meta((gb, plan.seq_len), "tokens"),
            "labels": _meta((gb, plan.seq_len), "labels"),
        }
        if cfg.embed_input:
            out["embeds"] = _meta((gb, plan.seq_len, d), "embeds")
        if cfg.mrope:
            out["mrope"] = _meta((3, gb, plan.seq_len), "mrope")
        if cfg.encoder_layers:
            out["enc_embeds"] = _meta((gb, plan.enc_len, d), "enc_embeds")
        return out
    if cfg.embed_input:
        return {"embeds": _meta((gb, 1, d), "embeds")}
    return {"tokens": _meta((gb,), "tokens")}


def cache_struct(plan: CellPlan) -> dict:
    """Meta tree of the decode caches (global shapes ``[S, l_max, ...]``,
    the keys of ``ArchModel.init_layer_cache``)."""
    model = plan.model
    gb = plan.cell.global_batch
    one = model.init_layer_cache(1, 1, enc_len=1, device="meta")

    def expand(tree, path=()):
        if isinstance(tree, dict):
            return {k: expand(v, path + (k,)) for k, v in tree.items()}
        shape = list(tree.shape)
        shape[0] = gb
        if path and path[-1] in ("k", "v"):
            shape[1] = plan.cell.seq_len
        if path and path[-1] in ("xk", "xv"):
            shape[1] = plan.enc_len
        return _meta((model.num_stages, model.l_max, *shape), tree.dtype)

    return expand(one)


def schedule_table(plan: CellPlan, schedule: str = "1f1b",
                   split_backward: bool = False):
    """The schedule table of a train cell, by name (any other name than
    rrfp, zb and gpipe is 1f1b, as the reference's ``build_cell`` reads
    it)."""
    spec = PipelineSpec(plan.model.num_stages, plan.num_microbatches,
                        split_backward=split_backward)
    return schedules.BUILDERS.get(schedule, schedules.one_f_one_b)(spec)


def exec_options(plan: CellPlan) -> ExecOptions:
    """The executor's options of a train cell."""
    grad_dtype = (torch.bfloat16 if plan.arch in _BF16_GRAD_ARCHS
                  else torch.float32)
    return ExecOptions(
        mb_rows=plan.mb_rows, seq_len=plan.seq_len, enc_len=plan.enc_len,
        grad_dtype=grad_dtype,
        loss_scale=1.0 / plan.tokens_per_step,
        multi_pod=plan.multi_pod,
    )


def decode_options(plan: CellPlan) -> DecodeOptions:
    """The serve step's options of a decode cell."""
    return DecodeOptions(
        mb_rows=plan.mb_rows, cache_len=plan.cell.seq_len,
        enc_len=plan.enc_len, sp_mode=plan.sp_mode, multi_pod=plan.multi_pod)


# ---------------------------------------------------------------------------
def build_cell(plan: CellPlan, mesh, schedule: str = "1f1b",
               split_backward: bool = False):
    """Returns ``(step_fn, arg_structs, batch_specs)``.

    ``step_fn`` is the rank program (``mesh.run`` runs it on every rank):
    ``make_train_fn``'s for a train cell, ``make_serve_fn``'s for a decode
    cell.  ``arg_structs`` holds the meta structures of its arguments:
    ``(stage modules [S], io module, input_specs)`` for a train cell and
    ``(stage modules [S], io module, cache_struct, input_specs, pos)`` for
    a decode cell, a rank taking its ``model`` index's stage module;
    ``batch_specs`` the batch's layout over the mesh.  Under ``sp_mode`` a
    plan the port refuses (``pipeline/decode.check_sp_mode``) raises its
    ``ValueError``."""
    model = plan.model
    # every stage's module as a rank holds it (its shard of the experts)
    sp_struct = [model.init_stage_params(s, seed=None, device="meta",
                                         data_size=mesh.shape["data"])
                 for s in range(model.num_stages)]
    io_struct = model.init_io_params(seed=None, device="meta")
    partition = partition_for(model, sp_struct[0], io_struct)

    if plan.step == "train":
        table = schedule_table(plan, schedule, split_backward)
        fn, batch_specs = make_train_fn(model, table, mesh,
                                        exec_options(plan), partition)
        return fn, (sp_struct, io_struct, input_specs(plan)), batch_specs

    fn, _, batch_specs = make_serve_fn(model, mesh, decode_options(plan),
                                       num_groups=plan.num_microbatches)
    args = (sp_struct, io_struct, cache_struct(plan), input_specs(plan),
            _meta((), "pos"))
    return fn, args, batch_specs
