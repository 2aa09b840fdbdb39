"""Analytic per-device memory model for every (arch × shape) cell.

Port of ``repro.analysis.memory_model`` (numpy only, the arithmetic line
for line the reference's).  It counts the per-device residency from the
executor's buffer inventory, independent of any compiler's buffer
assignment (the port has none: ``launch/dryrun.py`` reports the argument
bytes of one rank exactly, from meta structures, beside this model):

  params (bf16, stage shard + replicated io)            [persistent]
  gradient accumulators (grad_dtype stage + io)         [persistent in step]
  optimizer state (fp32 m/v/master shards; expert m/v)  [persistent]
  pipeline buffers  K_{act,res,grad} × [mb, seq, d]     [persistent in step]
  remat residuals   l_max × layer-input (bf16)          [peak, B branch]
  attention-bwd transients  4 × [hkv·g, sq, block] f32  [peak]
  FFN transients    2 × [tokens, d_ff] bf16             [peak]
  CE chunk          [chunk, V] f32                      [peak, last stage]
  decode caches (serve cells)                           [persistent]

``hbm_budget`` defaults to one NVIDIA H100 80GB HBM3's 80e9 bytes (the
card's data sheet).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.launch.cells import CellPlan
from repro_torch.pipeline.spec import ScheduleTable

F32, BF16 = 4, 2


@dataclasses.dataclass
class MemoryBreakdown:
    params: float
    grads: float
    opt_state: float
    buffers: float
    peak_transient: float
    caches: float

    @property
    def total(self) -> float:
        return (self.params + self.grads + self.opt_state + self.buffers
                + self.peak_transient + self.caches)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["total"] = self.total
        return d


def cell_memory(plan: CellPlan, table: ScheduleTable | None = None,
                hbm_budget: float = 80e9) -> MemoryBreakdown:
    cfg = plan.model.cfg
    model = plan.model
    S = model.num_stages
    d = cfg.d_model
    v = cfg.padded_vocab()
    data = 16  # production mesh data width
    n_stage_total = cfg.param_count(include_embed=False) - cfg.d_model
    n_io = 2 * v * d + d + (model.cfg.shared_attn_period and
                            cfg.layer_param_count("attn") or 0)
    n_stage = n_stage_total / S  # per stage-shard
    # expert leaves are additionally data-sharded (EP/TP)
    expert_frac = 0.0
    if cfg.moe is not None:
        e_params = sum(
            3 * d * cfg.d_ff * cfg.moe.num_experts
            for k in cfg.pattern if k == "moe") / len(cfg.pattern) * len(cfg.pattern) / S
        expert_frac = min(1.0, e_params / max(n_stage, 1))
    n_replicated = n_stage * (1 - expert_frac) + n_io
    n_sharded = n_stage * expert_frac / data

    params = (n_stage * (1 - expert_frac) + n_stage * expert_frac / data
              + n_io) * BF16

    if plan.step == "decode":
        cache_one = _cache_bytes(plan)
        bufs = (min(plan.num_microbatches, S) + 1) * plan.mb_rows * d * BF16
        return MemoryBreakdown(
            params=params, grads=0.0, opt_state=0.0, buffers=bufs,
            peak_transient=plan.mb_rows * d * 64 * BF16, caches=cache_one)

    grad_b = 2 if plan.arch in ("grok-1-314b", "granite-34b", "qwen1.5-32b") else 4
    grads = (n_stage * (1 - expert_frac) * grad_b
             + n_stage * expert_frac / data * 4  # expert grads fp32
             + n_io * BF16)  # io accumulators bf16
    # ZeRO-1: master+m+v fp32 on the data shard; expert m/v fp32 local
    opt = ((n_stage * (1 - expert_frac) + n_io) / data * 3 * F32
           + n_stage * expert_frac / data * 2 * F32)

    eff_seq = plan.seq_len + plan.enc_len
    occ = table.validate() if table is not None else {
        "act_span": min(S, plan.num_microbatches),
        "res_span": min(S, plan.num_microbatches),
        "grad_span": 2,
    }
    mb_bytes = plan.mb_rows * eff_seq * d * BF16
    bufs = (occ["act_span"] + occ["res_span"] + occ["grad_span"] + 2) * mb_bytes

    # B-branch peak: remat residuals + attention bwd + FFN transients + CE
    l_max = model.l_max
    resid = l_max * mb_bytes
    hq, hd = cfg.num_heads, cfg.resolved_head_dim
    block = 256
    attn_bwd = 4 * hq * eff_seq * block * plan.mb_rows * F32 \
        + 3 * plan.mb_rows * eff_seq * hq * hd * F32  # dq acc + q/do rows
    ffn = 2 * plan.mb_rows * eff_seq * max(cfg.d_ff, 2 * d) * BF16
    ce_chunk = max(64, min(2048, (1 << 24) // v * 4))
    ce = ce_chunk * v * F32
    peak = resid + attn_bwd + ffn + ce

    return MemoryBreakdown(params=params, grads=grads, opt_state=opt,
                           buffers=bufs, peak_transient=peak, caches=0.0)


def _cache_bytes(plan: CellPlan) -> float:
    cfg = plan.model.cfg
    model = plan.model
    b_loc = max(1, plan.cell.global_batch // plan.dp_total)
    kv = cfg.num_kv_heads * cfg.resolved_head_dim
    total = 0.0
    n_slots = int((model.type_ids >= 0).sum()) / model.num_stages
    seq = plan.cell.seq_len / (plan.dp_total if plan.sp_mode else 1)
    for kind in set(cfg.pattern):
        frac = sum(1 for k in cfg.pattern if k == kind) / len(cfg.pattern)
        n = n_slots * frac
        if kind in ("attn", "attn_local", "attn_global", "moe", "dense",
                    "dec", "enc"):
            w = cfg.sliding_window if kind == "attn_local" else 0
            eff = min(seq, w) if w else seq
            total += n * 2 * b_loc * eff * kv * BF16
            if kind == "dec":
                total += n * 2 * b_loc * (plan.enc_len / (plan.dp_total if plan.sp_mode else 1)) * kv * BF16
        elif kind == "mamba":
            ssm = cfg.ssm
            di = ssm.d_inner(cfg.d_model)
            total += n * b_loc * (
                (ssm.d_conv - 1) * (di + 2 * ssm.d_state) * BF16
                + ssm.num_heads(cfg.d_model) * ssm.head_dim * ssm.d_state * F32)
        elif kind == "mlstm":
            hd = cfg.d_model // cfg.num_heads
            total += n * b_loc * cfg.num_heads * (hd * hd + hd + 1) * F32
        elif kind == "slstm":
            total += n * b_loc * 4 * cfg.d_model * F32
    if cfg.shared_attn_period:
        # shared-attn KV rides every slot's cache union
        total += n_slots * 2 * b_loc * seq * kv * BF16
    return float(total)
