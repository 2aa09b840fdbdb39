"""DES cost models of the branch+fusion topology (simulation substrate).

Maps a :class:`~repro_torch.multimodal.model.MultimodalConfig` onto per-stage
F/B/W costs for the engine/actor simulation substrate, with the
per-microbatch skew drawn from the *same* shared length sampler that
generates the real variable-length batches (``repro_torch.data.lengths``):
encoder-branch stage cost scales with the sampled token count of the
microbatch, decoder-chain cost barely moves.  This is the §2.1 workload
dynamicity that makes fixed-order consumption pay its price on
multimodal pipelines.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.costs import CostModel, JitterModel
from repro_torch.data.lengths import TEXT_SIGMA, length_skew
from repro_torch.multimodal.model import MultimodalConfig

#: nominal chip throughput for turning FLOPs into seconds (RTX-4090-class,
#: matching benchmarks/workloads.py)
CHIP_FLOPS = 165e12 * 0.35


def _layer_flops(d_model: int, d_ff: int, tokens: int) -> float:
    """Forward FLOPs of one pre-norm transformer layer (per sample)."""
    attn = 4 * d_model * d_model  # qkvo projections
    ffn = 3 * d_model * d_ff      # glu
    return 2.0 * (attn + ffn) * tokens


def multimodal_dag_costs(
    cfg: MultimodalConfig,
    *,
    mb_rows: int = 1,
    seed: int = 0,
    num_mb_skew: int = 64,
    comm_base: float = 2e-3,
) -> CostModel:
    """Per-stage cost model of ``cfg``'s DAG pipeline.

    Encoder stages process ``mean_enc_tokens`` at width ``d_enc``; the
    text stage and LM chain process ``text_seq`` / ``fused_seq`` tokens at
    ``d_model``; the sink additionally pays the vocab head.  Per-microbatch
    skew: encoder stages follow the modality length distribution
    (correlated across the branch — the same sample's tokens), decoder
    stages the residual text spread.
    """
    S = cfg.num_stages
    enc_ff = cfg.enc_cfg.d_ff
    lm_ff = cfg.lm_cfg.d_ff
    flops = np.zeros(S)
    for s in range(S):
        role = cfg.role_of(s)
        if role == "encoder":
            flops[s] = cfg.enc_layers_per_stage * _layer_flops(
                cfg.d_enc, enc_ff, cfg.mean_enc_tokens)
        elif role == "text":
            flops[s] = cfg.lm_layers_per_stage * _layer_flops(
                cfg.d_model, lm_ff, cfg.text_seq)
        else:  # fusion / lm
            flops[s] = cfg.lm_layers_per_stage * _layer_flops(
                cfg.d_model, lm_ff, cfg.fused_seq)
    # vocab head + CE live on the sink (the Fig. 6 last-stage dominance)
    flops[S - 1] += 2.0 * cfg.d_model * cfg.vocab_size * cfg.text_seq
    flops *= mb_rows

    rng = np.random.default_rng(seed)
    per_mb_enc = length_skew(num_mb_skew, cfg.enc_sigma, rng)
    per_mb_lm = length_skew(num_mb_skew, TEXT_SIGMA, rng)
    skew = np.ones((S, num_mb_skew))
    for s in range(S):
        skew[s] = per_mb_enc if cfg.role_of(s) == "encoder" else per_mb_lm

    return CostModel.from_stage_flops(
        flops, chip_flops=CHIP_FLOPS, efficiency=1.0,
        comm_base=comm_base, mb_skew=skew, seed=seed,
        comm_jitter=JitterModel(sigma=0.35, spike_prob=0.03,
                                spike_scale=20.0))
