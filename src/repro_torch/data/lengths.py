"""Shared per-sample modality-token length sampling.

Multimodal samples vary strongly in encoder-token count: multi-image
samples at dynamic resolution (Qwen2-VL) and variable-duration audio
(SeamlessM4T) produce far more — or fewer — patch/frame tokens than text
tokens, with large per-sample variance.  That one distribution drives
three consumers, which previously carried parallel implementations:

* ``benchmarks.workloads`` — per-microbatch compute skew of the DES cost
  models (vision stages scale with token count, LM stages barely);
* ``data.synthetic`` — per-microbatch encoder-token counts of the real
  multimodal batches fed to the jitted DAG pipeline;
* ``repro_torch.multimodal`` — the shape-bucketing layer that pads those
  variable lengths to a bounded bucket set so jit recompiles stay bounded.

The skew is a **mean-one lognormal**: multiplying a mean token count (or a
mean stage cost) by it preserves the mean while spreading individual
samples heavy-tailed — the §2.1 workload-dynamicity model.
"""
from __future__ import annotations

import numpy as np

#: Fig. 2-calibrated per-sample spread of vision-encoder token counts
#: (dynamic-resolution multi-image mix).
VISION_SIGMA = 0.6
#: Residual text-side variation (sequence packing is nearly uniform).
TEXT_SIGMA = 0.1


def length_skew(num: int, sigma: float,
                rng: np.random.Generator) -> np.ndarray:
    """``num`` mean-one lognormal multipliers (sigma=0 -> all ones)."""
    if sigma <= 0:
        return np.ones(num)
    return rng.lognormal(mean=-0.5 * sigma**2, sigma=sigma, size=num)


def sample_token_lengths(
    num: int,
    mean_tokens: int,
    sigma: float = VISION_SIGMA,
    *,
    seed: int = 0,
    step: int = 0,
    lo: int = 1,
    hi: int | None = None,
) -> np.ndarray:
    """Per-microbatch encoder-token counts for one training step.

    Deterministic in (seed, step) — restart-safe like the rest of the
    synthetic data pipeline.  Clipped to [lo, hi].
    """
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, 0x1E45]))
    lens = np.round(mean_tokens * length_skew(num, sigma, rng)).astype(int)
    return np.clip(lens, lo, hi if hi is not None else None)


def bucket_for(length: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket >= length; lengths beyond the largest bucket clamp
    to it (the batch builder truncates, keeping compile counts bounded)."""
    for b in sorted(buckets):
        if length <= b:
            return int(b)
    return int(max(buckets))
