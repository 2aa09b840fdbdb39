"""Cost and runtime-variability models (§2, §7.6).

Execution time in the engine is  base_cost(stage, kind) * jitter  plus, under
the RQ4 injection protocol, an EMA-tracked additive delay.  Communication
latency uses a heavy-tailed mixture calibrated to the paper's Figure 2
measurement that (p95-p5)/p50 reaches 0.73 for compute and 58.74 for
communication: most messages are near-instant relative to compute, a small
fraction are spiked by orders of magnitude.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class JitterModel:
    """Multiplicative lognormal jitter + heavy-tail spikes.

    sample = lognormal(sigma)  and, with prob ``spike_prob``, multiplied by
    ``1 + Exp(spike_scale)``.
    """

    sigma: float = 0.0
    spike_prob: float = 0.0
    spike_scale: float = 0.0

    def sample(self, rng: np.random.Generator) -> float:
        x = 1.0
        if self.sigma > 0:
            # mean-1 lognormal so expected cost equals the base cost
            x *= float(rng.lognormal(mean=-0.5 * self.sigma**2, sigma=self.sigma))
        if self.spike_prob > 0 and rng.random() < self.spike_prob:
            x *= 1.0 + float(rng.exponential(self.spike_scale))
        return x


#: Compute jitter calibrated to Fig. 2: (p95-p5)/p50 ~ 0.73 -> sigma ~ 0.22.
DEFAULT_COMPUTE_JITTER = JitterModel(sigma=0.22)
#: Comm jitter calibrated to Fig. 2: (p95-p5)/p50 ~ 58.7 -> rare huge spikes.
DEFAULT_COMM_JITTER = JitterModel(sigma=0.35, spike_prob=0.10, spike_scale=80.0)


@dataclasses.dataclass
class InjectionModel:
    """RQ4 compute-path delay injection (Table 6).

    With probability ``p``, after a compute task of measured duration c_t, add
    d_t = alpha * max(base, e_t) * (0.5 + U(0,1)) where e_t is the stage-local
    EMA  e_t = 0.9 e_{t-1} + 0.1 c_t .
    """

    p: float = 0.0
    base: float = 0.0  # "B" in the paper, seconds
    alpha: float = 0.0

    def make_state(self) -> dict:
        return {"ema": 0.0, "init": False}

    def sample_delay(self, state: dict, c_t: float, rng: np.random.Generator) -> float:
        if not state["init"]:
            state["ema"] = c_t
            state["init"] = True
        else:
            state["ema"] = 0.9 * state["ema"] + 0.1 * c_t
        if self.p <= 0 or rng.random() >= self.p:
            return 0.0
        return self.alpha * max(self.base, state["ema"]) * (0.5 + rng.random())


# The paper's jitter levels J0..J3 (Table 6).
INJECTION_LEVELS = {
    "J0": InjectionModel(p=0.0, base=0.000, alpha=0.0),
    "J1": InjectionModel(p=0.1, base=0.005, alpha=0.5),
    "J2": InjectionModel(p=0.2, base=0.010, alpha=1.0),
    "J3": InjectionModel(p=0.3, base=0.015, alpha=1.5),
}


@dataclasses.dataclass
class CostModel:
    """Per-(stage, kind) base costs with variability.

    ``f_cost[s]`` / ``b_cost[s]`` / ``w_cost[s]`` are seconds for one
    microbatch of F / B / W work at stage ``s`` (per chunk).  ``comm_base`` is
    the no-jitter point-to-point activation/gradient transfer latency.
    """

    f_cost: np.ndarray
    b_cost: np.ndarray
    w_cost: np.ndarray
    comm_base: float = 1e-4
    compute_jitter: JitterModel = dataclasses.field(
        default_factory=lambda: dataclasses.replace(DEFAULT_COMPUTE_JITTER)
    )
    comm_jitter: JitterModel = dataclasses.field(
        default_factory=lambda: dataclasses.replace(DEFAULT_COMM_JITTER)
    )
    injection: InjectionModel = dataclasses.field(default_factory=InjectionModel)
    #: per-(stage, microbatch) multiplicative workload skew (e.g. MoE routing,
    #: multimodal length mix); 1.0 = homogeneous.
    mb_skew: np.ndarray | None = None
    seed: int = 0

    def __post_init__(self) -> None:
        self.f_cost = np.asarray(self.f_cost, dtype=np.float64)
        self.b_cost = np.asarray(self.b_cost, dtype=np.float64)
        self.w_cost = np.asarray(self.w_cost, dtype=np.float64)

    @property
    def num_stages(self) -> int:
        return len(self.f_cost)

    # ---- constructors ------------------------------------------------------
    @staticmethod
    def uniform(
        num_stages: int,
        f: float = 1.0,
        b: float = 2.0,
        w: float = 0.0,
        **kw,
    ) -> "CostModel":
        return CostModel(
            f_cost=np.full(num_stages, f),
            b_cost=np.full(num_stages, b),
            w_cost=np.full(num_stages, w),
            **kw,
        )

    @staticmethod
    def from_stage_flops(
        stage_flops: np.ndarray,
        chip_flops: float = 197e12,
        efficiency: float = 0.4,
        bwd_ratio: float = 2.0,
        split_backward: bool = False,
        **kw,
    ) -> "CostModel":
        """Derive per-stage costs from per-stage forward FLOPs.

        With BFW decomposition, B (dX only) and W (dW only) each take roughly
        half of the full backward.
        """
        f = np.asarray(stage_flops, dtype=np.float64) / (chip_flops * efficiency)
        if split_backward:
            return CostModel(
                f_cost=f, b_cost=f * bwd_ratio * 0.5, w_cost=f * bwd_ratio * 0.5, **kw
            )
        return CostModel(f_cost=f, b_cost=f * bwd_ratio, w_cost=0.0 * f, **kw)

    # ---- sampling ----------------------------------------------------------
    def make_rng(self, seed_offset: int = 0) -> np.random.Generator:
        return np.random.default_rng(self.seed + seed_offset)

    def base_compute(self, kind: int, stage: int, mb: int) -> float:
        base = (self.f_cost, self.b_cost, self.w_cost)[kind][stage]
        if self.mb_skew is not None:
            base *= float(self.mb_skew[stage, mb % self.mb_skew.shape[1]])
        return float(base)

    def sample_compute(
        self, kind: int, stage: int, mb: int, rng: np.random.Generator
    ) -> float:
        return self.base_compute(kind, stage, mb) * self.compute_jitter.sample(rng)

    def sample_comm(self, rng: np.random.Generator) -> float:
        return self.comm_base * self.comm_jitter.sample(rng)

    def with_split_backward(self, dx_frac: float = 0.5) -> "CostModel":
        """BFW decomposition of this model's backward cost.

        The fused B cost splits into a dX-only B (``dx_frac`` of it, on the
        critical path) and a deferrable W carrying the rest — total backward
        work is conserved, so fused-vs-split comparisons isolate scheduling
        flexibility from compute volume.
        """
        if not 0.0 < dx_frac < 1.0:
            raise ValueError(f"dx_frac must be in (0, 1), got {dx_frac}")
        if np.any(self.w_cost):
            raise ValueError(
                "backward is already split (nonzero w_cost); splitting again "
                "would discard W work and break conservation")
        return dataclasses.replace(
            self,
            b_cost=self.b_cost * dx_frac,
            w_cost=self.b_cost * (1.0 - dx_frac),
        )

    def expected(self) -> "CostModel":
        """Jitter-free copy (used for schedule synthesis)."""
        return dataclasses.replace(
            self,
            compute_jitter=JitterModel(),
            comm_jitter=JitterModel(),
            injection=InjectionModel(),
        )


def multimodal_stage_flops(
    vision_flops: float,
    lm_flops: float,
    num_stages: int,
    vision_stage_frac: float = 0.25,
) -> np.ndarray:
    """Heterogeneous per-stage forward FLOPs for a ViT+LM pipeline.

    The first ``vision_stage_frac`` of stages carry the vision encoder; the
    remainder carry the language model.  Mirrors the paper's Heavy-LMM setup
    where naive layer-count splits leave vision stages with very different
    cost than LM stages.
    """
    n_vis = max(1, int(round(num_stages * vision_stage_frac)))
    n_lm = num_stages - n_vis
    out = np.empty(num_stages)
    out[:n_vis] = vision_flops / n_vis
    out[n_vis:] = lm_flops / n_lm
    return out


def normalized_spread(samples: np.ndarray) -> dict[str, float]:
    """The paper's Fig. 2 statistics: (p95-p5)/p50 and (p75-p25)/p50."""
    p5, p25, p50, p75, p95 = np.percentile(samples, [5, 25, 50, 75, 95])
    if p50 <= 0:
        return {"p95_p5": math.inf, "iqr": math.inf}
    return {"p95_p5": (p95 - p5) / p50, "iqr": (p75 - p25) / p50}
