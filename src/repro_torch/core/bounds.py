"""Analytical characterization of the BF hint (§6, Appendix B).

Computes, from realized per-task durations:

* the forward-only / backward-only reference makespans F̃ and B̃ (pipelined
  recurrences respecting inter-stage dependencies),
* the Theorem 6.1 upper bound
  ``C <= F + B + sum_{j>=1}(Fmax^j - Flast^j) + sum_{j<=M-2}(Bmax^j - Blast^j)``,
* the universal lower bound ``L = sum_j (Flast^j + Blast^j)`` (any schedule
  must execute all last-stage work),
* the Fig. 6 bottleneck statistics (which stage is the per-microbatch
  bottleneck, and relative latencies vs the last stage).
"""
from __future__ import annotations

import dataclasses

import numpy as np


def reference_makespan(dur: np.ndarray, direction: str) -> float:
    """Makespan of a single-direction pipeline with durations ``dur[s, j]``.

    ``forward``: all microbatches initially available at stage 0;
    ``backward``: all initially available at stage N-1.  Inter-stage
    dependencies respected; each stage serial.
    """
    S, M = dur.shape
    if direction == "backward":
        dur = dur[::-1]  # stage N-1 becomes row 0; recurrence is identical
    e = np.zeros((S, M))
    for i in range(S):
        for j in range(M):
            up = e[i - 1, j] if i > 0 else 0.0
            left = e[i, j - 1] if j > 0 else 0.0
            e[i, j] = max(up, left) + dur[i, j]
    return float(e[-1, -1])


@dataclasses.dataclass
class BoundReport:
    makespan: float
    theorem_rhs: float
    lower_bound: float
    f_ref: float
    b_ref: float
    imbalance_f: float
    imbalance_b: float

    @property
    def holds(self) -> bool:
        return self.makespan <= self.theorem_rhs + 1e-9

    @property
    def ratio_to_lb(self) -> float:
        return self.makespan / max(self.lower_bound, 1e-12)


def check_theorem_6_1(f_dur: np.ndarray, b_dur: np.ndarray, makespan: float) -> BoundReport:
    """Evaluate Theorem 6.1 for one realized iteration.

    ``f_dur`` / ``b_dur`` are [stage, microbatch] realized durations
    (chunk-summed; the analysis setting is non-interleaved).
    """
    S, M = f_dur.shape
    f_ref = reference_makespan(f_dur, "forward")
    b_ref = reference_makespan(b_dur, "backward")
    f_max = f_dur.max(axis=0)
    b_max = b_dur.max(axis=0)
    f_last = f_dur[S - 1]
    b_last = b_dur[S - 1]
    imb_f = float(np.sum(f_max[1:] - f_last[1:]))
    imb_b = float(np.sum(b_max[: M - 1] - b_last[: M - 1]))
    rhs = f_ref + b_ref + imb_f + imb_b
    lb = float(np.sum(f_last + b_last))
    return BoundReport(
        makespan=makespan,
        theorem_rhs=rhs,
        lower_bound=lb,
        f_ref=f_ref,
        b_ref=b_ref,
        imbalance_f=imb_f,
        imbalance_b=imb_b,
    )


def corollary_terms(f_dur: np.ndarray, b_dur: np.ndarray) -> dict[str, float]:
    """Empirical p and rho of Corollary 6.2 from realized durations."""
    S, M = f_dur.shape
    not_last_f = f_dur.max(axis=0) > f_dur[S - 1] + 1e-12
    not_last_b = b_dur.max(axis=0) > b_dur[S - 1] + 1e-12
    p = float((not_last_f.sum() + not_last_b.sum()) / (2 * M))
    with np.errstate(divide="ignore", invalid="ignore"):
        rho_f = np.where(f_dur[S - 1] > 0, f_dur.max(axis=0) / f_dur[S - 1], 1.0)
        rho_b = np.where(b_dur[S - 1] > 0, b_dur.max(axis=0) / b_dur[S - 1], 1.0)
    rho = float(max(rho_f.max(), rho_b.max()))
    return {"p": p, "rho": rho, "cor_bound": 1 + 2 * p * (rho - 1)}


def bottleneck_stats(f_dur: np.ndarray) -> dict[str, np.ndarray]:
    """Fig. 6: per-stage bottleneck share and relative latency percentiles."""
    S, M = f_dur.shape
    argmax = f_dur.argmax(axis=0)
    share = np.bincount(argmax, minlength=S) / M
    rel = f_dur / np.maximum(f_dur[S - 1][None, :], 1e-12)
    pct = np.percentile(rel, [85, 90, 95], axis=1)  # [3, S]
    return {"bottleneck_share": share, "rel_p85_p90_p95": pct}
