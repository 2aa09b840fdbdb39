"""Readiness-driven schedule synthesis: the RRFP -> XLA bridge (DESIGN §2).

On a TPU pod the per-tick behavior of every stage must be known at compile
time, so the runtime cannot skip-and-retry at task granularity.  Instead we
run the faithful RRFP engine over the *expected* cost model (optionally
EMA-updated from measured step times — the paper's e_t estimator) and extract
each stage's realized execution order.  That order is exactly what a
readiness-first runtime would have dispatched; we then list-schedule it onto
the executor's tick grid (one ring-permute hop per tick) to obtain a static
``stage_orders`` table the compiled executor consumes as data — changing the
table does not recompile.

``synthesize`` returns per-stage task sequences; ``repro_torch.pipeline.spec``
converts them into a validated ScheduleTable.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.costs import CostModel
from repro_torch.core.engine import Engine, EngineConfig
from repro_torch.core.hints import HintKind
from repro_torch.core.taskgraph import PipelineSpec, Task


@dataclasses.dataclass
class SynthesisResult:
    stage_orders: list[list[Task]]
    sim_makespan: float
    #: simulated makespan of pre-committed 1F1B on the same costs (baseline)
    baseline_makespan: float

    @property
    def predicted_speedup(self) -> float:
        return self.baseline_makespan / max(self.sim_makespan, 1e-12)


def synthesize(
    spec: PipelineSpec,
    costs: CostModel,
    hint: HintKind = HintKind.BF,
    buffer_limit: int = 32,
    use_expected_costs: bool = True,
) -> SynthesisResult:
    """Run the RRFP engine and extract per-stage orders for the executor."""
    cm = costs.expected() if use_expected_costs else costs
    rrfp = Engine(
        spec, cm, EngineConfig(mode="hint", hint=hint, buffer_limit=buffer_limit)
    ).run()
    base = Engine(
        spec,
        cm,
        EngineConfig(
            mode="precommitted",
            # zero-bubble is the natural fixed-order baseline once the
            # backward is split; 1F1B is undefined for BFW specs
            fixed_order="zb" if spec.split_backward else "1f1b",
        ),
    ).run()
    return SynthesisResult(
        stage_orders=rrfp.stage_orders(),
        sim_makespan=rrfp.makespan,
        baseline_makespan=base.makespan,
    )


def price_orders(
    spec: PipelineSpec,
    orders: list[list[Task]],
    costs: CostModel,
    use_expected_costs: bool = True,
) -> float:
    """Predicted makespan of a candidate stage-order table under ``costs``.

    Runs the DES engine in pre-committed mode over the candidate orders —
    the same pricing model ``synthesize`` uses for its 1F1B baseline, so a
    re-synthesized table and the currently-active one are compared on
    equal footing.  The adaptive runtime's drift detector calls this with
    the *measured* (jitter-free EWMA snapshot) cost model: a swap happens
    only when the candidate's predicted makespan beats the active
    table's by the configured threshold (docs/adaptive.md).
    """
    cm = costs.expected() if use_expected_costs else costs
    # Async sends: the adaptive runtime executes tables on the actor
    # substrate (mailbox sends, no rendezvous).  Sync rendezvous would also
    # deadlock here — an RRFP-synthesized order can run sends arbitrarily
    # far ahead of the receiver's 2-deep recv window.
    r = Engine(
        spec, cm,
        EngineConfig(mode="precommitted", custom_orders=orders,
                     sync_sends=False),
    ).run()
    return r.makespan


def ema_update_costs(
    costs: CostModel,
    measured_f: np.ndarray,
    measured_b: np.ndarray,
    decay: float = 0.9,
) -> CostModel:
    """Online cost refresh: e_t = decay*e_{t-1} + (1-decay)*c_t (RQ4's EMA).

    Feeds straggler-aware re-synthesis: ``runtime.straggler`` calls this with
    per-stage step timings, then ``synthesize`` re-plans without recompiling.
    """
    return dataclasses.replace(
        costs,
        f_cost=decay * costs.f_cost + (1 - decay) * np.asarray(measured_f),
        b_cost=decay * costs.b_cost + (1 - decay) * np.asarray(measured_b),
    )
