"""Adaptive scheduling: online costs -> hint re-synthesis -> live hot-swap.

Closes ROADMAP item 3's loop.  Schedules in this runtime are *data* — a
rank table the arbiter consults, never a compiled artifact — so when the
measured per-(stage, op) costs drift away from the costs the active table
was synthesized against, a better table can be priced, synthesized, and
swapped into the live :class:`~repro_torch.core.hints.HintArbiter` /
:class:`~repro_torch.core.hints.ReadySet` without recompilation.

The loop, once per ``resynth_every`` training iterations:

1. **snapshot** — ``MetricsRegistry.cost_table().as_cost_model()`` turns the
   live per-(stage, kind) duration EWMAs (fed by the runtime's completion
   hooks) into a jitter-free expected cost model;
2. **re-synthesize** — ``core.synthesis.synthesize`` runs the faithful RRFP
   engine over the measured model and extracts candidate stage orders;
3. **price** — ``core.synthesis.price_orders`` predicts the makespan of the
   *active* table and the *candidate* table on the same measured model;
4. **decide** — swap only if the candidate beats the active table by
   ``swap_threshold`` for ``hysteresis`` consecutive checks (a drift
   detector with flap suppression: under a stationary cost profile the
   candidate re-derives the active table, the ratio pins to ~1.0, and no
   swap ever fires);
5. **hot-swap** — the caller passes ``scheduler.table`` to the next run's
   :class:`~repro_torch.runtime.rrfp.driver.ActorConfig` (iteration-boundary
   quiesce point), or arms ``swap_table``/``swap_at``/``swap_after`` for a
   mid-run swap; either way the adoption is recorded as ``HINT_SWAP``
   trace events, so replay and the conformance table-faithfulness check
   stay exact.

See ``docs/adaptive.md`` for the drift model and guarantees, and
``benchmarks/adaptive_compare.py`` for the static-decay-vs-adaptive-hold
experiment (``BENCH_adaptive.json``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.costs import CostModel
from repro_torch.core.hints import HintKind
from repro_torch.core.synthesis import price_orders, synthesize
from repro_torch.core.taskgraph import Kind, PipelineSpec, Task
from repro_torch.obs.metrics import MetricsRegistry


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    """Drift-detector and re-synthesis knobs (``launch.train`` CLI flags)."""

    #: check cadence: re-price/re-synthesize every N training iterations
    resynth_every: int = 1
    #: required predicted-makespan improvement factor
    #: (active / candidate >= threshold) for a check to count as improving
    swap_threshold: float = 1.03
    #: consecutive improving checks required before a swap fires
    hysteresis: int = 2
    #: per-stage realized-duration sample floor before the measured table
    #: is trusted at all (a cold EWMA is noise, not drift)
    min_samples: int = 4
    #: hint the re-synthesizer runs under (BFW for split-backward specs)
    hint: HintKind = HintKind.BF
    buffer_limit: int = 32


@dataclasses.dataclass
class SwapDecision:
    """One drift-detector evaluation (``scheduler.decisions`` history)."""

    step: int
    checked: bool          # False: off-cadence or cold-table skip
    swapped: bool
    predicted_active: float | None = None
    predicted_candidate: float | None = None
    streak: int = 0        # improving-check streak after this evaluation
    reason: str = ""
    #: when a swap fired: the critical-path category (obs.critpath) the
    #: candidate table was predicted to shrink the most — which kind of
    #: bound (compute / comm / gate / dispatch) the swap attacked
    predicted_category: str | None = None

    @property
    def ratio(self) -> float | None:
        """Predicted improvement factor of candidate over active (>1 =
        the measured costs say the candidate table is faster)."""
        if self.predicted_active is None or not self.predicted_candidate:
            return None
        return self.predicted_active / self.predicted_candidate

    def to_json(self) -> dict:
        return {
            "step": self.step, "checked": self.checked,
            "swapped": self.swapped, "ratio": self.ratio,
            "predicted_active": self.predicted_active,
            "predicted_candidate": self.predicted_candidate,
            "streak": self.streak, "reason": self.reason,
            "predicted_category": self.predicted_category,
        }


class AdaptiveScheduler:
    """Background re-synthesizer + drift detector for one pipeline.

    Owns (or adopts) the :class:`MetricsRegistry` the runtime feeds; the
    training loop calls :meth:`maybe_resynthesize` at each iteration
    boundary and passes the current :attr:`table` / :attr:`version` to the
    next iteration's ``ActorConfig`` (``hint_table`` /
    ``hint_table_version``).  Synthesis and pricing run on the snapshot,
    off the dispatch hot path.
    """

    def __init__(
        self,
        spec: PipelineSpec,
        base_costs: CostModel,
        config: AdaptiveConfig | None = None,
        registry: MetricsRegistry | None = None,
    ):
        self.spec = spec
        self.base_costs = base_costs
        self.config = config or AdaptiveConfig()
        self.registry = (registry if registry is not None
                         else MetricsRegistry(spec.num_stages))
        syn = synthesize(spec, base_costs, hint=self.config.hint,
                         buffer_limit=self.config.buffer_limit)
        #: the active per-stage rank table (ActorConfig.hint_table)
        self.table: list[list[Task]] = syn.stage_orders
        #: bumped on every swap (ActorConfig.hint_table_version)
        self.version = 0
        #: full decision history, one entry per maybe_resynthesize call
        self.decisions: list[SwapDecision] = []
        #: steps at which a swap fired
        self.swaps: list[int] = []
        self._streak = 0

    # ------------------------------------------------------------------
    def measured_costs(self) -> CostModel:
        """Jitter-free snapshot of the live EWMAs (base costs fill cold
        cells, e.g. before stage S-1's first completion lands)."""
        return self.registry.cost_table().as_cost_model(
            default=self.base_costs)

    def _cold(self) -> bool:
        table = self.registry.cost_table()
        kinds = [Kind.F, Kind.B] + (
            [Kind.W] if self.spec.split_backward else [])
        for s in range(self.spec.num_stages):
            if sum(table.samples(s, k) for k in kinds) < \
                    self.config.min_samples:
                return True
        return False

    def maybe_resynthesize(self, step: int) -> SwapDecision:
        """Run the drift detector at the boundary of iteration ``step``.

        Returns (and appends to :attr:`decisions`) the evaluation; when it
        fired, :attr:`table`/:attr:`version` already hold the new table.
        """
        cfg = self.config
        if (step + 1) % max(1, cfg.resynth_every) != 0:
            d = SwapDecision(step, checked=False, swapped=False,
                             streak=self._streak, reason="off-cadence")
            self.decisions.append(d)
            return d
        if self._cold():
            d = SwapDecision(step, checked=False, swapped=False,
                             streak=self._streak,
                             reason=f"cold table (<{cfg.min_samples} "
                                    f"samples on some stage)")
            self.decisions.append(d)
            return d
        measured = self.measured_costs()
        candidate = synthesize(
            self.spec, measured, hint=cfg.hint,
            buffer_limit=cfg.buffer_limit).stage_orders
        p_active = price_orders(self.spec, self.table, measured)
        p_cand = price_orders(self.spec, candidate, measured)
        improving = p_active / max(p_cand, 1e-12) >= cfg.swap_threshold
        self._streak = self._streak + 1 if improving else 0
        swapped = False
        reason = "below threshold" if not improving else (
            f"improving ({self._streak}/{cfg.hysteresis})")
        category = None
        if self._streak >= cfg.hysteresis:
            old_table = self.table
            self.table = candidate
            self.version += 1
            self.swaps.append(step)
            self._streak = 0
            swapped = True
            reason = "swapped"
            category = self._predicted_category(old_table, candidate,
                                                measured)
        d = SwapDecision(step, checked=True, swapped=swapped,
                         predicted_active=p_active,
                         predicted_candidate=p_cand,
                         streak=self._streak, reason=reason,
                         predicted_category=category)
        self.decisions.append(d)
        return d

    def note_remap(self, host_of: list[int],
                   recovery_cost: float = 0.0) -> SwapDecision:
        """Re-synthesize against a post-remap topology (elastic recovery).

        A re-map is a *known* regime shift, not measured drift: stages that
        now time-share a host run slower by their cohabitation factor, and
        the drift detector's hysteresis would leave the pipeline on a table
        priced for the dead topology for several iterations.  So this prices
        the remap directly — each stage's compute costs are scaled by the
        number of stages its host now carries, ``recovery_cost`` (restore +
        replay time, from the measured recovery window) is folded in as a
        uniform per-stage compute surcharge — and the candidate table is
        adopted *immediately* when it prices better than the active one.

        The caller (the recovery coordinator / training loop) passes the
        ``host_of`` map the remap produced, and arms the returned table for
        the post-recovery iterations exactly like a drift swap.
        """
        import collections

        load = collections.Counter(host_of)
        factors = [float(load[host_of[s]])
                   for s in range(self.spec.num_stages)]
        measured = self.measured_costs() if not self._cold() \
            else self.base_costs
        surcharge = recovery_cost / max(1, self.spec.num_microbatches)
        degraded = dataclasses.replace(
            measured,
            f_cost=measured.f_cost * factors + surcharge,
            b_cost=measured.b_cost * factors + surcharge,
            w_cost=measured.w_cost * factors,
        )
        candidate = synthesize(
            self.spec, degraded, hint=self.config.hint,
            buffer_limit=self.config.buffer_limit).stage_orders
        p_active = price_orders(self.spec, self.table, degraded)
        p_cand = price_orders(self.spec, candidate, degraded)
        swapped = p_cand < p_active
        if swapped:
            self.table = candidate
            self.version += 1
            # no hysteresis: the topology change already happened
            self._streak = 0
        d = SwapDecision(step=-1, checked=True, swapped=swapped,
                         predicted_active=p_active,
                         predicted_candidate=p_cand,
                         streak=self._streak,
                         reason="remap" if swapped
                         else "remap (active table still best)")
        self.decisions.append(d)
        return d

    def _predicted_category(self, old_table, new_table,
                            measured: CostModel) -> str | None:
        """Which critical-path category the swap was predicted to shrink.

        Prices both tables with recorded sim runs on the measured costs and
        diffs their critical-path decompositions (``obs.critpath``) — pure
        annotation on the swap decision, never part of the swap criterion;
        best-effort (None when the probe runs cannot be priced).
        """
        try:
            from repro_torch.obs.critpath import ExecGraph
            from repro_torch.runtime.rrfp import ActorConfig, ActorDriver

            cats = []
            for table in (old_table, new_table):
                cfg = ActorConfig(
                    mode="hint", hint=self.config.hint,
                    buffer_limit=self.config.buffer_limit,
                    hint_table=table, record_trace=True, seed=0)
                trace = ActorDriver(self.spec, measured, cfg).run().trace
                cats.append(ExecGraph.build(trace, self.spec)
                            .decompose().categories)
            delta = {c: cats[0][c] - cats[1][c] for c in cats[0]}
            best = max(delta, key=lambda c: delta[c])
            return best if delta[best] > 0 else None
        except Exception:
            return None

    def to_json(self) -> dict:
        return {
            "version": self.version,
            "swaps": list(self.swaps),
            "decisions": [d.to_json() for d in self.decisions],
            "config": {
                "resynth_every": self.config.resynth_every,
                "swap_threshold": self.config.swap_threshold,
                "hysteresis": self.config.hysteresis,
                "min_samples": self.config.min_samples,
                "hint": self.config.hint.value,
                "buffer_limit": self.config.buffer_limit,
            },
        }
