"""Fault injection for the actor runtime: make variability a test input.

The paper's claim is that readiness-driven consumption stays correct *under
runtime variability*; this module turns variability into a controlled,
deterministic input instead of an accident of the host.  A
:class:`ChaosConfig` describes the perturbations, a :class:`ChaosEngine`
samples them with CRN keying (every draw is keyed by (seed, task, rank), not
pulled from a shared stream), so:

* the *same* chaos realization hits a hint-mode run and a precommitted run
  on the same seed — apples-to-apples correctness and makespan comparisons;
* a re-run with the same config is bit-identical, independent of thread
  interleaving — chaos scenarios are reproducible by (config, seed) alone.

Perturbations (all off by default):

* **per-edge latency** — extra heavy-tailed delay per pipeline edge
  (``latency_base`` scaled by ``edge_scale[(src, dst)]``), applied to every
  envelope on both substrates;
* **message reorder** — with ``reorder_prob``, an envelope is additionally
  delayed by up to ``reorder_window`` seconds, letting later sends overtake
  it in the mailbox;
* **message duplication** — with ``duplicate_prob``, up to
  ``max_duplicates`` extra copies of an envelope are delivered at their own
  sampled delays (the TP gate and mailbox must stay idempotent);
* **stragglers** — per-stage compute slowdown factors: multiplicative on
  the sim substrate's sampled durations, an extra keyed sleep on the thread
  substrate;
* **transient stalls** — with ``stall_prob`` per task, the stage blocks for
  an Exp(``stall_scale``) pause before executing (a GC pause / preemption
  analog);
* **drifting costs** — per-stage compute slowdowns that develop *across
  training steps* (``drift_profile``: a slow ramp or a step change),
  deterministic in (config, stage, step): the regime where a
  statically-synthesized schedule decays and adaptive re-synthesis
  (``runtime.adaptive``) holds its speedup;
* **fail-stop faults** — a stage *dies*: ``kill`` (the actor vanishes
  mid-task; its in-memory state is lost) or ``permanent_stall`` (the actor
  hangs forever — indistinguishable from death to the control plane, which
  must detect it by heartbeat deadline rather than by a closed connection).
  Either an explicit injection point (``fail_stage`` dies at its
  ``fail_after``-th dispatch), a multi-fault plan (``fail_stages``: several
  stages — or the same stage twice, death-during-recovery — each with its
  own kind and dispatch index), or CRN-sampled per stage via ``fail_prob``,
  keyed by (seed, stage) so a scenario's death point is a reproducible
  function of the config.  With ``ActorConfig.recover`` the driver's
  recovery coordinator survives the fault; without it, the fault is
  *promoted to a detectable failure*: the run raises :class:`StageFailure`
  instead of hanging.
* **lossy network** — ``drop_prob`` silently discards a wire transmission;
  ``corrupt_prob`` flips the envelope checksum in flight (detectable — the
  reliable receiver NACKs it, it is never admitted); ``partitions`` are
  bidirectional link blackouts ``(a, b, t_start, duration)`` during which
  every transmission (data and ACK) between stages ``a`` and ``b`` is
  dropped, healing at ``t_start + duration``.  All three require the
  reliable-delivery layer (``ActorConfig.reliable``) — without
  retransmission a dropped message is a silent hang — and every draw is
  keyed by (seed, task, rank, src, attempt), so retries re-roll the loss
  while record/replay of the whole scenario stays exact.
"""
from __future__ import annotations

import dataclasses
import threading
import zlib

import numpy as np

from repro_torch.core.taskgraph import Task

from repro_torch.runtime.rrfp.mailbox import Mailbox
from repro_torch.runtime.rrfp.messages import Envelope

#: fail-stop fault kinds
FAIL_KINDS = ("kill", "permanent_stall")

#: drifting-cost profiles ("" = off): how a stage's compute slowdown
#: develops over training steps (see ChaosConfig.drift_scale)
DRIFT_PROFILES = ("", "ramp", "step")


class StageFailure(RuntimeError):
    """A stage died (fail-stop fault) and no recovery coordinator was armed.

    Raised instead of letting the run hang to its deadlock timeout: the
    chaos ``kill`` / ``permanent_stall`` faults are *detectable* failures,
    and an un-recovered run should fail fast and say why."""

    def __init__(self, stage: int, fail_kind: str, detail: str = ""):
        self.stage = stage
        self.fail_kind = fail_kind
        super().__init__(
            f"stage {stage} suffered a fail-stop fault ({fail_kind})"
            + (f": {detail}" if detail else "")
            + "; enable ActorConfig.recover for elastic recovery")


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """One fault-injection scenario (deterministic given ``seed``)."""

    seed: int = 0
    #: extra per-envelope latency: base seconds (0 disables)
    latency_base: float = 0.0
    #: lognormal sigma on the extra latency
    latency_sigma: float = 0.5
    #: per-(src_stage, dst_stage) multiplier on latency_base
    edge_scale: tuple[tuple[tuple[int, int], float], ...] = ()
    #: probability an envelope is held back by an extra uniform delay
    reorder_prob: float = 0.0
    reorder_window: float = 0.0
    #: probability an envelope is duplicated (each copy re-delayed)
    duplicate_prob: float = 0.0
    max_duplicates: int = 1
    #: per-stage compute slowdown: ((stage, factor), ...), factor >= 1
    straggler: tuple[tuple[int, float], ...] = ()
    #: thread substrate: seconds of extra sleep per unit of (factor - 1)
    straggler_unit: float = 1e-3
    #: per-task transient stage stall
    stall_prob: float = 0.0
    stall_scale: float = 0.0  # Exp() scale, seconds
    #: fail-stop fault: explicit injection — this stage dies at the dispatch
    #: of its ``fail_after``-th task (0-indexed; that task never completes
    #: and the stage makes no further progress).  -1 disables.
    fail_stage: int = -1
    fail_kind: str = "kill"  # "kill" | "permanent_stall"
    fail_after: int = 0
    #: fail-stop fault: CRN-sampled — each stage independently dies with
    #: this probability, at a death point drawn from (seed, stage)
    fail_prob: float = 0.0
    #: multi-fault plan: ((stage, kind, after), ...) — overlapping faults
    #: (concurrent deaths, or the same stage listed twice for
    #: death-during-recovery; ``after`` counts the stage's dispatches
    #: *across incarnations*, so a second entry must exceed the first)
    fail_stages: tuple[tuple[int, str, int], ...] = ()
    #: ---- lossy network (requires ActorConfig.reliable) -------------------
    #: probability one wire transmission (one attempt x one chaos copy) is
    #: silently dropped; ACK/NACK transmissions roll independently
    drop_prob: float = 0.0
    #: probability one wire transmission arrives with a corrupted checksum
    corrupt_prob: float = 0.0
    #: bidirectional link blackouts: ((a, b, t_start, duration), ...) in
    #: substrate seconds — between t_start and t_start + duration nothing
    #: crosses the a<->b edge in either direction
    partitions: tuple[tuple[int, int, float, float], ...] = ()
    #: ---- drifting compute costs (adaptive-scheduling scenarios) ----------
    #: "" (off) | "ramp" (slowdown grows linearly over drift_period steps,
    #: then holds) | "step" (slowdown switches on at step == drift_period)
    drift_profile: str = ""
    #: per-stage drift targets: ((stage, peak_factor), ...), factor >= 1 —
    #: the stage's compute slowdown once the drift has fully developed
    drift: tuple[tuple[int, float], ...] = ()
    #: steps to full ramp / the step-change point
    drift_period: int = 8
    #: the current training iteration — the drift's time axis.  The caller
    #: advances it between runs (``dataclasses.replace(chaos, step=k)``);
    #: within one run the scale is constant, so CRN keying is untouched.
    step: int = 0

    def __post_init__(self):
        if self.fail_kind not in FAIL_KINDS:
            raise ValueError(
                f"fail_kind must be one of {FAIL_KINDS}, "
                f"got {self.fail_kind!r}")
        if self.drift_profile not in DRIFT_PROFILES:
            raise ValueError(
                f"drift_profile must be one of {DRIFT_PROFILES}, "
                f"got {self.drift_profile!r}")
        for entry in self.fail_stages:
            s, kind, after = entry
            if kind not in FAIL_KINDS:
                raise ValueError(
                    f"fail_stages entry {entry!r}: kind must be one of "
                    f"{FAIL_KINDS}")
        for entry in self.partitions:
            if len(entry) != 4:
                raise ValueError(
                    f"partitions entry {entry!r}: expected "
                    f"(stage_a, stage_b, t_start, duration)")

    def active(self) -> bool:
        return (self.latency_base > 0 or self.reorder_prob > 0
                or self.duplicate_prob > 0 or bool(self.straggler)
                or self.stall_prob > 0 or self.fail_stage >= 0
                or self.fail_prob > 0 or bool(self.fail_stages)
                or self.lossy()
                or bool(self.drift_profile and self.drift))

    def lossy(self) -> bool:
        """True when messages can be lost or mangled outright — the regime
        that requires the reliable-delivery layer (``ActorConfig.reliable``)."""
        return (self.drop_prob > 0 or self.corrupt_prob > 0
                or bool(self.partitions))

    def drift_scale(self, stage: int) -> float:
        """Deterministic per-stage compute slowdown at ``self.step``.

        A pure function of (config, stage, step): no RNG draw, so drift
        composes with CRN chaos keying and replays exactly."""
        if not self.drift_profile:
            return 1.0
        mag = dict(self.drift).get(stage)
        if mag is None:
            return 1.0
        if self.drift_profile == "ramp":
            f = min(1.0, self.step / max(1, self.drift_period))
        else:  # "step"
            f = 1.0 if self.step >= self.drift_period else 0.0
        return 1.0 + (mag - 1.0) * f

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["edge_scale"] = [[list(k), v] for k, v in self.edge_scale]
        d["straggler"] = [list(kv) for kv in self.straggler]
        d["drift"] = [list(kv) for kv in self.drift]
        d["fail_stages"] = [list(kv) for kv in self.fail_stages]
        d["partitions"] = [list(kv) for kv in self.partitions]
        return d


#: Named intensity levels for sweeps and the CLI (C0 = control).
CHAOS_LEVELS = {
    "C0": ChaosConfig(),
    "C1": ChaosConfig(latency_base=5e-4, reorder_prob=0.1,
                      reorder_window=2e-3, duplicate_prob=0.05),
    "C2": ChaosConfig(latency_base=2e-3, reorder_prob=0.3, reorder_window=1e-2,
                      duplicate_prob=0.15, straggler=((1, 2.0),),
                      stall_prob=0.05, stall_scale=5e-3),
    "C3": ChaosConfig(latency_base=5e-3, latency_sigma=1.0, reorder_prob=0.5,
                      reorder_window=5e-2, duplicate_prob=0.3,
                      max_duplicates=2, straggler=((1, 3.0), (2, 2.0)),
                      stall_prob=0.15, stall_scale=2e-2),
}


#: Modality-aware fault profiles for heterogeneous (DAG) pipelines.  Each
#: profile targets one *branch* of a branch+fusion topology: which stages
#: straggle and which edges get scaled latency depend on the stage roles,
#: so the profile is a function of (encoder stages, decoder stages, fan-in
#: edges) rather than a fixed config.  Compose with a base intensity level:
#: ``modality_profile("slow_vision", ..., level="C2")``.
MODALITY_PROFILE_NAMES = ("slow_vision", "slow_decoder", "flaky_fusion_link")


def modality_profile(
    name: str,
    *,
    encoder_stages: tuple[int, ...] | list[int],
    decoder_stages: tuple[int, ...] | list[int],
    fanin_edges: tuple[tuple[int, int], ...] | list[tuple[int, int]] = (),
    level: str | ChaosConfig = "C1",
    seed: int | None = None,
) -> ChaosConfig:
    """Per-branch fault profile on top of a chaos intensity level.

    * ``slow_vision``      — the encoder branch straggles (3x on its slowest
      stage, 2x elsewhere in the branch): the regime where fixed orders
      tuned for balanced stages serialize on the cheap branch.
    * ``slow_decoder``     — the LM/decoder chain straggles instead: the
      encoder branch races ahead and fan-in buffering absorbs the skew.
    * ``flaky_fusion_link``— the fan-in edges into the fusion stage carry
      8x latency (and inherit the level's reorder/duplication): stresses
      the multi-predecessor admission gate under partial arrival.
    """
    base = CHAOS_LEVELS[level] if isinstance(level, str) else level
    if seed is not None:
        base = dataclasses.replace(base, seed=seed)
    enc = tuple(int(s) for s in encoder_stages)
    dec = tuple(int(s) for s in decoder_stages)
    if name == "slow_vision":
        strag = tuple((s, 3.0 if i == len(enc) - 1 else 2.0)
                      for i, s in enumerate(enc))
        return dataclasses.replace(base, straggler=strag)
    if name == "slow_decoder":
        strag = tuple((s, 2.5 if i == 0 else 2.0)
                      for i, s in enumerate(dec))
        return dataclasses.replace(base, straggler=strag)
    if name == "flaky_fusion_link":
        if not fanin_edges:
            raise ValueError(
                "flaky_fusion_link targets the fan-in edges; pass "
                "fanin_edges=((enc_last, fusion), (text, fusion), ...)")
        scale = tuple(((int(a), int(b)), 8.0) for a, b in fanin_edges)
        return dataclasses.replace(
            base,
            latency_base=max(base.latency_base, 5e-4),
            edge_scale=scale)
    raise ValueError(
        f"unknown modality profile {name!r}; "
        f"available: {MODALITY_PROFILE_NAMES}")


def drift_chaos(
    profile: str,
    targets: dict[int, float] | tuple[tuple[int, float], ...] | list[tuple[int, float]],
    period: int = 8,
    level: str | ChaosConfig = "C0",
    seed: int | None = None,
) -> ChaosConfig:
    """A drifting-cost scenario on top of a chaos intensity level.

    ``profile`` is ``"ramp"`` (slow creep — thermal throttling, a failing
    NIC's retransmits, a co-tenant warming up) or ``"step"`` (regime change
    — a remapped stage landing on a time-shared device, a frequency cap
    kicking in).  ``targets`` names the stages that slow down and their
    peak factors; the drift develops over ``period`` steps, advanced by
    the caller via ``dataclasses.replace(chaos, step=k)`` per iteration.
    This is the regime where a statically-synthesized hint decays and the
    adaptive re-synthesizer earns its keep (benchmarks/adaptive_compare).
    """
    base = CHAOS_LEVELS[level] if isinstance(level, str) else level
    if seed is not None:
        base = dataclasses.replace(base, seed=seed)
    pairs = targets.items() if isinstance(targets, dict) else targets
    return dataclasses.replace(
        base, drift_profile=profile,
        drift=tuple((int(s), float(f)) for s, f in pairs),
        drift_period=int(period))


#: parse_chaos key grammar (everything else is rejected, loudly)
_CHAOS_PAIR_KEYS = ("straggler", "drift")
_CHAOS_INT_KEYS = ("seed", "max_duplicates", "fail_stage", "fail_after",
                   "drift_period", "step")
_CHAOS_STR_KEYS = ("fail_kind", "drift_profile")
_CHAOS_FLOAT_KEYS = ("latency_base", "latency_sigma", "reorder_prob",
                     "reorder_window", "duplicate_prob", "straggler_unit",
                     "stall_prob", "stall_scale", "fail_prob", "drop_prob",
                     "corrupt_prob")
_CHAOS_STRUCT_KEYS = ("partition", "fail_stages")
CHAOS_SPEC_KEYS = (_CHAOS_PAIR_KEYS + _CHAOS_INT_KEYS + _CHAOS_STR_KEYS
                   + _CHAOS_FLOAT_KEYS + _CHAOS_STRUCT_KEYS)


def parse_chaos(spec: str) -> ChaosConfig:
    """CLI syntax: a level name and/or comma-separated key=value overrides.

        --chaos C2
        --chaos C1,reorder_prob=0.5,seed=7
        --chaos latency_base=1e-3,straggler=1:2.5+3:4.0
        --chaos drop_prob=0.05,corrupt_prob=0.01,partition=1:2:0.02:0.05
        --chaos fail_stages=1:kill:2+3:kill:4

    The level (at most one) is the base config regardless of where it
    appears; key=value parts override it in order.  ``partition`` entries
    are ``a:b:t_start:duration`` (``+``-joined for several); ``fail_stages``
    entries are ``stage:kind:after``.  Unknown keys and malformed values
    fail fast with the list of valid keys — a typo must never silently
    parse to "no chaos".
    """
    parts = list(filter(None, (p.strip() for p in spec.split(","))))
    levels = [p for p in parts if p in CHAOS_LEVELS]
    if len(levels) > 1:
        raise ValueError(f"at most one chaos level, got {levels}")
    cfg = CHAOS_LEVELS[levels[0]] if levels else ChaosConfig()
    for part in parts:
        if part in CHAOS_LEVELS:
            continue
        if "=" not in part:
            raise ValueError(
                f"bad chaos spec {part!r}: expected a level in "
                f"{sorted(CHAOS_LEVELS)} or key=value "
                f"(keys: {sorted(CHAOS_SPEC_KEYS)})")
        key, val = part.split("=", 1)
        if key not in CHAOS_SPEC_KEYS:
            raise ValueError(
                f"unknown chaos key {key!r} in {part!r}; valid keys: "
                f"{sorted(CHAOS_SPEC_KEYS)}")
        try:
            if key in _CHAOS_PAIR_KEYS:
                pairs = tuple(
                    (int(s), float(f))
                    for s, f in (kv.split(":") for kv in val.split("+")))
                cfg = dataclasses.replace(cfg, **{key: pairs})
            elif key == "partition":
                quads = tuple(
                    (int(a), int(b), float(t0), float(d))
                    for a, b, t0, d in
                    (kv.split(":") for kv in val.split("+")))
                cfg = dataclasses.replace(cfg, partitions=quads)
            elif key == "fail_stages":
                triples = tuple(
                    (int(s), kind, int(k))
                    for s, kind, k in
                    (kv.split(":") for kv in val.split("+")))
                cfg = dataclasses.replace(cfg, fail_stages=triples)
            elif key in _CHAOS_INT_KEYS:
                cfg = dataclasses.replace(cfg, **{key: int(val)})
            elif key in _CHAOS_STR_KEYS:
                cfg = dataclasses.replace(cfg, **{key: val})
            else:
                cfg = dataclasses.replace(cfg, **{key: float(val)})
        except ValueError as exc:
            # __post_init__ rejections (bad fail_kind etc.) are already
            # descriptive; wrap only raw conversion failures
            if "chaos" in str(exc) or "must be one of" in str(exc):
                raise
            raise ValueError(
                f"bad chaos value in {part!r}: {exc}") from exc
    return cfg


class ChaosEngine:
    """CRN-keyed sampler for one ChaosConfig.

    Stateless across calls: every sample is drawn from a generator keyed by
    (seed, purpose, task, rank), so results do not depend on call order,
    thread interleaving, or how many other samples were drawn — the property
    that makes chaotic runs replayable and mode comparisons fair.
    """

    def __init__(self, cfg: ChaosConfig):
        self.cfg = cfg
        self._edge = dict(cfg.edge_scale)
        self._straggler = dict(cfg.straggler)

    def _rng(self, purpose: str, task: Task, rank: int = 0,
             copy: int = 0, src: int = -1) -> np.random.Generator:
        return np.random.default_rng(
            [self.cfg.seed & 0x7FFFFFFF, zlib.crc32(purpose.encode()),
             int(task.kind), task.stage, task.mb, task.chunk, rank, copy,
             src & 0x7FFFFFFF])

    # ---- communication -----------------------------------------------------
    def comm_delay(self, env: Envelope, copy: int = 0) -> float:
        """Extra delivery delay for one envelope copy (0 when inactive).

        Keyed per (task, rank, copy, source edge): a DAG fan-in task's
        branch messages draw independent delays.
        """
        cfg, delay = self.cfg, 0.0
        if cfg.latency_base > 0:
            rng = self._rng("lat", env.task, env.rank, copy, env.src_stage)
            scale = self._edge.get((env.src_stage, env.dst_stage), 1.0)
            delay += cfg.latency_base * scale * float(rng.lognormal(
                mean=-0.5 * cfg.latency_sigma**2, sigma=cfg.latency_sigma))
        if cfg.reorder_prob > 0:
            rng = self._rng("reorder", env.task, env.rank, copy,
                            env.src_stage)
            if rng.random() < cfg.reorder_prob:
                delay += cfg.reorder_window * float(rng.random())
        return delay

    def copies(self, env: Envelope) -> int:
        """Total deliveries for this envelope (>= 1)."""
        if self.cfg.duplicate_prob <= 0:
            return 1
        rng = self._rng("dup", env.task, env.rank, src=env.src_stage)
        extra = 0
        while (extra < self.cfg.max_duplicates
               and rng.random() < self.cfg.duplicate_prob):
            extra += 1
        return 1 + extra

    # ---- compute -----------------------------------------------------------
    def compute_scale(self, stage: int) -> float:
        """Static straggler factor x the drift profile's step-``k`` factor
        (both deterministic; the product is what realized durations see)."""
        return self._straggler.get(stage, 1.0) * self.cfg.drift_scale(stage)

    def stall(self, task: Task) -> float:
        """Transient stage stall before executing ``task`` (seconds)."""
        if self.cfg.stall_prob <= 0:
            return 0.0
        rng = self._rng("stall", task)
        if rng.random() >= self.cfg.stall_prob:
            return 0.0
        return self.cfg.stall_scale * float(rng.exponential())

    def thread_delay(self, task: Task) -> float:
        """Thread substrate: total injected sleep before executing ``task``
        (stall + straggler emulation; compute itself cannot be scaled)."""
        factor = self.compute_scale(task.stage)
        return self.stall(task) + (factor - 1.0) * self.cfg.straggler_unit

    # ---- fail-stop ---------------------------------------------------------
    def fail_point(self, stage: int, n_tasks: int) -> tuple[str, int] | None:
        """Does ``stage`` suffer a fail-stop fault this run, and when?

        Returns ``(fail_kind, k)`` — the stage dies at the dispatch of its
        k-th task (0-indexed) — or None.  The sampled path is keyed by
        (seed, "fail", stage): a pure function of the config, so the same
        scenario kills the same stage at the same point in every consumption
        mode and on both substrates (CRN)."""
        cfg = self.cfg
        if cfg.fail_stage == stage:
            # clamp into the stage's dispatch range so an armed fault always
            # fires (a never-firing fault would hang the recovery coordinator)
            return (cfg.fail_kind, min(max(0, cfg.fail_after), n_tasks - 1))
        if cfg.fail_prob > 0:
            rng = np.random.default_rng(
                [cfg.seed & 0x7FFFFFFF, zlib.crc32(b"fail"), stage])
            if rng.random() < cfg.fail_prob:
                return (cfg.fail_kind, int(rng.integers(0, max(1, n_tasks))))
        return None

    def fail_points(self, stage: int, n_tasks: int) -> list[tuple[str, int]]:
        """All fail-stop faults planned for ``stage``, in dispatch order.

        Supersets :meth:`fail_point` with the ``fail_stages`` multi-fault
        plan: the same stage may appear several times (death-during-recovery)
        and several stages may carry overlapping windows.  Each entry's
        dispatch index is clamped into range so an armed fault always fires;
        duplicate indices on one stage are collapsed (a stage can only die
        once per dispatch)."""
        pts: list[tuple[str, int]] = []
        single = self.fail_point(stage, n_tasks)
        if single is not None:
            pts.append(single)
        for s, kind, after in self.cfg.fail_stages:
            if s == stage:
                pts.append((kind, min(max(0, after), max(0, n_tasks - 1))))
        pts.sort(key=lambda p: p[1])
        out: list[tuple[str, int]] = []
        for kind, k in pts:
            if not out or out[-1][1] != k:
                out.append((kind, k))
        return out

    # ---- lossy network -----------------------------------------------------
    def partitioned(self, a: int, b: int, now: float) -> bool:
        """Is the a<->b link blacked out at substrate time ``now``?"""
        for pa, pb, t0, dur in self.cfg.partitions:
            if {pa, pb} == {a, b} and t0 <= now < t0 + dur:
                return True
        return False

    def dropped(self, env: Envelope, now: float, attempt: int = 0,
                copy: int = 0) -> bool:
        """Is this wire transmission (one attempt x one copy) lost?

        Partitions drop deterministically (a blackout loses everything on
        the edge); otherwise ``drop_prob`` rolls per (task, rank, attempt,
        copy, src) — a retransmission re-rolls its fate, which is what lets
        bounded retry eventually get through a merely-lossy link while a
        partition defeats it until it heals or retry escalates."""
        if self.partitioned(env.src_stage, env.dst_stage, now):
            return True
        if self.cfg.drop_prob <= 0:
            return False
        rng = self._rng(f"drop:{attempt}:{copy}", env.task, env.rank,
                        src=env.src_stage)
        return bool(rng.random() < self.cfg.drop_prob)

    def corrupted(self, env: Envelope, attempt: int = 0) -> bool:
        """Does this transmission arrive with a mangled checksum?"""
        if self.cfg.corrupt_prob <= 0:
            return False
        rng = self._rng(f"corrupt:{attempt}", env.task, env.rank,
                        src=env.src_stage)
        return bool(rng.random() < self.cfg.corrupt_prob)

    def ack_dropped(self, env: Envelope, now: float,
                    attempt: int = 0) -> bool:
        """Is the ACK/NACK for this (env, attempt) lost on the way back?

        ACKs traverse the same lossy wire (reverse direction of the data
        edge) but carry no reliability of their own — a lost ACK is healed
        by the sender's retransmission plus receiver-side dedup."""
        if self.partitioned(env.src_stage, env.dst_stage, now):
            return True
        if self.cfg.drop_prob <= 0:
            return False
        rng = self._rng(f"ackdrop:{attempt}", env.task, env.rank,
                        src=env.src_stage)
        return bool(rng.random() < self.cfg.drop_prob)


class ChaosThreadTransport:
    """Thread-substrate transport applying chaos on the delivery path.

    Delayed or duplicated envelopes are delivered from daemon timer threads;
    an undelayed, unduplicated envelope takes the direct path (no timer).
    ``drain`` blocks until every outstanding delayed delivery has landed, so
    a driver can guarantee no timer outlives the run.
    """

    def __init__(self, mailboxes: dict[int, Mailbox], chaos: ChaosEngine,
                 on_send=None):
        self.mailboxes = mailboxes
        self.chaos = chaos
        self.on_send = on_send
        self.sent = 0
        self._pending = 0
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)

    def send(self, env: Envelope, now: float = 0.0) -> None:
        self.sent += 1
        if self.on_send is not None:
            self.on_send(env, now)
        n = self.chaos.copies(env)
        for copy in range(n):
            delay = self.chaos.comm_delay(env, copy)
            if copy == 0 and delay <= 0:
                self.mailboxes[env.dst_stage].deliver(env, now=now)
                continue
            with self._lock:
                self._pending += 1
            timer = threading.Timer(
                max(delay, 1e-6), self._deliver_late, args=(env, now + delay))
            timer.daemon = True
            timer.start()

    def _deliver_late(self, env: Envelope, at: float) -> None:
        try:
            self.mailboxes[env.dst_stage].deliver(env, now=at)
        finally:
            with self._lock:
                self._pending -= 1
                if self._pending == 0:
                    self._idle.notify_all()

    def drain(self, timeout: float = 30.0) -> bool:
        with self._lock:
            return self._idle.wait_for(lambda: self._pending == 0, timeout)
