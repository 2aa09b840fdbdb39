"""RRFP host actor runtime: message-driven pipeline dispatch (§4–§5).

The executable counterpart of the DES engine in ``repro_torch.core.engine``: each
pipeline stage is an actor with per-kind ready buffers fed by a message
transport, dispatching work by *arrival* under hint-order arbitration — not
by schedule-table tick.  See ``docs/runtime.md`` for the architecture.

Layering (bottom-up):
  trace     -- logical-clock event log: record / save / load / replay oracles
  messages  -- envelopes + per-TP-rank fan-out
  tp_group  -- §4.2 all-ranks admission barrier (duplicate-idempotent)
  mailbox   -- thread-safe per-kind arrival buffers
  transport -- SimTransport (virtual clock, injectable heavy-tailed latency)
               / ThreadTransport (thread-per-stage, real callables) /
               ReliableChannel + ReliableThreadTransport (per-edge seqnos,
               checksums, ACK/NACK, CRN-keyed retransmission: exactly-once
               delivery over a lossy wire, on both substrates)
  chaos     -- CRN-keyed fault injection: per-edge latency, reorder,
               duplication, stragglers, transient stalls, drifting costs
               (``drift_chaos``: the adaptive-rescheduling regime),
               fail-stop faults (kill / permanent_stall, concurrent and
               cascading via ``fail_stages``), and the lossy-network model
               (drop / corrupt / partition) — both substrates
  actor     -- ready-set arbitration + App. C backpressure + thread loop
  driver    -- builds/wires everything; emits core.engine.RunResult traces,
               records event traces, replays recorded runs; with
               ``ActorConfig.recover``, survives fail-stop faults (epoch
               fencing + respawn/re-map + restore + replay, exactly-once)

See ``docs/testing.md`` for the conformance invariants checked against
recorded traces and how to record/replay a run.
"""
from repro_torch.runtime.rrfp.actor import StageActor, TaskTrace
from repro_torch.runtime.rrfp.chaos import (
    CHAOS_LEVELS,
    DRIFT_PROFILES,
    FAIL_KINDS,
    MODALITY_PROFILE_NAMES,
    ChaosConfig,
    ChaosEngine,
    ChaosThreadTransport,
    StageFailure,
    drift_chaos,
    modality_profile,
    parse_chaos,
)
from repro_torch.runtime.rrfp.driver import (
    ActorConfig,
    ActorDriver,
    average_makespan_actor,
    run_actor_iteration,
)
from repro_torch.runtime.rrfp.mailbox import Mailbox
from repro_torch.runtime.rrfp.messages import (
    EdgePayloads,
    Envelope,
    envelopes_for,
    payload_for_edge,
)
from repro_torch.runtime.rrfp.tp_group import Admission, TPGroup
from repro_torch.runtime.rrfp.trace import (
    ReplayOracle,
    Trace,
    TraceEvent,
    TraceRecorder,
    engine_replay_config,
)
from repro_torch.runtime.rrfp.transport import (
    Ack,
    ReliableChannel,
    ReliableConfig,
    ReliableThreadTransport,
    SimTransport,
    ThreadTransport,
)

__all__ = [
    "Ack",
    "ActorConfig",
    "ActorDriver",
    "Admission",
    "ReliableChannel",
    "ReliableConfig",
    "ReliableThreadTransport",
    "CHAOS_LEVELS",
    "ChaosConfig",
    "DRIFT_PROFILES",
    "ChaosEngine",
    "ChaosThreadTransport",
    "EdgePayloads",
    "Envelope",
    "FAIL_KINDS",
    "MODALITY_PROFILE_NAMES",
    "Mailbox",
    "modality_profile",
    "payload_for_edge",
    "ReplayOracle",
    "SimTransport",
    "StageActor",
    "StageFailure",
    "TaskTrace",
    "ThreadTransport",
    "TPGroup",
    "Trace",
    "TraceEvent",
    "TraceRecorder",
    "average_makespan_actor",
    "drift_chaos",
    "engine_replay_config",
    "envelopes_for",
    "parse_chaos",
    "run_actor_iteration",
]
