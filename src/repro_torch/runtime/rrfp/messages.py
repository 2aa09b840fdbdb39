"""Message types of the host actor runtime (§4.1).

Everything that moves between stage actors is an :class:`Envelope`: a
task-readiness notification addressed to the (stage, rank) that will hold the
payload.  With tensor parallelism each logical message fans out into one
envelope per TP rank; the receiving :class:`~repro_torch.runtime.rrfp.tp_group.TPGroup`
re-assembles them and only then admits the task into the stage's ready
buffers (§4.2).

Envelopes are deliberately payload-free in simulation mode — the payload is
the *fact of arrival*.  In thread mode the payload slot carries the actual
activation / gradient array produced by the sender's jitted stage callable.
"""
from __future__ import annotations

import dataclasses
import itertools
import zlib
from typing import Any

from repro_torch.core.taskgraph import Task

_seq = itertools.count()


def reset_seq() -> None:
    """Rewind the global envelope sequence to zero (driver run start).

    ``seq`` only feeds trace records, but a process-global counter made a
    recorded trace depend on how many envelopes *earlier* runs in the same
    process had created.  Resetting per run makes traces deterministic
    artifacts: same seed -> byte-identical event logs, across runs and
    processes (the dispatch benchmark's paired identity check relies on
    this)."""
    global _seq
    _seq = itertools.count()


@dataclasses.dataclass(frozen=True)
class Envelope:
    """One task-readiness message in flight.

    ``task`` is receiver-side: the task this message makes ready (not the
    sender task that produced it).  ``seq`` is a global monotone id used for
    FIFO tie-breaking and tracing.

    ``epoch`` is the recovery generation the envelope was sent in.  A
    mailbox whose stage has been respawned fences every envelope from an
    earlier epoch (see :meth:`~repro_torch.runtime.rrfp.mailbox.Mailbox.deliver`),
    so pre-failure stragglers — including chaos-delayed duplicates still in
    flight when their destination died — can never contaminate the restored
    incarnation's state.
    """

    task: Task
    src_stage: int
    dst_stage: int
    rank: int = 0
    send_time: float = 0.0
    payload: Any = None
    epoch: int = 0
    seq: int = dataclasses.field(default_factory=lambda: next(_seq))
    #: reliable-transport per-edge sequence number (-1 = the envelope is not
    #: travelling over a :class:`~repro_torch.runtime.rrfp.transport.ReliableChannel`)
    eseq: int = -1
    #: CRC32 over the envelope's identity tuple (see :func:`envelope_checksum`);
    #: a lossy wire may corrupt it in flight, and the reliable receiver
    #: verifies it before admission (mismatch -> NACK, never delivered)
    checksum: int = 0


def envelope_checksum(env: "Envelope") -> int:
    """Deterministic integrity checksum over the envelope identity.

    Covers everything that determines what the receiver *does* with the
    message (task, edge, rank, per-edge sequence, epoch).  The payload is
    excluded: in simulation it is the fact of arrival, and on the thread
    substrate hashing a device array per send would dominate the wire — the
    identity tuple is what a corrupted header would scramble."""
    t = env.task
    return zlib.crc32(repr((
        int(t.kind), t.stage, t.mb, t.chunk,
        env.src_stage, env.dst_stage, env.rank, env.eseq, env.epoch,
    )).encode())


class EdgePayloads(dict):
    """Per-destination-stage payloads for a fan-out completion.

    A ``work_fn`` that feeds multiple successors (a DAG fan-out: e.g. the
    fusion stage's backward producing one input gradient per incoming
    branch) returns ``EdgePayloads({dst_stage: payload, ...})`` and each
    outgoing envelope carries only its edge's entry.  Any other return type
    (including a plain dict — batches are dicts) is broadcast unchanged to
    every successor.
    """


def payload_for_edge(out_payload, dst_stage: int):
    """Resolve one successor's payload from a work_fn return value."""
    if isinstance(out_payload, EdgePayloads):
        return out_payload.get(dst_stage)
    return out_payload


def envelopes_for(
    task: Task,
    src_stage: int,
    tp_degree: int,
    send_time: float = 0.0,
    payload: Any = None,
    epoch: int = 0,
) -> list[Envelope]:
    """Fan one logical message out into per-TP-rank envelopes."""
    return [
        Envelope(
            task=task,
            src_stage=src_stage,
            dst_stage=task.stage,
            rank=r,
            send_time=send_time,
            payload=payload,
            epoch=epoch,
        )
        for r in range(max(1, tp_degree))
    ]
