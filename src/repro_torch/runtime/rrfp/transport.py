"""Pluggable message transports for the actor runtime (§4.1).

* :class:`SimTransport` — in-process queue transport with *injectable*
  heavy-tailed latency: each envelope's arrival is delayed by a sample from
  the :class:`~repro_torch.core.costs.CostModel` communication jitter (per TP
  rank), delivered on the driver's virtual clock.  Sampling is keyed by
  (seed, task, rank) rather than drawn from a shared stream, so two runs in
  different consumption modes see the *same* realized latencies — common
  random numbers for apples-to-apples hint-vs-precommitted comparisons.

* :class:`ThreadTransport` — wall-clock transport between thread-per-stage
  actors in one process: ``send`` delivers straight into the destination
  mailbox (the Python-object hand-off is the wire), waking the receiver's
  condition variable.

* :class:`ReliableChannel` — a substrate-neutral reliable-delivery state
  machine layered over a lossy wire: per-edge sequence numbers, checksummed
  envelopes (:func:`~repro_torch.runtime.rrfp.messages.envelope_checksum`),
  ACK/NACK, CRN-keyed retransmission with exponential backoff + jitter, and
  receiver-side dedup — delivery is exactly-once under arbitrary
  drop/duplicate/reorder, and a retry budget exhausting escalates the edge
  to a *link failure* the recovery coordinator handles like a stage fault.
  The channel owns only the protocol state; the substrate injects its wire
  primitives (how to transmit, how to time out, how to deliver), so the sim
  driver's virtual clock and :class:`ReliableThreadTransport`'s wall-clock
  timers run the identical protocol with identical CRN draws.
"""
from __future__ import annotations

import dataclasses
import threading
import zlib
from typing import Callable, Protocol

import numpy as np

from repro_torch.core.costs import CostModel

from repro_torch.runtime.rrfp import trace as tr
from repro_torch.runtime.rrfp.mailbox import Mailbox
from repro_torch.runtime.rrfp.messages import Envelope, envelope_checksum


class Transport(Protocol):
    def send(self, env: Envelope, now: float = 0.0) -> None:
        """Hand one envelope to the network; delivery is asynchronous."""
        ...


def rng_for(seed: int, env: Envelope) -> np.random.Generator:
    """Deterministic per-(task, rank) generator: the CRN keying."""
    t = env.task
    return np.random.default_rng(
        [seed & 0x7FFFFFFF, zlib.crc32(b"rrfp-comm"),
         int(t.kind), t.stage, t.mb, t.chunk, env.rank])


class SimTransport:
    """Virtual-time transport with sampled heavy-tailed latency.

    ``schedule(time, env)`` is the driver's event-loop hook; the transport
    never blocks and never touches wall time.
    """

    def __init__(
        self,
        costs: CostModel,
        schedule: Callable[[float, Envelope], None],
        seed: int = 0,
        on_send: Callable[[Envelope, float], None] | None = None,
    ):
        self.costs = costs
        self.schedule = schedule
        self.seed = seed
        self.on_send = on_send
        self.sent = 0

    def send(self, env: Envelope, now: float = 0.0) -> None:
        lat = self.costs.sample_comm(rng_for(self.seed, env))
        self.sent += 1
        if self.on_send is not None:
            self.on_send(env, lat)
        self.schedule(now + lat, env)


class ThreadTransport:
    """Direct mailbox-to-mailbox delivery between actor threads."""

    def __init__(self, mailboxes: dict[int, Mailbox],
                 on_send: Callable[[Envelope, float], None] | None = None):
        self.mailboxes = mailboxes
        self.on_send = on_send
        self.sent = 0

    def send(self, env: Envelope, now: float = 0.0) -> None:
        self.sent += 1
        if self.on_send is not None:
            self.on_send(env, now)
        self.mailboxes[env.dst_stage].deliver(env, now=now)


# ---------------------------------------------------------------------------
# Reliable delivery over a lossy wire
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReliableConfig:
    """Retry policy for the reliable-delivery layer.

    The RTO for attempt ``k`` is ``rto * backoff**k * (1 + jitter * U)``
    with ``U`` a CRN-keyed uniform draw per (envelope, attempt) — the same
    scenario retries at the same virtual/wall offsets in every run.  After
    ``max_retries`` unacknowledged attempts the edge is declared dead and
    escalated to the recovery coordinator as a link failure."""

    rto: float = 5e-3
    backoff: float = 2.0
    jitter: float = 0.1
    max_retries: int = 6
    #: sim substrate: virtual latency of an ACK/NACK hop
    ack_latency: float = 1e-4


@dataclasses.dataclass(frozen=True)
class Ack:
    """Receiver -> sender acknowledgement for one (edge, eseq).

    ``src``/``dst`` are the *data* edge's endpoints (the ACK travels
    dst -> src).  ``nack`` means the transmission arrived mangled
    (checksum mismatch) and the sender should retransmit immediately.
    """

    src: int
    dst: int
    eseq: int
    rank: int = 0
    attempt: int = 0
    nack: bool = False


class _Inflight:
    """One unacknowledged envelope awaiting ACK (mutable attempt counter)."""

    __slots__ = ("env", "attempt")

    def __init__(self, env: Envelope):
        self.env = env
        self.attempt = -1  # no attempt transmitted yet


class ReliableChannel:
    """Substrate-neutral exactly-once delivery state machine.

    The channel owns the protocol — per-edge sequence assignment, checksum
    stamping/verification, ACK/NACK bookkeeping, retransmission scheduling,
    receiver-side dedup, link-failure escalation — and delegates the wire to
    injected primitives:

    * ``transmit(env, attempt, now)`` — put one attempt on the (lossy) wire;
      the substrate applies chaos (drop/corrupt/partition/delay) and feeds
      surviving transmissions back into :meth:`on_wire`;
    * ``send_ack(ack, env, now)`` — return an ACK/NACK across the wire
      (``env`` rides along purely for CRN keying of ack-drop draws); the
      substrate feeds surviving acks into :meth:`on_ack`;
    * ``set_timer(delay, fn)`` — arrange ``fn(fire_time)`` after ``delay``
      substrate seconds (virtual heap event or wall-clock timer);
    * ``deliver(env, now)`` — hand a verified, first-seen envelope to the
      destination mailbox;
    * ``on_link_fail(src, dst, env, now)`` — retry budget exhausted.

    Retransmissions are byte-identical to the original envelope (same eseq,
    same epoch, same checksum): receiver-side dedup is what makes redundant
    arrivals harmless, so the sender never needs to know which attempt won.
    Timers are lazily cancelled — a stale RTO firing for an attempt that
    was already superseded (or acked) is a no-op.
    """

    def __init__(
        self,
        rcfg: ReliableConfig,
        *,
        transmit: Callable[[Envelope, int, float], None],
        send_ack: Callable[[Ack, Envelope, float], None],
        set_timer: Callable[[float, Callable[[float], None]], None],
        deliver: Callable[[Envelope, float], None],
        on_link_fail: Callable[[int, int, Envelope, float], None] | None = None,
        recorder=None,
        on_send: Callable[[Envelope, float], None] | None = None,
        seed: int = 0,
    ):
        self.rcfg = rcfg
        self._transmit = transmit
        self._send_ack = send_ack
        self._set_timer = set_timer
        self._deliver = deliver
        self._on_link_fail = on_link_fail
        self.recorder = recorder
        self.on_send = on_send
        self.seed = seed
        self._lock = threading.RLock()
        #: next eseq per (src, dst) edge
        self._next: dict[tuple[int, int], int] = {}
        #: (src, dst, eseq) -> unacknowledged envelope
        self._inflight: dict[tuple[int, int, int], _Inflight] = {}
        #: (src, dst) -> eseqs already delivered (survives stage respawn:
        #: the channel is run-scoped, so a pre-recovery duplicate arriving
        #: after the respawn still dedups here before the epoch fence)
        self._seen: dict[tuple[int, int], set[int]] = {}
        self.sent = 0
        self.retransmits = 0
        self.dedup_drops = 0
        self.corrupt_detected = 0
        self.link_failures = 0

    # ---- sender side -------------------------------------------------------
    def send(self, env: Envelope, now: float = 0.0) -> None:
        with self._lock:
            edge = (env.src_stage, env.dst_stage)
            eseq = self._next.get(edge, 0)
            self._next[edge] = eseq + 1
            env = dataclasses.replace(env, eseq=eseq)
            env = dataclasses.replace(env, checksum=envelope_checksum(env))
            self._inflight[edge + (eseq,)] = _Inflight(env)
            self.sent += 1
        if self.on_send is not None:
            self.on_send(env, now)
        self._attempt(edge + (eseq,), 0, now)

    def _rto_delay(self, env: Envelope, attempt: int) -> float:
        t = env.task
        rng = np.random.default_rng(
            [self.seed & 0x7FFFFFFF, zlib.crc32(b"rrfp-rto"),
             int(t.kind), t.stage, t.mb, t.chunk, env.rank, attempt,
             env.src_stage & 0x7FFFFFFF])
        base = self.rcfg.rto * self.rcfg.backoff ** attempt
        return base * (1.0 + self.rcfg.jitter * float(rng.random()))

    def _attempt(self, key: tuple[int, int, int], attempt: int,
                 now: float) -> None:
        escalate: Envelope | None = None
        with self._lock:
            entry = self._inflight.get(key)
            if entry is None or attempt <= entry.attempt:
                return  # acked, escalated, or a stale timer firing
            env = entry.env
            if attempt > self.rcfg.max_retries:
                # the edge is unhealable within budget: clear every inflight
                # message on it (recovery will replay them from the send log
                # — one escalation, not a stampede) and hand the fault up
                src, dst, eseq = key
                for k in [k for k in self._inflight if k[:2] == (src, dst)]:
                    del self._inflight[k]
                self.link_failures += 1
                if self.recorder is not None:
                    self.recorder.record(
                        tr.LINK_FAIL, src, env.task, rank=env.rank, t=now,
                        dst=dst, eseq=eseq, attempts=attempt)
                escalate = env
            else:
                entry.attempt = attempt
                if attempt > 0:
                    self.retransmits += 1
                    if self.recorder is not None:
                        self.recorder.record(
                            tr.RETRANSMIT, env.src_stage, env.task,
                            rank=env.rank, t=now, dst=env.dst_stage,
                            eseq=env.eseq, attempt=attempt)
        if escalate is not None:
            if self._on_link_fail is not None:
                self._on_link_fail(key[0], key[1], escalate, now)
            return
        self._transmit(env, attempt, now)
        self._set_timer(
            self._rto_delay(env, attempt),
            lambda fire_now, k=key, a=attempt: self._attempt(
                k, a + 1, fire_now))

    def on_ack(self, ack: Ack, now: float = 0.0) -> None:
        key = (ack.src, ack.dst, ack.eseq)
        with self._lock:
            entry = self._inflight.get(key)
            if entry is None:
                return  # duplicate ack for an already-settled eseq
            if not ack.nack:
                del self._inflight[key]
                return
            nxt = entry.attempt + 1
        self._attempt(key, nxt, now)

    # ---- receiver side -----------------------------------------------------
    def on_wire(self, env: Envelope, attempt: int, now: float = 0.0) -> None:
        """One transmission survived the wire; verify, dedup, ack, deliver."""
        edge = (env.src_stage, env.dst_stage)
        ack: Ack | None = None
        admit = False
        with self._lock:
            if envelope_checksum(env) != env.checksum:
                self.corrupt_detected += 1
                if self.recorder is not None:
                    self.recorder.record(
                        tr.CORRUPT, env.dst_stage, env.task, rank=env.rank,
                        t=now, src=env.src_stage, eseq=env.eseq,
                        attempt=attempt)
                ack = Ack(*edge, env.eseq, env.rank, attempt, nack=True)
            else:
                seen = self._seen.setdefault(edge, set())
                if env.eseq in seen:
                    self.dedup_drops += 1
                    if self.recorder is not None:
                        self.recorder.record(
                            tr.RDUP, env.dst_stage, env.task, rank=env.rank,
                            t=now, src=env.src_stage, eseq=env.eseq,
                            attempt=attempt)
                else:
                    seen.add(env.eseq)
                    admit = True
                ack = Ack(*edge, env.eseq, env.rank, attempt)
        # wire I/O outside the protocol lock: deliver may take the mailbox
        # condition and ack may re-enter on_ack synchronously
        self._send_ack(ack, env, now)
        if admit:
            self._deliver(env, now)

    # ---- introspection -----------------------------------------------------
    def inflight(self) -> int:
        with self._lock:
            return len(self._inflight)

    def stats(self) -> dict:
        with self._lock:
            return {
                "sent": self.sent,
                "retransmits": self.retransmits,
                "dedup_drops": self.dedup_drops,
                "corrupt_detected": self.corrupt_detected,
                "link_failures": self.link_failures,
            }


class ReliableThreadTransport:
    """Wall-clock wire under a :class:`ReliableChannel` (thread substrate).

    Applies the chaos lossy-network model per transmission attempt — drop,
    corrupt (checksum flip), partition, plus the usual delay/duplication —
    and runs RTO timers on daemon :class:`threading.Timer` threads.  The
    ``mailboxes`` dict is the driver's *live* map: a respawned stage swaps
    its fresh mailbox in, and in-flight retransmissions land there (to be
    epoch-fenced if stale).
    """

    def __init__(
        self,
        mailboxes: dict[int, Mailbox],
        rcfg: ReliableConfig,
        chaos=None,
        seed: int = 0,
        clock: Callable[[], float] | None = None,
        recorder=None,
        on_send: Callable[[Envelope, float], None] | None = None,
        on_link_fail: Callable[[int, int, Envelope, float], None] | None = None,
    ):
        self.mailboxes = mailboxes
        self.chaos = chaos
        self.clock = clock or (lambda: 0.0)
        self.recorder = recorder
        self._timers: list[threading.Timer] = []
        self._tlock = threading.Lock()
        self.channel = ReliableChannel(
            rcfg,
            transmit=self._wire_transmit,
            send_ack=self._wire_ack,
            set_timer=self._set_timer,
            deliver=self._wire_deliver,
            on_link_fail=on_link_fail,
            recorder=recorder,
            on_send=on_send,
            seed=seed,
        )

    @property
    def sent(self) -> int:
        return self.channel.sent

    def stats(self) -> dict:
        return self.channel.stats()

    def send(self, env: Envelope, now: float = 0.0) -> None:
        self.channel.send(env, now=self.clock())

    # ---- wire primitives ---------------------------------------------------
    def _wire_transmit(self, env: Envelope, attempt: int,
                       now: float) -> None:
        copies = self.chaos.copies(env) if self.chaos is not None else 1
        for copy in range(copies):
            t_wire = self.clock()
            if self.chaos is not None and self.chaos.dropped(
                    env, t_wire, attempt, copy):
                if self.recorder is not None:
                    self.recorder.record(
                        tr.DROP, env.src_stage, env.task, rank=env.rank,
                        t=t_wire, dst=env.dst_stage, eseq=env.eseq,
                        attempt=attempt, copy=copy)
                continue
            arriving = env
            if self.chaos is not None and self.chaos.corrupted(env, attempt):
                arriving = dataclasses.replace(
                    env, checksum=env.checksum ^ (attempt + 1))
            delay = (self.chaos.comm_delay(env, copy)
                     if self.chaos is not None else 0.0)
            if delay <= 0:
                self.channel.on_wire(arriving, attempt, self.clock())
            else:
                self._set_timer(
                    delay,
                    lambda fire_now, e=arriving, a=attempt:
                        self.channel.on_wire(e, a, fire_now))

    def _wire_ack(self, ack: Ack, env: Envelope, now: float) -> None:
        if self.chaos is not None and self.chaos.ack_dropped(
                env, self.clock(), ack.attempt):
            return  # lost ack: the sender's RTO retransmits, receiver dedups
        self.channel.on_ack(ack, self.clock())

    def _wire_deliver(self, env: Envelope, now: float) -> None:
        self.mailboxes[env.dst_stage].deliver(env, now=self.clock())

    def _set_timer(self, delay: float,
                   fn: Callable[[float], None]) -> None:
        timer = threading.Timer(
            max(delay, 1e-6), lambda: fn(self.clock()))
        timer.daemon = True
        with self._tlock:
            self._timers = [t for t in self._timers if t.is_alive()]
            self._timers.append(timer)
        timer.start()

    # ---- lifecycle ---------------------------------------------------------
    def drain(self, timeout: float = 30.0) -> bool:
        """Block until nothing is unacknowledged (or timeout)."""
        import time as _time

        deadline = _time.monotonic() + timeout
        while self.channel.inflight() > 0:
            if _time.monotonic() >= deadline:
                return False
            _time.sleep(1e-3)
        return True

    def close(self) -> None:
        with self._tlock:
            for t in self._timers:
                t.cancel()
            self._timers.clear()
