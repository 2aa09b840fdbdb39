"""Host spans of a training step, and the step records they end in.

``span(name)`` times a block on ``time.perf_counter_ns()`` and keeps its
name, start, end and parent (the thread's innermost open span) in the
thread's own buffer: no lock, no string formatting.  A ``step(step_id)``
opens the buffer and the step's outer span; when it closes, the spans its
thread opened inside it, all of that step's id, become one step record,
and the record goes into a bounded log of the process (the newest
:data:`LOG_STEPS`; :func:`recent` reads it).  A span opened outside a step
is timed into no record.

While a ``torch.profiler`` is active (``torch.autograd.profiler.
_is_profiler_enabled``), every span also opens a profiler range of its
name, so it lies in the profiler's trace on the profiler's own clock;
:class:`profiled` opens that range alone (the stage threads' task ranges).
The range is an operator's (``torch._C._profiler._RecordFunctionFast``, a
``cpu_op``), not ``torch.profiler.record_function``'s user annotation: the
profiler draws a user annotation a second time on the device's timeline,
over the kernels launched inside it, where it would count as device work.
With no profiler active no range is opened.  Nothing else switches either
on.

A record is a plain host dict of floats, ints and short strings, never a
tensor::

    {"step": 3,
     "spans": [{"name": "rrfp.step", "start_ns": ..., "end_ns": ...,
                "parent": -1, "step": 3}, ...],
     # from add_run(result), the pipeline run's own stamps:
     "tasks": [{"kind": "F", "stage": 0, "mb": 0, "start_ns": ...,
                "end_ns": ...}, ...],
     "blocking": [s, ...], "makespan": s}

``parent`` is the index of the enclosing span in ``spans`` (-1: none).
Task stamps are the runtime's dispatch and completion times (``RunResult``
``start``/``end``) moved onto the same ``perf_counter`` clock by the run's
origin ``t0``; the tasks get no second timer.  ``blocking`` is each
stage's time with no ready task (``StageStats.blocking``).
"""
from __future__ import annotations

import collections
import threading
import time

import torch

#: step records the process keeps, the newest last
LOG_STEPS = 32
_log: collections.deque = collections.deque(maxlen=LOG_STEPS)
_local = threading.local()


class _Buffer:
    """One thread's open step: its id, its spans as ``[name, start_ns,
    end_ns, parent]`` and the indices of the spans still open."""

    __slots__ = ("step", "spans", "stack")

    def __init__(self):
        self.step = None
        self.spans: list[list] = []
        self.stack: list[int] = []


def _buffer() -> _Buffer:
    buf = getattr(_local, "buf", None)
    if buf is None:
        buf = _local.buf = _Buffer()
    return buf


class profiled:
    """A profiler range ``name`` while a profiler is active; nothing
    otherwise (the flag is read once on entry)."""

    __slots__ = ("name", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rf = None
        if torch.autograd.profiler._is_profiler_enabled:
            self._rf = torch._C._profiler._RecordFunctionFast(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


class span(profiled):
    """A timed block of the thread's open step (and a profiler range)."""

    __slots__ = ("_buf", "_i")

    def __enter__(self):
        super().__enter__()
        buf = self._buf = _buffer()
        self._i = -1
        if buf.step is not None:
            self._i = len(buf.spans)
            buf.spans.append([self.name, time.perf_counter_ns(), 0,
                              buf.stack[-1] if buf.stack else -1])
            buf.stack.append(self._i)
        return self

    def __exit__(self, *exc) -> bool:
        if self._i >= 0:
            self._buf.spans[self._i][2] = time.perf_counter_ns()
            self._buf.stack.pop()
        return super().__exit__(*exc)


class step:
    """One step's record: ``with step(i, "rrfp.step") as rec:`` opens the
    outer span; the record (``rec.record``) joins the log when the block
    ends without an exception."""

    def __init__(self, step_id: int, name: str):
        self.record: dict = {"step": step_id}
        self._span = span(name)

    def __enter__(self):
        buf = _buffer()
        if buf.step is not None:
            raise RuntimeError(f"step {self.record['step']}: step "
                               f"{buf.step} is still open on this thread")
        buf.step = self.record["step"]
        self._span.__enter__()
        return self

    def add_run(self, result) -> None:
        """The pipeline run's task stamps, each stage's ``blocking`` (s)
        and its makespan (s), from a thread-substrate ``RunResult``."""
        if result.t0 is None:
            raise ValueError("the run has no perf_counter origin (t0): "
                             "only a threaded run's stamps are host times")
        self.record.update(
            tasks=[{"kind": t.kind.name, "stage": t.stage, "mb": t.mb,
                    "start_ns": round((result.t0 + result.start[t]) * 1e9),
                    "end_ns": round((result.t0 + end) * 1e9)}
                   for t, end in result.end.items()],
            blocking=[float(s.blocking) for s in result.stage_stats],
            makespan=float(result.makespan))

    def __exit__(self, exc_type, *rest) -> bool:
        self._span.__exit__(exc_type, *rest)
        buf = _buffer()
        done, step_id = buf.spans, buf.step
        buf.step, buf.spans, buf.stack = None, [], []
        if exc_type is None:
            self.record["spans"] = [
                {"name": n, "start_ns": a, "end_ns": b, "parent": p,
                 "step": step_id} for n, a, b, p in done]
            log(self.record)
        return False


def log(record: dict) -> None:
    """Add a step record to the process's log."""
    _log.append(record)


def recent(n: int) -> list[dict]:
    """The newest ``n`` step records, oldest first."""
    return list(_log)[-n:] if n > 0 else []


def clear() -> None:
    _log.clear()


def seconds(record: dict, name: str) -> float:
    """Seconds in the spans named ``name`` of a record, summed."""
    return sum(s["end_ns"] - s["start_ns"] for s in record["spans"]
               if s["name"] == name) / 1e9

