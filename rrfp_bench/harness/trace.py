"""The traced run's profiler (``torch.profiler``, CPU and CUDA activity).

The profiler starts when the window opens; the window's first step is the
profiler's own warm-up, and the ``steps`` after it are recorded.  The
traced window is the host-clock span of those steps, from the hook that
ends the warm-up step to the hook that ends the last; each step ends in
the loss's device sync, so no kernel of a traced step runs outside it.
"""
from __future__ import annotations

import bisect
import time

import torch

from rrfp_bench.yardstick.categories import category


class Tracer:
    def __init__(self, steps: int):
        self.steps = steps
        self.seen = 0
        self.prof = None
        self.t_first = self.t_last = None
        self.kernels: list[tuple[str, float, float]] = []
        self.host: list[tuple[str, float, float]] = []
        self.marks: list[tuple[float, float]] = []
        self.read_s = 0.0

    def start(self) -> None:
        act = torch.profiler.ProfilerActivity
        self.prof = torch.profiler.profile(
            activities=[act.CPU, act.CUDA],
            schedule=torch.profiler.schedule(wait=0, warmup=1,
                                             active=self.steps, repeat=1),
            on_trace_ready=self._ready)
        self.prof.start()

    def step(self, now: float) -> bool:
        """After each window step; True once the traced steps are read."""
        self.seen += 1
        if self.seen == 1:
            self.t_first = now
        self.prof.step()
        if self.seen == self.steps + 1:
            self.t_last = now
            return True
        return False

    def _ready(self, prof) -> None:
        t0 = time.perf_counter()
        cuda = torch.autograd.DeviceType.CUDA
        for e in prof.events():
            span = (e.time_range.start, e.time_range.end)
            if e.name.startswith("ProfilerStep"):
                if e.device_type != cuda:
                    self.marks.append(span)
            elif e.device_type == cuda:
                self.kernels.append((e.name, *span))
            else:
                self.host.append((e.name, *span))
        self.read_s = time.perf_counter() - t0

    def stop(self) -> None:
        if self.prof is not None:
            self.prof.stop()
            self.prof = None

    def result(self) -> dict | None:
        if self.t_last is None:
            return None
        return {"kernels": self.kernels, "host": self.host,
                "marks": self.marks, "steps": self.steps,
                "window_s": self.t_last - self.t_first,
                "read_s": self.read_s}


def merged(spans) -> list[list[float]]:
    """The union of (start, end) intervals as sorted disjoint segments."""
    out: list[list[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_seconds(kernels) -> float:
    return sum(b - a for a, b in merged((a, b) for _, a, b in kernels)) / 1e6


def device_seconds_by(kernels, key) -> dict[str, float]:
    out: dict[str, float] = {}
    for name, a, b in kernels:
        k = key(name)
        out[k] = out.get(k, 0.0) + (b - a) / 1e6
    return out


def _host_op_at(host_sorted, starts, t: float) -> str:
    """The innermost host op running at ``t`` (the latest-started one that
    has not ended), or a note that none was."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 20000, -1), -1):
        name, a, b = host_sorted[j]
        if b >= t:
            return name
    return "(no host op recorded)"


def breakdown(trace: dict, top: int = 10) -> dict:
    """The heaviest device operations, and the longest idle gaps of the
    traced steps summed by the host op under each gap's middle."""
    kernels = trace["kernels"]
    by_name = device_seconds_by(kernels, lambda n: n[:120])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    segs = merged((a, b) for _, a, b in kernels)
    lo = min([a for a, _ in trace["marks"]] + [s[0] for s in segs[:1]])
    hi = max([b for _, b in trace["marks"]] + [s[1] for s in segs[-1:]])
    edges = [lo] + [x for s in segs for x in s] + [hi]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges) - 1, 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:200]
    host_sorted = sorted(trace["host"], key=lambda h: h[1])
    starts = [h[1] for h in host_sorted]
    idle: dict[str, float] = {}
    for length, a, b in gaps:
        name = _host_op_at(host_sorted, starts, (a + b) / 2)[:120]
        idle[name] = idle.get(name, 0.0) + length / 1e6
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in sorted(
                idle.items(), key=lambda kv: -kv[1])[:top]]}


def categories(kernels) -> dict[str, float]:
    return device_seconds_by(kernels, category)
