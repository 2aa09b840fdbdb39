"""The readers of the program's step records (``repro_torch.obs.spans``)
against values worked out by hand on a fabricated log; none on an empty
log, and none where the program has no step records."""
import sys

import pytest

from rrfp_bench.harness import manifest
from repro_torch.obs import spans

READERS = ("step_overhead_ms", "adamw_host_ms", "stage_wait_pct",
           "task_host_ms")
MS = 1_000_000


def _record(step, phases, stages, makespan, tasks):
    """``phases``: name -> (start, end) ms; ``tasks``: (start, end) ms."""
    return {
        "step": step,
        "spans": [{"name": n, "start_ns": a * MS, "end_ns": b * MS,
                   "parent": -1 if n == "rrfp.step" else 0, "step": step}
                  for n, (a, b) in phases.items()],
        "tasks": [{"kind": "F", "stage": 0, "mb": i, "start_ns": a * MS,
                   "end_ns": b * MS} for i, (a, b) in enumerate(tasks)],
        "blocking": list(stages), "makespan": makespan}


@pytest.fixture
def log():
    spans.clear()
    # an older step, outside the two traced ones
    spans.log(_record(0, {"rrfp.step": (0, 9000)}, [5.0, 5.0], 5.0,
                      [(0, 5000)]))
    spans.log(_record(1, {"rrfp.step": (0, 1000), "rrfp.batch": (0, 100),
                          "rrfp.pipeline": (100, 700),
                          "rrfp.adamw": (700, 760),
                          "rrfp.loss_sync": (760, 800)},
                      [0.1, 0.2], 0.5, [(100, 110), (110, 140)]))
    spans.log(_record(2, {"rrfp.step": (3000, 5000),
                          "rrfp.pipeline": (3000, 4000),
                          "rrfp.adamw": (4000, 4100),
                          "rrfp.loss_sync": (4100, 4200)},
                      [0.0, 0.4], 1.0, [(3000, 3020)]))
    yield
    spans.clear()


@pytest.mark.parametrize("name,want", [
    # (1000 - 600 - 60 - 40 + 2000 - 1000 - 100 - 100) / 2
    ("step_overhead_ms", 550.0),
    ("adamw_host_ms", 80.0),
    # (0.3 / (2 x 0.5) + 0.4 / (2 x 1.0)) / 2 x 100
    ("stage_wait_pct", 25.0),
    # (10 + 30 + 20) / 3
    ("task_host_ms", 20.0),
])
def test_a_reader_averages_the_traced_steps(log, name, want):
    assert manifest.reader(name)({"steps": 2}) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_a_reader_finds_nothing_in_an_empty_log(name):
    spans.clear()
    assert manifest.reader(name)({"steps": 2}) is None


@pytest.mark.parametrize("name", READERS)
def test_a_reader_of_a_program_without_step_records(name, monkeypatch):
    # a program whose package has no obs/spans.py: the import fails
    monkeypatch.setitem(sys.modules, "repro_torch.obs.spans", None)
    monkeypatch.delattr("repro_torch.obs.spans", raising=False)
    assert manifest.reader(name)({"steps": 2}) is None
