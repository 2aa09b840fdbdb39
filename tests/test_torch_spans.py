"""The port's step spans (``obs/spans.py``): nesting and parents, the
bounded log, no profiler range without a profiler, one record a
step from ``train_actor``, the ranges in a CPU ``torch.profiler`` trace,
and ``launch/profile.py``'s idle breakdown on fabricated events."""
import threading
import time
import types

import pytest
import torch

from repro_torch.launch import profile, train
from repro_torch.obs import spans

ARGS = ["--device", "cpu", "--arch", "paper-gpt3-large", "--stages", "2",
        "--layers", "4", "--microbatches", "4", "--mb-rows", "1", "--seq",
        "16"]
PHASES = ("rrfp.batch", "rrfp.programs", "rrfp.pipeline", "rrfp.grads",
          "rrfp.adamw", "rrfp.loss_sync", "rrfp.after")


@pytest.fixture(autouse=True)
def _empty_log():
    spans.clear()
    yield
    spans.clear()


def _dur(s) -> int:
    return s["end_ns"] - s["start_ns"]


def _plain(value) -> bool:
    """Only host scalars, short strings, lists and dicts: no tensor."""
    if isinstance(value, dict):
        return all(isinstance(k, str) and _plain(v) for k, v in value.items())
    if isinstance(value, list):
        return all(_plain(v) for v in value)
    return isinstance(value, (int, float, str))


def test_spans_nest_with_their_parents():
    with spans.step(7, "outer") as rec:
        with spans.span("a"):
            with spans.span("b"):
                time.sleep(0.01)
            with spans.span("c"):
                pass
        with spans.span("d"):
            pass
    r = rec.record
    assert [s["name"] for s in r["spans"]] == ["outer", "a", "b", "c", "d"]
    assert [s["parent"] for s in r["spans"]] == [-1, 0, 1, 1, 0]
    assert {s["step"] for s in r["spans"]} == {7}
    for s in r["spans"][1:]:
        p = r["spans"][s["parent"]]
        assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
    b = r["spans"][2]
    assert spans.seconds(r, "b") == _dur(b) / 1e9 >= 0.01
    assert spans.recent(1) == [r] and _plain(r)


def test_a_step_keeps_its_own_threads_spans_alone():
    def other():
        with spans.span("elsewhere"):
            pass

    with spans.span("before"):
        pass
    with spans.step(0, "outer") as rec:
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        with pytest.raises(RuntimeError, match="still open"):
            with spans.step(1, "inner"):
                pass
    assert [s["name"] for s in rec.record["spans"]] == ["outer"]
    with spans.span("after"):
        pass
    assert spans.recent(5) == [rec.record]


def test_a_failed_step_leaves_no_record():
    with pytest.raises(ValueError):
        with spans.step(0, "outer"):
            with spans.span("a"):
                raise ValueError("boom")
    assert spans.recent(5) == []
    with spans.step(1, "outer") as rec:
        pass
    assert [s["parent"] for s in rec.record["spans"]] == [-1]


def test_no_profiler_range_without_a_profiler(monkeypatch):
    entered = []
    real = torch._C._profiler._RecordFunctionFast

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counting)
    assert not torch.autograd.profiler._is_profiler_enabled
    with spans.step(0, "outer"):
        with spans.span("a"), spans.profiled("task"):
            pass
    assert entered == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with spans.step(1, "outer"):
            with spans.span("a"), spans.profiled("task"):
                pass
    assert entered == ["outer", "a", "task"]
    got = {e.name: e for e in prof.events()}
    assert {"outer", "a", "task"} <= set(got)
    # operators' ranges, not user annotations: the profiler draws no
    # device-side copy of them over the kernels launched inside
    assert not any(got[n].is_user_annotation for n in ("outer", "a", "task"))


def test_recent_returns_the_newest_records_and_the_log_is_bounded():
    for i in range(spans.LOG_STEPS + 8):
        spans.log({"step": i})
    assert [r["step"] for r in spans.recent(3)] == [
        spans.LOG_STEPS + 5, spans.LOG_STEPS + 6, spans.LOG_STEPS + 7]
    assert len(spans.recent(1000)) == spans.LOG_STEPS == 32
    assert spans.recent(1000)[0]["step"] == 8
    assert spans.recent(0) == []


@pytest.mark.parametrize("hint,per_mb", [("bf", 2), ("bfw", 3)])
def test_train_actor_gives_one_record_a_step(hint, per_mb):
    argv = ARGS + ["--steps", "2", "--hint", hint]
    if hint == "bfw":
        argv.append("--split-backward")
    train.train_actor(train.parser().parse_args(argv))
    records = spans.recent(10)
    assert len(records) == 2
    for i, r in enumerate(records):
        assert r["step"] == i and _plain(r)
        by_name = {s["name"]: s for s in r["spans"]}
        assert r["spans"][0]["name"] == "rrfp.step"
        assert set(by_name) == {"rrfp.step", *PHASES}
        outer = r["spans"][0]
        for name in PHASES:
            s = by_name[name]
            assert s["parent"] == 0
            assert outer["start_ns"] <= s["start_ns"] <= s["end_ns"] <= (
                outer["end_ns"])
        starts = [by_name[n]["start_ns"] for n in PHASES]
        assert starts == sorted(starts)
        pipe = by_name["rrfp.pipeline"]
        assert len(r["tasks"]) == 2 * 4 * per_mb
        for t in r["tasks"]:
            assert pipe["start_ns"] <= t["start_ns"] < t["end_ns"] <= (
                pipe["end_ns"])
        kinds = [t["kind"] for t in r["tasks"]]
        assert sorted(set(kinds)) == sorted("BFW"[:per_mb])
        assert all(kinds.count(k) == 8 for k in set(kinds))
        assert len(r["blocking"]) == 2
        for b in r["blocking"]:
            assert 0.0 <= b <= r["makespan"] + 1e-6
        # the runtime's makespan is the last completion after its origin
        last = max(t["end_ns"] for t in r["tasks"])
        assert last - pipe["start_ns"] >= r["makespan"] * 1e9 - 1e6


def _events_of_a_traced_step(experimental_config=None):
    args = train.parser().parse_args(ARGS + ["--steps", "2"])
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                             repeat=1),
            experimental_config=experimental_config) as prof:
        train.train_actor(args, step_hook=lambda *_: prof.step())
    return prof.events()


def test_a_cpu_profiler_records_the_main_thread_phases():
    events = _events_of_a_traced_step()
    names = [e.name for e in events if e.name.startswith("rrfp.")
             and not e.name.startswith("rrfp.task.")]
    assert sorted(names) == sorted(["rrfp.step", *PHASES])


def test_an_all_threads_profiler_records_the_stage_tasks():
    events = _events_of_a_traced_step(profile.all_threads_config())
    steps = [e for e in events if e.name == "rrfp.step"]
    tasks = [e for e in events if e.name.startswith("rrfp.task.")]
    assert len(steps) == 1
    assert {e.name for e in tasks} == {"rrfp.task.F", "rrfp.task.B"}
    assert len(tasks) == 2 * 4 * 2
    assert {e.thread for e in tasks}.isdisjoint({steps[0].thread})
    out = profile.breakdown(events, 0.0)
    assert out["kernels"] == 0 and out["device_busy_s"] == 0.0
    assert "rrfp.pipeline" in out["idle_by_span_s"]
    assert out["device_idle_share"] == 1.0
    assert sum(out["idle_by_span_s"].values()) == pytest.approx(
        out["step_span_s"])


def _event(name, a, b, *, cuda=False, self_us=0.0, thread=1,
           annotation=False):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=a, end=b),
        device_type=(torch.autograd.DeviceType.CUDA if cuda else
                     torch.autograd.DeviceType.CPU),
        self_cpu_time_total=self_us, thread=thread,
        is_user_annotation=annotation)


FABRICATED = [
    _event("ProfilerStep#2", 0.0, 100.0),
    _event("rrfp.step", 1.0, 99.0),
    _event("rrfp.batch", 2.0, 12.0),
    _event("rrfp.pipeline", 40.0, 80.0),
    _event("rrfp.task.F", 50.0, 65.0, thread=2),
    _event("aten::add", 41.0, 42.0, self_us=1.0, thread=2),
    _event("gemm_kernel", 10.0, 20.0, cuda=True),
    _event("gemm_kernel", 15.0, 30.0, cuda=True),
    _event("elementwise_kernel", 60.0, 70.0, cuda=True),
    # a record_function range's device-side copy: no device work
    _event("user.range", 10.0, 95.0, cuda=True, annotation=True),
]


def test_profile_breakdown_of_fabricated_events():
    out = profile.breakdown(FABRICATED, 0.25)
    # busy: [10, 30] and [60, 70] of the step's host span [0, 100] (us)
    assert out["step_span_s"] == pytest.approx(100e-6)
    assert out["device_busy_s"] == pytest.approx(30e-6)
    assert out["device_idle_share"] == pytest.approx(0.7)
    assert out["kernels"] == 3 and out["step_wall_s"] == 0.25
    # gaps [0, 10], [30, 60], [70, 100] by the innermost span on any
    # thread: [0, 1] none, [1, 2] step, [2, 10] batch; [30, 40] step,
    # [40, 50] pipeline, [50, 60] the stage thread's task; [70, 80]
    # pipeline, [80, 99] step, [99, 100] none
    want = {profile.NO_SPAN: 2, "rrfp.step": 30, "rrfp.batch": 8,
            "rrfp.pipeline": 20, "rrfp.task.F": 10}
    got = out["idle_by_span_s"]
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v * 1e-6)
    assert list(got)[0] == "rrfp.step"
    assert out["by_category_s"] == pytest.approx(
        {profile.category("gemm_kernel"): 25e-6,
         profile.category("elementwise_kernel"): 10e-6})
    assert out["top_host_ops_self_s"] == {"aten::add": 1e-6}
    assert "kernel_window_s" not in out


def test_idle_by_span_without_program_spans():
    gaps = [(0.0, 5.0), (7.0, 9.0)]
    assert profile.idle_by_span(gaps, []) == {profile.NO_SPAN: 7.0}
    assert profile.idle_by_span(gaps, [("rrfp.step", 4.0, 8.0)]) == {
        profile.NO_SPAN: 5.0, "rrfp.step": 2.0}
