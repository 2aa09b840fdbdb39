"""The port's telemetry (its verbatim copy of ``obs/``) against the reference's.

* A trace the port's launcher records on the CPU (real stage callables,
  ``--metrics-report``) is written by the port's ``Trace.save`` and read by
  the reference's ``Trace.load``; ``explain(...).format()``,
  ``to_perfetto`` and ``MetricsRegistry.report()`` (fed the trace's task
  completions) are identical in both packages, and so are the launcher's
  ``--export-perfetto`` file and its ``Trace.to_perfetto`` delegation.
* A sim-substrate run with a ``MetricsRegistry`` gives the same report in
  both packages.
* The reference's own obs cases (``tests/test_obs.py``,
  ``tests/test_obs_export.py``, ``tests/test_critpath.py``) run unchanged
  on the port's copy.  The reference's two bit-exact-recovery failures
  (``conformance/test_critpath_exact.py``, ROADMAP queue 3) are not among
  them and the port is not held to that property.
"""
import json

import pytest

from _port_copy import port_cases
from repro.core import CostModel as JCostModel
from repro.core import HintKind as JHintKind
from repro.core import PipelineSpec as JPipelineSpec
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.obs import explain as jexplain
from repro.obs import to_perfetto as jto_perfetto
from repro.runtime.rrfp import ActorConfig as JActorConfig
from repro.runtime.rrfp import ActorDriver as JActorDriver
from repro.runtime.rrfp import Trace as JTrace
from repro_torch.core import CostModel, HintKind, PipelineSpec
from repro_torch.launch import train
from repro_torch.obs import MetricsRegistry, explain, to_perfetto
from repro_torch.obs import validate_chrome_trace
from repro_torch.runtime.rrfp import ActorConfig, ActorDriver, Trace
from repro_torch.runtime.rrfp import trace as tr

ACTOR = ["--arch", "paper-gpt3-large", "--stages", "2", "--layers", "4",
         "--microbatches", "4", "--mb-rows", "1", "--seq", "16", "--steps",
         "1", "--device", "cpu"]

port_cases("test_obs.py", globals())
port_cases("test_obs_export.py", globals())
port_cases("test_critpath.py", globals())


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """A port launcher run's step-0 trace, saved by the port."""
    d = tmp_path_factory.mktemp("obs")
    path = d / "step0.trace.jsonl"
    perfetto = d / "step0.perfetto.json"
    run = train.main(ACTOR + ["--hint", "bf", "--metrics-report",
                              "--record-trace", str(path),
                              "--export-perfetto", str(perfetto)])
    return run, path, perfetto


def _fed_report(registry_cls, trace) -> str:
    """A registry fed the trace's dispatches and completions."""
    reg = registry_cls()
    for ev in trace.events:
        if ev.kind == tr.DISPATCH:
            reg.shard(ev.stage).on_dispatch(
                ev.task, len(ev.info.get("ready", ())), ev.info["path"],
                None)
        elif ev.kind == tr.COMPLETE:
            reg.shard(ev.stage).on_complete(ev.task, ev.info["dur"])
    return reg.report()


def test_port_trace_loads_in_the_reference_and_explains_identically(
        recorded):
    run, path, _ = recorded
    port = Trace.load(str(path))
    ref = JTrace.load(str(path))
    assert len(ref.events) == len(port.events) == len(run.trace.events)
    assert ref.signature(include_time=True) == \
        port.signature(include_time=True)
    assert explain(port).format() == jexplain(ref).format()
    assert json.dumps(to_perfetto(port)) == json.dumps(jto_perfetto(ref))
    assert json.dumps(to_perfetto(port, critical_path=True)) == \
        json.dumps(jto_perfetto(ref, critical_path=True))
    want = _fed_report(JMetricsRegistry, ref)
    assert _fed_report(MetricsRegistry, port) == want
    assert "stage" in want and "total dispatches" in want


def test_trace_to_perfetto_delegates_to_the_obs_exporter(recorded):
    """``Trace.to_perfetto`` is the exporter's document, and the launcher's
    ``--export-perfetto`` file is that document, valid Chrome trace JSON."""
    run, _, perfetto = recorded
    doc = run.trace.to_perfetto()
    validate_chrome_trace(doc)
    assert json.dumps(doc) == json.dumps(to_perfetto(run.trace))
    assert json.loads(perfetto.read_text()) == json.loads(json.dumps(doc))
    assert any(e.get("cat") == "task" for e in doc["traceEvents"])
    assert Trace(meta={}, events=[]).to_perfetto()["traceEvents"] == \
        JTrace(meta={}, events=[]).to_perfetto()["traceEvents"]


@pytest.mark.parametrize("hint", ["bf", "bfw"])
def test_sim_run_metrics_report_identical(hint):
    split = hint == "bfw"
    out = []
    for pkg in ((PipelineSpec, CostModel, HintKind, ActorConfig, ActorDriver,
                 MetricsRegistry),
                (JPipelineSpec, JCostModel, JHintKind, JActorConfig,
                 JActorDriver, JMetricsRegistry)):
        spec_cls, cost_cls, hint_cls, cfg_cls, driver_cls, reg_cls = pkg
        spec = spec_cls(4, 8, split_backward=split)
        costs = cost_cls.uniform(4)
        if split:
            costs = costs.with_split_backward()
        reg = reg_cls(4)
        driver = driver_cls(spec, costs, cfg_cls(
            mode="hint", hint=hint_cls(hint), seed=3, metrics=reg,
            record_trace=True))
        res = driver.run()
        out.append((reg.report(), json.dumps(reg.to_json()), res.makespan,
                    json.dumps(to_perfetto(driver.trace))
                    if pkg[0] is PipelineSpec
                    else json.dumps(jto_perfetto(driver.trace))))
    assert out[0] == out[1]


def test_launcher_obs_flags_print_the_reports(capsys):
    """``--metrics-report --explain`` print the per-stage table and the
    health report, as the reference's launcher does."""
    train.main(ACTOR + ["--steps", "2", "--metrics-report", "--explain"])
    out = capsys.readouterr().out
    assert "per-stage metrics (accumulated over all steps):" in out
    assert "makespan explained" in out and "binding bottleneck" in out
