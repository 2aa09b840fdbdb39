"""The runtime's conformance checker (the port's copy of
``runtime/rrfp/conformance.py``) on traces of the port's own runs, and the
copy of ``core/bounds.py`` against the reference's.

``check_all`` passes on the step-0 traces that ``--record-trace`` writes
for ``train_actor`` (fused, ``--split-backward``, ``--chaos C2``, a
``--replay-trace`` run) and for ``train_multimodal`` (fused and split, the
DAG with its fan-in), all on the CPU at a reduced size.  The checker is
live on that trace format: it rejects the same trace with one dispatch
duplicated, and with one task's dispatch moved before a predecessor's
completion.  Theorem 6.1, Corollary 6.2 and the bottleneck statistics of
the copied ``core/bounds.py`` equal the reference's on seeded arrays.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import bounds as jbounds
from repro_torch.core import PipelineSpec, bounds
from repro_torch.launch import train
from repro_torch.multimodal import multimodal_config
from repro_torch.runtime.rrfp import ActorConfig, Trace, conformance
from repro_torch.runtime.rrfp import trace as tr

ACTOR = ["--arch", "paper-gpt3-large", "--stages", "2", "--layers", "4",
         "--microbatches", "4", "--mb-rows", "1", "--seq", "16", "--steps",
         "1", "--device", "cpu"]
MULTIMODAL = ["--workload", "multimodal", "--stages", "4", "--layers", "2",
              "--microbatches", "4", "--mb-rows", "1", "--seq", "16",
              "--steps", "1", "--device", "cpu"]
BFW = ["--hint", "bfw", "--split-backward"]


def _record(tmp_path, argv, name="step0.trace.jsonl"):
    """Run the launcher with ``--record-trace``; return (trace, spec,
    config) of the recorded step."""
    path = str(tmp_path / name)
    train.main(argv + ["--record-trace", path])
    args = train.parser().parse_args(argv)
    split = args.split_backward
    if args.workload == "multimodal":
        enc, lm = train._multimodal_stage_split(args.stages)
        spec = multimodal_config(args.arch or "qwen2-vl-2b", enc_stages=enc,
                                 lm_stages=lm).spec(args.microbatches, split)
    else:
        spec = PipelineSpec(args.stages, args.microbatches,
                            split_backward=split)
    mode = "hint" if args.schedule == "rrfp" else "precommitted"
    config = ActorConfig(mode=mode, w_defer_cap=args.w_defer_cap)
    return Trace.load(path), spec, config


@pytest.mark.parametrize("flags", [[], BFW, ["--chaos", "C2"],
                                   ["--chaos", "C2"] + BFW,
                                   ["--schedule", "1f1b"]],
                         ids=["fused", "split", "chaos", "chaos-split",
                              "precommitted"])
def test_check_all_passes_on_train_actor_traces(tmp_path, flags):
    trace, spec, config = _record(tmp_path, ACTOR + flags)
    assert trace.select(tr.DISPATCH)
    conformance.check_all(trace, spec, config)


def test_check_all_passes_on_a_replayed_run(tmp_path):
    rec = str(tmp_path / "rec.trace.jsonl")
    train.main(ACTOR + ["--chaos", "C2", "--record-trace", rec])
    trace, spec, config = _record(tmp_path, ACTOR + ["--replay-trace", rec],
                                  "replayed.trace.jsonl")
    conformance.check_all(trace, spec, config)
    assert trace.dispatch_orders(2) == Trace.load(rec).dispatch_orders(2)


@pytest.mark.parametrize("flags", [[], BFW, ["--chaos", "C2"],
                                   ["--arch", "seamless-m4t-large-v2"]],
                         ids=["fused", "split", "chaos", "seamless"])
def test_check_all_passes_on_train_multimodal_traces(tmp_path, flags):
    trace, spec, config = _record(tmp_path, MULTIMODAL + flags)
    assert spec.graph is not None and len(spec.graph.edges) == 3
    conformance.check_all(trace, spec, config)
    # the fusion stage's F tasks were admitted on both branches
    fusion = max(s for _, s in spec.graph.edges[:2])
    assert any(ev.stage == fusion for ev in trace.select(tr.DISPATCH))


def _broken(trace: Trace, how: str) -> Trace:
    events = list(trace.events)
    dispatches = [i for i, ev in enumerate(events) if ev.kind == tr.DISPATCH]
    if how == "duplicate":
        i = dispatches[len(dispatches) // 2]
        events.insert(i + 1, dataclasses.replace(events[i]))
    else:  # move a late F's dispatch to the very start
        i = next(i for i in reversed(dispatches)
                 if events[i].task.stage > 0 and events[i].task.kind == 0)
        first = min(ev.lc for ev in events)
        moved = dataclasses.replace(events[i], lc=first - 1)
        events = [moved] + events[:i] + events[i + 1:]
    return Trace(meta=dict(trace.meta), events=events)


@pytest.mark.parametrize("how,check", [
    ("duplicate", conformance.check_exactly_once),
    ("inverted", conformance.check_dependency_order)])
@pytest.mark.parametrize("argv", [ACTOR, MULTIMODAL],
                         ids=["actor", "multimodal"])
def test_checker_rejects_a_broken_port_trace(tmp_path, argv, how, check):
    trace, spec, config = _record(tmp_path, argv)
    check(trace, spec)  # the trace as recorded holds
    bad = _broken(trace, how)
    with pytest.raises(AssertionError):
        check(bad, spec)
    with pytest.raises(AssertionError):
        conformance.check_all(bad, spec, config)


# ---------------------------------------------------------------------------
# core/bounds.py
# ---------------------------------------------------------------------------
def _fields(x):
    if dataclasses.is_dataclass(x):
        return {f.name: _fields(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _fields(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_fields(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("S,M", [(4, 8), (8, 16), (2, 3)])
def test_bounds_equal_reference(seed, S, M):
    rng = np.random.default_rng(seed)
    f_dur = rng.lognormal(0.0, 0.5, (S, M))
    b_dur = 2.0 * rng.lognormal(0.0, 0.5, (S, M))
    makespan = float(f_dur.sum() + b_dur.sum()) / S
    for name, args in (("check_theorem_6_1", (f_dur, b_dur, makespan)),
                       ("corollary_terms", (f_dur, b_dur)),
                       ("bottleneck_stats", (f_dur,))):
        got = getattr(bounds, name)(*args)
        want = getattr(jbounds, name)(*args)
        assert _fields(got) == _fields(want), name
    got = bounds.check_theorem_6_1(f_dur, b_dur, makespan)
    assert (got.holds, got.ratio_to_lb) == (
        jbounds.check_theorem_6_1(f_dur, b_dur, makespan).holds,
        jbounds.check_theorem_6_1(f_dur, b_dur, makespan).ratio_to_lb)
    for d in ("forward", "backward"):
        assert bounds.reference_makespan(f_dur, d) == \
            jbounds.reference_makespan(f_dur, d)
