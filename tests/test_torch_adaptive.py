"""The port's adaptive hint loop (its verbatim copy of ``runtime/adaptive.py``)
against the reference's, and on the port's driver with real stage callables.

* Given the same registry samples, the port's and the reference's
  ``AdaptiveScheduler`` make the same decisions and the same tables.
* The reference's own cases (``tests/test_adaptive.py`` and
  ``tests/conformance/test_adaptive_swap.py``, its ``harness`` rewritten
  onto the port as well) run unchanged on the port's copy.
* Analogues of ``test_adaptive_swap.py`` on the port's driver, with the
  port's real stage callables instead of the harness's numpy programs: a
  mid-run table swap is recorded as ``HINT_SWAP`` events, obeyed by every
  table-path dispatch (``check_all``), and replayed order-exactly to the
  same loss and gradient bits.
* The launcher's ``--adaptive`` (``--resynth-every``, ``--swap-threshold``):
  a swap it makes is adopted at the next step boundary, and the losses stay
  within the parity tolerance of the plain rrfp run and the reference's
  launcher on the same flags.
"""
import argparse
import dataclasses

import numpy as np
import pytest

from _port_copy import port_cases
from repro.core import CostModel as JCostModel
from repro.core import HintKind as JHintKind
from repro.core import Kind as JKind
from repro.core import PipelineSpec as JPipelineSpec
from repro.core.taskgraph import Task as JTask
from repro.launch import train as jtrain
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.runtime.adaptive import AdaptiveConfig as JAdaptiveConfig
from repro.runtime.adaptive import AdaptiveScheduler as JAdaptiveScheduler
from repro_torch.configs import registry
from repro_torch.core import CostModel, HintKind, Kind, PipelineSpec
from repro_torch.core.synthesis import synthesize
from repro_torch.core.taskgraph import Task
from repro_torch.data.synthetic import synth_batch
from repro_torch.launch import train
from repro_torch.models.build import build
from repro_torch.obs import MetricsRegistry
from repro_torch.pipeline.stagefn import (
    ActorStageProgram,
    StageFnOptions,
    StageFns,
)
from repro_torch.runtime.adaptive import AdaptiveConfig, AdaptiveScheduler
from repro_torch.runtime.rrfp import ActorConfig, ActorDriver
from repro_torch.runtime.rrfp import trace as tr
from repro_torch.runtime.rrfp.conformance import check_all

port_cases("test_adaptive.py", globals())
port_cases("conformance/test_adaptive_swap.py", globals(),
           helpers=("harness",))

ACTOR = ["--arch", "paper-gpt3-large", "--stages", "2", "--layers", "4",
         "--microbatches", "4", "--mb-rows", "1", "--seq", "16",
         "--device", "cpu", "--hint", "bf"]
#: heterogeneous per-stage costs where a 2x drift on stage 4 changes the
#: best table (tests/test_adaptive.py's pp6 workload)
BASE6 = (1.0, 1.2, 0.9, 1.3, 0.8, 1.1)


def _scheduler_run(pkg, split: bool):
    (spec_cls, cost_cls, hint_cls, kind_cls, task_cls, reg_cls, cfg_cls,
     sched_cls) = pkg
    spec = spec_cls(6, 18, split_backward=split)
    base = np.asarray(BASE6)
    costs = cost_cls(f_cost=base, b_cost=base, w_cost=base, comm_base=0.4)
    if not split:
        costs = dataclasses.replace(costs, w_cost=np.zeros(6))
    kinds = [kind_cls.F, kind_cls.B] + ([kind_cls.W] if split else [])
    hint = hint_cls.BFW if split else hint_cls.BF
    reg = reg_cls(6)
    sched = sched_cls(spec, costs, cfg_cls(hint=hint, swap_threshold=1.02),
                      registry=reg)
    for step in range(6):
        drift = 2.0 if step >= 2 else 1.0  # stage 4 slows from step 2
        for s in range(6):
            for k in kinds:
                for mb in range(3):
                    dur = BASE6[s] * (drift if s == 4 else 1.0) * \
                        (1.0 + 0.01 * mb)
                    reg.shard(s).on_complete(task_cls(k, s, mb), dur)
        sched.maybe_resynthesize(step)
    return (sched.to_json(), sched.swaps, sched.version,
            [[repr(t) for t in order] for order in sched.table])


@pytest.mark.parametrize("split", [False, True], ids=["bf", "bfw"])
def test_scheduler_decisions_and_tables_equal_the_reference(split):
    port = _scheduler_run((PipelineSpec, CostModel, HintKind, Kind, Task,
                           MetricsRegistry, AdaptiveConfig,
                           AdaptiveScheduler), split)
    ref = _scheduler_run((JPipelineSpec, JCostModel, JHintKind, JKind, JTask,
                          JMetricsRegistry, JAdaptiveConfig,
                          JAdaptiveScheduler), split)
    assert port == ref
    assert port[1], "the drift should fire a swap"


# ---------------------------------------------------------------------------
# a mid-run swap on the port's driver with real stage callables
# ---------------------------------------------------------------------------
def _real_programs(split: bool):
    cfg = registry.reduced_config("paper-gpt3-large", num_layers=4)
    model = build(cfg, num_stages=3)
    stage_params = [model.init_stage_params(s, seed=0, device="cpu")
                    for s in range(3)]
    io = model.init_io_params(seed=0, device="cpu")
    batch = train._device_batch(synth_batch(cfg, 6, 16, seed=0, step=0),
                                "cpu")
    fns = StageFns(model, StageFnOptions(mb_rows=1, seq_len=16,
                                         loss_scale=1.0 / 96))
    return [ActorStageProgram(fns, s, stage_params[s], io, batch,
                              split_backward=split) for s in range(3)]


def _swap_config(split: bool):
    spec = PipelineSpec(3, 6, split_backward=split)
    hint = HintKind.BFW if split else HintKind.BF
    costs = CostModel.uniform(3, f=1.0, b=2.0, w=1.0 if split else 0.0)
    drifted = dataclasses.replace(costs, b_cost=costs.b_cost * [1, 2, 1])
    old = synthesize(spec, costs, hint=hint).stage_orders
    new = synthesize(spec, drifted, hint=hint).stage_orders
    cfg = ActorConfig(mode="hint", hint=hint, hint_table=old,
                      hint_table_version=0, swap_table=new, swap_after=3,
                      record_trace=True)
    return spec, cfg


def _bits(programs):
    return ([p.loss_acc.numpy().tobytes() for p in programs],
            [None if g is None else g.numpy().tobytes()
             for p in programs for g in (*p.d_stage, *p.d_io)])


@pytest.mark.parametrize("split", [False, True], ids=["bf", "bfw"])
def test_real_callables_hint_swap_is_table_faithful_and_replays(split):
    spec, cfg = _swap_config(split)
    first = _real_programs(split)
    driver = ActorDriver(spec, None, cfg)
    driver.run_threaded(list(first))
    trace = driver.trace
    swaps = trace.select(tr.HINT_SWAP)
    assert len(swaps) == spec.num_stages
    assert all(ev.info["version"] == 1 for ev in swaps)
    assert any(ev.info.get("path") == "table"
               for ev in trace.select(tr.DISPATCH))
    check_all(trace, spec, cfg)  # includes check_table_faithful

    second = _real_programs(split)
    rdriver = ActorDriver(spec, None, ActorConfig(record_trace=True,
                                                  replay=trace))
    rdriver.run_threaded(list(second))
    assert rdriver.trace.dispatch_orders(3) == trace.dispatch_orders(3)
    assert _bits(second) == _bits(first)


# ---------------------------------------------------------------------------
# the launcher's --adaptive
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def plain_rrfp():
    return train.main(ACTOR + ["--steps", "4"]).losses


def test_launcher_adopts_a_swap_at_the_step_boundary(plain_rrfp, tmp_path):
    """``--swap-threshold 1.0`` counts a ratio of 1 as improving, so every
    second check swaps (the streak restarts after a swap): step 1, whose
    table v1 step 2 runs, and step 3."""
    path = str(tmp_path / "step0.trace.jsonl")
    run = train.main(ACTOR + ["--steps", "4", "--adaptive",
                              "--resynth-every", "1", "--swap-threshold",
                              "1.0", "--record-trace", path])
    sched = run.scheduler
    assert sched.swaps == [1, 3] and sched.version == 2
    assert [d.checked for d in sched.decisions] == [True] * 4
    check_all(run.trace, PipelineSpec(2, 4), ActorConfig(mode="hint"))
    assert run.trace.meta.get("hint_table") is not None
    np.testing.assert_allclose(run.losses, plain_rrfp, rtol=1e-5)


def test_launcher_cadence_skips_off_steps(plain_rrfp):
    run = train.main(ACTOR + ["--steps", "4", "--adaptive",
                              "--resynth-every", "2"])
    assert [d.checked for d in run.scheduler.decisions] == \
        [False, True, False, True]
    assert run.scheduler.decisions[0].reason == "off-cadence"
    np.testing.assert_allclose(run.losses, plain_rrfp, rtol=1e-5)


def test_launcher_adaptive_matches_the_reference_launcher():
    from test_torch_train import _reference_init

    argv = ACTOR + ["--steps", "3", "--adaptive"]
    args = train.parser().parse_args(argv)
    ns = vars(args).copy()
    ns.update(runtime="actor", ckpt_every=10, resynth_every=1,
              swap_threshold=1.03)
    want = jtrain.train_actor(argparse.Namespace(**ns))
    got = train.train_actor(args, init_params=_reference_init)
    np.testing.assert_allclose(got.losses, want, atol=1e-4, rtol=1e-4)
