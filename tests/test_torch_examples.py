"""The port's examples (``repro_torch.examples``) against the reference's.

The reference's four JAX-calling examples (``examples/quickstart.py``,
``serve_batch.py``, ``train_lm.py``, ``async_runtime.py``) are scripts
that force 8 host devices; each counterpart is a module with ``main(argv)``
whose flags cut the model part down (the reference's sizes are the
defaults, which ``chip_smoke.py``'s ``phase_examples`` runs on the card).

* The DES parts (the engine's 1F1B-vs-RRFP contrast, the actor runtime's
  simulated transport over ``INJECTION_LEVELS``) run the port's copies of
  ``core`` and ``runtime/rrfp``; their printed lines equal the same lines
  formatted from the reference's own JAX-free ``repro.core`` and
  ``repro.runtime.rrfp`` calls on the same inputs.
* The model parts run on the CPU at a reduced size and show what the
  reference example shows: ``quickstart``'s losses are those of ``train
  --runtime table --schedule rrfp`` with the same flags; ``serve_batch``'s
  tokens lie in the vocabulary and are those of ``launch.serve`` for the
  same arguments; ``train_lm``'s loss falls (its own assertion, the
  reference's); ``async_runtime``'s threaded steps give finite losses.

The functions the examples call are held against the reference
elsewhere, and not again here: ``make_train_fn`` and ``make_optimizer``
(``build_trainer``) in ``tests/test_torch_executor.py``, the serve mesh's
``make_serve_fn`` in ``tests/test_torch_serve_mesh.py``, and the actor
path's ``StageFns``/``ActorStageProgram`` in ``tests/test_torch_train.py``.
"""
import dataclasses
import math

import pytest
import torch

from repro.core import (
    INJECTION_LEVELS as J_LEVELS,
    CostModel as JCostModel,
    EngineConfig as JEngineConfig,
    HintKind as JHintKind,
    PipelineSpec as JPipelineSpec,
    multimodal_stage_flops as j_stage_flops,
    run_iteration as j_run_iteration,
)
from repro.runtime.rrfp import (
    ActorConfig as JActorConfig,
    average_makespan_actor as j_average_makespan_actor,
)
from repro_torch.configs import registry
from repro_torch.examples import async_runtime, quickstart, serve_batch, train_lm
from repro_torch.launch import serve, train


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart_engine_lines_are_the_references(capsys):
    got = quickstart.engine_contrast()
    lines = capsys.readouterr().out.splitlines()
    S, M = 8, 32
    spec = JPipelineSpec(S, M)
    costs = JCostModel.from_stage_flops(
        j_stage_flops(5e12, 2e12, S), comm_base=2e-3, seed=0)
    fixed = j_run_iteration(spec, costs, JEngineConfig(
        mode="precommitted", fixed_order="1f1b"))
    rrfp = j_run_iteration(spec, costs, JEngineConfig(mode="hint",
                                                      hint=JHintKind.BF))
    assert got["fixed"].makespan == fixed.makespan
    assert got["rrfp"].makespan == rrfp.makespan
    assert got["fixed"].breakdown() == fixed.breakdown()
    assert got["rrfp"].breakdown() == rrfp.breakdown()
    assert lines[1:] == [
        f"pre-committed 1F1B: {fixed.makespan:.3f}s  "
        f"(blocking {fixed.breakdown()['blocking']:.3f}s)",
        f"RRFP (BF hint):     {rrfp.makespan:.3f}s  "
        f"(blocking {rrfp.breakdown()['blocking']:.3f}s)  "
        f"speedup {fixed.makespan / rrfp.makespan:.2f}x"]
    assert rrfp.makespan < fixed.makespan


def test_async_runtime_simulated_lines_are_the_references(capsys):
    got = async_runtime.simulated(iters=1)
    lines = capsys.readouterr().out.splitlines()
    S, M = 8, 32
    spec = JPipelineSpec(S, M)
    base = JCostModel.from_stage_flops(j_stage_flops(4e12, 2e12, S),
                                       comm_base=2e-3)
    want = []
    for level, inj in J_LEVELS.items():
        costs = dataclasses.replace(base, injection=inj)
        pre, _, _ = j_average_makespan_actor(
            spec, costs, JActorConfig(mode="precommitted",
                                      fixed_order="1f1b"), 1)
        hint, _, _ = j_average_makespan_actor(
            spec, costs, JActorConfig(mode="hint"), 1)
        assert got[level] == (pre, hint)
        want.append(f"{level:>6} {pre:>10.3f} {hint:>10.3f} "
                    f"{pre / hint:>7.2f}x")
    assert lines[2:] == want and len(want) == len(J_LEVELS)


def test_quickstart_trains_as_the_table_launcher_does(one_thread):
    flags = ["--layers", "4", "--microbatches", "4", "--seq", "16",
             "--steps", "2"]
    got = quickstart.main(["--device", "cpu"] + flags)
    want = train.main(["--runtime", "table", "--schedule", "rrfp",
                       "--device", "cpu", "--arch", "deepseek-7b",
                       "--devices", "8", "--stages", "4"] + flags)
    assert got["losses"] == want.losses and len(got["losses"]) == 2
    assert all(math.isfinite(x) for x in got["losses"])
    assert 0 < got["bubble"] < 1


def test_serve_batch_gives_the_serve_launchers_tokens(one_thread):
    flags = ["--layers", "4", "--batch", "4", "--tokens", "3",
             "--cache-len", "16"]
    rows = serve_batch.main(["--device", "cpu"] + flags)
    want = serve.main(["--device", "cpu", "--arch", "deepseek-7b",
                       "--devices", "8", "--stages", "4"] + flags)
    assert rows == want.tokens
    assert len(rows) == 4 and all(len(r) == 4 for r in rows)
    vocab = registry.reduced_config("deepseek-7b", 4).vocab_size
    assert all(0 <= t < vocab for r in rows for t in r)


def test_train_lm_loss_falls(one_thread):
    losses = train_lm.main(["--device", "cpu", "--steps", "3", "--d-model",
                            "64", "--layers", "4", "--seq", "16"])
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    assert losses[-1] < losses[0]


def test_async_runtime_threaded_steps(one_thread, capsys):
    losses = async_runtime.threaded(torch.device("cpu"), steps=2)
    out = capsys.readouterr().out
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    # the reduced vocabulary's uniform loss is ln 256 = 5.55
    assert all(4.0 < x < 7.0 for x in losses)
    assert out.count("tasks 16") == 2  # 2 stages x 4 microbatches x F, B


@pytest.mark.parametrize("name", ["quickstart", "serve_batch", "train_lm",
                                  "async_runtime"])
def test_examples_need_cuda_unless_asked_for_the_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    module = {"quickstart": quickstart, "serve_batch": serve_batch,
              "train_lm": train_lm, "async_runtime": async_runtime}[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main([])
