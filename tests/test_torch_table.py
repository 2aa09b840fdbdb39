"""The port's ``--runtime table`` on its own (no JAX): schedule tables,
order invariance, determinism, the families against the actor runtime,
what still raises, and the launcher.

* the reference's ``TestScheduleTable`` (tests/test_pipeline.py) on the
  port's copy of ``pipeline/schedules.py`` (through ``_port_copy``; the
  file's executor cases are JAX programs and stay there);
* ``gpipe``, ``1f1b``, ``zb`` and ``rrfp`` give the same two-step loss
  trajectory within 1e-5 (float32): the reference's order-invariance test;
* the data replicas hold bitwise equal parameters after every step, and
  two runs of one schedule are bitwise equal;
* the table loss and the all-gathered grads of every decoder family match
  the port's actor ``1f1b`` run on the same weights and global batch
  within 1e-4 (float32); the actor path is held against the reference per
  family elsewhere (tests/test_torch_train.py, test_torch_stagefn.py);
  (and seamless-m4t-large-v2's enc-dec forward, whose actor callables
  take the table's encoder frames);
* the enc-dec config gives the same losses under every schedule too;
* deepseek-moe over 2 data ranks, ``tp`` (8 experts) and ``ep`` (16),
  against the actor runtime on the whole weights, its replicated leaves
  bitwise equal across the data ranks and its reruns bitwise; a data
  size that does not divide the experts raises;
* ``main([... --runtime table ...])`` trains on the CPU, raises without
  CUDA unless the CPU is asked for, and stops on the actor-only flags;
  ``--runtime actor`` stops on the enc-dec config.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _port_copy import port_cases
from repro_torch.configs import registry
from repro_torch.core import HintKind, PipelineSpec
from repro_torch.data.synthetic import synth_batch
from repro_torch.launch import train
from repro_torch.models.convert import (
    params_from_reference,
    rank_params_to_reference,
    zero1_state_to_reference,
)
from repro_torch.pipeline.executor import shard_batch
from repro_torch.pipeline.sharding import flat_leaf
from repro_torch.pipeline.stagefn import (
    ActorStageProgram,
    StageFnOptions,
    StageFns,
)
from repro_torch.runtime.rrfp import ActorConfig, ActorDriver

port_cases("test_pipeline.py", globals(),
           skip=("test_executor_matches_reference",
                 "test_executor_schedule_equivalence"))

F32 = {"io_grad_dtype": torch.float32, "flat_dtype": torch.float32}
ARGS = ["--runtime", "table", "--device", "cpu", "--arch",
        "paper-gpt3-large", "--devices", "8", "--stages", "4", "--layers",
        "8", "--microbatches", "4", "--seq", "16"]


def _config(arch: str, layers: int, experts: int | None = None):
    cfg = registry.reduced_config(arch, layers)
    if arch == "zamba2-1.2b":  # the reduced hybrid config has no Mamba layer
        cfg = dataclasses.replace(cfg, layer_pattern=("mamba",) * layers)
    if experts is not None:  # 16 and more: the ep layout
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=experts))
    return cfg


def _trainer(schedule="1f1b", *, arch="paper-gpt3-large", layers=8, data=2,
             stages=4, microbatches=4, mb_rows=2, seq=16, exec_options=None,
             experts=None):
    return train.build_trainer(
        arch, data=data, stages=stages, layers=layers, mb_rows=mb_rows,
        microbatches=microbatches, seq=seq, schedule=schedule, device="cpu",
        cfg=_config(arch, layers, experts), exec_options=exec_options)


def _batch(t, step: int) -> dict:
    return train._device_batch(
        synth_batch(t["cfg"], t["batch_size"], t["seq"], seed=0, step=step,
                    enc_len=t["opts"].enc_len), "cpu")


def _steps(t, n: int = 2, each=None) -> list[float]:
    losses = []
    for step in range(n):
        losses.append(float(t["train_step"](_batch(t, step), step)["loss"]))
        if each is not None:
            each(t)
    return losses


def _assert_schedules_agree(**kw):
    losses = {s: _steps(_trainer(s, exec_options=F32, **kw))
              for s in ("gpipe", "1f1b", "zb", "rrfp")}
    base = losses["1f1b"]
    for s, got in losses.items():
        for a, b in zip(got, base):
            assert abs(a - b) <= 1e-5 * abs(b), (s, got, base)


def test_schedules_give_the_same_losses():
    _assert_schedules_agree()


def test_schedules_give_the_same_losses_enc_dec():
    """seamless reduced to 4 + 4 layers on 2 x 4 (two encoder stages, two
    decoder stages), 16 decoder tokens and 16 encoder frames a row."""
    _assert_schedules_agree(arch="seamless-m4t-large-v2")


def _params(t) -> list[list[torch.Tensor]]:
    return [[p.detach().clone() for p in list(sp.parameters())
             + list(io.parameters())]
            for sp, io in zip(t["stage_params"], t["io_params"])]


def _assert_replicas_equal(t):
    mesh, params = t["mesh"], _params(t)
    for r in range(mesh.size):
        twin = mesh.rank_of(data=0, model=mesh.coords(r)["model"])
        assert all(torch.equal(a, b) for a, b in zip(params[r],
                                                     params[twin])), r
    # every rank's io parameters are the same too
    io = [list(m.parameters()) for m in t["io_params"]]
    assert all(torch.equal(a, b) for r in range(1, mesh.size)
               for a, b in zip(io[0], io[r]))


@pytest.mark.parametrize("schedule", ["1f1b", "zb"])
def test_replicas_stay_bitwise_equal_and_runs_repeat(schedule):
    first = _trainer(schedule)
    a = _steps(first, each=_assert_replicas_equal)
    second = _trainer(schedule)
    b = _steps(second)
    assert a == b
    assert all(torch.equal(x, y) for px, py in zip(_params(first),
                                                   _params(second))
               for x, y in zip(px, py))
    for r, st in enumerate(first["opt_state"]):
        for k, leaf in st["shards"].items():
            for name, v in leaf.items():
                assert torch.equal(v, second["opt_state"][r]["shards"][k][
                    name]), (r, k, name)


@pytest.mark.parametrize("schedule", ["1f1b", "zb"])
def test_moe_replicated_leaves_stay_bitwise_equal_and_runs_repeat(schedule):
    """``ep`` (16 experts) on 2 x 2: after every step the data ranks hold
    bitwise equal replicated leaves and distinct expert shards (not
    replicas), and a second run gives the same bits."""
    def trainer():
        return _trainer(schedule, arch="deepseek-moe-16b", layers=4,
                        stages=2, microbatches=2, mb_rows=1, experts=16)

    def check(t):
        mesh, flags = t["mesh"], t["partition"].stage_data_sharded
        for s in range(2):
            a, b = (t["partition"].stage_leaves(t["stage_params"][
                mesh.rank_of(data=i, model=s)].parameters())
                for i in range(2))
            for k in a:
                same = all(torch.equal(x, y) for x, y in zip(a[k], b[k]))
                assert same != flags[k], (s, k)

    first = trainer()
    a = _steps(first, each=check)
    b = _steps(trainer())
    assert a == b and all(np.isfinite(a))


def _actor_grads(t, microbatches: int, mb_rows: int):
    """Loss and per-stage / io grads (flat per leaf) of the port's actor
    runtime under the fixed 1f1b order, on the table trainer's weights and
    global batch (deterministic fold in microbatch order)."""
    model, part = t["model"], t["partition"]
    mesh, seq = t["mesh"], t["seq"]
    S = model.num_stages
    # whole stage modules: the data ranks' expert shards concatenated
    stages, io = params_from_reference(model, *rank_params_to_reference(
        model, mesh, t["stage_params"], t["io_params"]), "cpu")
    tokens = microbatches * mb_rows * seq
    fns = StageFns(model, StageFnOptions(mb_rows=mb_rows, seq_len=seq,
                                         loss_scale=1.0 / tokens,
                                         enc_len=t["opts"].enc_len))
    batch = _batch(t, 0)
    programs = [ActorStageProgram(fns, s, stages[s], io, batch,
                                  deterministic_reduction=True)
                for s in range(S)]
    ActorDriver(PipelineSpec(S, microbatches), None, ActorConfig(
        mode="precommitted", hint=HintKind.BF, fixed_order="1f1b",
        deadlock_timeout=300.0)).run_threaded(list(programs))

    def flat(grads, params):
        return [torch.zeros_like(p) if g is None else g
                for g, p in zip(grads, params)]

    loss = sum(p.loss_sum for p in programs) / tokens
    per_stage = [{k: flat_leaf(v) for k, v in part.stage_leaves(
        flat(p.d_stage, stages[s].parameters())).items()}
        for s, p in enumerate(programs)]
    d_io = [sum(torch.zeros_like(q) if p.d_io[i] is None else p.d_io[i]
                for p in programs)
            for i, q in enumerate(io.parameters())]
    io_grads = {k: v.reshape(-1) for k, v in part.io_leaves(d_io).items()}
    return loss, per_stage, io_grads


def _close(got: np.ndarray, want: torch.Tensor, what: str):
    want = want.numpy()
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= 1e-4 * scale, what


FAMILIES = [("deepseek-7b", 2), ("zamba2-1.2b", 2), ("xlstm-350m", 2),
            ("qwen2-vl-2b", 2), ("gemma3-4b", 2), ("deepseek-moe-16b", 1),
            ("deepseek-moe-16b", 2), ("seamless-m4t-large-v2", 2)]


@pytest.mark.parametrize("arch,data", FAMILIES)
def test_family_matches_the_actor_runtime(arch, data):
    """deepseek-moe over 2 data ranks: the ``tp`` layout (8 experts)."""
    _check_against_the_actor_runtime(arch, data)


def test_moe_raises_over_more_than_one_data_rank():
    """Over more than one data rank the MoE layouts train: the ``ep``
    layout (16 experts, 8 a rank) on 2 x 2 matches the actor runtime on
    the whole weights, loss and grads, every routed expert's among them;
    what still raises is a data size that does not divide the experts."""
    _check_against_the_actor_runtime("deepseek-moe-16b", 2, experts=16)
    with pytest.raises(ValueError, match="16 does not divide by 3"):
        _trainer(arch="deepseek-moe-16b", layers=4, data=3, stages=2,
                 microbatches=2, mb_rows=1, experts=16)


def _check_against_the_actor_runtime(arch, data, experts=None):
    S, M, rows, seq = 2, 2 * (3 - data), 1, 16
    t = _trainer(arch=arch, layers=4, data=data, stages=S, microbatches=M,
                 mb_rows=rows, seq=seq, exec_options=F32, experts=experts)
    if experts is not None:
        assert t["model"].moe_layout == "ep"
    mesh, model, part = t["mesh"], t["model"], t["partition"]
    shards = shard_batch(mesh, _batch(t, 0), t["batch_specs"])
    out = mesh.run(t["exec_fn"], [
        (t["stage_params"][r], t["io_params"][r], shards[r])
        for r in range(mesh.size)])
    want_loss, want_stage, want_io = _actor_grads(t, data * M, rows)
    loss = float(out[0][0]["loss"])
    assert abs(loss - want_loss) <= 1e-4 * abs(want_loss)
    got = zero1_state_to_reference(model, mesh, part, [
        {"shards": {k: {"g": g} for k, g in o[1].items()},
         "experts": {k: {"g": g} for k, g in o[2].items()}} for o in out])
    assert bool(got["experts"]) == (arch == "deepseek-moe-16b")
    assert all(part.stage_data_sharded[k] for k in got["experts"])
    for s in range(S):
        for k, want in want_stage[s].items():
            g = (got["experts"][k]["g"][s].reshape(-1)
                 if part.stage_data_sharded[k]
                 else got["shards"][k]["g"][s][:want.numel()])
            _close(g, want, f"stage {s} {k}")
    for k, want in want_io.items():
        for s in range(S):  # io shards are the same on every model rank
            _close(got["shards"]["io:" + k]["g"][s][:want.numel()], want,
                   f"stage {s} io {k}")


def test_enc_dec_trainer_takes_seq_encoder_frames():
    """The launcher gives an enc-dec config ``--seq`` frames a row (what
    ``synth_batch`` makes), unless ``exec_options`` sets ``enc_len``."""
    t = _trainer(arch="seamless-m4t-large-v2", layers=4, stages=2, data=1)
    assert t["opts"].enc_len == t["seq"] == 16
    assert t["batch_specs"]["enc_embeds"] == (0, ("data",))
    t = _trainer(arch="seamless-m4t-large-v2", layers=4, stages=2, data=1,
                 exec_options={"enc_len": 24})
    assert t["opts"].enc_len == 24
    assert _batch(t, 0)["enc_embeds"].shape == (t["batch_size"], 24, 64)
    assert np.isfinite(_steps(t, 1)[0])
    assert _trainer(layers=4, stages=2, data=1)["opts"].enc_len == 0


def test_actor_runtime_stops_on_enc_dec():
    with pytest.raises(SystemExit, match="--runtime table"):
        train.main(["--runtime", "actor", "--device", "cpu", "--arch",
                    "seamless-m4t-large-v2", "--stages", "2", "--layers",
                    "4", "--microbatches", "2", "--seq", "16", "--steps",
                    "1"])


def test_cli_trains_on_the_cpu():
    run = train.main(ARGS + ["--steps", "3", "--schedule", "zb"])
    assert len(run.losses) == len(run.gnorms) == len(run.step_seconds) == 3
    assert all(np.isfinite(run.losses)) and all(g > 0 for g in run.gnorms)


def test_cli_needs_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    argv = [a for a in ARGS if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(argv + ["--steps", "1"])


@pytest.mark.parametrize("flag", [["--metrics-report"], ["--explain"],
                                  ["--export-perfetto", "x.json"],
                                  ["--recover"], ["--adaptive"],
                                  ["--split-backward"], ["--chaos", "C1"],
                                  ["--record-trace", "x.jsonl"]])
def test_cli_stops_on_actor_runtime_flags(flag):
    with pytest.raises(SystemExit):
        train.main(ARGS + ["--steps", "1"] + flag)


def test_cli_needs_a_rank_per_stage():
    with pytest.raises(SystemExit, match="--devices >= --stages"):
        train.main(ARGS + ["--steps", "1", "--devices", "2"])
