"""Fail-stop recovery through the port's launcher (``--recover``).

A chaos ``kill`` or ``permanent_stall`` of one stage, survived with
``--recover``, respawns the stage's program (from the live step-start
modules, or through ``restore_host`` of the latest checkpoint under
``--ckpt-dir``) and re-executes its tasks: under the fixed 1f1b order the
losses equal the unfailed run's bit for bit, and the recorded trace passes
``check_all`` in its recovery-aware form.  Without ``--recover`` the fault
is a ``StageFailure``.  The reference's launcher on the same flags (its own
``--recover`` works on real stage callables) agrees within the launchers'
parity tolerance.
"""
import argparse

import numpy as np
import pytest

from repro.launch import train as jtrain
from repro_torch.core import PipelineSpec
from repro_torch.launch import train
from repro_torch.runtime.rrfp import ActorConfig, StageFailure
from repro_torch.runtime.rrfp.conformance import check_all

ACTOR = ["--arch", "paper-gpt3-large", "--stages", "2", "--layers", "4",
         "--microbatches", "4", "--mb-rows", "1", "--seq", "16", "--steps",
         "2", "--device", "cpu", "--schedule", "1f1b"]
#: short enough that a stall is detected quickly on the CPU
HB = ["--hb-deadline", "0.2"]


def _chaos(kind: str, stage: int = 1, after: int = 3) -> list[str]:
    return ["--chaos", f"fail_stage={stage},fail_kind={kind},"
                       f"fail_after={after}"]


@pytest.fixture(scope="module")
def unfailed():
    return train.main(ACTOR).losses


@pytest.mark.parametrize("ckpt", [False, True], ids=["live", "ckpt"])
@pytest.mark.parametrize("kind", ["kill", "permanent_stall"])
def test_recovered_run_equals_the_unfailed_run(tmp_path, unfailed, kind,
                                               ckpt):
    trace = str(tmp_path / "step0.trace.jsonl")
    argv = ACTOR + _chaos(kind) + ["--recover", "--record-trace", trace] + HB
    if ckpt:
        argv += ["--ckpt-dir", str(tmp_path / "ck")]
    run = train.main(argv)
    assert run.losses == unfailed
    windows = run.trace.recovery_windows()
    assert [w["stage"] for w in windows] == [1]
    assert windows[0]["t_end"] >= windows[0]["t_detect"] >= \
        windows[0]["t_fail"]
    check_all(run.trace, PipelineSpec(2, 4),
              ActorConfig(mode="precommitted"))
    respawns = [e for e in run.ckpt_log if e["op"] == "respawn"]
    if ckpt:
        # --ckpt-every defaults to 1 under --recover: step 1's respawn
        # restores the step-1 checkpoint, the params that step started from
        saves = [e["step"] for e in run.ckpt_log if e["op"] == "save"]
        assert saves == [1, 2]
        assert [e["step"] for e in respawns] == [1]
    else:
        assert not respawns


def test_a_failure_of_the_first_stage_and_a_resumed_run(tmp_path, unfailed):
    """Stage 0 (the embedding's stage) dies in a run resumed from a
    checkpoint, and is respawned through ``restore_host``."""
    ck = str(tmp_path / "ck")
    argv = ACTOR + ["--steps", "3"]  # the last --steps counts
    full = train.main(argv + ["--ckpt-dir", ck, "--ckpt-every", "2"])
    rr = train.main(argv + ["--ckpt-dir", ck, "--resume", "--ckpt-every",
                            "2", "--recover"] + _chaos("kill", stage=0)
                    + HB)
    assert rr.losses == full.losses[2:]
    assert [e["op"] for e in rr.ckpt_log] == ["resume", "respawn"]


@pytest.mark.parametrize("kind", ["kill", "permanent_stall"])
def test_a_fault_without_recover_is_a_stage_failure(kind):
    with pytest.raises(StageFailure, match="fail-stop"):
        train.main(ACTOR + _chaos(kind) + HB)


def test_recovery_under_the_hint_order(unfailed):
    """rrfp: dispatch follows arrival, so the fold order may move; the
    losses stay within the parity tolerance of the unfailed run."""
    argv = [a for a in ACTOR if a not in ("--schedule", "1f1b")]
    want = train.main(argv).losses
    got = train.main(argv + _chaos("kill") + ["--recover"] + HB).losses
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _reference_init(model, device):
    from test_torch_train import _reference_init as init

    return init(model, device)


@pytest.mark.parametrize("kind", ["kill", "permanent_stall"])
def test_recovered_losses_match_the_reference_launcher(kind):
    argv = ACTOR + _chaos(kind) + ["--recover"] + HB
    args = train.parser().parse_args(argv)
    ns = vars(args).copy()
    ns.update(runtime="actor", ckpt_every=1, resynth_every=1,
              swap_threshold=1.03)
    want = jtrain.train_actor(argparse.Namespace(**ns))
    got = train.train_actor(args, init_params=_reference_init)
    np.testing.assert_allclose(got.losses, want, atol=1e-4, rtol=1e-4)
