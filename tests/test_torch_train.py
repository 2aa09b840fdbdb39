"""The port's training entry point against the reference's ``train_actor``.

Same initial weights (the reference's, loaded by path), same synthetic
batches: the 3-step loss trajectory of reduced paper-gpt3-large (2 stages,
4 microbatches, seq 16) agrees within 1e-4.  Also: the deferred flags of
the reference's launcher stop with the ROADMAP item that brings them, and
without CUDA the launcher raises unless asked for the CPU.
"""
import argparse

import jax
import numpy as np
import pytest
import torch

from repro.launch import train as jtrain
from repro_torch.launch import train
from repro_torch.models.convert import params_from_reference

ARGS = ["--arch", "paper-gpt3-large", "--stages", "2", "--layers", "4",
        "--microbatches", "4", "--mb-rows", "1", "--seq", "16", "--steps",
        "3", "--device", "cpu"]


def _reference_losses(port_args) -> list[float]:
    ns = vars(port_args).copy()
    ns.update(recover=False, hb_deadline=2.0, adaptive=False,
              resynth_every=1, swap_threshold=1.03, metrics_report=False,
              export_perfetto=None, explain=False, ckpt_dir=None,
              ckpt_every=10, resume=False)
    return jtrain.train_actor(argparse.Namespace(**ns))


def _reference_init(model, device):
    """The reference train_actor's initial weights (jax.random.key(0))."""
    from repro.configs import registry as jreg
    from repro.models.build import build as jbuild

    model_j = jbuild(jreg.reduced_config("paper-gpt3-large", num_layers=4),
                     num_stages=model.num_stages)
    key = jax.random.key(0)
    sp = jax.tree.map(np.asarray, model_j.init_stage_params(key))
    io = jax.tree.map(np.asarray,
                      model_j.init_io_params(jax.random.fold_in(key, 1)))
    return params_from_reference(model, sp, io, device)


@pytest.mark.parametrize("hint", ["bf", "bfw"])
def test_loss_trajectory_matches_reference_train_actor(hint):
    argv = ARGS + (["--hint", "bfw", "--split-backward"] if hint == "bfw"
                   else [])
    args = train.parser().parse_args(argv)
    want = _reference_losses(args)
    got = train.train_actor(args, init_params=_reference_init)
    assert len(got.losses) == 3 and len(got.step_seconds) == 3
    np.testing.assert_allclose(got.losses, want, atol=1e-4, rtol=1e-4)
    assert got.losses[-1] < got.losses[0]


@pytest.mark.parametrize("flag", ["--recover", "--adaptive",
                                  "--metrics-report", "--explain",
                                  "--export-perfetto=x.json",
                                  "--ckpt-dir=ck", "--resume"])
def test_deferred_flags_name_their_roadmap_item(flag):
    with pytest.raises(SystemExit, match="ROADMAP.md queue 1"):
        train.main(ARGS + [flag])


def test_runtime_table_is_deferred_to_the_multi_device_slice():
    with pytest.raises(SystemExit, match="Multi-device"):
        train.main(ARGS + ["--runtime", "table"])


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    argv = [a for a in ARGS if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(argv)


def test_record_and_replay_reproduce_the_loss(tmp_path):
    path = str(tmp_path / "step0.trace.jsonl")
    base = ARGS[:-4] + ["--steps", "1", "--device", "cpu"]
    rec = train.main(base + ["--record-trace", path, "--chaos", "C2"])
    rep = train.main(base + ["--replay-trace", path])
    assert rep.losses == rec.losses
