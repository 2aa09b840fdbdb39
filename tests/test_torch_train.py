"""The port's training entry point against the reference's ``train_actor``.

Same initial weights (the reference's, loaded by path), same synthetic
batches: the 3-step loss trajectory of reduced paper-gpt3-large (2 stages,
4 microbatches, seq 16), of reduced zamba2 (Mamba layers and the shared
attention block, seq 32) and of the reduced MoE, xLSTM and M-RoPE archs
agrees within 1e-4, under hint bf and bfw.  Also:
each runtime flag of the reference's launcher runs, or stops with the
reference's guard (or, where the reference ignores the flag, says so), and
without CUDA the launcher raises unless asked for the CPU.
"""
import argparse
import dataclasses

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
    """The reference train_actor's initial weights (jax.random.key(0)) for
    the port model's config."""
    from repro.configs import registry as jreg
    from repro.models.build import build as jbuild

    cfg = model.cfg
    cfg_j = jreg.reduced_config(cfg.name.removesuffix("-reduced"),
                                num_layers=cfg.num_layers)
    if cfg.layer_pattern is not None:
        cfg_j = dataclasses.replace(cfg_j, layer_pattern=cfg.layer_pattern)
    model_j = jbuild(cfg_j, num_stages=model.num_stages)
    key = jax.random.key(0)
    sp = jax.tree.map(np.asarray, model_j.init_stage_params(key))
    io = jax.tree.map(np.asarray,
                      model_j.init_io_params(jax.random.fold_in(key, 1)))
    return params_from_reference(model, sp, io, device)


def _check_trajectory(argv, *, falls: bool = True):
    args = train.parser().parse_args(argv)
    want = _reference_losses(args)
    got = train.train_actor(args, init_params=_reference_init)
    assert len(got.losses) == 3 and len(got.step_seconds) == 3
    np.testing.assert_allclose(got.losses, want, atol=1e-4, rtol=1e-4)
    if falls:
        assert got.losses[-1] < got.losses[0]


@pytest.mark.parametrize("hint", ["bf", "bfw"])
def test_loss_trajectory_matches_reference_train_actor(hint):
    _check_trajectory(ARGS + (["--hint", "bfw", "--split-backward"]
                              if hint == "bfw" else []))


@pytest.mark.parametrize("hint", ["bf", "bfw"])
def test_zamba2_loss_trajectory_matches_reference_train_actor(hint,
                                                              monkeypatch):
    """zamba2 with its Mamba pattern (both registries' reduced configs keep
    only attention layers for the hybrid family, so both launchers are
    given the Mamba pattern): 4 layers on 2 stages, shared block on both,
    seq 32 (two chunks of 16)."""
    from repro.configs import registry as jreg
    from repro_torch.configs import registry

    for reg in (jreg, registry):
        def reduced(name, num_layers=None, _orig=reg.reduced_config):
            cfg = _orig(name, num_layers=num_layers)
            return dataclasses.replace(
                cfg, layer_pattern=("mamba",) * cfg.num_layers)

        monkeypatch.setattr(reg, "reduced_config", reduced)
    argv = [a for a in ARGS] + (["--hint", "bfw", "--split-backward"]
                                if hint == "bfw" else [])
    argv[argv.index("paper-gpt3-large")] = "zamba2-1.2b"
    argv[argv.index("--seq") + 1] = "32"
    # the reference's own zamba2 loss rises at step 2 (warm-up to lr 1e-3
    # on random tokens): only the agreement is checked
    _check_trajectory(argv, falls=False)


@pytest.mark.parametrize("hint", ["bf", "bfw"])
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "grok-1-314b",
                                  "xlstm-350m", "qwen2-vl-2b"])
def test_family_loss_trajectory_matches_reference_train_actor(arch, hint):
    """The MoE, xLSTM and M-RoPE families (the registries' reduced configs,
    4 layers on 2 stages): deepseek-moe's dense and MoE layers, grok's
    GEGLU experts, xlstm's 3:1 mLSTM/sLSTM pattern, qwen2-vl's embeddings
    and M-RoPE positions (the synthetic streams are equal)."""
    argv = [a for a in ARGS] + (["--hint", "bfw", "--split-backward"]
                                if hint == "bfw" else [])
    argv[argv.index("paper-gpt3-large")] = arch
    _check_trajectory(argv, falls=False)


MM = ["--workload", "multimodal", "--stages", "3", "--layers", "2",
      "--microbatches", "2", "--seq", "16", "--steps", "1", "--device",
      "cpu"]
#: every flag of the reference's single-device actor launcher: (flags, the
#: SystemExit message it raises, or None where it runs); {tmp} is a fresh
#: directory
RUNTIME_FLAGS = {
    "metrics-report": (["--metrics-report"], None),
    "export-perfetto": (["--export-perfetto", "{tmp}/t.perfetto.json"], None),
    "explain": (["--explain"], None),
    "ckpt-dir": (["--ckpt-dir", "{tmp}/ck"], None),
    "ckpt-every": (["--ckpt-dir", "{tmp}/ck", "--ckpt-every", "1"], None),
    "resume": (["--ckpt-dir", "{tmp}/ck", "--resume"], None),
    "recover": (["--recover"], None),
    "hb-deadline": (["--recover", "--hb-deadline", "1.5"], None),
    "adaptive": (["--adaptive"], None),
    "resynth-every": (["--adaptive", "--resynth-every", "2"], None),
    "swap-threshold": (["--adaptive", "--swap-threshold", "1.1"], None),
    # the reference's own guards
    "adaptive-1f1b": (["--adaptive", "--schedule", "1f1b"],
                      "requires --schedule rrfp"),
    "adaptive-replay": (["--adaptive", "--replay-trace", "{tmp}/r.jsonl"],
                        "combining it with --replay-trace"),
    "recover-multimodal": (MM + ["--recover"], "--recover drives the "
                           "thread-per-stage actor runtime"),
    "adaptive-multimodal": (MM + ["--adaptive"], "--adaptive drives the "
                            "thread-per-stage actor runtime"),
    # where the reference silently ignores the flag
    "ckpt-dir-multimodal": (MM + ["--ckpt-dir", "{tmp}/ck"],
                            "keeps no checkpoints"),
    "resume-alone": (["--resume"], "needs --ckpt-dir"),
    "ckpt-every-alone": (["--ckpt-every", "2"], "needs --ckpt-dir"),
    "resynth-every-alone": (["--resynth-every", "2"], "tunes --adaptive"),
    "swap-threshold-alone": (["--swap-threshold", "1.1"], "tunes --adaptive"),
}


@pytest.mark.parametrize("case", list(RUNTIME_FLAGS))
def test_runtime_flags_run_or_raise_the_reference_guard(case, tmp_path,
                                                        capsys):
    flags, guard = RUNTIME_FLAGS[case]
    flags = [f.format(tmp=tmp_path) for f in flags]
    base = [] if flags[:2] == MM[:2] else ARGS + ["--steps", "1"]
    if case == "adaptive-replay":
        train.main(base + ["--record-trace", f"{tmp_path}/r.jsonl"])
    if guard is not None:
        with pytest.raises(SystemExit, match=guard):
            train.main(base + flags)
        return
    run = train.main(base + flags)
    assert len(run.losses) == 1 and np.isfinite(run.losses[0])
    out = capsys.readouterr().out
    if case == "metrics-report":
        assert "per-stage metrics" in out
    elif case == "export-perfetto":
        assert (tmp_path / "t.perfetto.json").stat().st_size > 0
    elif case == "explain":
        assert "makespan explained" in out
    elif case == "ckpt-every":
        assert [e["op"] for e in run.ckpt_log] == ["save"]
    elif case in ("adaptive", "resynth-every", "swap-threshold"):
        assert len(run.scheduler.decisions) == 1


def test_runtime_table_is_deferred_to_the_multi_device_slice():
    """What ``--runtime table`` once deferred to the multi-device slice,
    the MoE exchanges over more than one data rank, trains through the
    launcher: reduced deepseek-moe-16b (8 experts, the ``tp`` layout) on a
    2 x 2 mesh, two steps with finite losses and gradient norms."""
    argv = ["--runtime", "table", "--arch", "deepseek-moe-16b", "--stages",
            "2", "--devices", "4", "--layers", "4", "--microbatches", "2",
            "--mb-rows", "1", "--seq", "16", "--steps", "2", "--device",
            "cpu"]
    run = train.main(argv)
    t = run.trainer
    assert (t["mesh"].shape, t["model"].moe_layout) == (
        {"data": 2, "model": 2}, "tp")
    assert len(run.losses) == 2 and all(np.isfinite(run.losses))
    assert all(np.isfinite(run.gnorms)) and all(g > 0 for g in run.gnorms)
    # the experts' exchanges, every step: the stacked all_gather of the
    # dispatch and its transpose's psum_scatter among the ZeRO-1 ones
    assert len(run.collectives) == 2
    assert all(c["all_gather"][0] > 0 and c["psum_scatter"][0] > 0
               for c in run.collectives)


@pytest.mark.parametrize("arch,data", [("paper-gpt3-large", 1),
                                       ("deepseek-moe-16b", 2)])
def test_actor_gnorm_is_the_table_clip_norm(arch, data):
    """The actor path's recorded step-0 gradient norm is the table
    runtime's clip norm on the same weights and global batch (reduced
    configs, float32, within 1e-4): over one data rank, and over two with
    deepseek-moe's ``tp`` experts differentiated cut at their exchanges."""
    common = ["--arch", arch, "--stages", "2", "--layers", "4", "--mb-rows",
              "1", "--seq", "16", "--steps", "1", "--device", "cpu"]
    actor = train.main(["--runtime", "actor", "--schedule", "1f1b",
                        "--microbatches", "4"] + common)
    table = train.main(["--runtime", "table", "--schedule", "1f1b",
                        "--devices", str(2 * data), "--microbatches",
                        str(4 // data)] + common)
    assert table.trainer["model"].moe_layout == (
        "tp" if data > 1 else "none")
    assert abs(actor.losses[0] - table.losses[0]) <= 1e-4 * table.losses[0]
    assert abs(actor.gnorms[0] - table.gnorms[0]) <= 1e-4 * table.gnorms[0]


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
