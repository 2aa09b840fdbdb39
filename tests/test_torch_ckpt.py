"""The port's checkpoint store against the reference's ``repro.ckpt.store``.

* Leaf names are ``jax.tree_util.keystr``'s, computed without JAX.
* ``params_to_reference`` / ``state_to_reference`` give the reference's
  stacked trees (disabled slots included) of the port's modules, and
  ``params_from_reference`` / ``state_from_reference`` invert them.
* A checkpoint the port writes restores in the reference's
  ``CheckpointStore``, and the reverse, bitwise (float32 and bfloat16).
* ``LATEST`` moves only after a whole step landed; ``keep`` bounds the
  step directories.
* The crash-restart case of ``tests/test_fault_tolerance.py``: a run that
  dies after its step-2 save and resumes gives the uninterrupted run's
  losses (bitwise under the fixed 1f1b order); a checkpoint the reference's
  ``train_actor`` writes resumes in the port's launcher, and the reverse.
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import store as jstore
from repro.configs import registry as jreg
from repro.launch import train as jtrain
from repro.models.build import build as jbuild
from repro_torch.ckpt import CheckpointStore
from repro_torch.ckpt import store
from repro_torch.configs import registry
from repro_torch.launch import train
from repro_torch.models.build import build
from repro_torch.models.convert import (
    params_from_reference,
    params_to_reference,
    reference_layout,
    state_from_reference,
    state_to_reference,
)

ACTOR = ["--arch", "paper-gpt3-large", "--stages", "2", "--layers", "4",
         "--microbatches", "4", "--mb-rows", "1", "--seq", "16",
         "--device", "cpu"]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _models(arch: str, dtype: str, layers: int = 5, stages: int = 2):
    """(port model, reference model, the reference's numpy init) at
    ``dtype``; 5 layers on 2 stages leave one disabled slot."""
    t_dtype, j_dtype = DTYPES[dtype]
    cfg = dataclasses.replace(registry.reduced_config(arch, num_layers=layers),
                              dtype=t_dtype)
    cfg_j = dataclasses.replace(jreg.reduced_config(arch, num_layers=layers),
                                dtype=j_dtype)
    model, model_j = build(cfg, num_stages=stages), jbuild(cfg_j, stages)
    key = jax.random.key(0)
    sp = jax.tree.map(np.asarray, model_j.init_stage_params(key))
    io = jax.tree.map(np.asarray,
                      model_j.init_io_params(jax.random.fold_in(key, 1)))
    return model, model_j, sp, io


def _assert_tree_equal(got, want):
    got_l = jax.tree_util.tree_leaves_with_path(got)
    want_l = jax.tree_util.tree_leaves_with_path(want)
    assert [jax.tree_util.keystr(p) for p, _ in got_l] == \
        [jax.tree_util.keystr(p) for p, _ in want_l]
    for (p, a), (_, b) in zip(got_l, want_l):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, jax.tree_util.keystr(p)
        assert a.astype(np.float32).tobytes() == \
            b.astype(np.float32).tobytes(), jax.tree_util.keystr(p)


def _seeded_state(stage_params, io_params, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(p.shape, generator=gen)
            for sp in (*stage_params, io_params) for p in sp.parameters()]


def test_leaf_names_are_jax_keystr():
    tree = {"params": {"sp": {"blk": {"attn": {"wq": np.zeros(2)}}},
                       "b": [np.zeros(1), (np.ones(1), None)]},
            "m": {"x": [np.zeros(3)]}, 'k"q': np.zeros(1)}
    want = [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_leaves_with_path(tree)]
    assert [k for k, _ in store._leaves_with_path(tree)] == want
    assert "['params']['sp']['blk']['attn']['wq']" in want
    assert "['m']['x'][0]" in want
    ints = {3: np.zeros(1), 1: np.zeros(1)}
    assert [k for k, _ in store._leaves_with_path(ints)] == [
        jax.tree_util.keystr(p)
        for p, _ in jax.tree_util.tree_leaves_with_path(ints)]


@pytest.mark.parametrize("arch", ["paper-gpt3-large", "zamba2-1.2b",
                                  "seamless-m4t-large-v2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_to_reference_inverts_params_from_reference(arch, dtype):
    model, _, sp, io = _models(arch, dtype)
    assert (model.type_ids == -1).any()  # a disabled slot is covered
    stages, io_mod = params_from_reference(model, sp, io, "cpu")
    got_sp, got_io = params_to_reference(model, stages, io_mod)
    _assert_tree_equal(got_sp, sp)
    _assert_tree_equal(got_io, io)
    if dtype == "bfloat16":  # numpy has no bfloat16 here: widened
        assert got_sp["blk"]["attn"]["wq"].dtype == np.float32
    # one stage alone (the respawn path) holds the same weights
    (s1,), _ = params_from_reference(model, sp, io, "cpu", stages=[1])
    for a, b in zip(s1.parameters(), stages[1].parameters()):
        assert torch.equal(a, b)


def test_state_lists_round_trip():
    model, _, sp, io = _models("zamba2-1.2b", "bfloat16")
    stages, io_mod = params_from_reference(model, sp, io, "cpu")
    flat = _seeded_state(stages, io_mod, 1)
    tree_sp, tree_io = state_to_reference(model, stages, io_mod, flat)
    assert np.shape(tree_sp["blk"]["attn"]["wq"])[:2] == (2, model.l_max)
    back = state_from_reference(model, stages, io_mod, tree_sp, tree_io,
                                "cpu")
    assert len(back) == len(flat)
    for a, b in zip(back, flat):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    with pytest.raises(TypeError, match="values for"):
        state_to_reference(model, stages, io_mod, flat[:-1])


def _port_tree(model, stages, io_mod):
    m = _seeded_state(stages, io_mod, 1)
    v = [t.abs() for t in _seeded_state(stages, io_mod, 2)]
    return train._ckpt_tree(model, stages, io_mod, m, v), m, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, dtype):
    model, _, sp, io = _models("paper-gpt3-large", dtype)
    stages, io_mod = params_from_reference(model, sp, io, "cpu")
    tree, _, _ = _port_tree(model, stages, io_mod)
    CheckpointStore(str(tmp_path)).save(3, tree, meta={"step": 3})
    ref = jstore.CheckpointStore(str(tmp_path))
    assert ref.latest_step() == 3
    params = {"sp": jax.tree.map(jnp.asarray, sp),
              "io": jax.tree.map(jnp.asarray, io)}
    zeros = jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), params)
    got, meta = ref.restore(3, {"params": params, "m": zeros, "v": zeros})
    assert meta == {"step": 3}
    assert np.asarray(got["params"]["sp"]["blk"]["attn"]["wq"]).dtype == \
        np.dtype(DTYPES[dtype][1])
    _assert_tree_equal(got, tree)
    _assert_tree_equal(got["params"], {"sp": sp, "io": io})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, dtype):
    model, _, sp, io = _models("zamba2-1.2b", dtype)
    params = {"sp": jax.tree.map(jnp.asarray, sp),
              "io": jax.tree.map(jnp.asarray, io)}
    key = jax.random.key(5)
    m = jax.tree.map(lambda x: jax.random.normal(key, x.shape, jnp.float32),
                     params)
    jstore.CheckpointStore(str(tmp_path)).save(
        4, {"params": params, "m": m, "v": m}, meta={"arch": "zamba2"})
    stages0 = [model.init_stage_params(s, device="cpu") for s in range(2)]
    io0 = model.init_io_params(device="cpu")
    target = train._ckpt_target(model, stages0, io0, with_state=True)
    got, meta = CheckpointStore(str(tmp_path)).restore(4, target)
    assert meta == {"arch": "zamba2"}
    stages, io_mod = params_from_reference(model, got["params"]["sp"],
                                           got["params"]["io"], "cpu")
    want_stages, want_io = params_from_reference(model, sp, io, "cpu")
    for a, b in zip([*stages, io_mod], [*want_stages, want_io]):
        for (n, x), (_, y) in zip(a.named_parameters(),
                                  b.named_parameters()):
            assert x.dtype == y.dtype and torch.equal(x, y), n
    flat = state_from_reference(model, stages, io_mod, got["m"]["sp"],
                                got["m"]["io"], "cpu")
    want_sp, want_io_m = state_to_reference(model, stages, io_mod, flat)
    _assert_tree_equal({"sp": want_sp, "io": want_io_m}, m)
    # restore_host of the params alone (the respawn target)
    host, _ = CheckpointStore(str(tmp_path)).restore_host(
        4, train._ckpt_target(model, stages0, io0, with_state=False))
    assert set(host) == {"params"}
    assert host["params"]["io"]["embed"].device.type == "cpu"


def test_restore_checks_every_leaf(tmp_path):
    model, _, sp, io = _models("paper-gpt3-large", "float32")
    stages, io_mod = params_from_reference(model, sp, io, "cpu")
    st = CheckpointStore(str(tmp_path))
    st.save(1, {"params": dict(zip(("sp", "io"), params_to_reference(
        model, stages, io_mod)))})
    target = train._ckpt_target(model, stages, io_mod, with_state=True)
    with pytest.raises(KeyError, match=r"\['m'\]"):
        st.restore(1, target)
    other, _, _, _ = _models("paper-gpt3-large", "float32", layers=4)
    stages4 = [other.init_stage_params(s, device="cpu") for s in range(2)]
    with pytest.raises(ValueError, match="shape mismatch"):
        st.restore(1, train._ckpt_target(
            other, stages4, other.init_io_params(device="cpu"), False))
    sp_meta, _ = reference_layout(model, stages, io_mod)
    assert sp_meta["blk"]["attn"]["wq"].device.type == "meta"


def test_latest_moves_only_after_a_whole_step(tmp_path, monkeypatch):
    st = CheckpointStore(str(tmp_path))
    st.save(1, {"w": torch.ones(3)})

    def crash(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", crash)
    with pytest.raises(OSError):
        st.save(2, {"w": torch.full((3,), 2.0)})
    monkeypatch.undo()
    assert st.latest_step() == 1 and st.list_steps() == [1]
    got, _ = st.restore(1, {"w": torch.empty(3)})
    assert torch.equal(got["w"], torch.ones(3))
    st.save(2, {"w": torch.full((3,), 2.0)}, asynchronous=True)
    st.wait()
    assert st.latest_step() == 2
    assert not any(n.startswith(".LATEST") for n in
                   __import__("os").listdir(tmp_path))


def test_keep_bounds_the_step_directories(tmp_path):
    st = CheckpointStore(str(tmp_path), keep=2)
    for k in range(1, 6):
        st.save(k, {"w": np.full(2, k, np.float32)})
    assert st.list_steps() == [4, 5] and st.latest_step() == 5
    assert jstore.CheckpointStore(str(tmp_path)).list_steps() == [4, 5]


class _Crash(Exception):
    pass


def _crash_after(step):
    def hook(s):
        if s == step:
            raise _Crash
    return hook


@pytest.mark.parametrize("schedule", ["1f1b", "rrfp"])
def test_crash_restart_resumes_identically(tmp_path, schedule):
    """4 steps straight vs 2 steps, a crash after the step-2 save, and a
    resume: the same losses (bitwise in the fixed order; rrfp's dispatch
    order follows arrival, so within the reference test's 1e-4)."""
    argv = ACTOR + ["--steps", "4", "--schedule", schedule]
    full = train.main(argv).losses
    part = train.parser().parse_args(
        argv + ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    with pytest.raises(_Crash):
        train.train_actor(part, step_hook=_crash_after(1))
    resumed = train.main(argv + ["--ckpt-dir", str(tmp_path), "--resume"])
    assert len(resumed.losses) == 2
    assert resumed.ckpt_log[0]["op"] == "resume"
    if schedule == "1f1b":
        assert resumed.losses == full[2:]
    else:
        np.testing.assert_allclose(resumed.losses, full[2:], rtol=1e-4)


def _reference_args(argv):
    ns = vars(train.parser().parse_args(argv)).copy()
    ns.update(runtime="actor", ckpt_every=ns["ckpt_every"] or 10,
              resynth_every=1, swap_threshold=1.03)
    return argparse.Namespace(**ns)


def _reference_init(model, device):
    from test_torch_train import _reference_init as init

    return init(model, device)


def test_checkpoints_cross_between_the_launchers(tmp_path):
    """The reference's ``train_actor`` writes step 2 of 4; the port resumes
    from it.  The port (on the reference's initial weights) writes step 2;
    the reference resumes from it.  Each resumed loss is the other
    package's uninterrupted one within the launchers' parity tolerance."""
    argv = ACTOR + ["--steps", "4", "--schedule", "1f1b"]
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    want = jtrain.train_actor(_reference_args(
        argv + ["--ckpt-dir", str(ref_dir), "--ckpt-every", "2"]))
    port_full = train.train_actor(train.parser().parse_args(
        argv + ["--ckpt-dir", str(port_dir), "--ckpt-every", "2"]),
        init_params=_reference_init)
    np.testing.assert_allclose(port_full.losses, want, atol=1e-4, rtol=1e-4)
    assert jstore.CheckpointStore(str(ref_dir)).list_steps() == [2, 4]
    assert CheckpointStore(str(port_dir)).list_steps() == [2, 4]
    for d in (ref_dir, port_dir):  # resume from step 2
        (d / "LATEST").write_text("2")
    port_resumed = train.main(argv + ["--ckpt-dir", str(ref_dir),
                                      "--resume"])
    ref_resumed = jtrain.train_actor(_reference_args(
        argv + ["--ckpt-dir", str(port_dir), "--resume"]))
    np.testing.assert_allclose(port_resumed.losses, want[2:], atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(ref_resumed, port_full.losses[2:], atol=1e-4,
                               rtol=1e-4)
