"""The port's parameter partition and ZeRO-1 state against the reference.

* ``partition_for``: leaf names, order, data-sharded flags and layouts are
  the reference's (``jax.tree_util.keystr`` of its stacked trees) for
  every decoder family, the MoE layouts included;
* ``flatten_replicated`` / ``unflatten_replicated`` / ``replicated_size``
  agree with the reference's on the same leaves;
* ZeRO-1 state converts to the reference's global layout and back;
* at ``data == 1`` with no clipping, a ZeRO-1 step equals the actor
  runtime's AdamW (``make_host_update``) on the same grads, expert leaves
  (their local ``m``/``v``) included;
* a table checkpoint resumed in the port continues bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models.build import build as jbuild
from repro.pipeline import executor as jexecutor
from repro.pipeline import sharding as jsharding
from repro_torch.configs import registry
from repro_torch.data.synthetic import synth_batch
from repro_torch.launch import train
from repro_torch.models.build import build
from repro_torch.models.convert import (
    zero1_state_from_reference,
    zero1_state_to_reference,
)
from repro_torch.optim.adamw import make_host_update, make_optimizer
from repro_torch.pipeline import sharding
from repro_torch.pipeline.executor import (
    ExecOptions,
    grad_shard_specs,
    shard_batch,
)

ARCHS = ["deepseek-7b", "zamba2-1.2b", "xlstm-350m", "qwen2-vl-2b",
         "gemma3-4b", "deepseek-moe-16b", "grok-1-314b"]


def _models(arch: str, layers: int = 4, stages: int = 2):
    cj, ct = jreg.reduced_config(arch, layers), registry.reduced_config(
        arch, layers)
    if arch == "zamba2-1.2b":  # Mamba layers and the shared block
        cj = dataclasses.replace(cj, layer_pattern=("mamba",) * layers)
        ct = dataclasses.replace(ct, layer_pattern=("mamba",) * layers)
    return jbuild(cj, stages), build(ct, stages)


@pytest.mark.parametrize("arch,layout", [(a, None) for a in ARCHS] + [
    ("deepseek-moe-16b", "ep"), ("grok-1-314b", "tp"),
    ("deepseek-moe-16b", "none")])
def test_partition_matches_the_reference(arch, layout):
    model_j, model_t = _models(arch)
    if layout is not None:
        model_j = dataclasses.replace(model_j, moe_layout=layout)
        model_t = dataclasses.replace(model_t, moe_layout=layout)
    key = jax.random.key(0)
    sp = jax.eval_shape(model_j.init_stage_params, key)
    io = jax.eval_shape(model_j.init_io_params, key)
    pj = jsharding.partition_for(model_j, sp, io)
    pt = sharding.partition_for(model_t, model_t.init_stage_params(
        0, device="cpu"), model_t.init_io_params(device="cpu"))
    ks = jax.tree_util.keystr
    specs = jax.tree_util.tree_leaves_with_path(
        pj.stage_specs, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
    assert list(pt.stage_keys) == [ks(p) for p, _ in specs]
    assert [pt.stage_specs[k] for k in pt.stage_keys] == [
        tuple(s) for _, s in specs]
    assert [pt.stage_data_sharded[k] for k in pt.stage_keys] == \
        jax.tree.leaves(pj.stage_data_sharded)
    assert list(pt.io_keys) == [
        ks(p) for p, _ in jax.tree_util.tree_leaves_with_path(io)]
    sharded = any(pt.stage_data_sharded.values())
    assert sharded == (model_t.cfg.moe is not None
                       and model_t.moe_layout != "none")
    for multi_pod in (False, True):
        want = jexecutor.grad_shard_specs(model_j, pj, jexecutor.ExecOptions(
            mb_rows=1, seq_len=16, multi_pod=multi_pod))
        got = grad_shard_specs(model_t, pt, ExecOptions(
            mb_rows=1, seq_len=16, multi_pod=multi_pod))
        assert list(got) == list(want)
        assert all(jax.sharding.PartitionSpec(*got[k]) == s
                   for k, s in want.items())


def test_flat_helpers_match_the_reference():
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 5), "b": (7,), "c": (2, 2, 2)}
    arrays = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    flags = {"a": False, "b": True, "c": False}
    leaves = {k: torch.from_numpy(v) for k, v in arrays.items()}
    vec = sharding.flatten_replicated(leaves, flags, pad_to=4)
    want = jsharding.flatten_replicated(arrays, flags, pad_to=4)
    np.testing.assert_array_equal(vec.numpy(), np.asarray(want))
    assert sharding.replicated_size(leaves, flags) == \
        jsharding.replicated_size(arrays, flags) == 23
    back = sharding.unflatten_replicated(vec * 2, leaves, flags)
    want = jsharding.unflatten_replicated(jnp.asarray(want) * 2, arrays,
                                          flags)
    for k in shapes:
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(want[k]))


def _trainer(arch="paper-gpt3-large", data=2, **kw):
    cfg = registry.reduced_config(arch, 4)
    return train.build_trainer(arch, data=data, stages=2, layers=4,
                               mb_rows=1, microbatches=2, seq=16,
                               schedule="1f1b", device="cpu", cfg=cfg, **kw)


@pytest.mark.parametrize("arch,data", [("paper-gpt3-large", 2),
                                       ("deepseek-moe-16b", 1)])
def test_zero1_state_round_trips_through_the_reference_layout(arch, data):
    t = _trainer(arch, data)
    batch = train._device_batch(synth_batch(t["cfg"], t["batch_size"], 16,
                                            seed=0, step=0), "cpu")
    t["train_step"](batch, 0)  # nonzero m and v
    mesh, model, part = t["mesh"], t["model"], t["partition"]
    tree = zero1_state_to_reference(model, mesh, part, t["opt_state"])
    n = {k: sum(p.numel() for p in v) for k, v in
         part.stage_leaves(t["stage_params"][0].parameters()).items()}
    for k, st in tree["shards"].items():
        if not k.startswith("io:"):
            # [S, dp * ceil(n / dp)]: one padded flat leaf per stage
            assert st["master"].shape == (2, -(-n[k] // data) * data)
    assert bool(tree["experts"]) == (arch == "deepseek-moe-16b")
    back = zero1_state_from_reference(model, mesh, part, tree, "cpu")
    for r, st in enumerate(t["opt_state"]):
        for group in ("shards", "experts"):
            for k, leaf in st[group].items():
                for name, v in leaf.items():
                    assert torch.equal(back[r][group][k][name], v)


@pytest.mark.parametrize("arch", ["paper-gpt3-large", "deepseek-moe-16b"])
def test_zero1_step_equals_host_adamw_without_clipping(arch):
    t = _trainer(arch, 1)
    mesh, part = t["mesh"], t["partition"]
    cfg = dataclasses.replace(t["opt_cfg"], grad_clip=1e9)
    init_fn, update_fn = make_optimizer(t["model"], mesh, part, cfg)
    sps, ios = t["stage_params"], t["io_params"]
    before = [[p.detach().clone() for p in list(sp.parameters())
               + list(io.parameters())] for sp, io in zip(sps, ios)]
    state = mesh.run(init_fn, list(zip(sps, ios)))
    batch = train._device_batch(synth_batch(t["cfg"], t["batch_size"], 16,
                                            seed=0, step=0), "cpu")
    shards = shard_batch(mesh, batch, t["batch_specs"])
    out = mesh.run(t["exec_fn"], [(sps[r], ios[r], shards[r])
                                  for r in range(mesh.size)])
    mesh.run(update_fn, [(sps[r], ios[r], state[r], out[r][1], out[r][2], 0)
                         for r in range(mesh.size)])
    apply = make_host_update(cfg)
    for r in range(mesh.size):
        params = [p.clone() for p in before[r]]
        n_stage = len(list(sps[r].parameters()))
        grads = [None] * len(params)
        leaves = part.stage_leaves(range(n_stage))
        for k, idx in leaves.items():
            g = (out[r][2][k].reshape(-1) if part.stage_data_sharded[k]
                 else out[r][1][k])
            off = 0
            for i in idx:
                n = params[i].numel()
                grads[i] = g[off:off + n].reshape(params[i].shape)
                off += n
        for k, i in part.io_leaves(range(len(params) - n_stage)).items():
            n = params[n_stage + i].numel()
            grads[n_stage + i] = out[r][1]["io:" + k][:n].reshape(
                params[n_stage + i].shape)
        m = [torch.zeros(p.shape) for p in params]
        v = [torch.zeros(p.shape) for p in params]
        apply(params, grads, m, v, 0)
        got = list(sps[r].parameters()) + list(ios[r].parameters())
        for a, b in zip(got, params):
            np.testing.assert_allclose(a.detach().numpy(), b.numpy(),
                                       atol=1e-7, rtol=0)


@pytest.mark.parametrize("arch,data", [("paper-gpt3-large", 2),
                                       ("deepseek-moe-16b", 1)])
def test_table_checkpoint_resume_continues_bit_for_bit(arch, data, tmp_path):
    args = ["--runtime", "table", "--device", "cpu", "--arch", arch,
            "--devices", str(2 * data), "--stages", "2", "--layers", "4",
            "--microbatches", "2", "--seq", "16", "--schedule", "1f1b",
            "--steps", "3"]
    whole = train.main(args)
    train.main(args[:-1] + ["2", "--ckpt-dir", str(tmp_path),
                            "--ckpt-every", "2"])
    resumed = train.main(args + ["--ckpt-dir", str(tmp_path), "--resume"])
    assert resumed.losses == whole.losses[2:]
    assert resumed.gnorms == whole.gnorms[2:]
