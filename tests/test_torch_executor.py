"""The port's schedule-table executor and ZeRO-1 AdamW against the reference.

One subprocess (JAX on 8 forced host devices) runs the reference's
``make_train_fn`` and ``make_optimizer`` on a 2 x 4 mesh: reduced
paper-gpt3-large with 8 layers, seq 16, 4 microbatches of 2 rows per data
shard, two steps under ``1f1b`` and ``zb``, once with ``io_grad_dtype``
and ``flat_dtype`` float32 (the reduced model is float32) and once at the
``ExecOptions`` defaults (bf16 io accumulators and reduce-scatter
payload); then the reference launcher's table loop writes a checkpoint at
step 2.  The port runs the same steps on its in-process mesh from the same
weights (carried across with ``models.convert``) and the same batches:

* float32: the loss within 1e-4 relative, every grad shard within 1e-4 of
  its leaf's max |g|, the params after 2 steps within 1e-4, and the
  2-step update itself (params after minus initial) within 1e-3 of its
  own norm in each leaf;
* defaults: the loss, params and update as above; a grad shard within one
  bf16 ulp
  of its leaf's max |g| (its payload is bf16: a float32 difference in the
  last bits may round the other way);
* the reference launcher (4 steps) checkpoints at steps 2 and 4.  Its
  step-2 checkpoint restores on every rank the ZeRO-1 shard that the
  reference's ``[S, dp_total * n]`` layout gives that rank, bitwise; the
  port's table loop resumes from it and runs steps 2 and 3, whose losses
  match the reference's within 1e-4 relative (the reference prints 4
  decimals: at most 5e-5 of that); step 3's loss and the port's step-4
  checkpoint depend on the restored master, m and v, and that checkpoint
  matches the reference's: params and master within 1e-4, m and v within
  one bf16 ulp of the leaf's max (the launcher runs at the bf16 defaults);
* a checkpoint of the port's table loop has the reference's leaves and
  shapes; the reference's step-2 checkpoint also resumes under ``--procs``
  (eight processes): steps 2 and 3 within 1e-4 relative, and its step-4
  checkpoint with the reference's leaves and shapes;
* the enc-dec forward: reduced seamless-m4t-large-v2 (2 encoder + 2
  decoder layers, one per stage) on the same 2 x 4 mesh, seq 16 and
  ``ExecOptions(enc_len=24)`` encoder frames (so the cross-attention has
  sq != sk), float32, two steps under ``1f1b`` and ``zb``: loss, grad
  shards, params after 2 steps and the 2-step update, at the float32
  yardsticks above;
* the MoE layouts over the data ranks: reduced deepseek-moe-16b (the
  dense layer and 3 MoE layers, one a stage) on the same 2 x 4 mesh, seq
  16, float32, two steps under ``1f1b`` and ``zb``, with its 8 experts
  (``tp``: every rank holds each expert's d_ff / 2 slice) and with 16
  (``ep``: 8 whole experts a rank): loss, grad shards, every routed
  expert's grad, params after 2 steps and the 2-step update, at the
  float32 yardsticks; and a table checkpoint of the ``ep`` run holds the
  reference's global shapes and restores every rank's shard bitwise;
* the mesh of processes (``launch/procs.py``, gloo, four processes): the
  reference also runs step 0 of reduced gpt3 on a 2 x 2 mesh (2 stages of
  4 layers, float32, 1f1b); the port runs it with one process per rank,
  each loading its own rank's weights with
  ``convert.rank_params_from_reference``: the loss within 1e-4 relative
  and every grad shard within 1e-4 of its leaf's max |g|.
"""
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.ckpt.store import CheckpointStore, _leaves_with_path
from repro_torch.configs import registry
from repro_torch.core.taskgraph import PipelineSpec
from repro_torch.data.synthetic import synth_batch
from repro_torch.launch import train
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.build import build
from repro_torch.models.convert import (
    rank_params_from_reference,
    rank_params_to_reference,
    zero1_state_to_reference,
)
from repro_torch.optim.adamw import AdamWConfig, make_optimizer
from repro_torch.pipeline import schedules
from repro_torch.pipeline.executor import (
    ExecOptions,
    make_train_fn,
    shard_batch,
)
from repro_torch.pipeline.sharding import partition_for

ROOT = Path(__file__).resolve().parents[1]
S, DATA, M, ROWS, SEQ, LAYERS = 4, 2, 4, 2, 16, 8
B = DATA * M * ROWS
MODES = ("float32", "default")
SCHEDULES = ("1f1b", "zb")
TABLE_ARGS = ["--runtime", "table", "--arch", "paper-gpt3-large",
              "--devices", str(DATA * S), "--stages", str(S), "--layers",
              str(LAYERS), "--microbatches", str(M), "--mb-rows", str(ROWS),
              "--seq", str(SEQ), "--steps", "4", "--schedule", "1f1b"]
TOL = 1e-4
#: the enc-dec case: reduced seamless with 4 layers (2 enc + 2 dec) and
#: ENC_LEN encoder frames per row against SEQ decoder tokens
ENC_DEC, ENC_DEC_LAYERS, ENC_LEN = "seamless-m4t-large-v2", 4, 24
#: the MoE cases: reduced deepseek-moe-16b with 4 layers (the dense one and
#: 3 MoE, one a stage), its 8 experts (``tp``) and 16 (``ep``)
MOE, MOE_LAYERS = "deepseek-moe-16b", 4
MOE_EXPERTS = {"tp": 8, "ep": 16}

REFERENCE = r"""
import contextlib, dataclasses, io as _io, json, os, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import registry
from repro.core.taskgraph import PipelineSpec
from repro.data.synthetic import synth_batch
from repro.launch import train as jtrain
from repro.launch.mesh import make_mesh
from repro.models.build import build
from repro.optim.adamw import AdamWConfig, make_optimizer
from repro.pipeline import schedules
from repro.pipeline.executor import ExecOptions, make_train_fn
from repro.pipeline.sharding import partition_for

out, S, DATA, M, ROWS, SEQ, LAYERS = sys.argv[1], *map(int, sys.argv[2:8])
table_args = json.loads(sys.argv[8])
enc_dec, enc_dec_layers, enc_len = json.loads(sys.argv[9])
moe_arch, moe_layers, moe_experts = json.loads(sys.argv[10])
B = DATA * M * ROWS
mesh = make_mesh(DATA, S)
ks = jax.tree_util.keystr
opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=1000)

def leaves(prefix, tree):
    return {prefix + ks(p): np.asarray(l.astype(jnp.float32))
            for p, l in jax.tree_util.tree_leaves_with_path(tree)}

def run(arch, layers, modes, tag, enc_len=0, experts=None):
    cfg = registry.reduced_config(arch, num_layers=layers)
    if experts is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=experts))
    model = build(cfg, num_stages=S)
    key = jax.random.key(0)
    sp = model.init_stage_params(key)
    io = model.init_io_params(jax.random.fold_in(key, 1))
    part = partition_for(model, sp, io)
    np.savez(os.path.join(out, f"{tag}init.npz"), **leaves("sp", sp),
             **leaves("io", io))
    batches = [synth_batch(cfg, B, SEQ, seed=0, step=s, enc_len=enc_len)
               for s in range(2)]
    for mode in modes:
        extra = (dict(io_grad_dtype=jnp.float32, flat_dtype=jnp.float32)
                 if mode == "float32" else {})
        init_fn, update_fn = map(jax.jit, make_optimizer(model, mesh, part,
                                                         opt_cfg))
        for sched in ("1f1b", "zb"):
            table = schedules.BUILDERS[sched](
                PipelineSpec(S, M, split_backward=(sched == "zb")))
            opts = ExecOptions(mb_rows=ROWS, seq_len=SEQ, enc_len=enc_len,
                               loss_scale=1.0 / (B * SEQ), **extra)
            fn = jax.jit(make_train_fn(model, table, mesh, opts, part)[0])
            st, p_sp, p_io, arrays = init_fn(sp, io), sp, io, {}
            for step in range(2):
                metrics, gs, eg = fn(p_sp, p_io, batches[step])
                arrays[f"loss{step}"] = np.asarray(metrics["loss"])
                if step == 0:
                    arrays.update({"grad" + k: np.asarray(
                        v.astype(jnp.float32)) for k, v in gs.items()})
                    arrays.update({"egrad" + k: np.asarray(
                        v.astype(jnp.float32)) for k, v in eg.items()})
                p_sp, p_io, st, stats = update_fn(
                    p_sp, p_io, st, gs, eg, jnp.asarray(step, jnp.int32))
                arrays[f"gnorm{step}"] = np.asarray(stats["gnorm"])
            arrays.update(leaves("sp", p_sp))
            arrays.update(leaves("io", p_io))
            np.savez(os.path.join(out, f"{tag}{mode}_{sched}.npz"), **arrays)

run("paper-gpt3-large", LAYERS, ("float32", "default"), "")
run(enc_dec, enc_dec_layers, ("float32",), "enc_dec_", enc_len)
for layout, experts in moe_experts.items():
    assert build(dataclasses.replace(
        registry.reduced_config(moe_arch, num_layers=moe_layers),
        moe=dataclasses.replace(registry.reduced_config(moe_arch).moe,
                                num_experts=experts)), S).moe_layout == layout
    run(moe_arch, moe_layers, ("float32",), f"moe_{layout}_",
        experts=experts)

# step 0 of gpt3 on a 2 x 2 mesh (the port's mesh of processes)
cfg = registry.reduced_config("paper-gpt3-large", num_layers=LAYERS)
model = build(cfg, num_stages=2)
key = jax.random.key(0)
sp = model.init_stage_params(key)
io = model.init_io_params(jax.random.fold_in(key, 1))
part = partition_for(model, sp, io)
mesh22 = make_mesh(2, 2)
table = schedules.BUILDERS["1f1b"](PipelineSpec(2, M))
opts = ExecOptions(mb_rows=ROWS, seq_len=SEQ, loss_scale=1.0 / (B * SEQ),
                   io_grad_dtype=jnp.float32, flat_dtype=jnp.float32)
fn = jax.jit(make_train_fn(model, table, mesh22, opts, part)[0])
metrics, gs, _ = fn(sp, io, synth_batch(cfg, B, SEQ, seed=0, step=0))
np.savez(os.path.join(out, "procs_2x2.npz"), loss0=np.asarray(
    metrics["loss"]), **{"grad" + k: np.asarray(v.astype(jnp.float32))
                         for k, v in gs.items()},
    **leaves("sp", sp), **leaves("io", io))

# the reference launcher's table loop, checkpointing at step 2
sys.argv = ["train"] + table_args + ["--ckpt-dir", os.path.join(out, "ck"),
                                     "--ckpt-every", "2"]
buf = _io.StringIO()
with contextlib.redirect_stdout(buf):
    jtrain.main()
steps = {int(m[0]): float(m[1]) for m in
         __import__("re").findall(r"step +(\d+) +loss +([-\d.]+)",
                                  buf.getvalue())}
json.dump(steps, open(os.path.join(out, "launcher_losses.json"), "w"))
print(buf.getvalue())
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory) -> Path:
    d = tmp_path_factory.mktemp("reference_table")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(d),
         *map(str, (S, DATA, M, ROWS, SEQ, LAYERS)),
         json.dumps(TABLE_ARGS),
         json.dumps([ENC_DEC, ENC_DEC_LAYERS, ENC_LEN]),
         json.dumps([MOE, MOE_LAYERS, MOE_EXPERTS])],
        env=env, capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return d


def _tree(arrays, prefix: str) -> dict:
    """The nested tree of ``prefix + keystr`` entries."""
    out: dict = {}
    for k in arrays.files:
        if not k.startswith(prefix):
            continue
        *parents, last = re.findall(r"\['([^']*)'\]", k[len(prefix):])
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = arrays[k]
    return out


_PORT: dict = {}


def _config(tag: str):
    """The reduced config of a case: ``""`` gpt3, ``"enc_dec_"`` seamless,
    ``"moe_tp_"``/``"moe_ep_"`` deepseek-moe with MOE_EXPERTS experts."""
    if tag == "enc_dec_":
        return registry.reduced_config(ENC_DEC, ENC_DEC_LAYERS)
    if tag.startswith("moe_"):
        cfg = registry.reduced_config(MOE, MOE_LAYERS)
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=MOE_EXPERTS[tag[4:6]]))
    return registry.reduced_config("paper-gpt3-large", LAYERS)


def _port_run(reference: Path, mode: str, sched: str, tag: str = "") -> dict:
    """The port's two steps of ``mode``/``sched`` from the reference's
    initial weights (cached per module) of case ``tag`` (:func:`_config`;
    the enc-dec case with ENC_LEN encoder frames)."""
    if (mode, sched, tag) in _PORT:
        return _PORT[mode, sched, tag]
    enc_len = ENC_LEN if tag == "enc_dec_" else 0
    init = np.load(reference / f"{tag}init.npz")
    cfg = _config(tag)
    model = build(cfg, num_stages=S)
    mesh = make_mesh(DATA, S, device="cpu")
    sps, ios = rank_params_from_reference(model, mesh, _tree(init, "sp"),
                                          _tree(init, "io"), "cpu")
    part = partition_for(model, sps[0], ios[0])
    extra = (dict(io_grad_dtype=torch.float32, flat_dtype=torch.float32)
             if mode == "float32" else {})
    table = schedules.BUILDERS[sched](
        PipelineSpec(S, M, split_backward=(sched == "zb")))
    fn, specs = make_train_fn(model, table, mesh, ExecOptions(
        mb_rows=ROWS, seq_len=SEQ, enc_len=enc_len,
        loss_scale=1.0 / (B * SEQ), **extra), part)
    init_fn, update_fn = make_optimizer(
        model, mesh, part, AdamWConfig(lr=1e-3, warmup_steps=20,
                                       total_steps=1000))
    state = mesh.run(init_fn, list(zip(sps, ios)))
    res: dict = {"losses": [], "gnorms": []}
    for step in range(2):
        batch = {k: torch.from_numpy(v) if k == "enc_embeds"
                 else torch.from_numpy(v).long() for k, v in
                 synth_batch(cfg, B, SEQ, seed=0, step=step,
                             enc_len=enc_len).items()}
        shards = shard_batch(mesh, batch, specs)
        out = mesh.run(fn, [(sps[r], ios[r], shards[r])
                            for r in range(mesh.size)])
        res["losses"].append(float(out[0][0]["loss"]))
        if step == 0:
            g = zero1_state_to_reference(
                model, mesh, part, [{"shards": {k: {"g": g} for k, g in
                                                o[1].items()},
                                     "experts": {k: {"g": g} for k, g in
                                                 o[2].items()}}
                                    for o in out])
            res["grads"], res["expert_grads"] = g["shards"], g["experts"]
        stats = mesh.run(update_fn, [
            (sps[r], ios[r], state[r], out[r][1], out[r][2], step)
            for r in range(mesh.size)])
        res["gnorms"].append(float(stats[0]["gnorm"]))
    res["params"] = rank_params_to_reference(model, mesh, sps, ios)
    _PORT[mode, sched, tag] = res
    return res


CASES = [(m, s) for m in MODES for s in SCHEDULES]


def _check_loss_and_gnorm(reference, mode, sched, tag=""):
    ref = np.load(reference / f"{tag}{mode}_{sched}.npz")
    got = _port_run(reference, mode, sched, tag)
    for step in range(2):
        want = float(ref[f"loss{step}"])
        assert abs(got["losses"][step] - want) <= TOL * abs(want), step
        gn = float(ref[f"gnorm{step}"])
        assert abs(got["gnorms"][step] - gn) <= TOL * gn, step


@pytest.mark.parametrize("mode,sched", CASES)
def test_loss_and_gnorm_match_reference(reference, mode, sched):
    _check_loss_and_gnorm(reference, mode, sched)


def _bf16_ulp(x: float) -> float:
    """One bfloat16 ulp at magnitude ``x`` (8 significand bits)."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def _check_grad_shards(reference, mode, sched, tag=""):
    ref = np.load(reference / f"{tag}{mode}_{sched}.npz")
    run = _port_run(reference, mode, sched, tag)
    for prefix, got in (("grad", run["grads"]),
                        ("egrad", run["expert_grads"])):
        want_keys = [k[len(prefix):] for k in ref.files
                     if k.startswith(prefix)]
        assert sorted(got) == sorted(want_keys), prefix
        for k in want_keys:
            a, b = got[k]["g"].astype(np.float32), ref[prefix + k]
            # [S, dp_total * n]; an expert grad [S, l_max, ...] (global)
            assert a.shape == b.shape, k
            scale = float(np.abs(b).max())
            tol = TOL * scale if mode == "float32" else _bf16_ulp(scale)
            assert float(np.abs(a - b).max()) <= tol, k


@pytest.mark.parametrize("mode,sched", CASES)
def test_grad_shards_match_reference(reference, mode, sched):
    _check_grad_shards(reference, mode, sched)


def _check_params_after_two_steps(reference, mode, sched, tag=""):
    ref = np.load(reference / f"{tag}{mode}_{sched}.npz")
    init = np.load(reference / f"{tag}init.npz")
    sp, io = _port_run(reference, mode, sched, tag)["params"]
    n = 0
    for prefix, tree in (("sp", sp), ("io", io)):
        for k, v in _leaves_with_path(tree):
            want = ref[prefix + k]
            assert float(np.abs(v - want).max()) <= TOL, k
            d_ref = want.astype(np.float64) - init[prefix + k]
            d_port = v.astype(np.float64) - init[prefix + k]
            assert (np.linalg.norm(d_port - d_ref)
                    <= 1e-3 * np.linalg.norm(d_ref)), k
            n += 1
    assert n == sum(1 for k in ref.files if k.startswith(("sp", "io")))


@pytest.mark.parametrize("mode,sched", CASES)
def test_params_after_two_steps_match_reference(reference, mode, sched):
    """The params within 1e-4, and the update itself within 1e-3 of its
    norm: the update is about lr, so the 1e-4 bound alone would pass an
    optimizer with half the learning rate.  The update is held in norm,
    not element by element: where a gradient is rounding noise in both
    packages (softmax's shift invariance leaves directions of wq and wk
    with no true gradient), Adam scales the noise up to +-lr."""
    _check_params_after_two_steps(reference, mode, sched)


@pytest.mark.parametrize("sched", SCHEDULES)
def test_enc_dec_loss_and_gnorm_match_reference(reference, sched):
    _check_loss_and_gnorm(reference, "float32", sched, "enc_dec_")


@pytest.mark.parametrize("sched", SCHEDULES)
def test_enc_dec_grad_shards_match_reference(reference, sched):
    _check_grad_shards(reference, "float32", sched, "enc_dec_")


@pytest.mark.parametrize("sched", SCHEDULES)
def test_enc_dec_params_after_two_steps_match_reference(reference, sched):
    """As the gpt3 cases: params within 1e-4, the update within 1e-3 of
    its norm in each leaf (the encoder's, the cross-attention's)."""
    _check_params_after_two_steps(reference, "float32", sched,
                                  "enc_dec_")


MOE_CASES = [(layout, s) for layout in sorted(MOE_EXPERTS)
             for s in SCHEDULES]


@pytest.mark.parametrize("layout,sched", MOE_CASES)
def test_moe_loss_and_gnorm_match_reference(reference, layout, sched):
    """deepseek-moe on 2 x 4 under ``tp`` (8 experts) and ``ep`` (16): the
    exchanges over the data ranks against the reference's, float32."""
    _check_loss_and_gnorm(reference, "float32", sched, f"moe_{layout}_")


@pytest.mark.parametrize("layout,sched", MOE_CASES)
def test_moe_grad_shards_match_reference(reference, layout, sched):
    """Every ZeRO-1 grad shard and every routed expert's grad (each rank's
    shard, concatenated over the data ranks)."""
    _check_grad_shards(reference, "float32", sched, f"moe_{layout}_")


@pytest.mark.parametrize("layout,sched", MOE_CASES)
def test_moe_params_after_two_steps_match_reference(reference, layout,
                                                    sched):
    """The params, the experts' shards among them, within 1e-4 after 2
    steps, and the 2-step update within 1e-3 of its norm."""
    _check_params_after_two_steps(reference, "float32", sched,
                                  f"moe_{layout}_")


def test_moe_table_checkpoint_round_trips_the_expert_shards(reference,
                                                            tmp_path):
    """A table checkpoint of an ``ep`` run (16 experts, 8 a data rank)
    holds the reference's global shapes (those of its own initial
    weights) for every stage leaf and expert moment, and restoring it
    into a fresh trainer gives every rank its shard, its replicated
    leaves and its ZeRO-1 state back bitwise."""
    argv = ["--runtime", "table", "--device", "cpu", "--arch", MOE,
            "--devices", str(DATA * S), "--stages", str(S), "--layers",
            str(MOE_LAYERS), "--microbatches", str(M), "--mb-rows",
            str(ROWS), "--seq", str(SEQ), "--schedule", "1f1b"]
    cfg = _config("moe_ep_")
    run = train.train_table(train.parser().parse_args(
        argv + ["--steps", "2", "--ckpt-dir", str(tmp_path),
                "--ckpt-every", "2"]), cfg=cfg)
    t = run.trainer
    init = np.load(reference / "moe_ep_init.npz")
    with np.load(tmp_path / "step_2" / "shard_0.npz") as saved:
        n = 0
        for k in init.files:
            if not k.startswith("sp"):
                continue
            leaf = k[2:]
            assert saved["['stage_params']" + leaf].shape == init[k].shape
            if t["partition"].stage_data_sharded[leaf]:
                for name in ("m", "v"):
                    assert saved[f"['opt_state']['experts'][{leaf!r}]"
                                 f"['{name}']"].shape == init[k].shape
                n += 1
        assert n == 3  # wi, wg, wo
    fresh = train.build_trainer(
        MOE, data=DATA, stages=S, layers=MOE_LAYERS, mb_rows=ROWS,
        microbatches=M, seq=SEQ, schedule="1f1b", device="cpu", cfg=cfg)
    train._table_restore(fresh, CheckpointStore(str(tmp_path)), 2)
    for r in range(t["mesh"].size):
        for mods in ("stage_params", "io_params"):
            for a, b in zip(t[mods][r].parameters(),
                            fresh[mods][r].parameters(), strict=True):
                assert a.shape == b.shape and torch.equal(a, b), (r, mods)
        for kind in ("shards", "experts"):
            want = t["opt_state"][r][kind]
            got = fresh["opt_state"][r][kind]
            assert sorted(got) == sorted(want)
            for k, st in want.items():
                for name, v in st.items():
                    assert torch.equal(got[k][name], v), (r, kind, k, name)


def _step_2_checkpoint(reference: Path, tmp_path: Path) -> Path:
    """A copy of the reference's checkpoint directory holding only step 2."""
    ck = tmp_path / "ck"
    ck.mkdir()
    shutil.copytree(reference / "ck" / "step_2", ck / "step_2")
    (ck / "LATEST").write_text("2")
    return ck


def test_reference_checkpoint_restores_each_ranks_shard(reference,
                                                        tmp_path):
    ck = _step_2_checkpoint(reference, tmp_path)
    run = train.main(TABLE_ARGS + ["--device", "cpu", "--ckpt-dir", str(ck),
                                   "--resume", "--steps", "2"])
    assert run.ckpt_log[0]["op"] == "resume" and run.losses == []
    t = run.trainer
    with np.load(ck / "step_2" / "shard_0.npz") as saved:
        for r, state in enumerate(t["opt_state"]):
            c = t["mesh"].coords(r)
            assert not state["experts"]
            for k, st in state["shards"].items():
                assert sorted(st) == ["m", "master", "v"], k
                for name, got in st.items():
                    a = saved[f"['opt_state']['shards'][{k!r}]['{name}']"]
                    want = a[c["model"]].reshape(DATA, -1)[c["data"]]
                    np.testing.assert_array_equal(got.numpy(), want,
                                                  err_msg=f"{r} {k} {name}")


def test_reference_checkpoint_resumes_in_the_port(reference, tmp_path):
    ck = _step_2_checkpoint(reference, tmp_path)
    want = json.loads((reference / "launcher_losses.json").read_text())
    run = train.main(TABLE_ARGS + ["--device", "cpu", "--ckpt-dir", str(ck),
                                   "--resume", "--ckpt-every", "2"])
    assert run.ckpt_log[0]["op"] == "resume" and len(run.losses) == 2
    for loss, step in zip(run.losses, ("2", "3")):
        assert abs(loss - want[step]) <= TOL * abs(want[step]), step
    with np.load(ck / "step_4" / "shard_0.npz") as a, \
            np.load(reference / "ck" / "step_4" / "shard_0.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            err = float(np.abs(a[k] - b[k]).max())
            if k.endswith(("['m']", "['v']")):
                assert err <= _bf16_ulp(float(np.abs(b[k]).max())), k
            else:
                assert err <= TOL, k


def test_reference_checkpoint_resumes_under_procs(reference, tmp_path):
    """The reference's step-2 checkpoint through ``--procs`` (eight
    processes, gloo): rank 0 reads it and moves each rank its own state;
    steps 2 and 3 match the reference launcher's within TOL, and the
    step-4 checkpoint, gathered through rank 0's host, has the
    reference's leaves and shapes."""
    ck = _step_2_checkpoint(reference, tmp_path)
    want = json.loads((reference / "launcher_losses.json").read_text())
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run = train.main(TABLE_ARGS + ["--device", "cpu", "--ckpt-dir",
                                       str(ck), "--resume", "--ckpt-every",
                                       "2", "--procs"])
    finally:
        torch.set_num_threads(n)
    assert run.ckpt_log[0]["op"] == "resume" and len(run.losses) == 2
    assert len(run.ranks) == DATA * S
    for loss, step in zip(run.losses, ("2", "3")):
        assert abs(loss - want[step]) <= TOL * abs(want[step]), step
    mine = json.loads((ck / "step_4" / "manifest.json").read_text())
    theirs = json.loads(
        (reference / "ck" / "step_4" / "manifest.json").read_text())
    assert mine["leaves"] == theirs["leaves"] and mine["shards"] == 1
    with np.load(ck / "step_4" / "shard_0.npz") as a, \
            np.load(reference / "ck" / "step_4" / "shard_0.npz") as b:
        for k in theirs["leaves"]:
            assert a[k].shape == b[k].shape, k


def test_port_checkpoint_has_the_reference_leaves(reference, tmp_path):
    run = train.main(TABLE_ARGS + ["--device", "cpu", "--steps", "2",
                                   "--ckpt-dir", str(tmp_path),
                                   "--ckpt-every", "2"])
    assert [e["op"] for e in run.ckpt_log] == ["save"]
    mine = json.loads((tmp_path / "step_2" / "manifest.json").read_text())
    theirs = json.loads(
        (reference / "ck" / "step_2" / "manifest.json").read_text())
    assert mine["leaves"] == theirs["leaves"]
    with np.load(tmp_path / "step_2" / "shard_0.npz") as a, \
            np.load(reference / "ck" / "step_2" / "shard_0.npz") as b:
        for k in theirs["leaves"]:
            assert a[k].shape == b[k].shape, k


def test_a_mesh_of_processes_matches_the_reference(reference):
    """Step 0 of reduced gpt3 on a 2 x 2 mesh of four processes (gloo),
    each rank loading its own weights from the reference's
    (``convert.rank_params_from_reference`` on its ``ProcessMesh``): the
    loss and every ZeRO-1 grad shard against the reference's 2 x 2
    ``make_train_fn``, at the float32 yardsticks."""
    from repro_torch.launch import mesh_probes
    from repro_torch.launch.procs import spawn_world

    ref = np.load(reference / "procs_2x2.npz")
    cfg = registry.reduced_config("paper-gpt3-large", LAYERS)
    f32 = dict(io_grad_dtype=torch.float32, flat_dtype=torch.float32)
    got = mesh_probes.merge(spawn_world(
        mesh_probes.reference_step,
        (cfg, "1f1b", M, ROWS, SEQ, _tree(ref, "sp"), _tree(ref, "io"), f32),
        4, shape={"data": 2, "model": 2}, device="cpu", deadline=60.0,
        threads=1))
    want = float(ref["loss0"])
    for r in range(4):
        assert abs(got[r]["loss"] - want) <= TOL * abs(want), r
    model = build(cfg, num_stages=2)
    mesh = make_mesh(2, 2, device="cpu")
    sps, ios = rank_params_from_reference(model, mesh, _tree(ref, "sp"),
                                          _tree(ref, "io"), "cpu")
    part = partition_for(model, sps[0], ios[0])
    grads = zero1_state_to_reference(model, mesh, part, [
        {"shards": {k: {"g": g} for k, g in got[r]["grads"].items()},
         "experts": {}} for r in range(4)])["shards"]
    want_keys = [k[4:] for k in ref.files if k.startswith("grad")]
    assert sorted(grads) == sorted(want_keys)
    for k in want_keys:
        a, b = grads[k]["g"].astype(np.float32), ref["grad" + k]
        assert a.shape == b.shape, k
        assert float(np.abs(a - b).max()) <= TOL * float(np.abs(b).max()), k
