"""The port's cell matrix (``launch/cells.py``) and dry run
(``launch/dryrun.py``) against the reference's.

* Every cell of ``all_cells()`` on both production mesh shapes:
  ``plan_cell`` equals the reference's field by field, and ``input_specs``
  and ``cache_struct`` have the reference's shapes and dtypes under
  ``cells.BATCH_DTYPES``.
* ``build_cell`` on a small CPU mesh: a reduced paper-gpt3-large
  ``train_4k`` plan on 2 x 2 gives ``build_trainer``'s step-0 loss and
  grad shards bit for bit; a reduced gemma3-4b ``long_500k`` plan on 2 x 2
  (``sp_mode``: batch 1 on two data ranks) gives ``make_serve_fn``'s
  tokens bit for bit; the zamba2-1.2b ``long_500k`` plan is refused.
* ``dryrun_cell`` on deepseek-7b ``train_4k``, gemma3-4b ``long_500k`` and
  seamless ``decode_32k`` allocates nothing (every tensor it makes is a
  meta tensor); zamba2 ``long_500k`` is refused with the reference's line
  named; and ``step_collectives`` of a reduced plan equals ``Mesh.counts``
  of a real run of the cell's step function on a small CPU mesh.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.analysis.roofline import ProductionMeshShape as JMeshShape
from repro.launch import cells as jcells
from repro_torch.analysis.roofline import ProductionMeshShape
from repro_torch.configs import registry
from repro_torch.data.synthetic import synth_batch
from repro_torch.launch import cells, dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import _device_batch, build_trainer, rank_params
from repro_torch.models.build import build
from repro_torch.models.convert import rank_caches_from_reference
from repro_torch.pipeline.decode import cache_specs, make_serve_fn
from repro_torch.pipeline.executor import shard_batch

CELLS = jcells.all_cells()
MESHES = {"16x16": False, "2x16x16": True}
MATRIX = [(a, s, m) for a, s in CELLS for m in MESHES]


def _plans(arch, shape, mesh):
    mp = MESHES[mesh]
    return (cells.plan_cell(arch, shape, ProductionMeshShape(mp)),
            jcells.plan_cell(arch, shape, JMeshShape(mp)))


def test_cell_matrix_is_the_reference_matrix():
    assert cells.all_cells() == CELLS and len(CELLS) == 33
    assert cells._BF16_GRAD_ARCHS == jcells._BF16_GRAD_ARCHS
    for arch in registry.ARCHS:
        for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            assert cells.cell_is_runnable(arch, shape) == \
                jcells.cell_is_runnable(arch, shape)


@pytest.mark.parametrize("arch,shape,mesh", MATRIX)
def test_plan_cell_equals_the_reference(arch, shape, mesh):
    p, j = _plans(arch, shape, mesh)
    for f in dataclasses.fields(jcells.CellPlan):
        if f.name == "model":
            continue
        a, b = getattr(p, f.name), getattr(j, f.name)
        if f.name == "cell":  # each package's ShapeCell
            a, b = dataclasses.astuple(a), dataclasses.astuple(b)
        assert a == b, f.name
    assert p.tokens_per_step == j.tokens_per_step
    m, jm = p.model, j.model
    assert (m.num_stages, m.l_max, m.layer_types, m.moe_layout) == \
        (jm.num_stages, jm.l_max, jm.layer_types, jm.moe_layout)
    for k in ("counts", "type_ids", "shared_flags"):
        np.testing.assert_array_equal(getattr(m, k), getattr(jm, k))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         prefix + (k,))]
    return [(prefix, tuple(tree.shape), tree.dtype)]


def _torch_dtype(jdtype):
    return getattr(torch, jnp.dtype(jdtype).name)


@pytest.mark.parametrize("arch,shape,mesh", MATRIX)
def test_input_specs_and_caches_are_the_references(arch, shape, mesh):
    p, j = _plans(arch, shape, mesh)
    got, want = cells.input_specs(p), jcells.input_specs(j)
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[k].shape), k
        # int32 token ids are the port's int64; the rest keep their dtype
        assert t.dtype == cells.BATCH_DTYPES[k]
        assert want[k].dtype == (jnp.int32 if k in ("tokens", "labels",
                                                     "mrope")
                                 else jnp.float32)
    if p.step != "decode":
        return
    got = _leaves(cells.cache_struct(p))
    want = _leaves(jcells.cache_struct(j))
    assert [(k, s) for k, s, _ in got] == [(k, s) for k, s, _ in want]
    assert [d for _, _, d in got] == [_torch_dtype(d) for _, _, d in want]


# ---------------------------------------------------------------------------
# build_cell on a small CPU mesh
# ---------------------------------------------------------------------------
def _reduced_train_plan(arch, mesh, *, layers=4, seq=8, rows=2, cfg=None):
    """The ``train_4k`` plan of ``arch`` on ``mesh``, cut to a reduced
    config of ``layers`` layers, ``seq`` tokens and ``rows`` one-row
    microbatches a data rank (the global batch to match)."""
    plan = cells.plan_cell(arch, "train_4k", mesh,
                           num_stages=mesh.shape["model"])
    cfg = cfg or registry.reduced_config(arch, num_layers=layers)
    return dataclasses.replace(
        plan, model=build(cfg, num_stages=mesh.shape["model"]), seq_len=seq,
        num_microbatches=rows,
        cell=dataclasses.replace(plan.cell,
                                 global_batch=rows * plan.dp_total))


def _reduced_decode_plan(arch, shape, mesh, *, layers=4, cache=16,
                         batch=None):
    plan = cells.plan_cell(arch, shape, mesh, num_stages=mesh.shape["model"])
    cfg = registry.reduced_config(arch, num_layers=layers)
    cell = dataclasses.replace(plan.cell, seq_len=cache,
                               global_batch=batch or plan.cell.global_batch)
    plan = dataclasses.replace(
        plan, model=build(cfg, num_stages=mesh.shape["model"]), cell=cell,
        seq_len=cache, enc_len=cache if cfg.encoder_layers else 0)
    if not plan.sp_mode:
        plan = dataclasses.replace(
            plan, num_microbatches=cell.global_batch // plan.dp_total)
    return plan


def _train_batch(plan, mesh, specs):
    cfg = plan.model.cfg
    arrays = synth_batch(cfg, plan.cell.global_batch, plan.seq_len, seed=3,
                         enc_len=plan.enc_len)
    return shard_batch(mesh, _device_batch(arrays, "cpu"), specs)


def _rank_caches(plan, mesh):
    """Seeded caches of a decode plan, each rank's shard."""
    rng = np.random.default_rng(5)

    def fill(tree):
        if isinstance(tree, dict):
            return {k: fill(v) for k, v in tree.items()}
        dtype = str(tree.dtype).split(".")[1]
        return rng.standard_normal(tuple(tree.shape)).astype(dtype) * 0.5

    specs = cache_specs(plan.model, cells.decode_options(plan))
    return rank_caches_from_reference(plan.model, mesh,
                                      fill(cells.cache_struct(plan)), specs,
                                      "cpu")


def _decode_batch(plan, mesh, specs, step):
    tokens = torch.tensor([(7 * step + 3 * i) % plan.model.cfg.vocab_size
                           for i in range(plan.cell.global_batch)])
    return shard_batch(mesh, {"tokens": tokens}, specs)


def test_build_cell_train_is_build_trainer_bit_for_bit():
    t = build_trainer("paper-gpt3-large", data=2, stages=2, layers=4,
                      mb_rows=1, microbatches=2, seq=8, schedule="1f1b",
                      device="cpu")
    mesh = t["mesh"]
    plan = _reduced_train_plan("paper-gpt3-large", mesh, cfg=t["cfg"])
    assert plan.tokens_per_step == 2 * 2 * 8
    fn, (sp_s, io_s, specs_in), specs = cells.build_cell(plan, mesh)
    assert [tuple(p.shape) for p in sp_s[0].parameters()] == \
        [tuple(p.shape) for p in t["stage_params"][0].parameters()]
    shards = _train_batch(plan, mesh, specs)
    args = [(t["stage_params"][r], t["io_params"][r], shards[r])
            for r in range(mesh.size)]
    got = mesh.run(fn, args)
    want = mesh.run(t["exec_fn"], args)
    for (gm, gs, ge), (wm, ws, we) in zip(got, want):
        assert torch.equal(gm["loss"], wm["loss"])
        assert sorted(gs) == sorted(ws) and not ge and not we
        for k in gs:
            assert torch.equal(gs[k], ws[k]), k


def test_build_cell_sp_decode_is_make_serve_fn_bit_for_bit():
    mesh = make_mesh(2, 2, device="cpu")
    plan = _reduced_decode_plan("gemma3-4b", "long_500k", mesh, layers=4,
                                cache=32)
    assert plan.sp_mode and plan.num_microbatches == 1
    fn, args, specs = cells.build_cell(plan, mesh)
    ref, _, ref_specs = make_serve_fn(plan.model, mesh,
                                      cells.decode_options(plan), 1)
    assert specs == ref_specs
    sp, io = rank_params(plan.model, mesh, seed=0, device="cpu")
    caches = [_rank_caches(plan, mesh) for _ in range(2)]
    for step, pos in enumerate((20, 21, 22)):
        batch = _decode_batch(plan, mesh, specs, step)
        out = [mesh.run(f, [(sp[r], io[r], c[r], batch[r], pos)
                            for r in range(mesh.size)])
               for f, c in ((fn, caches[0]), (ref, caches[1]))]
        for a, b in zip(*out):
            assert torch.equal(a[0], b[0])
            assert (a[1] is None) == (b[1] is None)
            if a[1] is not None:
                assert torch.equal(a[1], b[1])


def test_build_cell_refuses_the_zamba2_long_context_plan():
    plan = cells.plan_cell("zamba2-1.2b", "long_500k", ProductionMeshShape())
    assert plan.sp_mode  # the reference plans it so (cells.py:101)
    with pytest.raises(ValueError, match="build.py:408"):
        cells.build_cell(plan, make_mesh(16, 16, device="meta"))


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------
class Devices(TorchDispatchMode):
    """The devices of every tensor an op makes, and the ops that made one
    off the meta device."""

    def __init__(self):
        super().__init__()
        self.seen = set()
        self.off_meta = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.seen.add(t.device.type)
                if t.device.type != "meta":
                    self.off_meta.add(str(func))
        return out


@pytest.mark.parametrize("arch,shape", [("deepseek-7b", "train_4k"),
                                        ("gemma3-4b", "long_500k"),
                                        ("seamless-m4t-large-v2",
                                         "decode_32k")])
def test_dryrun_cell_allocates_nothing(arch, shape):
    with Devices() as d:
        r = dryrun.dryrun_cell(arch, shape)
    # on the host only the RoPE table, lifted from numpy before its copy to
    # the meta device (``layers.apply_rope``); no weight, activation or cache
    assert d.seen <= {"meta", "cpu"}
    assert d.off_meta <= {"aten.lift_fresh.default"}
    assert "error" not in r and "refused" not in r
    mem = r["memory"]
    assert mem["argument_bytes"] > 0 and mem["output_bytes"] > 0
    assert mem["temp_bytes"] is None and mem["model"]["total"] > 0
    if arch.startswith("seamless"):
        # the roofline costs F_dec on the first stage (as the reference's
        # per_op_costs does), whose encoder layers are inert at decode
        assert r["cost_raw"] == {"flops": 0.0, "bytes_accessed": 0.0}
    else:
        assert r["cost_raw"]["flops"] > 0
        assert r["cost_raw"]["bytes_accessed"] > 0
    assert r["collectives"]["ppermute"] > 0


@pytest.mark.parametrize("multi_pod,gap", [(False, "(a)"), (True, "(b)")])
def test_dryrun_reports_the_zamba2_long_context_cell_refused(multi_pod, gap):
    r = dryrun.dryrun_cell("zamba2-1.2b", "long_500k", multi_pod=multi_pod)
    assert "error" not in r
    assert "src/repro/launch/cells.py:101" in r["refused"]
    assert f"gap {gap}" in r["refused"]


def test_dryrun_cli_exits_0_and_counts_errors_only(tmp_path, capsys):
    out = tmp_path / "r.json"
    dryrun.main(["--arch", "zamba2-1.2b", "--shape", "long_500k", "--out",
                 str(out)])
    assert "0/1 cells passed, 1 refused by design" in capsys.readouterr().out


def _argument_bytes(mesh, sp, io, shards, opt=None, caches=None):
    """The largest per-rank argument bytes of a real run."""
    def nbytes(tree):
        if isinstance(tree, torch.Tensor):
            return tree.numel() * tree.element_size()
        if isinstance(tree, torch.nn.Module):
            return sum(nbytes(p) for p in tree.parameters())
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        return 0
    return max(nbytes(sp[r]) + nbytes(io[r]) + nbytes(shards[r])
               + nbytes(opt[r] if opt else None)
               + nbytes(caches[r] if caches else None)
               for r in range(mesh.size))


#: (case, arch, layers, experts, schedule): a reduced train plan on 2 x 2
TRAIN_COUNTS = [("dense_1f1b", "deepseek-7b", 4, 0, "1f1b"),
                ("dense_zb", "deepseek-7b", 4, 0, "zb"),
                ("moe_tp", "deepseek-moe-16b", 4, 0, "1f1b"),
                ("moe_ep_zb", "deepseek-moe-16b", 4, 16, "zb")]


@pytest.mark.parametrize("case,arch,layers,experts,schedule", TRAIN_COUNTS,
                         ids=[c[0] for c in TRAIN_COUNTS])
def test_step_collectives_and_bytes_of_a_train_run(case, arch, layers,
                                                   experts, schedule):
    from repro_torch.optim.adamw import AdamWConfig, make_optimizer

    mesh = make_mesh(2, 2, device="cpu")
    cfg = registry.reduced_config(arch, num_layers=layers)
    if experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=experts))
    plan = _reduced_train_plan(arch, mesh, cfg=cfg)
    fn, args, specs = cells.build_cell(plan, mesh, schedule=schedule,
                                       split_backward=schedule == "zb")
    sp, io = rank_params(plan.model, mesh, seed=0, device="cpu")
    shards = _train_batch(plan, mesh, specs)
    mesh.reset_counts()
    mesh.run(fn, [(sp[r], io[r], shards[r]) for r in range(mesh.size)])
    table = cells.schedule_table(plan, schedule, schedule == "zb")
    assert dryrun.step_collectives(plan, mesh, table) == dict(
        sorted(mesh.counts.items()))
    # a rank's arguments and ZeRO-1 state, as the dry run counts them
    from repro_torch.pipeline.sharding import partition_for
    init, _ = make_optimizer(plan.model, mesh,
                             partition_for(plan.model, sp[0], io[0]),
                             AdamWConfig())
    opt = mesh.run(init, list(zip(sp, io)))
    full = cells.input_specs(plan)
    want = _argument_bytes(mesh, sp, io, shards, opt=opt)
    assert dryrun.rank_memory(plan, mesh, args, specs)["argument_bytes"] \
        == want
    assert full["tokens"].shape[0] == plan.cell.global_batch


#: (case, arch, shape, layers, batch): a reduced decode plan on 2 x 2
DECODE_COUNTS = [("sp_gemma", "gemma3-4b", "long_500k", 4, None),
                 ("seamless", "seamless-m4t-large-v2", "decode_32k", 4, 4),
                 ("moe_tp", "deepseek-moe-16b", "decode_32k", 4, 4)]


@pytest.mark.parametrize("case,arch,shape,layers,batch", DECODE_COUNTS,
                         ids=[c[0] for c in DECODE_COUNTS])
def test_step_collectives_and_bytes_of_a_serve_run(case, arch, shape, layers,
                                                   batch):
    mesh = make_mesh(2, 2, device="cpu")
    plan = _reduced_decode_plan(arch, shape, mesh, layers=layers, cache=16,
                                batch=batch)
    fn, args, specs = cells.build_cell(plan, mesh)
    sp, io = rank_params(plan.model, mesh, seed=0, device="cpu")
    caches = _rank_caches(plan, mesh)
    shards = _decode_batch(plan, mesh, specs, 0)
    mesh.reset_counts()
    mesh.run(fn, [(sp[r], io[r], caches[r], shards[r], 5)
                  for r in range(mesh.size)])
    assert dryrun.step_collectives(plan, mesh) == dict(
        sorted(mesh.counts.items()))
    assert dryrun.rank_memory(plan, mesh, args, specs)["argument_bytes"] \
        == _argument_bytes(mesh, sp, io, shards, caches=caches)
