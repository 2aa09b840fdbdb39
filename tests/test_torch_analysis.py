"""The port's analysis tooling (``analysis/memory_model.py``,
``analysis/roofline.py``) against the reference's.

* The reference's own ``tests/test_analysis.py`` runs on the port's copies
  (``tests/_port_copy.py``), ``TestRooflineEndToEnd`` at the H100
  constants.
* ``cell_memory`` and ``collective_bytes`` equal the reference's, float for
  float, for every cell of the matrix on both production mesh shapes.
* ``per_op_costs(kernels=False)``, the plain compositions the reference
  counts: the FLOPs of each op body, counted on meta tensors,
  against the reference's ``HloCostAnalysis`` counts of the same bodies,
  computed in one JAX subprocess, on planned cells cut to a short sequence
  (one CE chunk) with their config in float32: XLA on the CPU upcasts bf16
  dot operands to float32, elementwise work that it counts at every
  weight, which at a decode's one token outweighs the matmuls (a bf16
  ``F_dec`` reads 3x the port's count; in float32 the two agree).
  Tolerance :data:`TOL_FLOPS` (1 %): both count the same matmuls and the
  same dense attention, and the elementwise work, counted one FLOP per
  output element here and by XLA's own rules there, is well under 1 % of
  a train or decode op.  Two differences of program, not of counting, are
  taken out first: the port's chunked CE is checkpointed per chunk and
  recomputes its forward in ``B_last`` (so ``B_last - ce`` is compared),
  and XLA's ``B`` shares the last slot's forward with that slot's
  recompute, which the port's eager backward runs again (so ``B`` less
  that slot's forward is compared).
* ``per_op_costs()`` counts each kernel wrapper's call as its kernel's
  work (``roofline.KERNEL_WORK``), the formulas ``chip_smoke.py`` bounds
  the kernels by.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from _port_copy import port_cases
from repro.analysis import memory_model as jmem
from repro.analysis import roofline as jroof
from repro.core.taskgraph import PipelineSpec as JSpec
from repro.launch import cells as jcells
from repro.pipeline import schedules as jschedules
from repro_torch.analysis import memory_model, roofline
from repro_torch.core.taskgraph import PipelineSpec
from repro_torch.launch import cells
from repro_torch.models.build import build
from repro_torch.pipeline import schedules

ROOT = Path(__file__).resolve().parents[1]

port_cases("test_analysis.py", globals())

MESHES = {"16x16": False, "2x16x16": True}
MATRIX = [(a, s, m) for a, s in jcells.all_cells() for m in MESHES]


def _plans(arch, shape, mesh):
    mp = MESHES[mesh]
    return (cells.plan_cell(arch, shape, roofline.ProductionMeshShape(mp)),
            jcells.plan_cell(arch, shape, jroof.ProductionMeshShape(mp)))


def test_roofline_constants_are_the_h100s():
    assert roofline.PEAK_FLOPS == 989e12  # dense bf16, H100 SXM
    assert roofline.HBM_BW == 3.35e12     # HBM3, H100 SXM 80 GB
    assert roofline.LINK_BW == 50e9       # one 400 Gb/s NDR rail
    assert roofline.CHIPS == jroof.CHIPS == 256


@pytest.mark.parametrize("arch,shape,mesh", MATRIX)
def test_cell_memory_equals_the_reference(arch, shape, mesh):
    p, j = _plans(arch, shape, mesh)
    got = memory_model.cell_memory(p).as_dict()
    want = jmem.cell_memory(j).as_dict()
    assert got == want
    if p.step == "train":  # with the 1f1b table's occupancy
        t = schedules.one_f_one_b(PipelineSpec(16, p.num_microbatches))
        jt = jschedules.one_f_one_b(JSpec(16, j.num_microbatches))
        assert memory_model.cell_memory(p, t).as_dict() == \
            jmem.cell_memory(j, jt).as_dict()


@pytest.mark.parametrize("arch,shape,mesh", MATRIX)
def test_collective_bytes_equal_the_reference(arch, shape, mesh):
    p, j = _plans(arch, shape, mesh)
    t = jt = None
    if p.step == "train":
        t = schedules.one_f_one_b(PipelineSpec(16, p.num_microbatches))
        jt = jschedules.one_f_one_b(JSpec(16, j.num_microbatches))
    assert roofline.collective_bytes(p, t) == jroof.collective_bytes(j, jt)


def test_counter_counts_matmuls_pointwise_ops_and_no_view_bytes():
    a = torch.empty((4, 8), device="meta")
    b = torch.empty((8, 16), device="meta")
    with roofline.CostCounter() as c:
        y = a @ b
    assert c.flops == 2 * 4 * 8 * 16
    assert c.bytes == (4 * 8 + 8 * 16 + 4 * 16) * 4
    with roofline.CostCounter() as c:
        z = torch.exp(y)
        z.t()[:3]
        z.view(-1)
    assert c.flops == 4 * 16  # one a pointwise output element
    assert c.bytes == 2 * 4 * 16 * 4  # exp's in and out; the views none
    # a repeat of one signature counts again, with a fresh output
    with roofline.CostCounter() as c:
        outs = [torch.exp(y) for _ in range(3)]
    assert c.flops == 3 * 4 * 16 and len({id(o) for o in outs}) == 3
    assert all(o.shape == y.shape and o.device.type == "meta" for o in outs)


# ---------------------------------------------------------------------------
# per_op_costs against the reference's HloCostAnalysis counts
# ---------------------------------------------------------------------------
#: relative tolerance of an op's FLOPs (see the module docstring)
TOL_FLOPS = 1e-2
#: (arch, shape, seq): a planned cell on the production mesh, its sequence
#: (a decode cell's cache) cut to ``seq``, its config in float32
COST_CASES = [("paper-gpt3-large", "train_4k", 256),
              ("gemma3-4b", "train_4k", 256),
              ("deepseek-moe-16b", "train_4k", 128),
              ("seamless-m4t-large-v2", "train_4k", 256),
              ("zamba2-1.2b", "train_4k", 256),
              ("gemma3-4b", "decode_32k", 256),
              ("deepseek-7b", "decode_32k", 256)]

#: the reference's counts of the same plans (``reduced_plan``'s cut)
REFERENCE = r"""
import dataclasses, json, sys
import jax.numpy as jnp
from repro.analysis.roofline import ProductionMeshShape, per_op_costs
from repro.launch.cells import plan_cell
from repro.models.build import build
out = {}
for arch, shape, seq in json.loads(sys.argv[1]):
    plan = plan_cell(arch, shape, ProductionMeshShape())
    cfg = dataclasses.replace(plan.model.cfg, dtype=jnp.float32)
    plan = dataclasses.replace(plan, model=build(cfg, 16), seq_len=seq,
                               enc_len=seq if plan.enc_len else 0)
    if plan.step == "decode":
        plan = dataclasses.replace(
            plan, cell=dataclasses.replace(plan.cell, seq_len=seq))
    out[f"{arch}|{shape}"] = {k: v["flops"]
                              for k, v in per_op_costs(plan).items()}
print(json.dumps(out))
"""


def reduced_plan(arch, shape, seq):
    """The cell's plan on the production mesh, its sequence cut to ``seq``
    and its config in float32 (as ``REFERENCE`` cuts the reference's)."""
    plan = cells.plan_cell(arch, shape, roofline.ProductionMeshShape())
    cfg = dataclasses.replace(plan.model.cfg, dtype=torch.float32)
    plan = dataclasses.replace(plan, model=build(cfg, 16), seq_len=seq,
                               enc_len=seq if plan.enc_len else 0)
    if plan.step == "decode":
        plan = dataclasses.replace(
            plan, cell=dataclasses.replace(plan.cell, seq_len=seq))
    return plan


@pytest.fixture(scope="module")
def reference_costs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", REFERENCE, json.dumps(COST_CASES)],
        env=env, capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _last_slot_forward(plan) -> float:
    """FLOPs of the forward of stage 0's last enabled slot alone."""
    model = plan.model
    rows = model.rows(0)
    last = max(i for i in range(model.l_max) if rows["enabled"][i])
    only = {**rows, "enabled": (rows["enabled"] * 0)}
    only["enabled"][last] = 1
    cfg = model.cfg
    meta = torch.device("meta")
    sp = model.init_stage_params(0, seed=None, device=meta)
    io = model.init_io_params(seed=None, device=meta)
    eff = plan.seq_len + plan.enc_len
    x = torch.empty((plan.mb_rows, eff, cfg.d_model), dtype=cfg.dtype,
                    device=meta)
    aux = {"positions": torch.zeros((plan.mb_rows, eff), dtype=torch.int32,
                                    device=meta),
           "data_size": 16, "moe_layout": "none"}
    if cfg.encoder_layers:
        aux["dec_len"] = plan.seq_len
    with torch.no_grad(), roofline.CostCounter() as c:
        model.stage_forward(sp, io, x, aux, only)
    return c.flops


@pytest.mark.parametrize("arch,shape,seq", COST_CASES,
                         ids=[f"{a}-{s}" for a, s, _ in COST_CASES])
def test_per_op_flops_match_the_reference(reference_costs, arch, shape, seq):
    plan = reduced_plan(arch, shape, seq)
    got = {k: v["flops"] for k, v in
           roofline.per_op_costs(plan, kernels=False).items()}
    want = reference_costs[f"{arch}|{shape}"]
    assert sorted(got) == sorted(want)
    pairs = {op: (got[op], want[op]) for op in ("F", "ce", "F_dec")
             if op in want}
    if plan.step == "train":
        pairs["B_last - ce"] = (got["B_last"] - got["ce"], want["B_last"])
        pairs["B - last slot"] = (got["B"] - _last_slot_forward(plan),
                                  want["B"])
    for op, (a, b) in pairs.items():
        if b == 0:  # seamless decode: stage 0's encoder layers are inert
            assert a == 0, op
            continue
        assert abs(a / b - 1) <= TOL_FLOPS, (op, a, b)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_a_kernel_call_counts_as_its_kernels_work():
    from repro_torch.kernels import ops

    b, s, hq, hkv, hd = 1, 300, 8, 2, 64
    q, k, v = _meta(b, s, hq, hd), _meta(b, s, hkv, hd), _meta(b, s, hkv, hd)
    with roofline.CostCounter() as c, roofline._as_kernels(c):
        ops.flash_attention(q, k, v, window=100)
    pairs = 100 * 101 // 2 + (s - 100) * 100
    assert c.by_op["kernel flash_attention_fwd"] == [
        1, 4 * b * hq * pairs * hd,
        (2 * b * s * hq * hd + 2 * b * s * hkv * hd) * 2 + b * hq * s * 4]
    # K1b: five products a pair; q, k, v, out, dout, lse in, dq, dk, dv out
    qg, kg, vg = (t.requires_grad_() for t in (q, k, v))
    with roofline.CostCounter() as c, roofline._as_kernels(c):
        out = ops.flash_attention(qg, kg, vg, window=100)
        torch.autograd.grad(out, (qg, kg, vg), _meta(b, s, hq, hd))
    assert c.by_op["kernel flash_attention_bwd"] == [
        1, 10 * b * hq * pairs * hd,
        (4 * b * s * hq * hd + 4 * b * s * hkv * hd) * 2 + b * hq * s * 4]
    # float32 runs the plain backward on the card: counted as its aten ops
    qf, kf, vf = (_meta(*t.shape, dtype=torch.float32).requires_grad_()
                  for t in (q, k, v))
    with roofline.CostCounter() as c, roofline._as_kernels(c):
        out = ops.flash_attention(qf, kf, vf, window=100)
        torch.autograd.grad(out, (qf, kf, vf),
                            _meta(b, s, hq, hd, dtype=torch.float32))
    assert "kernel flash_attention_bwd" not in c.by_op
    assert "kernel flash_attention_fwd" in c.by_op
    x, scale = _meta(4, 7, 32), _meta(32)
    with roofline.CostCounter() as c, roofline._as_kernels(c):
        ops.rmsnorm(x, scale)
    assert c.by_op["kernel rmsnorm"] == [1, 4 * 28 * 32, 2 * 28 * 32 * 2 + 64]
    assert c.flops == 4 * 28 * 32  # nothing of the plain route counted
    kc, vc = _meta(2, 50, 2, 64), _meta(2, 50, 2, 64)
    with roofline.CostCounter() as c, roofline._as_kernels(c):
        ops.decode_attention(_meta(2, 1, 8, 64), kc, vc, 20)
    assert c.by_op["kernel flash_decode"][1:] == [
        4 * 2 * 8 * 20 * 64, 2 * 2 * 20 * 2 * 64 * 2 + 2 * 2 * 8 * 64 * 2]
    x, dt = _meta(1, 128, 4, 16), _meta(1, 128, 4, dtype=torch.float32)
    A, D = _meta(4, dtype=torch.float32), _meta(4, dtype=torch.float32)
    B, C = _meta(1, 128, 8), _meta(1, 128, 8)
    with roofline.CostCounter() as c, roofline._as_kernels(c):
        ops.ssd(x, dt, A, B, C, D, chunk=64)
    assert c.by_op["kernel ssd_scan"][1] == \
        2 * 4 * 2 * (64 * 64 * 8 + 64 * 64 * 16 + 2 * 64 * 8 * 16)
    # the wrappers are the kernels' again outside the block
    from repro_torch.kernels import flash_attention as fa
    assert fa.flash_attention_fwd.__name__ == "flash_attention_fwd"


def test_kernel_counts_skip_what_the_kernels_skip():
    plan = cells.plan_cell("paper-gpt3-large", "train_4k",
                           roofline.ProductionMeshShape())
    plan = dataclasses.replace(plan, seq_len=512)
    k = roofline.per_op_costs(plan)
    p = roofline.per_op_costs(plan, kernels=False)
    # K1 scores the causal half of the pairs and writes no score matrix
    assert k["F"]["flops"] < p["F"]["flops"]
    assert k["F"]["bytes"] < p["F"]["bytes"] / 2
    # B recomputes the forward through K1, and its backward is K1b, which
    # also scores only the causal half and keeps no score tile
    assert k["B"]["flops"] < p["B"]["flops"]
    assert k["B"]["bytes"] < p["B"]["bytes"] / 2
