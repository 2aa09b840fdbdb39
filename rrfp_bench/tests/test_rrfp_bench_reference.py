"""The reference against the program's CPU path at toy widths, and the
runs that ``correct`` has to fail: the control (the reference in the next
precision below the configuration's) and the program with its step broken
underneath."""
import time

import numpy as np
import pytest
import torch

from rrfp_bench.harness import cell as cell_run
from rrfp_bench.harness import checks, program
from rrfp_bench.reference import train as reference
from rrfp_bench.reference.precision import CONTROL
from rrfp_bench.tests._small import CELLS, any_cell, small_cell

#: one cell of each model: the dense, MoE and embedding-input references
MODELS = ["qwen2vl-rrfp-bf", "gpt3-rrfp-bf", "moe-rrfp-bf"]
SEED = 2 ** 31 + 101


def _run(name, dtype="float32", seed=SEED, cfg_cell=None):
    cell, cfg = cfg_cell or small_cell(name, dtype)
    return cell_run.run_cell(cell, seed=seed, seconds=0.5, trace_on=False,
                             device="cpu", t_start=time.perf_counter(),
                             cfg=cfg)[0]


@pytest.mark.parametrize("name", CELLS)
def test_float32_program_matches_the_reference(name):
    """In float32 the program computes what the reference does: the same
    losses to rounding, every leaf's gradient within 1e-4, and every leaf's
    change within 1e-4 or, where float32's own rounding reaches further
    (Adam turns the rounding of a key projection's small, cancelling
    gradient into whole steps), within three times the float32
    reference's own gap to a float64 one."""
    res = _run(name)
    assert res["correct"] and res["attempted"] >= 1
    gaps = {k: v["value"] for k, v in res["checks"].items()}
    assert gaps["loss_gap"] < 1e-5
    assert gaps["grad_gap"] < 1e-4
    cell, _ = small_cell(name)
    rounding = checks.readings_gaps(_readings(cell),
                                    _readings(cell, precision="fp64"))
    assert gaps["change_gap"] < max(1e-4, 3 * rounding["change_gap"]), (
        gaps, rounding)
    assert {"tokens_per_s", "mfu", "setup_s"} <= set(res["metrics"])


def _readings(cell, seed=SEED, **kw):
    return reference.train(cell.config, cell.traffic, seed=seed,
                           device=torch.device("cpu"),
                           lr=cell.config["train"]["lr"],
                           total_steps=program.STEPS_BOUND,
                           steps=program.SETUP_STEPS, **kw)


#: the numbers a bfloat16 program reads below the float8 control at toy
#: widths.  Not qwen2-vl's change: its key biases start at zero, their
#: gradient nearly cancels over the positions, and Adam turns bfloat16's
#: rounding of it into whole steps of either sign (at toy widths 10-12 %
#: of the slice; at d 256, seq 512 about 1 %, under the control's 2 %)
BELOW_CONTROL = {"qwen2vl-rrfp-bf": ("loss_gap", "grad_gap")}


@pytest.mark.parametrize("name", MODELS)
def test_a_bfloat16_program_reads_below_its_float8_control(name):
    """The models in bfloat16, as the configurations state them: each
    number the program reads sits below the float8 control's."""
    cell, cfg = small_cell(name, "bfloat16")
    ran = program.run(cell.config, cell.traffic, seed=SEED, seconds=0.0,
                      trace=False, device="cpu",
                      t_start=time.perf_counter(), cfg=cfg, window=False)
    base = _readings(cell)
    prog = checks.readings_gaps(ran.readings, base)
    ctl = checks.readings_gaps(_readings(cell, precision="fp8"), base)
    assert all(prog[k] < ctl[k] for k in BELOW_CONTROL.get(name, prog)), (
        prog, ctl)


@pytest.mark.parametrize("arch", ["paper-gpt3-large", "qwen2-vl-2b"])
def test_the_batches_are_the_programs(arch):
    from repro_torch.data.synthetic import synth_batch
    from repro_torch.configs import registry

    from rrfp_bench.reference import data

    cfg = registry.get_arch(arch)
    for step in (0, 2):
        want = synth_batch(cfg, 3, 64, seed=SEED, step=step)
        got = data.batch(cfg.padded_vocab(), 3, 64, seed=SEED, step=step,
                         embed_d=cfg.d_model if cfg.embed_input else 0)
        assert set(got) == set(want) - {"mrope"}
        for k, v in got.items():
            assert np.array_equal(v, want[k]), k
        if cfg.mrope:
            # the stub's positions: every axis 0..s-1, as the reference has
            assert np.array_equal(want["mrope"], np.broadcast_to(
                np.arange(64), (3, 3, 64)))


def test_the_weights_are_the_seeds():
    from rrfp_bench.harness import weights

    cell, _ = small_cell("moe-rrfp-bf")
    a = weights.draw_all(cell.config, SEED, "cpu")
    b = weights.draw_all(cell.config, SEED, "cpu")
    c = weights.draw_all(cell.config, SEED + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["moe.wi"], c["moe.wi"])
    assert a["moe.router"].dtype == torch.float32


@pytest.mark.parametrize("name", MODELS)
def test_the_control_is_not_correct(name):
    """The control (float8 products below the configurations' bfloat16),
    put in the program's place, fails the cell's limits."""
    cell, _ = small_cell(name, "bfloat16")
    control = _readings(cell, precision=CONTROL[cell.config["dtype"]])
    ok, numbers = checks.compare(control, _readings(cell), cell.limits)
    assert not ok, numbers


@pytest.mark.parametrize("name", CELLS)
def test_a_step_that_leaves_the_state_unchanged_is_not_correct(
        name, monkeypatch):
    from repro_torch.launch import train

    monkeypatch.setattr(train, "make_host_update",
                        lambda cfg: lambda params, grads, m, v, step: 0.0)
    res = _run(name)
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", CELLS)
def test_half_the_batch_left_out_is_not_correct(name, monkeypatch):
    """The second half of every step's rows a copy of the first: the mean
    over half the batch."""
    from repro_torch.launch import train

    real = train.synth_batch

    def halved(*a, **kw):
        out = real(*a, **kw)
        rows = {k: v for k, v in out.items() if k != "mrope"}
        return {**out, **reference.halve(rows)}

    monkeypatch.setattr(train, "synth_batch", halved)
    res = _run(name)
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_on_the_card_the_control_fails_at_the_cells_own_size(name):
    """The control at the cell's own size, one seed (a few minutes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = any_cell(name)
    kw = dict(seed=SEED, device=torch.device("cuda"),
              lr=cell.config["train"]["lr"],
              total_steps=program.STEPS_BOUND, steps=program.SETUP_STEPS)
    base = reference.train(cell.config, cell.traffic, **kw)
    control = reference.train(cell.config, cell.traffic,
                              precision=CONTROL[cell.config["dtype"]], **kw)
    ok, numbers = checks.compare(control, base, cell.limits)
    assert not ok, numbers
