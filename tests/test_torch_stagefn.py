"""Port stage callables and actor programs.

* Parity with the reference's ``StageFns`` on identical weights and batch:
  ``(y, loss, dx, d_stage, d_io)`` per stage of a 2-stage pipeline,
  float32, tolerance 1e-4.
* Inside the port, bit for bit (mirroring tests/test_split_backward.py and
  tests/conformance/test_real_model.py): the BFW split backward equals the
  fused one, and a chaotic threaded run equals a fixed-order run under
  ``deterministic_reduction``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models.build import build as jbuild
from repro.pipeline import stagefn as jstagefn
from repro_torch.configs import registry
from repro_torch.core import HintKind, PipelineSpec
from repro_torch.core.taskgraph import Kind, Task
from repro_torch.models.build import build
from repro_torch.models.convert import params_from_reference
from repro_torch.pipeline.stagefn import (
    ActorStageProgram,
    StageFnOptions,
    StageFns,
    microbatch,
)
from repro_torch.runtime.rrfp import ActorConfig, ActorDriver, ChaosConfig
from repro_torch.runtime.rrfp.messages import payload_for_edge

TOL = 1e-4


def _batch_np(vocab, rows, seq, seed=2):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (rows, seq)).astype(np.int32),
            "labels": rng.integers(0, vocab, (rows, seq)).astype(np.int32)}


def _torch_batch(b):
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


def _close(got, want):
    want = np.zeros(got.shape, np.float32) if want is None else want
    got = np.zeros(np.shape(want), np.float32) if got is None else got
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)


def _leaf(tree, dotted):
    for part in dotted.split("."):
        tree = tree[part]
    return tree


@pytest.mark.parametrize("arch", ["paper-gpt3-large", "deepseek-7b"])
def test_stage_fns_match_reference(arch):
    S, mb_rows, seq = 2, 2, 16
    cfg_j = jreg.reduced_config(arch, num_layers=4)
    model_j = jbuild(cfg_j, num_stages=S)
    key = jax.random.key(0)
    sp = model_j.init_stage_params(key)
    io = model_j.init_io_params(jax.random.fold_in(key, 1))
    model_t = build(registry.reduced_config(arch, num_layers=4), S)
    stages, io_t = params_from_reference(
        model_t, jax.tree.map(np.asarray, sp), jax.tree.map(np.asarray, io),
        "cpu")
    bnp = _batch_np(cfg_j.vocab_size, mb_rows, seq)
    tokens = mb_rows * seq
    fj = jstagefn.StageFns(model_j, jstagefn.StageFnOptions(
        mb_rows=mb_rows, seq_len=seq, loss_scale=1.0 / tokens))
    ft = StageFns(model_t, StageFnOptions(mb_rows=mb_rows, seq_len=seq,
                                          loss_scale=1.0 / tokens))
    bj = {k: jnp.asarray(v) for k, v in bnp.items()}
    bt = _torch_batch(bnp)
    spj = [jax.tree.map(lambda x, s=s: x[s], sp) for s in range(S)]

    y0j, l0j = fj.forward(0)(spj[0], io, None, bj)
    y1j, l1j = fj.forward(1)(spj[1], io, y0j, bj)
    y0t, l0t = ft.forward(0)(stages[0], io_t, None, bt)
    y1t, l1t = ft.forward(1)(stages[1], io_t, y0t, bt)
    for got, want in ((y0t, y0j), (y1t, y1j), (l0t, l0j), (l1t, l1j)):
        _close(got, want)
    assert float(l1t) > 0.0

    # stage 1 first: its dx is stage 0's cotangent, as in the pipeline
    zeros = jnp.zeros_like(y1j)
    out1j = fj.backward(1)(spj[1], io, y0j, zeros, bj)
    out1t = ft.backward(1)(stages[1], io_t, y0t, None, bt)
    g_in = np.array(out1j[0])
    outs_j = [fj.backward(0)(spj[0], io, None, jnp.asarray(g_in), bj), out1j]
    outs_t = [ft.backward(0)(stages[0], io_t, None, torch.from_numpy(g_in),
                             bt), out1t]
    for s, ((dxj, dspj, dioj), (dxt, dspt, diot)) in enumerate(
            zip(outs_j, outs_t)):
        if s == 0:
            assert dxt is None
        else:
            _close(dxt, dxj)
        for (name, _), g in zip(stages[s].named_parameters(), dspt):
            _, slot, path = name.split(".", 2)
            _close(g, np.asarray(_leaf(dspj, path))[int(slot)])
        for (name, _), g in zip(io_t.named_parameters(), diot):
            _close(g, _leaf(dioj, name))


# ---------------------------------------------------------------------------
# bit-for-bit properties inside the port
# ---------------------------------------------------------------------------
def _port_setup(S, M, mb_rows, seq, layers, arch="deepseek-7b"):
    cfg = registry.reduced_config(arch, num_layers=layers)
    model = build(cfg, num_stages=S)
    stages = [model.init_stage_params(s, seed=0, device="cpu")
              for s in range(S)]
    io = model.init_io_params(seed=0, device="cpu")
    batch = _torch_batch(_batch_np(cfg.vocab_size, M * mb_rows, seq))
    fns = StageFns(model, StageFnOptions(
        mb_rows=mb_rows, seq_len=seq, loss_scale=1.0 / (M * mb_rows * seq)))
    return fns, stages, io, batch


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and torch.equal(a, b)


def test_split_backward_matches_fused_bitwise():
    S, mb_rows, seq = 2, 2, 16
    fns, stages, io, batch = _port_setup(S, 1, mb_rows, seq, 4)
    bm = microbatch(batch, 0, mb_rows)
    y0, _ = fns.forward(0)(stages[0], io, None, bm)
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(
        y0.shape).astype(np.float32))
    for s, x, g_in in ((1, y0, None), (0, None, g)):
        dx_f, dsp_f, dio_f = fns.backward(s)(stages[s], io, x, g_in, bm)
        dsp_s, dio_s = fns.weight_grad(s)(stages[s], io, x, g_in, bm)
        if s > 0:
            assert _same(dx_f, fns.backward_dx(s)(stages[s], io, x, g_in, bm))
        assert all(_same(a, b) for a, b in zip(dsp_f, dsp_s))
        assert all(_same(a, b) for a, b in zip(dio_f, dio_s))


def test_threaded_bfw_matches_fused_run():
    S, M, mb_rows, seq, cap = 2, 4, 2, 16, 2
    fns, stages, io, batch = _port_setup(S, M, mb_rows, seq, 4)

    def run(split):
        spec = PipelineSpec(S, M, split_backward=split)
        programs = [ActorStageProgram(fns, s, stages[s], io, batch,
                                      split_backward=split)
                    for s in range(S)]
        acfg = ActorConfig(mode="hint",
                           hint=HintKind.BFW if split else HintKind.BF,
                           w_defer_cap=cap if split else 0,
                           deadlock_timeout=300.0)
        r = ActorDriver(spec, None, acfg).run_threaded(list(programs))
        assert set(r.end) == set(spec.tasks())
        return programs

    fused, bfw = run(False), run(True)
    tokens = M * mb_rows * seq
    loss_f = sum(p.loss_sum for p in fused) / tokens
    loss_w = sum(p.loss_sum for p in bfw) / tokens
    assert abs(loss_f - loss_w) < 1e-5 * max(1.0, abs(loss_f))
    for pf, pw in zip(fused, bfw):
        assert pw.w_high_water <= cap
        assert pw.w_outstanding() == 0
        for a, b in zip(pf.d_stage + pf.d_io, pw.d_stage + pw.d_io):
            if a is not None or b is not None:
                np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def reference_execute(spec, programs):
    """Fixed-order executor: every task in a canonical topological order
    (the conformance harness's ``reference_execute``)."""
    done, outputs = set(), {}
    tasks = list(spec.tasks())
    while len(done) < len(tasks):
        for t in tasks:
            if t in done or any(p not in done for p in spec.predecessors(t)):
                continue
            mps = spec.message_predecessors(t)
            payload = (payload_for_edge(outputs.get(mps[0]), t.stage)
                       if mps else None)
            outputs[t] = programs[t.stage](t, payload)
            done.add(t)


@pytest.mark.parametrize("split", [False, True], ids=["fused", "bfw"])
def test_chaotic_run_matches_fixed_order_bitwise(split):
    if split:
        S, M, mb_rows, seq, layers = 2, 4, 2, 16, 4
        chaos = ChaosConfig(seed=2, latency_base=2e-3, reorder_prob=0.5,
                            reorder_window=2e-2, duplicate_prob=0.3,
                            straggler=((0, 2.0),), stall_prob=0.15,
                            stall_scale=1e-2)
        acfg = ActorConfig(mode="hint", hint=HintKind.BFW, w_defer_cap=2,
                           chaos=chaos, deadlock_timeout=300.0)
    else:
        S, M, mb_rows, seq, layers = 2, 3, 1, 8, 2
        chaos = ChaosConfig(seed=1, latency_base=2e-3, reorder_prob=0.4,
                            reorder_window=1e-2, duplicate_prob=0.2,
                            straggler=((1, 2.0),), stall_prob=0.1,
                            stall_scale=5e-3)
        acfg = ActorConfig(mode="hint", chaos=chaos, deadlock_timeout=300.0)
    fns, stages, io, batch = _port_setup(S, M, mb_rows, seq, layers)
    spec = PipelineSpec(S, M, split_backward=split)

    def programs():
        return [ActorStageProgram(fns, s, stages[s], io, batch,
                                  split_backward=split,
                                  deterministic_reduction=True)
                for s in range(S)]

    reference = programs()
    reference_execute(spec, reference)
    chaotic = programs()
    result = ActorDriver(spec, None, acfg).run_threaded(list(chaotic))
    assert len(result.end) == spec.total_tasks()
    for cp, rp in zip(chaotic, reference):
        cp.finalize()
        rp.finalize()
        assert cp.loss_acc.numpy().tobytes() == rp.loss_acc.numpy().tobytes()
        for a, b in zip(cp.d_stage + cp.d_io, rp.d_stage + rp.d_io):
            assert _same(a, b)


def test_mid_run_finalize_raises_instead_of_corrupting_order():
    fns, stages, io, batch = _port_setup(1, 3, 1, 8, 2)
    p = ActorStageProgram(fns, 0, stages[0], io, batch,
                          deterministic_reduction=True)
    p(Task(Kind.F, 0, 0), None)
    p(Task(Kind.F, 0, 2), None)
    p.loss_sum  # mid-run read: folds microbatches {0, 2} early
    p(Task(Kind.F, 0, 1), None)
    with pytest.raises(RuntimeError, match="mid-run"):
        p.finalize()


def test_w_task_on_fused_program_raises():
    fns, stages, io, batch = _port_setup(1, 1, 1, 8, 2)
    p = ActorStageProgram(fns, 0, stages[0], io, batch)
    with pytest.raises(ValueError, match="split_backward"):
        p(Task(Kind.W, 0, 0), None)
