"""The port's multimodal DAG (``repro_torch.multimodal``) against the
reference's ``repro.multimodal``.

On the CPU, reduced configs, float32, the reference's weights loaded by
path (``multimodal_params_from_reference``):

* ``multimodal_batch`` gives the reference's arrays bit for bit;
* ``multimodal_config`` and the stage graph equal the reference's;
* ``pool_weights`` and ``masked_encoder_attention`` agree within
  ``tests/test_kernels.py``'s float32 TOL;
* one DAG step (the counterpart of ``tests/test_multimodal.py::run_step``)
  gives the reference's loss and per-stage gradients, for qwen2-vl-2b and
  seamless, and three ``train_multimodal`` steps its losses within 1e-4;
* ``--substrate sim`` gives the reference's makespans exactly.

Inside PyTorch, bit for bit (mirroring ``tests/test_multimodal.py``): a
chaotic run equals a fixed-order run, and the BFW split equals the fused
backward.  Bucketed against unbucketed agrees within a tolerance only: the
reference itself fails that property bitwise on this tree.  Also the
fusion stage's fan-in routing, the refusal of other archs, the dtype
promotion of a bfloat16 model, and K1's head_dim 256 plan read from the
CUDA source.
"""
import argparse
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as jsynthetic
from repro.launch import train as jtrain
from repro.models import layers as jlayers
from repro.multimodal import model as jmodel
from repro.multimodal import stagefn as jstagefn
from repro_torch.core import HintKind
from repro_torch.core.taskgraph import Kind, Task
from repro_torch.data.synthetic import multimodal_batch
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import train
from repro_torch.models import layers
from repro_torch.models.convert import multimodal_params_from_reference
from repro_torch.multimodal import (
    MultimodalStageFns,
    MultimodalStageProgram,
    multimodal_config,
    multimodal_model,
)
from repro_torch.multimodal import model as tmodel
from repro_torch.multimodal.stagefn import MultimodalStageOptions
from repro_torch.runtime.rrfp import ActorConfig, ActorDriver, ChaosConfig
from repro_torch.runtime.rrfp.messages import EdgePayloads

TOL = 2e-5  # tests/test_kernels.py TOL, float32
M, ROWS, SEQ = 5, 2, 16
BUCKETS = (8, 16, 24)
#: the tiny DAGs of tests/test_multimodal.py
TINY = {
    "qwen2-vl-2b": dict(enc_stages=2, lm_stages=2, enc_layers_per_stage=1,
                        lm_layers_per_stage=1, text_seq=SEQ, fusion_slots=4,
                        mean_enc_tokens=14, buckets=BUCKETS),
    "seamless-m4t-large-v2": dict(enc_stages=1, lm_stages=1,
                                  enc_layers_per_stage=1,
                                  lm_layers_per_stage=1, text_seq=8,
                                  fusion_slots=2, mean_enc_tokens=10,
                                  buckets=(8, 16)),
}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _both(arch, seed=0, **kw):
    """(reference model, its params as numpy, port model, port params
    holding the same weights)."""
    jm = jmodel.multimodal_model(arch, **kw)
    tm = multimodal_model(arch, **kw)
    jp = jm.init_stage_params(jax.random.key(seed))
    tp = multimodal_params_from_reference(tm, _np_tree(jp), "cpu")
    return jm, jp, tm, tp


def _torch_batch(b):
    return train._device_mm_batch(b, "cpu")


# ---------------------------------------------------------------------------
# data, config and topology
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bucketing", [True, False])
@pytest.mark.parametrize("seed,step", [(0, 0), (0, 3), (7, 1), (11, 5)])
@pytest.mark.parametrize("arch", sorted(TINY))
def test_multimodal_batch_equals_reference(arch, seed, step, bucketing):
    want = jsynthetic.multimodal_batch(
        jmodel.multimodal_config(arch, **TINY[arch]), M, ROWS, seed=seed,
        step=step, bucketing=bucketing)
    got = multimodal_batch(multimodal_config(arch, **TINY[arch]), M, ROWS,
                           seed=seed, step=step, bucketing=bucketing)
    assert set(got) == set(want)
    for k in ("tokens", "labels", "enc_lens"):
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes(), k
    assert len(got["enc_embeds"]) == len(want["enc_embeds"]) == M
    for g, w in zip(got["enc_embeds"], want["enc_embeds"]):
        assert g.shape == w.shape and g.tobytes() == w.tobytes()


def _cfg_fields(c):
    return {f.name: getattr(c, f.name) for f in dataclasses.fields(c)
            if f.name not in ("lm_cfg", "dtype")}


@pytest.mark.parametrize("kw", [
    {}, dict(enc_stages=1, lm_stages=2), dict(enc_stages=3, lm_stages=1),
    dict(reduced=False), dict(reduced=False, text_seq=512,
                              mean_enc_tokens=2048,
                              buckets=(4096, 1024, 2048))])
@pytest.mark.parametrize("arch", sorted(TINY))
def test_multimodal_config_and_stage_graph_equal_reference(arch, kw):
    want = jmodel.multimodal_config(arch, **kw)
    got = multimodal_config(arch, **kw)
    assert _cfg_fields(got) == _cfg_fields(want)
    assert _cfg_fields(got.lm_cfg) == _cfg_fields(want.lm_cfg)
    assert _cfg_fields(got.enc_cfg) == _cfg_fields(want.enc_cfg)
    assert (got.num_stages, got.text_stage, got.fusion_stage,
            got.fused_seq) == (want.num_stages, want.text_stage,
                               want.fusion_stage, want.fused_seq)
    assert got.stage_graph().edges == want.stage_graph().edges
    for split in (False, True):
        gs, ws = got.spec(5, split), want.spec(5, split)
        key = lambda t: (int(t.kind), t.stage, t.mb, t.chunk)  # noqa: E731
        assert [key(t) for t in gs.tasks()] == [key(t) for t in ws.tasks()]
        assert gs.total_tasks() == ws.total_tasks()
    assert got.roles() == want.roles()
    assert got.fanin_edges() == want.fanin_edges()
    assert [got.role_of(s) for s in range(got.num_stages)] == \
        [want.role_of(s) for s in range(want.num_stages)]


@pytest.mark.parametrize("arch", sorted(TINY))
def test_param_layout_and_count_equal_reference(arch):
    jm, jp, tm, tp = _both(arch, **TINY[arch])
    assert tm.param_count() == jm.param_count()
    for s, (t, j) in enumerate(zip(tp, jp)):
        for name, p in t.named_parameters():
            assert p.dtype == torch.float32, (s, name)


# ---------------------------------------------------------------------------
# the encoder's plain float32 math
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("length,bucket,slots", [
    (1, 8, 4), (5, 8, 4), (14, 16, 4), (24, 24, 4), (3, 24, 2), (0, 8, 3)])
def test_pool_weights_match_reference(length, bucket, slots):
    want = jmodel.pool_weights(jnp.asarray(length, jnp.int32), bucket, slots)
    got = tmodel.pool_weights(length, bucket, slots)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("arch,length,bucket", [
    (arch, length, bucket) for arch in sorted(TINY)
    for length, bucket in ((5, 8), (14, 16), (16, 16), (20, 24), (1, 24))
    if bucket <= max(TINY[arch]["buckets"])])
def test_masked_encoder_attention_matches_reference(arch, length, bucket):
    jm, jp, tm, tp = _both(arch, **TINY[arch])
    ecfg_j, ecfg_t = jm.cfg.enc_cfg, tm.cfg.enc_cfg
    pad_to = max(tm.cfg.buckets)
    rng = np.random.default_rng(length * 31 + bucket)
    x = rng.standard_normal((ROWS, bucket, tm.cfg.d_enc)).astype(np.float32)
    want = jmodel.masked_encoder_attention(
        jp[0]["layers"][0]["attn"], jnp.asarray(x),
        jnp.asarray(length, jnp.int32), ecfg_j, pad_to)
    got = tmodel.masked_encoder_attention(
        tp[0].layers[0].attn, torch.from_numpy(x), length, ecfg_t, pad_to)
    np.testing.assert_allclose(got.detach().numpy()[:, :length],
                               np.asarray(want)[:, :length], atol=TOL,
                               rtol=TOL)
    # the whole encoder stage, padding rows included
    want = jm.encoder_forward(0, jp[0], jnp.asarray(x),
                              jnp.asarray(length, jnp.int32))
    got = tm.encoder_forward(0, tp[0], torch.from_numpy(x), length)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)


def test_mrope_config_without_positions_takes_plain_rope():
    """qwen2-vl-2b (``mrope=True``): no M-RoPE positions -> plain RoPE, as
    the reference's ``attention_block``; given three distinct position
    streams, M-RoPE, as the reference's, and not the plain rotation."""
    jm, jp, tm, tp = _both("qwen2-vl-2b", **TINY["qwen2-vl-2b"])
    cfg_j, cfg_t = jm.cfg.lm_cfg, tm.cfg.lm_cfg
    assert cfg_t.mrope and cfg_j.mrope
    rng = np.random.default_rng(3)
    x = rng.standard_normal((ROWS, SEQ, cfg_t.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(SEQ, dtype=np.int32), (ROWS, SEQ)).copy()
    t = tm.cfg.text_stage
    want = jlayers.attention_block(jp[t]["layers"][0]["attn"],
                                   jnp.asarray(x), jnp.asarray(pos), cfg_j)
    got = layers.attention_block(tp[t].layers[0].attn, torch.from_numpy(x),
                                 torch.from_numpy(pos), cfg_t)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)
    pos3 = np.stack([pos, rng.integers(0, 4, pos.shape),
                     rng.integers(0, 6, pos.shape)]).astype(np.int32)
    want_m = jlayers.attention_block(
        jp[t]["layers"][0]["attn"], jnp.asarray(x), jnp.asarray(pos), cfg_j,
        mrope_pos=jnp.asarray(pos3))
    got_m = layers.attention_block(
        tp[t].layers[0].attn, torch.from_numpy(x), torch.from_numpy(pos),
        cfg_t, mrope_pos=torch.from_numpy(pos3))
    np.testing.assert_allclose(got_m.detach().numpy(), np.asarray(want_m),
                               atol=TOL, rtol=TOL)
    assert (got_m - got).abs().max() > 1e-3


def test_language_qwen2_vl_matches_reference_train_actor():
    """The language workload feeds qwen2-vl its 3-axis positions (equal
    streams from ``synth_batch``) and embeddings: the port's losses are
    the reference's ``train_actor``'s on its weights, within 1e-4."""
    from test_torch_train import _check_trajectory

    _check_trajectory(["--arch", "qwen2-vl-2b", "--stages", "2", "--layers",
                       "2", "--microbatches", "2", "--seq", "8", "--steps",
                       "3", "--device", "cpu"], falls=False)


def test_bf16_model_promotes_as_the_reference():
    """A bfloat16 model: the float32 encoder input keeps the encoder, fusion
    and LM stages in float32 (the reference promotes float32 x bfloat16
    products), the text stage stays bfloat16.  Each port stage, given the
    reference's stage inputs, agrees within the bfloat16 tolerance (the
    text stage's bf16 roundings differ by an ulp, which later stages would
    carry), and so does the end-to-end loss."""
    kw = dict(enc_stages=1, lm_stages=2, enc_layers_per_stage=1,
              lm_layers_per_stage=1, text_seq=SEQ, mean_enc_tokens=14,
              buckets=BUCKETS)
    jcfg = jmodel.multimodal_config("qwen2-vl-2b", **kw)
    jcfg = dataclasses.replace(jcfg, lm_cfg=dataclasses.replace(
        jcfg.lm_cfg, dtype=jnp.bfloat16))
    tcfg = multimodal_config("qwen2-vl-2b", **kw)
    tcfg = dataclasses.replace(tcfg, lm_cfg=dataclasses.replace(
        tcfg.lm_cfg, dtype=torch.bfloat16))
    jm, tm = jmodel.MultimodalModel(jcfg), tmodel.MultimodalModel(tcfg)
    jp = jm.init_stage_params(jax.random.key(0))
    tp = multimodal_params_from_reference(tm, _np_tree(jp), "cpu")
    b = jsynthetic.multimodal_batch(jcfg, 2, 1)
    n = int(b["enc_lens"][0])
    xj = jm.encoder_forward(0, jp[0], jnp.asarray(b["enc_embeds"][0]), n)
    tj = jm.text_forward(jp[1], jnp.asarray(b["tokens"][:1]))
    fj = jm.fusion_forward(jp[2], xj, n, tj)
    lj = jm.lm_forward(jp[3], fj)
    lossj = jm.loss_sum(jp[3], lj, jnp.asarray(b["labels"][:1]))
    tb = _torch_batch(b)

    xr = torch.from_numpy(np.array(xj))
    tr = torch.from_numpy(np.array(tj, np.float32)).bfloat16()
    fr = torch.from_numpy(np.array(fj))
    with torch.no_grad():
        xt = tm.encoder_forward(0, tp[0], tb["enc_embeds"][0], n)
        tt = tm.text_forward(tp[1], tb["tokens"][:1])
        ft = tm.fusion_forward(tp[2], xr, n, tr)
        lt = tm.lm_forward(tp[3], fr)
        y = tm.lm_forward(tp[3], tm.fusion_forward(tp[2], xt, n, tt))
        losst = tm.loss_sum(tp[3], y, tb["labels"][:1])
    assert [a.dtype for a in (xt, tt, ft, lt, y)] == [
        torch.float32, torch.bfloat16, torch.float32, torch.float32,
        torch.float32]
    assert [a.dtype for a in (xj, tj, fj, lj)] == [
        jnp.float32, jnp.bfloat16, jnp.float32, jnp.float32]
    for got, want in ((xt, xj), (tt, tj), (ft, fj), (lt, lj)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=2e-2,
                                   rtol=2e-2)
    np.testing.assert_allclose(float(losst), float(lossj), rtol=2e-2)


# ---------------------------------------------------------------------------
# one DAG step against the reference; the port's bitwise properties
# ---------------------------------------------------------------------------
def _run_step(pkg, fns, params, cfg, *, bucketing=True, split=False, cap=0,
              chaos=None, seed=0, step=0, mode="hint", deterministic=True,
              m=M, rows=ROWS):
    """tests/test_multimodal.py::run_step for either package."""
    jax_side = pkg == "ref"
    batch = (jsynthetic.multimodal_batch if jax_side else multimodal_batch)(
        cfg, m, rows, seed=0, step=step, bucketing=bucketing)
    if jax_side:
        from repro.core.hints import HintKind as JHint
        from repro.runtime.rrfp import ActorConfig as JConfig
        from repro.runtime.rrfp import ActorDriver as JDriver
        prog_cls, hint, conf, drv = (jstagefn.MultimodalStageProgram, JHint,
                                     JConfig, JDriver)
    else:
        batch = _torch_batch(batch)
        prog_cls, hint, conf, drv = (MultimodalStageProgram, HintKind,
                                     ActorConfig, ActorDriver)
    programs = [prog_cls(fns, s, params[s], batch, split_backward=split,
                         deterministic_reduction=deterministic)
                for s in range(cfg.num_stages)]
    acfg = conf(mode=mode, hint=hint.BFW if split else hint.BF,
                fixed_order="zb" if split else "1f1b", w_defer_cap=cap,
                deadlock_timeout=120.0, chaos=chaos, seed=seed)
    drv(cfg.spec(m, split_backward=split), None, acfg).run_threaded(
        list(programs))
    for p in programs:
        p.finalize()
    return programs


def _port_fns(tm, rows=ROWS, m=M):
    return MultimodalStageFns(tm, MultimodalStageOptions(
        mb_rows=rows, loss_scale=1.0 / (m * rows * tm.cfg.text_seq)))


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("arch", sorted(TINY))
def test_dag_step_matches_reference_loss_and_grads(arch, split):
    jm, jp, tm, tp = _both(arch, **TINY[arch])
    m, rows = (M, ROWS) if arch == "qwen2-vl-2b" else (2, 1)
    jfns = jstagefn.MultimodalStageFns(jm, jstagefn.MultimodalStageOptions(
        mb_rows=rows, loss_scale=1.0 / (m * rows * jm.cfg.text_seq)))
    want = _run_step("ref", jfns, jp, jm.cfg, split=split, m=m, rows=rows)
    got = _run_step("port", _port_fns(tm, rows, m), tp, tm.cfg, split=split,
                    m=m, rows=rows)
    loss_w = float(sum(p.loss_acc for p in want))
    loss_g = float(sum(p.loss_acc for p in got))
    np.testing.assert_allclose(loss_g, loss_w, rtol=1e-5)
    for s, (g, w) in enumerate(zip(got, want)):
        names = [n for n, _ in g.params.named_parameters()]
        assert len(names) == len(g.d_params)
        for name, dp in zip(names, g.d_params):
            ref = np.asarray(_leaf(w.d_params, name))
            dp = np.zeros(ref.shape, np.float32) if dp is None else dp.numpy()
            np.testing.assert_allclose(dp, ref, atol=TOL, rtol=1e-4,
                                       err_msg=f"stage {s} {name}")
        assert max(p.w_high_water for p in got) >= (1 if split else 0)


def _leaf(tree, dotted):
    for part in dotted.split("."):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


@pytest.fixture(scope="module")
def tiny():
    tm = multimodal_model("qwen2-vl-2b", **TINY["qwen2-vl-2b"])
    tp = tm.init_stage_params(seed=0, device="cpu")
    return tm, tp, _port_fns(tm)


def _bits(programs):
    loss = np.asarray(float(sum(p.loss_acc for p in programs)),
                      np.float32).tobytes()
    grads = b"".join(b"" if g is None else g.numpy().tobytes()
                     for p in programs for g in p.d_params)
    return loss, grads


def test_chaotic_run_matches_fixed_order_bitwise(tiny):
    tm, tp, fns = tiny
    chaos = ChaosConfig(seed=5, latency_base=1e-3, reorder_prob=0.5,
                        reorder_window=5e-3, duplicate_prob=0.3,
                        straggler=((1, 2.0),), stall_prob=0.1,
                        stall_scale=3e-3)
    a = _bits(_run_step("port", fns, tp, tm.cfg))
    b = _bits(_run_step("port", fns, tp, tm.cfg, chaos=chaos, seed=9))
    c = _bits(_run_step("port", fns, tp, tm.cfg, mode="precommitted"))
    assert a == b, "chaotic run diverged from clean run"
    assert a == c, "hint run diverged from fixed-order reference"


def test_bfw_split_matches_fused_bitwise(tiny):
    tm, tp, fns = tiny
    a = _bits(_run_step("port", fns, tp, tm.cfg))
    d = _bits(_run_step("port", fns, tp, tm.cfg, split=True, cap=2))
    e = _bits(_run_step("port", fns, tp, tm.cfg, split=True,
                        mode="precommitted"))
    assert a == d
    assert d == e
    progs = _run_step("port", fns, tp, tm.cfg, split=True, cap=2)
    assert max(p.w_high_water for p in progs) <= 2
    assert all(p.w_outstanding() == 0 for p in progs)


@pytest.mark.parametrize("step", [0, 1, 2])
def test_bucketed_agrees_with_unbucketed(tiny, step):
    """Padding to a bucket moves the loss and gradients by rounding only
    (not bitwise: the reference fails that property on this tree)."""
    tm, tp, fns = tiny
    a = _run_step("port", fns, tp, tm.cfg, step=step)
    b = _run_step("port", fns, tp, tm.cfg, step=step, bucketing=False)
    np.testing.assert_allclose(float(sum(p.loss_acc for p in a)),
                               float(sum(p.loss_acc for p in b)), rtol=1e-6)
    for pa, pb in zip(a, b):
        for ga, gb in zip(pa.d_params, pb.d_params):
            np.testing.assert_allclose(ga.numpy(), gb.numpy(), atol=1e-6,
                                       rtol=1e-5)


def test_fusion_fan_in_payload_routing(tiny):
    """The fusion stage's F sees one payload per incoming edge; its B
    returns one input gradient per branch."""
    tm, tp, fns = tiny
    cfg = tm.cfg
    batch = _torch_batch(multimodal_batch(cfg, M, ROWS, seed=0, step=0))
    prog = MultimodalStageProgram(fns, cfg.fusion_stage,
                                  tp[cfg.fusion_stage], batch)
    h_enc = torch.zeros((ROWS, BUCKETS[0], cfg.d_enc))
    h_txt = torch.zeros((ROWS, cfg.text_seq, cfg.d_model))
    y = prog(Task(Kind.F, cfg.fusion_stage, 0),
             {cfg.enc_stages - 1: h_enc, cfg.text_stage: h_txt})
    assert y.shape == (ROWS, cfg.fused_seq, cfg.d_model)
    dx = prog(Task(Kind.B, cfg.fusion_stage, 0), torch.zeros_like(y))
    assert isinstance(dx, EdgePayloads)
    assert set(dx) == {cfg.enc_stages - 1, cfg.text_stage}
    assert dx[cfg.enc_stages - 1].shape == h_enc.shape
    assert dx[cfg.text_stage].shape == h_txt.shape


def test_non_multimodal_archs_are_refused():
    with pytest.raises(ValueError, match="not a multimodal arch"):
        multimodal_config("deepseek-7b")
    for arch in sorted(TINY):
        cfg = multimodal_config(arch)
        assert cfg.num_stages == cfg.enc_stages + 1 + cfg.lm_stages
    with pytest.raises(SystemExit, match="multimodal arch"):
        train.main(["--workload", "multimodal", "--arch", "deepseek-7b",
                    "--device", "cpu", "--steps", "1"])
    with pytest.raises(SystemExit, match="--stages >= 3"):
        train.main(["--workload", "multimodal", "--stages", "2",
                    "--device", "cpu", "--steps", "1"])
    with pytest.raises(SystemExit, match="replay-trace"):
        train.main(["--workload", "multimodal", "--replay-trace", "x",
                    "--device", "cpu", "--steps", "1"])


# ---------------------------------------------------------------------------
# the launcher: train_multimodal against the reference's
# ---------------------------------------------------------------------------
MM_ARGS = ["--workload", "multimodal", "--stages", "4", "--layers", "2",
           "--microbatches", "4", "--mb-rows", "1", "--seq", "16",
           "--steps", "3", "--device", "cpu"]


def _reference_ns(port_args):
    ns = vars(port_args).copy()
    ns.update(runtime="actor", metrics_report=False, export_perfetto=None,
              explain=False)
    return argparse.Namespace(**ns)


def _reference_init(args):
    def init(model, device):
        enc, lm = train._multimodal_stage_split(args.stages)
        jm = jmodel.multimodal_model(
            args.arch, enc_stages=enc, lm_stages=lm, text_seq=args.seq,
            reduced=not args.full_size, num_layers=args.layers)
        jp = jm.init_stage_params(jax.random.key(args.seed))
        return multimodal_params_from_reference(model, _np_tree(jp), device)

    return init


@pytest.mark.parametrize("arch,hint", [("qwen2-vl-2b", "bf"),
                                       ("qwen2-vl-2b", "bfw"),
                                       ("seamless-m4t-large-v2", "bf")])
def test_train_multimodal_losses_match_reference(arch, hint):
    argv = MM_ARGS + ["--arch", arch] + (
        ["--hint", "bfw", "--split-backward"] if hint == "bfw" else [])
    args = train.parser().parse_args(argv)
    want = jtrain.train_multimodal(_reference_ns(args))
    got = train.train_multimodal(args, init_params=_reference_init(args))
    assert len(got.losses) == 3 and len(got.step_seconds) == 3
    np.testing.assert_allclose(got.losses, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch,flags", [
    ("qwen2-vl-2b", []), ("qwen2-vl-2b", ["--hint", "bfw",
                                          "--split-backward"]),
    ("seamless-m4t-large-v2", ["--chaos", "C2"]),
    ("qwen2-vl-2b", ["--schedule", "1f1b", "--stages", "6"])])
def test_sim_substrate_makespans_equal_reference(arch, flags):
    argv = MM_ARGS + ["--arch", arch, "--substrate", "sim"] + flags
    args = train.parser().parse_args(argv)
    want = jtrain.train_multimodal(_reference_ns(args))
    got = train.main(argv)
    assert got.makespans == want and not got.losses


def test_model_keyword_replaces_the_flags_config():
    """``train_multimodal(args, model=...)`` trains the caller's model."""
    argv = MM_ARGS + ["--steps", "1"]
    args = train.parser().parse_args(argv)
    model = multimodal_model("qwen2-vl-2b", enc_stages=1, lm_stages=2,
                             enc_layers_per_stage=1, lm_layers_per_stage=1,
                             text_seq=16, mean_enc_tokens=40,
                             buckets=(32, 64))
    seen = []
    run = train.train_multimodal(args, model=model, step_hook=seen.append)
    assert seen == [0] and np.isfinite(run.losses[0])


# ---------------------------------------------------------------------------
# K1 at head_dim 256: the plan of the CUDA source
# ---------------------------------------------------------------------------
_CU = (Path(fa.__file__).parent / "csrc" / "flash_attention.cu").read_text()
_F32, _TC = _CU.split("namespace tc {", 1)
SMEM_LIMIT = 232_448  # bytes a block can opt in to on an H100
#: gemma3-4b's attention at seq 2048 (local window 1024, global), ragged
GEMMA_SHAPES = [(1, 2048, 8, 4, 256, 1024), (1, 2048, 8, 4, 256, 0),
                (1, 1000, 8, 4, 256, 300)]


def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])


def test_k1_head_dim_256_plan_fits_the_card():
    """Shared memory of both hd 256 instantiations within the opt-in limit
    (from the source's constants and formulas); the bf16 kernel at hd 256
    with its query fragments staged in shared memory and two column groups
    of warps, so a thread's O accumulator is 64 registers, not 128; the
    grid of each gemma3 shape, and its tile plan covering every unmasked
    pair once."""
    assert 256 in fa.HEAD_DIMS
    limit, small, large = map(int, re.search(
        r"return HD <= (\d+) \? (\d+) : (\d+);", _TC).groups())
    bm = small if 256 <= limit else large
    pad, bn, warps = _const(_TC, "PAD"), _const(_TC, "BLOCK_N"), \
        _const(_TC, "WARPS")
    assert "(block_m<HD>() + 4 * BLOCK_N) * (HD + PAD)" in _TC
    tc_smem = 2 * (bm + 4 * bn) * (256 + pad)
    assert tc_smem == 168_960 <= SMEM_LIMIT
    assert re.search(r"q_in_regs\(\)\s*{\s*return HD <= 128;", _TC)
    groups = re.search(r"col_groups\(\)\s*{\s*return HD <= 128 \? 1 : "
                       r"(\d+);", _TC)
    cg = int(groups[1])
    # per thread: O accumulator [BM/16/WARPS m16 tiles][hd/8/groups][4]
    assert bm // (16 * warps) * (256 // 8 // cg) * 4 == 64
    threads = 32 * warps * cg
    assert threads == 256 and (bm * 256 // 8) % threads == 0  # tile copies
    assert (bn * 256 // 8) % threads == 0
    f_bm, f_bn = _const(_F32, "BLOCK_M"), _const(_F32, "BLOCK_N")
    assert "3 * BLOCK_M * (HD + 1) + BLOCK_M * LP" in _F32
    f32_smem = 4 * (3 * f_bm * (256 + 1) + f_bm * (f_bn + 1))
    assert f32_smem == 214_016 <= SMEM_LIMIT
    assert re.search(r"case 256:\s*return launch<256>", _CU)
    for b, sq, hq, hkv, hd, window in GEMMA_SHAPES:
        blocks = hq * b * -(-sq // bm)
        assert blocks == 8 * -(-sq // 64)
        # every query row's keys are covered once by the tiles its block
        # visits (heaviest first), and no visited tile is fully masked
        qp, kp = np.arange(sq)[:, None], np.arange(sq)[None]
        valid = (qp >= kp) & ((qp - kp < window) if window else True)
        seen = np.zeros((sq, sq), np.int32)
        for z in range(-(-sq // bm)):
            m0 = (-(-sq // bm) - 1 - z) * bm
            first = m0 - window + 1
            n0 = first // bn * bn if window > 0 and first > 0 else 0
            for n in range(n0, min(sq, m0 + bm), bn):
                rows, keys = slice(m0, m0 + bm), slice(n, n + bn)
                assert valid[rows, keys].any()
                seen[rows, keys] += 1
        assert (seen[valid] == 1).all()
