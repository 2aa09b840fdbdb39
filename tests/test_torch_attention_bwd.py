"""K1b, the bf16 attention backward (``flash_attention_bwd``), against the
plain backward (``flash_attention_bwd_plain``) on the card: every head dim
the forward takes, causal, windowed and non-causal with sq != sk, GQA; a
second launch bitwise; one count a call; float32 and CPU tensors on the
plain route, counting nothing; and a BFW split step (dX, then W) bitwise
the fused B.  The kernel's tile plans and arithmetic are checked on the CPU
in tests/test_torch_kernels.py.

No JAX here: the card's machine runs this file (``python -m pytest
tests/test_torch_attention_bwd.py``); without a card the tests marked
``cuda`` skip.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models.build import build
from repro_torch.pipeline.stagefn import StageFnOptions, StageFns, microbatch

TOL = 2e-2  # bf16, as the forward's checks
#: (b, sq, sk, hq, hkv, hd, window, causal): each head dim of the kernel;
#: causal MHA, GQA 12/2 (qwen2-vl) and 8/4 at hd 256 with a window
#: (gemma3), MQA, ragged lengths; non-causal sq != sk both ways
CARD_CASES = [
    (1, 2048, 2048, 16, 16, 96, 0, True),
    (1, 2048, 2048, 12, 2, 128, 0, True),
    (2, 333, 333, 8, 2, 64, 0, True),
    (1, 777, 777, 4, 1, 32, 256, True),
    (1, 1100, 1100, 4, 4, 64, 300, True),
    (1, 2048, 2048, 8, 4, 256, 1024, True),
    (1, 1000, 1000, 8, 4, 256, 300, True),
    (1, 200, 200, 4, 4, 32, 0, True),
    (2, 333, 517, 8, 2, 96, 0, False),
    (1, 517, 333, 4, 1, 128, 0, False),
    (1, 700, 1100, 8, 4, 256, 0, False),
    (1, 2048, 1536, 16, 16, 64, 0, False),
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode "
                    "(chip_smoke.py runs it on the card)")


def _inputs(b, sq, sk, hq, hkv, hd, dtype, device, seed):
    """Pre-scaled q, k, v, and dout in the model's [b, s, h, hd] storage
    viewed as the kernel's [b, h, s, hd]."""
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((b, sq, hq, hd), generator=g, device=device) * hd ** -0.5
    k = torch.randn((b, sk, hkv, hd), generator=g, device=device)
    v = torch.randn((b, sk, hkv, hd), generator=g, device=device)
    do = torch.randn((b, sq, hq, hd), generator=g, device=device)
    return tuple(t.to(dtype).transpose(1, 2) for t in (q, k, v, do))


def test_cpu_and_float32_take_the_plain_backward_and_count_nothing():
    """On the CPU (here and on the card) both dtypes take the plain version
    itself; the card's float32 is in the test below."""
    ops.reset_launch_counts()
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = _inputs(1, 40, 40, 4, 2, 32, dtype, "cpu", seed=1)
        out, lse = fa.flash_attention_fwd(q, k, v, window=16)
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, window=16,
                                     dq_scale=0.5)
        want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, window=16,
                                            dq_scale=0.5)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.launch_counts()["flash_attention_bwd"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,hq,hkv,hd,window,causal", CARD_CASES)
def test_k1b_matches_the_plain_backward_on_card(b, sq, sk, hq, hkv, hd,
                                                window, causal):
    _card()
    q, k, v, do = _inputs(b, sq, sk, hq, hkv, hd, torch.bfloat16, "cuda",
                          seed=sq + sk + hd)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    ops.reset_launch_counts()
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                 window=window, dq_scale=0.7)
    assert ops.launch_counts()["flash_attention_bwd"] == 1
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal,
                                        window=window, dq_scale=0.7)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == w.shape and a.dtype == torch.bfloat16, name
        # the model's layout: [b, s, h, hd] contiguous behind the view
        assert a.transpose(1, 2).is_contiguous(), name
        assert torch.isfinite(a.float()).all(), name
        torch.testing.assert_close(a.float(), w.float(), atol=TOL, rtol=TOL,
                                   msg=name)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                   window=window, dq_scale=0.7)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert ops.launch_counts()["flash_attention_bwd"] == 2


@pytest.mark.cuda
def test_float32_on_the_card_takes_the_plain_backward():
    _card()
    q, k, v, do = _inputs(1, 300, 300, 4, 2, 64, torch.float32, "cuda", 3)
    out, lse = fa.flash_attention_fwd(q, k, v)
    ops.reset_launch_counts()
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, dq_scale=0.5)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, dq_scale=0.5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.launch_counts()["flash_attention_bwd"] == 0
    # the kernel takes the forward's bf16 head dims only
    q, k, v, do = _inputs(1, 64, 64, 2, 2, 16, torch.bfloat16, "cuda", 4)
    with pytest.raises(ValueError, match="head_dim 16"):
        fa.flash_attention_bwd(q, k, v, q, torch.zeros(1, 2, 64,
                                                       device="cuda"), do)


@pytest.mark.cuda
def test_split_backward_equals_the_fused_one_on_card():
    """qwen2-vl-2b at full width cut to 2 layers, bf16, 2 stages of one
    layer: the BFW split backward (dX, then W) equals the fused B bit for
    bit at each stage, through K1b (it launches once a layer and pass)."""
    _card()
    cfg = registry.cut_depth("qwen2-vl-2b", 2)
    seq, mb_rows = 256, 1
    model = build(cfg, num_stages=2)
    stages = [model.init_stage_params(s, seed=0, device="cuda")
              for s in range(2)]
    io = model.init_io_params(seed=0, device="cuda")
    rng = np.random.default_rng(2)
    batch = {
        "tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (mb_rows, seq))).cuda(),
        "labels": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (mb_rows, seq))).cuda(),
        "embeds": torch.from_numpy(rng.standard_normal(
            (mb_rows, seq, cfg.d_model)).astype(np.float32)).cuda(),
        "mrope": torch.from_numpy(np.stack([
            np.cumsum(rng.integers(0, 2, (mb_rows, seq)), 1),
            rng.integers(0, 6, (mb_rows, seq)),
            rng.integers(0, 9, (mb_rows, seq))])).cuda()}
    fns = StageFns(model, StageFnOptions(mb_rows=mb_rows, seq_len=seq,
                                         loss_scale=1.0 / (mb_rows * seq)))
    bm = microbatch(batch, 0, mb_rows)
    y0, _ = fns.forward(0)(stages[0], io, None, bm)
    g = torch.randn(y0.shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(1))
    ops.reset_launch_counts()
    for s, x, g_in in ((1, y0, None), (0, None, g)):
        dx_f, dsp_f, dio_f = fns.backward(s)(stages[s], io, x, g_in, bm)
        dsp_s, dio_s = fns.weight_grad(s)(stages[s], io, x, g_in, bm)
        if s > 0:
            dx_s = fns.backward_dx(s)(stages[s], io, x, g_in, bm)
            assert torch.equal(dx_f, dx_s)
        for a, b in zip(dsp_f + dio_f, dsp_s + dio_s):
            assert (a is None and b is None) or torch.equal(a, b)
    # stage 1: B, W and dX; stage 0: B and W (one attention layer each)
    assert ops.launch_counts()["flash_attention_bwd"] == 5
