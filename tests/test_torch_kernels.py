"""Port kernels K1 (flash attention) and K2 (RMSNorm) against the reference.

On the CPU the port's wrappers run the kernels' plain PyTorch versions; the
reference runs its Pallas kernels in interpret mode (and its XLA VJPs for
the gradients).  Inputs come from numpy seeds and go to both.  Tolerances:
float32 2e-5 (``TOL`` of tests/test_kernels.py), bfloat16 2e-2.  The CUDA
and Triton kernels themselves run only on the card (marker ``cuda``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels.ref import attention_ref, rmsnorm_ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
#: tests/test_kernels.py shapes: MHA, ragged GQA, MQA hd 128, window, tiny
SHAPES = [
    (1, 128, 4, 4, 64, 0),
    (2, 200, 8, 2, 64, 0),
    (1, 384, 8, 1, 128, 0),
    (2, 160, 4, 4, 64, 64),
    (1, 96, 4, 2, 32, 0),
]


def both(a: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def attn_inputs(b, sq, hq, hkv, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, hq, hd)).astype(np.float32),
            rng.standard_normal((b, sq, hkv, hd)).astype(np.float32),
            rng.standard_normal((b, sq, hkv, hd)).astype(np.float32))


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,hq,hkv,hd,window", SHAPES)
def test_flash_attention_matches_pallas_interpret(b, sq, hq, hkv, hd, window,
                                                  dtype):
    qn, kn, vn = attn_inputs(b, sq, hq, hkv, hd, seed=sq * 7 + hq)
    (qj, qt), (kj, kt), (vj, vt) = (both(a, dtype) for a in (qn, kn, vn))
    pos = jnp.broadcast_to(jnp.arange(sq)[None], (b, sq))
    want = jops.flash_attention(qj, kj, vj, pos, causal=True, window=window,
                                backend="interpret")
    got = ops.flash_attention(qt, kt, vt, causal=True, window=window)
    assert got.shape == (b, sq, hq, hd) and got.dtype == qt.dtype
    close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,hq,hkv,hd,window", SHAPES)
def test_flash_attention_lse_matches_reference(b, sq, hq, hkv, hd, window,
                                               dtype):
    """The port's kernel also returns the row log-sum-exp; the reference's
    streaming forward computes the same quantity for its VJP."""
    qn, kn, vn = attn_inputs(b, sq, hq, hkv, hd, seed=sq + hd)
    (qj, qt), (kj, kt), (vj, vt) = (both(a, dtype) for a in (qn, kn, vn))
    pos = jnp.broadcast_to(jnp.arange(sq)[None], (b, sq))
    _, lse_j = jlayers._blocked_attention_fwd_impl(qj, kj, vj, pos, True,
                                                   window, 128)
    qs = (qt * hd ** -0.5).to(qt.dtype).transpose(1, 2)
    out, lse = fa.flash_attention_fwd(qs, kt.transpose(1, 2),
                                      vt.transpose(1, 2), causal=True,
                                      window=window)
    assert out.shape == (b, hq, sq, hd) and lse.dtype == torch.float32
    # bf16 inputs: the reference's CPU scores round through bf16
    close(lse, np.asarray(lse_j).reshape(b, hq, sq), TOL[dtype])


@pytest.mark.parametrize("b,sq,hq,hkv,hd,window", SHAPES)
def test_flash_attention_grad_matches_jax_grad(b, sq, hq, hkv, hd, window):
    qn, kn, vn = attn_inputs(b, sq, hq, hkv, hd, seed=sq + 3)
    cot = np.random.default_rng(sq).standard_normal(
        (b, sq, hq, hd)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(sq)[None], (b, sq))

    def f(q, k, v):
        o = jlayers.blocked_attention(q, k, v, pos, True, window, 256)
        return jnp.sum(o * cot)

    want = jax.grad(f, argnums=(0, 1, 2))(qn, kn, vn)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (qn, kn, vn))
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    got = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), (q, k, v))
    for g, w in zip(got, want):
        close(g, w, TOL["float32"])


def test_plain_attention_matches_oracle():
    qn, kn, vn = attn_inputs(2, 200, 8, 2, 64, seed=0)
    q, k, v = (torch.from_numpy(a) for a in (qn, kn, vn))
    pos = torch.arange(200)[None].expand(2, 200)
    for window in (0, 64):
        close(ops.flash_attention(q, k, v, causal=True, window=window),
              attention_ref(q, k, v, pos, True, window).numpy(), 2e-5)


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 100, 128), (1, 256), (3, 7, 512),
                                   (512, 1536)])
def test_rmsnorm_matches_pallas_interpret(shape, dtype):
    rng = np.random.default_rng(len(shape))
    xj, xt = both(rng.standard_normal(shape).astype(np.float32), dtype)
    sn = (rng.standard_normal(shape[-1]) * 0.1).astype(np.float32)
    want = jops.rmsnorm(xj, jnp.asarray(sn), backend="interpret")
    got = ops.rmsnorm(xt, torch.from_numpy(sn))
    assert got.shape == xt.shape and got.dtype == xt.dtype
    close(got, want, TOL[dtype])
    close(rmsnorm_ref(xt, torch.from_numpy(sn)), want, TOL[dtype])


@pytest.mark.parametrize("shape", [(4, 100, 128), (3, 7, 512)])
def test_rmsnorm_grad_matches_jax_grad(shape):
    rng = np.random.default_rng(11)
    xn = rng.standard_normal(shape).astype(np.float32)
    sn = (rng.standard_normal(shape[-1]) * 0.1).astype(np.float32)
    cot = rng.standard_normal(shape).astype(np.float32)
    want = jax.grad(lambda x, s: jnp.sum(jlayers.rmsnorm(x, s) * cot),
                    argnums=(0, 1))(xn, sn)
    x, s = torch.from_numpy(xn).requires_grad_(), torch.from_numpy(sn)
    s.requires_grad_()
    got = torch.autograd.grad((ops.rmsnorm(x, s) * torch.from_numpy(cot)).sum(),
                              (x, s))
    for g, w in zip(got, want):
        close(g, w, TOL["float32"])


# ---------------------------------------------------------------------------
# wrappers: CPU -> plain version, never a kernel; counts only on launch
# ---------------------------------------------------------------------------
def test_cpu_wrappers_take_plain_versions_and_count_nothing():
    ops.reset_launch_counts()
    x = torch.randn(8, 64)
    ops.rmsnorm(x, torch.zeros(64))
    q = torch.randn(1, 16, 2, 32)
    ops.flash_attention(q, q, q)
    assert ops.launch_counts() == {"flash_attention_fwd": 0, "rmsnorm": 0}


def test_wrappers_reject_devices_without_a_kernel():
    x = torch.randn(4, 32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        rn.rmsnorm(x, torch.zeros(32, device="meta"))
    q = torch.randn(1, 2, 16, 32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        fa.flash_attention_fwd(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_versions_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA/Triton kernels have no "
                    "CPU mode (chip_smoke.py runs them on the card)")
    td = DTYPES[dtype][1]
    ops.reset_launch_counts()
    for b, sq, hq, hkv, hd, window in SHAPES:
        qn, kn, vn = attn_inputs(b, sq, hq, hkv, hd, seed=1)
        q, k, v = (torch.from_numpy(a).to("cuda", td).transpose(1, 2)
                   for a in (qn, kn, vn))
        out, lse = fa.flash_attention_fwd(q, k, v, window=window)
        want, want_lse = fa.flash_attention_fwd_plain(q, k, v, window=window)
        close(out.cpu(), want.cpu().float().numpy(), TOL[dtype])
        close(lse.cpu(), want_lse.cpu().numpy(), 1e-4)
    x = torch.randn(2048, 1536, device="cuda").to(td)
    s = torch.randn(1536, device="cuda").to(td) * 0.1
    close(rn.rmsnorm(x, s).cpu(), rn.rmsnorm_plain(x, s).cpu().float().numpy(),
          TOL[dtype])
    assert ops.launch_counts() == {"flash_attention_fwd": len(SHAPES),
                                   "rmsnorm": 1}
