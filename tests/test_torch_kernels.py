"""Port kernels K1 (flash attention; causal and, for the enc-dec encoder
and cross-attention, non-causal with sq != sk), K2 (RMSNorm) and K3
(flash decode) against the reference.

On the CPU the port's wrappers run the kernels' plain PyTorch versions; the
reference runs its Pallas kernels in interpret mode (and its XLA VJPs for
the gradients).  Inputs come from numpy seeds and go to both.  Tolerances:
float32 2e-5 (``TOL`` of tests/test_kernels.py), bfloat16 2e-2.  The CUDA
and Triton kernels themselves run only on the card (marker ``cuda``).
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_fwd as jflash_fwd
from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels.ref import attention_ref, decode_ref, rmsnorm_ref

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
#: non-causal K1 (the enc-dec encoder and cross-attention), (b, sq, sk, hq,
#: hkv, hd): sq == sk, ragged and GQA; then sq != sk, keys ragged against
#: the 256-key block of the plain backward (300, 517), more queries than
#: keys, MQA
NONCAUSAL_SHAPES = [
    (1, 128, 128, 4, 4, 64),
    (2, 200, 200, 8, 2, 64),
    (2, 150, 300, 8, 2, 96),
    (1, 96, 517, 4, 1, 32),
    (1, 333, 280, 4, 4, 128),
]
#: tests/test_kernels.py decode shapes (b, S, hq, hkv, hd, length, window):
#: ragged GQA, MQA hd 128 at full length, a window, the first token
DECODE_SHAPES = [
    (2, 300, 8, 2, 64, 157, 0),
    (1, 1024, 4, 1, 128, 1024, 0),
    (2, 512, 4, 4, 64, 300, 128),
    (1, 64, 2, 2, 32, 1, 0),
]


def both(a: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def attn_inputs(b, sq, hq, hkv, hd, seed, sk=None):
    rng = np.random.default_rng(seed)
    sk = sq if sk is None else sk
    return (rng.standard_normal((b, sq, hq, hd)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, hd)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, hd)).astype(np.float32))


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,hq,hkv,hd", NONCAUSAL_SHAPES)
def test_noncausal_attention_matches_pallas_interpret(b, sq, sk, hq, hkv, hd,
                                                      dtype):
    """``causal=False``, also with sq != sk: the plain forward (out and
    lse) against the reference's K1 in interpret mode (it pads q and k
    apart) and the lse of its streaming forward."""
    qn, kn, vn = attn_inputs(b, sq, hq, hkv, hd, seed=sq + 5 * sk, sk=sk)
    (qj, qt), (kj, kt), (vj, vt) = (both(a, dtype) for a in (qn, kn, vn))
    pos = jnp.broadcast_to(jnp.arange(sq)[None], (b, sq))
    want = jops.flash_attention(qj, kj, vj, pos, causal=False,
                                backend="interpret")
    got = ops.flash_attention(qt, kt, vt, causal=False)
    assert got.shape == (b, sq, hq, hd) and got.dtype == qt.dtype
    close(got, want, TOL[dtype])
    _, lse_j = jlayers._blocked_attention_fwd_impl(qj, kj, vj, pos, False, 0,
                                                   128)
    qs = (qt * hd ** -0.5).to(qt.dtype).transpose(1, 2)
    _, lse = fa.flash_attention_fwd(qs, kt.transpose(1, 2),
                                    vt.transpose(1, 2), causal=False)
    close(lse, np.asarray(lse_j).reshape(b, hq, sq), TOL[dtype])


@pytest.mark.parametrize("b,sq,sk,hq,hkv,hd", NONCAUSAL_SHAPES)
def test_noncausal_attention_grad_matches_jax_grad(b, sq, sk, hq, hkv, hd):
    """``flash_attention_bwd_plain`` with ``causal=False`` (every key block
    unmasked but the ragged last) against ``jax.grad`` of the reference's
    ``blocked_attention`` (its lse VJP, 256-key blocks)."""
    qn, kn, vn = attn_inputs(b, sq, hq, hkv, hd, seed=sk + 3, sk=sk)
    cot = np.random.default_rng(sk).standard_normal(
        (b, sq, hq, hd)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(sq)[None], (b, sq))

    def f(q, k, v):
        o = jlayers.blocked_attention(q, k, v, pos, False, 0, 256)
        return jnp.sum(o * cot)

    want = jax.grad(f, argnums=(0, 1, 2))(qn, kn, vn)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (qn, kn, vn))
    out = ops.flash_attention(q, k, v, causal=False)
    got = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), (q, k, v))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        close(g, w, TOL["float32"])


# K1's tensor-core kernel (bf16): its tile plan and its arithmetic, mirrored
# in Python.  These tests check the design as the source states it (the
# tile constants below are read from the source), not the built binary:
# only the card's comparison with the plain version checks the kernel.
_K1_TC = (Path(fa.__file__).parent / "csrc" / "flash_attention.cu"
          ).read_text().split("namespace tc {", 1)[1]
#: keys per tile (``tc::BLOCK_N``)
K1_BLOCK_N = int(re.search(r"constexpr int BLOCK_N = (\d+);", _K1_TC)[1])
#: ``tc::block_m``: (largest hd of the first value, first, second value)
K1_BLOCK_M_RULE = tuple(map(int, re.search(
    r"return HD <= (\d+) \? (\d+) : (\d+);", _K1_TC).groups()))
#: the training shapes of the main paths: gpt3 (hd 96) and zamba2 (hd 64)
TRAIN_SHAPES = [(1, 2048, 16, 16, 96, 0), (1, 2048, 32, 32, 64, 0)]
#: seamless's non-causal training shapes (b, sq, sk, hq, hkv, hd): the
#: encoder and the cross-attention at 2048 + 2048, and a cross-attention
#: over fewer frames than tokens
NONCAUSAL_TRAIN_SHAPES = [(1, 2048, 2048, 16, 16, 64),
                          (1, 2048, 1536, 16, 16, 64)]


def test_k1_plan_tests_cover_the_kernels_block_m():
    """The plan and arithmetic tests run BLOCK_M 64 and 128: the values
    that the source's ``tc::block_m`` takes at every head dim of K1."""
    limit, small, large = K1_BLOCK_M_RULE
    used = {small if hd <= limit else large for hd in fa.HEAD_DIMS}
    assert used <= {64, 128}


def k1_plan(sq, sk, window, block_m, causal=True, block_n=K1_BLOCK_N):
    """The bf16 kernel's blocks of one (head, batch row) in launch order
    (``blockIdx.z``), each as (first query row, the key tiles it visits):
    heaviest first, and only tiles that can hold an unmasked entry.  Also
    the plan of the backward's dq pass (``block_n`` its key tile)."""
    nq = -(-sq // block_m)
    plan = []
    for z in range(nq):
        m0 = (nq - 1 - z) * block_m
        n_end = min(sk, m0 + block_m) if causal else sk
        first = m0 - window + 1
        n_begin = (first // block_n * block_n
                   if window > 0 and first > 0 else 0)
        plan.append((m0, list(range(n_begin, n_end, block_n))))
    return plan


def k1_warp_flags(m0, n0, sk, window, block_m, warp, causal=True,
                  block_n=K1_BLOCK_N):
    """(idle, edge) of one of the 4 warps on a key tile: idle skips the
    tile, edge evaluates the mask (the kernel's predicates)."""
    wr0 = m0 + warp * block_m // 4
    wr1 = wr0 + block_m // 4 - 1
    idle = ((causal and n0 > wr1)
            or (window > 0 and n0 + block_n - 1 <= wr0 - window))
    edge = (n0 + block_n > sk or (causal and n0 + block_n - 1 > wr0)
            or (window > 0 and wr1 - n0 >= window))
    return idle, edge


def k1_valid(sq, sk, window, causal=True):
    qp, kp = np.arange(sq)[:, None], np.arange(sk)[None]
    valid = np.ones((sq, sk), bool)
    if causal:
        valid &= qp >= kp
    if window > 0:
        valid &= qp - kp < window
    return valid


@pytest.mark.parametrize("block_m", [64, 128])
@pytest.mark.parametrize("b,sq,hq,hkv,hd,window", SHAPES + TRAIN_SHAPES)
def test_k1_tile_plan_covers_every_unmasked_pair_once(b, sq, hq, hkv, hd,
                                                      window, block_m):
    valid = k1_valid(sq, sq, window)
    seen = np.zeros((sq, sq), np.int32)
    plan = k1_plan(sq, sq, window, block_m)
    for m0, tiles in plan:
        rows = slice(m0, min(sq, m0 + block_m))
        for n0 in tiles:
            keys = slice(n0, min(sq, n0 + K1_BLOCK_N))
            assert valid[rows, keys].any(), (m0, n0)  # no fully masked tile
            seen[rows, keys] += 1
            for warp in range(4):
                idle, edge = k1_warp_flags(m0, n0, sq, window, block_m, warp)
                w0 = m0 + warp * block_m // 4
                wv = valid[w0:min(sq, w0 + block_m // 4), keys]
                if idle:
                    assert not wv.any(), (m0, n0, warp)
                elif not edge:  # unmasked: every pair of a full tile valid
                    assert n0 + K1_BLOCK_N <= sq and wv.all(), (m0, n0, warp)
    assert (seen[valid] == 1).all() and seen.max() <= 1
    assert [m0 for m0, _ in plan] == sorted((m0 for m0, _ in plan),
                                            reverse=True)
    if window == 0:  # causal: the longest rows go out first
        work = [len(t) for _, t in plan]
        assert work == sorted(work, reverse=True)


@pytest.mark.parametrize("block_m", [64, 128])
@pytest.mark.parametrize("b,sq,sk,hq,hkv,hd",
                         NONCAUSAL_SHAPES + NONCAUSAL_TRAIN_SHAPES)
def test_k1_noncausal_tile_plan_covers_every_pair_once(b, sq, sk, hq, hkv,
                                                       hd, block_m):
    """``causal=False``: every query tile visits every key tile once
    (``n_end = sk``); no warp is idle; a warp masks only on the ragged last
    key tile, where the mask keeps exactly the keys below sk."""
    valid = k1_valid(sq, sk, 0, causal=False)
    seen = np.zeros((sq, sk), np.int32)
    plan = k1_plan(sq, sk, 0, block_m, causal=False)
    assert len(plan) == -(-sq // block_m)
    for m0, tiles in plan:
        rows = slice(m0, min(sq, m0 + block_m))
        assert tiles == list(range(0, sk, K1_BLOCK_N))
        for n0 in tiles:
            keys = slice(n0, min(sk, n0 + K1_BLOCK_N))
            seen[rows, keys] += 1
            for warp in range(4):
                idle, edge = k1_warp_flags(m0, n0, sk, 0, block_m, warp,
                                           causal=False)
                assert not idle
                assert edge == (n0 + K1_BLOCK_N > sk), (m0, n0, warp)
    assert valid.all() and (seen == 1).all()


def k1_bf16_emulation(q, k, v, window, block_m, causal=True):
    """The bf16 kernel's arithmetic on the CPU, block by block of its plan:
    S in float32 from the bf16 products, masked on edge tiles, running row
    max; p = exp(s - m) in float32, l summed from the unrounded p, P
    rounded to bf16 before P.V; out = acc / l rounded to bf16, lse = m +
    log l.  q [b, hq, sq, hd] pre-scaled, k, v [b, hkv, sk, hd], bf16."""
    b, hq, sq, hd = q.shape
    g, sk = hq // k.shape[1], k.shape[2]
    valid = torch.from_numpy(k1_valid(sq, sk, window, causal))
    qf = q.float()
    kf, vf = (t.float().repeat_interleave(g, 1) for t in (k, v))
    out = torch.empty(q.shape, dtype=torch.bfloat16)
    lse = torch.empty((b, hq, sq))
    for m0, tiles in k1_plan(sq, sk, window, block_m, causal):
        r = slice(m0, min(sq, m0 + block_m))
        m = torch.full((b, hq, r.stop - m0, 1), -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, hq, r.stop - m0, hd))
        for n0 in tiles:
            c = slice(n0, min(sk, n0 + K1_BLOCK_N))
            s = qf[:, :, r] @ kf[:, :, c].transpose(-1, -2)
            s = torch.where(valid[r, c], s, -1e30)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.where(valid[r, c], torch.exp(s - m_new), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + p.bfloat16().float() @ vf[:, :, c]
            m = m_new
        l = l.clamp_min(1e-30)
        out[:, :, r] = (acc / l).bfloat16()
        lse[:, :, r] = (m + torch.log(l))[..., 0]
    return out, lse


@pytest.mark.parametrize("b,sq,hq,hkv,hd,window", SHAPES)
def test_k1_bf16_arithmetic_matches_pallas_interpret(b, sq, hq, hkv, hd,
                                                     window):
    """P rounded to bf16 before P.V (the kernel's one extra rounding) stays
    within the bf16 tolerance of the Pallas kernel, for either BLOCK_M."""
    qn, kn, vn = attn_inputs(b, sq, hq, hkv, hd, seed=sq * 3 + hd)
    qn = qn * np.float32(hd ** -0.5)
    (qj, qt), (kj, kt), (vj, vt) = (both(a.transpose(0, 2, 1, 3).copy(),
                                         "bfloat16") for a in (qn, kn, vn))
    want = jflash_fwd(qj, kj, vj, causal=True, window=window, interpret=True)
    _, want_lse = fa.flash_attention_fwd_plain(qt, kt, vt, window=window)
    for block_m in (64, 128):
        out, lse = k1_bf16_emulation(qt, kt, vt, window, block_m)
        close(out, want, TOL["bfloat16"])
        close(lse, want_lse.numpy(), 1e-4)


@pytest.mark.parametrize("b,sq,sk,hq,hkv,hd", NONCAUSAL_SHAPES)
def test_k1_bf16_noncausal_arithmetic_matches_pallas_interpret(b, sq, sk, hq,
                                                               hkv, hd):
    """The bf16 kernel's arithmetic over its non-causal plan (sq != sk,
    ragged keys) against the Pallas kernel, for either BLOCK_M."""
    qn, kn, vn = attn_inputs(b, sq, hq, hkv, hd, seed=sq * 3 + sk, sk=sk)
    qn = qn * np.float32(hd ** -0.5)
    (qj, qt), (kj, kt), (vj, vt) = (both(a.transpose(0, 2, 1, 3).copy(),
                                         "bfloat16") for a in (qn, kn, vn))
    want = jflash_fwd(qj, kj, vj, causal=False, interpret=True)
    _, want_lse = fa.flash_attention_fwd_plain(qt, kt, vt, causal=False)
    for block_m in (64, 128):
        out, lse = k1_bf16_emulation(qt, kt, vt, 0, block_m, causal=False)
        close(out, want, TOL["bfloat16"])
        close(lse, want_lse.numpy(), 1e-4)


# K1b, the bf16 backward: its two passes' tile plans and their arithmetic,
# mirrored in Python from the constants of the source's ``bwd`` namespace.
_K1B = _K1_TC.split("namespace bwd {", 1)[1]
#: keys per tile of the dq pass and per block of the dk/dv pass
K1B_BLOCK_N = int(re.search(r"constexpr int BLOCK_N = (\d+);", _K1B)[1])
#: query rows per block of the dq pass
K1B_DQ_BLOCK_M = int(re.search(r"constexpr int DQ_BLOCK_M = (\d+);",
                               _K1B)[1])
#: ``bwd::kv_block_m``: (largest hd of the first value, first, second)
K1B_KV_BLOCK_M_RULE = tuple(map(int, re.search(
    r"kv_block_m\(\) \{\s*return HD <= (\d+) \? (\d+) : (\d+);",
    _K1B).groups()))
#: (b, sq, sk, hq, hkv, hd, window, causal): causal MHA and GQA (8/2, MQA
#: 8/1, ragged), windows, non-causal sq != sk with ragged keys, and the
#: main paths' training shapes (gpt3, zamba2, qwen2-vl 12/2, gemma3 8/4 at
#: hd 256 with its 1024 window, seamless's encoder and cross-attention)
K1B_PLAN_CASES = (
    [(b, s, s, hq, hkv, hd, w, True) for b, s, hq, hkv, hd, w in SHAPES]
    + [(b, sq, sk, hq, hkv, hd, 0, False)
       for b, sq, sk, hq, hkv, hd in NONCAUSAL_SHAPES]
    + [(1, 2048, 2048, 16, 16, 96, 0, True),
       (1, 2048, 2048, 32, 32, 64, 0, True),
       (1, 2048, 2048, 12, 2, 128, 0, True),
       (1, 2048, 2048, 8, 4, 256, 1024, True),
       (1, 1000, 1000, 8, 4, 256, 300, True),
       (1, 2048, 1536, 16, 16, 64, 0, False)])


def k1b_kv_block_m(hd):
    limit, small, large = K1B_KV_BLOCK_M_RULE
    return small if hd <= limit else large


def k1b_kv_plan(sq, sk, window, block_m, causal=True):
    """The dk/dv pass's blocks of one (query head, batch row) in launch
    order (``blockIdx.z``), each as (first key, the query tiles it visits):
    those that can hold an unmasked pair with the block's keys."""
    plan = []
    for z in range(-(-sk // K1B_BLOCK_N)):
        n0 = z * K1B_BLOCK_N
        m_begin = n0 // block_m * block_m if causal else 0
        m_end = (min(sq, n0 + K1B_BLOCK_N - 1 + window) if window > 0
                 else sq)
        plan.append((n0, list(range(m_begin, m_end, block_m))))
    return plan


def k1b_kv_warp_flags(n0, m0, sq, sk, window, block_m, warp, causal=True):
    """(idle, edge) of one of the 4 warps (16 keys each) on a query tile."""
    kw0 = n0 + 16 * warp
    kw1 = kw0 + 15
    idle = ((causal and m0 + block_m - 1 < kw0)
            or (window > 0 and m0 - kw1 >= window))
    edge = (kw1 >= sk or m0 + block_m > sq or (causal and m0 < kw1)
            or (window > 0 and m0 + block_m - 1 - kw0 >= window))
    return idle, edge


def test_k1b_plan_tests_cover_the_kernels_block_sizes():
    """The backward's plan and arithmetic tests run the dk/dv pass at query
    tiles of 32 and 64 rows: the values ``bwd::kv_block_m`` takes at every
    head dim of the kernel; each warp owns 16 rows or keys."""
    assert {k1b_kv_block_m(hd) for hd in fa.HEAD_DIMS} <= {32, 64}
    assert K1B_DQ_BLOCK_M == K1B_BLOCK_N == 64


@pytest.mark.parametrize("block_m", [32, 64])
@pytest.mark.parametrize("b,sq,sk,hq,hkv,hd,window,causal", K1B_PLAN_CASES)
def test_k1b_tile_plans_visit_every_unmasked_pair_once(b, sq, sk, hq, hkv,
                                                        hd, window, causal,
                                                        block_m):
    """Both passes of the backward score every unmasked (query, key) pair
    exactly once (each query head runs the same plan, in both passes its
    own blocks), visit no tile without one, and skip or mask by predicates
    that agree with the mask; the longest causal tiles go out first."""
    valid = k1_valid(sq, sk, window, causal)
    # the dq pass: the forward's plan at its own tiles, every query head
    seen = np.zeros((sq, sk), np.int8)
    plan = k1_plan(sq, sk, window, K1B_DQ_BLOCK_M, causal, K1B_BLOCK_N)
    for m0, tiles in plan:
        rows = slice(m0, min(sq, m0 + K1B_DQ_BLOCK_M))
        for n0 in tiles:
            keys = slice(n0, min(sk, n0 + K1B_BLOCK_N))
            assert valid[rows, keys].any(), (m0, n0)
            seen[rows, keys] += 1
            for warp in range(4):
                idle, edge = k1_warp_flags(m0, n0, sk, window,
                                           K1B_DQ_BLOCK_M, warp, causal,
                                           K1B_BLOCK_N)
                w0 = m0 + 16 * warp
                wv = valid[w0:min(sq, w0 + 16), keys]
                if idle:
                    assert not wv.any(), (m0, n0, warp)
                elif not edge:
                    assert n0 + K1B_BLOCK_N <= sk and wv.all(), (m0, n0)
    assert (seen[valid] == 1).all() and seen.max() <= 1
    # the dk/dv pass
    seen = np.zeros((sq, sk), np.int8)
    plan = k1b_kv_plan(sq, sk, window, block_m, causal)
    for n0, tiles in plan:
        keys = slice(n0, min(sk, n0 + K1B_BLOCK_N))
        for m0 in tiles:
            rows = slice(m0, min(sq, m0 + block_m))
            assert valid[rows, keys].any(), (n0, m0)
            seen[rows, keys] += 1
            for warp in range(4):
                idle, edge = k1b_kv_warp_flags(n0, m0, sq, sk, window,
                                               block_m, warp, causal)
                kw0 = n0 + 16 * warp
                wv = valid[rows, kw0:min(sk, kw0 + 16)]
                if idle:
                    assert not wv.any(), (n0, m0, warp)
                elif not edge:
                    assert (kw0 + 16 <= sk and m0 + block_m <= sq
                            and wv.all()), (n0, m0, warp)
    assert (seen[valid] == 1).all() and seen.max() <= 1
    if causal and window == 0:  # the lowest keys see the most queries
        work = [len(t) for _, t in plan]
        assert work == sorted(work, reverse=True)


def k1b_bf16_emulation(q, k, v, out, lse, dout, window, causal=True,
                       dq_scale=1.0, kv_block_m=64):
    """The backward kernels' arithmetic on the CPU, tile by tile of their
    plans: delta = rowsum(dout * out) in float32; S (or S^T) and dP from
    the bf16 operands in float32; P = exp(S - lse), 0 where masked; dS =
    P (dP - delta); bf16(dS) K summed over the key tiles into dq, bf16(P^T)
    dO and bf16(dS^T) Q over each query head's tiles into its dv and dk
    (under GQA float32 partials, then added over the group in head order),
    each in float32, rounded once (dq after ``dq_scale``).  Inputs in the
    kernel's layout, bf16; lse float32."""
    b, hq, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    valid = torch.from_numpy(k1_valid(sq, sk, window, causal))
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, out, dout))
    delta = (dof * of).sum(-1)
    kr, vr = kf.repeat_interleave(g, 1), vf.repeat_interleave(g, 1)
    dq = torch.empty(q.shape, dtype=torch.bfloat16)
    for m0, tiles in k1_plan(sq, sk, window, K1B_DQ_BLOCK_M, causal,
                             K1B_BLOCK_N):
        r = slice(m0, min(sq, m0 + K1B_DQ_BLOCK_M))
        acc = torch.zeros((b, hq, r.stop - m0, hd))
        for n0 in tiles:
            c = slice(n0, min(sk, n0 + K1B_BLOCK_N))
            s = qf[:, :, r] @ kr[:, :, c].transpose(-1, -2)
            p = torch.where(valid[r, c], torch.exp(s - lse[:, :, r, None]),
                            0.0)
            dp = dof[:, :, r] @ vr[:, :, c].transpose(-1, -2)
            ds = p * (dp - delta[:, :, r, None])
            acc = acc + ds.bfloat16().float() @ kr[:, :, c]
        dq[:, :, r] = (acc * dq_scale).bfloat16()
    q5, do5 = (t.reshape(b, hkv, g, sq, hd) for t in (qf, dof))
    lse5, delta5 = (t.reshape(b, hkv, g, sq) for t in (lse, delta))
    dk = torch.empty(k.shape, dtype=torch.bfloat16)
    dv = torch.empty(v.shape, dtype=torch.bfloat16)
    for n0, tiles in k1b_kv_plan(sq, sk, window, kv_block_m, causal):
        c = slice(n0, min(sk, n0 + K1B_BLOCK_N))
        dk_sum = torch.zeros((b, hkv, c.stop - n0, hd))
        dv_sum = torch.zeros_like(dk_sum)
        for j in range(g):  # the group's partials, added in head order
            dk_acc = torch.zeros_like(dk_sum)
            dv_acc = torch.zeros_like(dk_sum)
            for m0 in tiles:
                r = slice(m0, min(sq, m0 + kv_block_m))
                qj, doj = q5[:, :, j, r], do5[:, :, j, r]
                st = kf[:, :, c] @ qj.transpose(-1, -2)  # [b, hkv, keys, q]
                pt = torch.where(valid[r, c].T,
                                 torch.exp(st - lse5[:, :, j, None, r]), 0.0)
                dv_acc = dv_acc + pt.bfloat16().float() @ doj
                dpt = vf[:, :, c] @ doj.transpose(-1, -2)
                dst = pt * (dpt - delta5[:, :, j, None, r])
                dk_acc = dk_acc + dst.bfloat16().float() @ qj
            dk_sum, dv_sum = dk_sum + dk_acc, dv_sum + dv_acc
        dk[:, :, c] = dk_sum.bfloat16()
        dv[:, :, c] = dv_sum.bfloat16()
    return dq, dk, dv


@pytest.mark.parametrize("b,sq,sk,hq,hkv,hd,window,causal",
                         K1B_PLAN_CASES[:len(SHAPES) + len(NONCAUSAL_SHAPES)])
def test_k1b_bf16_arithmetic_matches_jax_grad(b, sq, sk, hq, hkv, hd, window,
                                               causal):
    """The backward kernels' arithmetic (bf16 operands, float32 sums tile by
    tile, bf16(P) and bf16(dS), one final rounding) on bf16 inputs against
    ``jax.grad`` of the reference's ``blocked_attention`` on the same bf16
    inputs (its lse VJP rounds at the same points), within the bf16
    tolerance, for either query tile of the dk/dv pass; and against
    ``flash_attention_bwd_plain``, whose float32 sums run in another order."""
    qn, kn, vn = attn_inputs(b, sq, hq, hkv, hd, seed=sq + 11 * sk + hd,
                             sk=sk)
    cot = np.random.default_rng(sk + hd).standard_normal(
        (b, sq, hq, hd)).astype(np.float32)
    cot = torch.from_numpy(cot).bfloat16()
    (qj, qt), (kj, kt), (vj, vt) = (both(a, "bfloat16") for a in (qn, kn, vn))
    pos = jnp.broadcast_to(jnp.arange(sq)[None], (b, sq))
    cot_j = jnp.asarray(cot.float().numpy())

    def f(q, k, v):
        o = jlayers.blocked_attention(q, k, v, pos, causal, window, 256)
        return jnp.sum(o.astype(jnp.float32) * cot_j)

    want = jax.grad(f, argnums=(0, 1, 2))(qj, kj, vj)
    scale = hd ** -0.5
    qs = (qt * scale).to(torch.bfloat16).transpose(1, 2)
    ks, vs = kt.transpose(1, 2), vt.transpose(1, 2)
    out, lse = fa.flash_attention_fwd_plain(qs, ks, vs, causal=causal,
                                            window=window)
    dout = cot.transpose(1, 2)
    plain = fa.flash_attention_bwd_plain(qs, ks, vs, out, lse, dout,
                                         causal=causal, window=window,
                                         dq_scale=scale)
    for block_m in (32, 64):
        got = k1b_bf16_emulation(qs, ks, vs, out, lse, dout, window, causal,
                                 scale, block_m)
        for g_, w, p_ in zip(got, want, plain):
            assert g_.dtype == torch.bfloat16 and g_.shape == p_.shape
            close(g_.transpose(1, 2), np.asarray(w, np.float32),
                  TOL["bfloat16"])
            close(g_, p_.float().numpy(), TOL["bfloat16"])


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
# K3
# ---------------------------------------------------------------------------
def decode_inputs(b, S, hq, hkv, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 1, hq, hd)).astype(np.float32),
            rng.standard_normal((b, S, hkv, hd)).astype(np.float32),
            rng.standard_normal((b, S, hkv, hd)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,S,hq,hkv,hd,length,window", DECODE_SHAPES)
def test_flash_decode_matches_pallas_interpret(b, S, hq, hkv, hd, length,
                                              window, dtype):
    qn, kn, vn = decode_inputs(b, S, hq, hkv, hd, seed=S + length)
    (qj, qt), (kj, kt), (vj, vt) = (both(a, dtype) for a in (qn, kn, vn))
    got = ops.decode_attention(qt, kt, vt, length, window=window)
    assert got.shape == (b, 1, hq, hd) and got.dtype == qt.dtype
    close(got, jops.decode_attention(qj, kj, vj, length, window=window,
                                     backend="interpret"), TOL[dtype])
    close(got, jref.decode_ref(qj, kj, vj, jnp.full((b,), length, jnp.int32),
                               window), TOL[dtype])
    # the plain version in the kernel's layout, q pre-scaled and rounded
    qs = (qt * hd ** -0.5).to(qt.dtype).transpose(1, 2)
    plain = fd.flash_decode_plain(qs, kt.transpose(1, 2), vt.transpose(1, 2),
                                  length, window=window)
    assert torch.equal(plain.transpose(1, 2), got)


def test_decode_length_is_dynamic():
    """tests/test_kernels.py's check: one call signature serves every
    position; the length may also come as an int32 tensor."""
    qn, kn, vn = decode_inputs(1, 256, 4, 2, 32, seed=3)
    q, k, v = (torch.from_numpy(a) for a in (qn, kn, vn))
    for length in (1, 100, 256):
        want = jref.decode_ref(*map(jnp.asarray, (qn, kn, vn)),
                               jnp.full((1,), length, jnp.int32))
        close(ops.decode_attention(q, k, v, length), want, TOL["float32"])
        close(ops.decode_attention(q, k, v, torch.tensor([length],
                                                         dtype=torch.int32)),
              want, TOL["float32"])


@pytest.mark.parametrize("window", [0, 5])
def test_decode_ref_matches_reference_with_per_row_lengths(window):
    qn, kn, vn = decode_inputs(3, 40, 4, 2, 16, seed=window)
    lengths = np.array([1, 17, 40], np.int32)
    want = jref.decode_ref(*map(jnp.asarray, (qn, kn, vn, lengths)), window)
    got = decode_ref(*map(torch.from_numpy, (qn, kn, vn, lengths)), window)
    close(got, want, TOL["float32"])


def split_kv_emulation(q, k, v, length, window, sm_count, arrival=None):
    """flash_decode.cu in PyTorch, for one split plan.  Each split block
    walks its 64-key tiles (skipping those outside the valid range) keeping
    a running (m, l, acc), writes it to the workspace and takes a ticket
    from its arrival counter; the block that takes the last ticket merges
    the workspace in split index order (only splits that saw a key) and
    resets the counter.  ``arrival``: the order in which the split blocks
    finish (index order by default).  q: [b, hq, 1, hd] pre-scaled; caches
    [b, hkv, S, hd]."""
    b, hq, _, hd = q.shape
    hkv, S = k.shape[1], k.shape[2]
    splits, per = fd.split_plan(S, b, hkv, sm_count)
    assert splits * per * fd.TILE >= S > (splits - 1) * per * fd.TILE
    length = min(max(length, 0), S)
    lo = max(0, length - window) if window > 0 else 0
    qg = q[:, :, 0].reshape(b, hkv, hq // hkv, hd)
    ws_m = torch.empty((b, hkv, hq // hkv, splits))
    ws_l = torch.empty_like(ws_m)
    ws_acc = torch.empty(ws_m.shape + (hd,))
    counter, out = 0, None
    for sp in range(splits) if arrival is None else arrival:
        m = torch.full((b, hkv, hq // hkv), -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros(m.shape + (hd,))
        for n0 in range(sp * per * fd.TILE, min(S, (sp + 1) * per * fd.TILE),
                        fd.TILE):
            if n0 >= length or n0 + fd.TILE <= lo:
                continue
            kp = torch.arange(n0, min(n0 + fd.TILE, S))
            valid = (kp >= lo) & (kp < length)
            s = torch.einsum("bkgd,bkjd->bkgj", qg, k[:, :, kp])
            s = torch.where(valid, s, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = (acc * corr[..., None]
                   + torch.einsum("bkgj,bkjd->bkgd", p, v[:, :, kp]))
            m = m_new
        ws_m[..., sp], ws_l[..., sp], ws_acc[..., sp, :] = m, l, acc
        ticket, counter = counter, counter + 1
        if ticket == splits - 1:  # the last to arrive merges, in index order
            assert out is None
            seen = ws_l > 0
            mx = torch.where(seen, ws_m, -1e30).amax(-1, keepdim=True)
            w = torch.where(seen, torch.exp(ws_m - mx), 0.0)
            out = (w[..., None] * ws_acc).sum(-2) / (w * ws_l).sum(
                -1, keepdim=True).clamp_min(1e-30)
            counter = 0  # ready for the next launch
    assert out is not None and counter == 0
    return out.reshape(b, hq, 1, hd)


@pytest.mark.parametrize("b,S,hq,hkv,hd,length,window", DECODE_SHAPES + [
    (1, 1024, 16, 16, 64, 1024, 0),  # the seamless serve shape
    (1, 1024, 16, 16, 64, 1, 0),     # 15 of 16 splits empty
    (1, 1024, 16, 16, 64, 700, 100),  # a window that empties most splits
    (2, 4096, 8, 1, 128, 2049, 0),   # several tiles per split
])
def test_split_kv_plan_and_merge_match_plain_version(b, S, hq, hkv, hd,
                                                     length, window):
    qn, kn, vn = decode_inputs(b, S, hq, hkv, hd, seed=length)
    q = torch.from_numpy(qn).transpose(1, 2) * hd ** -0.5
    k, v = (torch.from_numpy(a).transpose(1, 2) for a in (kn, vn))
    want = fd.flash_decode_plain(q, k, v, length, window=window)
    for sm_count in (132, 1):
        close(split_kv_emulation(q, k, v, length, window, sm_count),
              want.numpy(), TOL["float32"])


@pytest.mark.parametrize("b,S,hq,hkv,hd,length,window", [
    (1, 1024, 16, 16, 64, 1024, 0),   # the seamless serve shape
    (1, 1024, 16, 16, 64, 700, 100),  # empty splits among full ones
    (2, 300, 8, 2, 64, 157, 0),
])
def test_split_kv_merge_is_independent_of_arrival_order(b, S, hq, hkv, hd,
                                                        length, window):
    """Whichever split block arrives last, it merges the workspace in split
    index order: the bits do not depend on the order of arrival."""
    qn, kn, vn = decode_inputs(b, S, hq, hkv, hd, seed=length + 1)
    q = torch.from_numpy(qn).transpose(1, 2) * hd ** -0.5
    k, v = (torch.from_numpy(a).transpose(1, 2) for a in (kn, vn))
    splits = fd.split_plan(S, b, hkv, 132)[0]
    first = split_kv_emulation(q, k, v, length, window, 132)
    rng = np.random.default_rng(S)
    for order in (range(splits - 1, -1, -1), rng.permutation(splits),
                  rng.permutation(splits)):
        assert torch.equal(split_kv_emulation(q, k, v, length, window, 132,
                                              arrival=list(order)), first)


def test_split_plan_fills_the_card_from_capacity_alone():
    assert fd.split_plan(1024, 1, 16, 132) == (16, 1)  # the serve shape
    assert fd.split_plan(4096, 8, 16, 132) == (3, 22)
    assert fd.split_plan(64, 1, 2, 132) == (1, 1)
    assert fd.split_plan(300, 2, 2, 132) == (5, 1)


def test_decode_plain_gives_zero_without_a_valid_key():
    q, k, v = (torch.from_numpy(a).transpose(1, 2)
               for a in decode_inputs(1, 64, 2, 2, 32, seed=0))
    assert torch.equal(fd.flash_decode_plain(q, k, v, 0),
                       torch.zeros(1, 2, 1, 32))


# ---------------------------------------------------------------------------
# wrappers: CPU -> plain version, never a kernel; counts only on launch
# ---------------------------------------------------------------------------
def test_cpu_wrappers_take_plain_versions_and_count_nothing():
    ops.reset_launch_counts()
    x = torch.randn(8, 64)
    ops.rmsnorm(x, torch.zeros(64))
    q = torch.randn(1, 16, 2, 32)
    ops.flash_attention(q, q, q)
    x = torch.randn(1, 40, 2, 16)
    ops.ssd(x, torch.rand(1, 40, 2), -torch.rand(2), torch.randn(1, 40, 8),
            torch.randn(1, 40, 8), torch.ones(2), chunk=16)
    ops.decode_attention(q[:, :1], q, q, 7)
    qg = torch.randn(1, 16, 2, 32, requires_grad=True)
    ops.flash_attention(qg, qg, qg).sum().backward()  # the plain backward
    assert ops.launch_counts() == {"flash_attention_fwd": 0,
                                   "flash_attention_bwd": 0, "rmsnorm": 0,
                                   "flash_decode": 0, "ssd_scan": 0}


class _OnXPU:
    """Stands for a tensor on a device with neither a kernel nor a plain
    route (the wrappers read its device first)."""

    device = torch.device("xpu")


def test_wrappers_reject_devices_without_a_kernel():
    from repro_torch.kernels import ssd_scan as ssd_mod

    x = _OnXPU()
    with pytest.raises(RuntimeError, match="no kernel"):
        rn.rmsnorm(x, x)
    with pytest.raises(RuntimeError, match="no kernel"):
        fa.flash_attention_fwd(x, x, x)
    with pytest.raises(RuntimeError, match="no kernel"):
        fa.flash_attention_bwd(x, x, x, x, x, x)
    with pytest.raises(RuntimeError, match="no kernel"):
        ssd_mod.ssd_scan(x, x, x, x, x, x, chunk=16)
    with pytest.raises(RuntimeError, match="no kernel"):
        fd.flash_decode(x, x, x, 1)
    # a meta tensor takes the plain route, which carries the shapes (the
    # roofline counts on meta tensors) and launches nothing
    ops.reset_launch_counts()
    x = torch.empty(4, 32, device="meta")
    assert rn.rmsnorm(x, torch.zeros(32, device="meta")).shape == (4, 32)
    q = torch.empty(1, 2, 16, 32, device="meta")
    out, lse = fa.flash_attention_fwd(q, q, q)
    assert out.shape == q.shape and lse.shape == (1, 2, 16)
    grads = fa.flash_attention_bwd(q, q, q, out, lse, out)
    assert all(t.shape == q.shape and t.device.type == "meta" for t in grads)
    x, bc, h = (torch.empty(shape, device="meta") for shape in
                ((1, 32, 2, 16), (1, 32, 8), (2,)))
    y = ops.ssd(x, torch.empty(1, 32, 2, device="meta"), h, bc, bc, h,
                chunk=16)
    assert y.shape == x.shape and y.device.type == "meta"
    q = torch.empty(1, 1, 2, 32, device="meta")
    assert ops.decode_attention(q, q, q, 1).shape == q.shape
    assert not any(ops.launch_counts().values())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_versions_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA/Triton kernels have no "
                    "CPU mode (chip_smoke.py runs them on the card)")
    td = DTYPES[dtype][1]
    ops.reset_launch_counts()
    shapes = SHAPES + TRAIN_SHAPES  # every head dim: 64, 128, 32, 96
    for b, sq, hq, hkv, hd, window in shapes:
        qn, kn, vn = attn_inputs(b, sq, hq, hkv, hd, seed=1)
        q, k, v = (torch.from_numpy(a).to("cuda", td).transpose(1, 2)
                   for a in (qn, kn, vn))
        out, lse = fa.flash_attention_fwd(q, k, v, window=window)
        want, want_lse = fa.flash_attention_fwd_plain(q, k, v, window=window)
        close(out.cpu(), want.cpu().float().numpy(), TOL[dtype])
        close(lse.cpu(), want_lse.cpu().numpy(), 1e-4)
        again, lse2 = fa.flash_attention_fwd(q, k, v, window=window)
        assert torch.equal(again, out) and torch.equal(lse2, lse)
    x = torch.randn(2048, 1536, device="cuda").to(td)
    s = torch.randn(1536, device="cuda").to(td) * 0.1
    close(rn.rmsnorm(x, s).cpu(), rn.rmsnorm_plain(x, s).cpu().float().numpy(),
          TOL[dtype])
    assert ops.launch_counts() == {"flash_attention_fwd": 2 * len(shapes),
                                   "flash_attention_bwd": 0, "rmsnorm": 1,
                                   "flash_decode": 0, "ssd_scan": 0}


@pytest.mark.cuda
def test_k1_takes_head_dim_16_in_float32_only_on_card():
    """The reduced configs' head_dim 16: K1's float32 scalar kernel against
    its plain version (causal, GQA with a window, ragged), two launches
    bitwise; the bf16 kernel refuses it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode "
                    "(chip_smoke.py runs it on the card)")
    assert 16 in fa.HEAD_DIMS_F32 and 16 not in fa.HEAD_DIMS
    for b, sq, hq, hkv, hd, window in [(1, 64, 4, 4, 16, 0),
                                       (2, 100, 4, 1, 16, 8)]:
        qn, kn, vn = attn_inputs(b, sq, hq, hkv, hd, seed=3)
        q, k, v = (torch.from_numpy(a).to("cuda").transpose(1, 2)
                   for a in (qn, kn, vn))
        out, lse = fa.flash_attention_fwd(q, k, v, window=window)
        want, want_lse = fa.flash_attention_fwd_plain(q, k, v, window=window)
        close(out.cpu(), want.cpu().numpy(), TOL["float32"])
        close(lse.cpu(), want_lse.cpu().numpy(), 1e-4)
        again, _ = fa.flash_attention_fwd(q, k, v, window=window)
        assert torch.equal(again, out)
    with pytest.raises(ValueError, match="head_dim 16"):
        fa.flash_attention_fwd(q.bfloat16(), k.bfloat16(), v.bfloat16())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_noncausal_k1_matches_plain_version_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode "
                    "(chip_smoke.py runs them on the card)")
    td = DTYPES[dtype][1]
    for b, sq, sk, hq, hkv, hd in NONCAUSAL_SHAPES + NONCAUSAL_TRAIN_SHAPES:
        qn, kn, vn = attn_inputs(b, sq, hq, hkv, hd, seed=2, sk=sk)
        q, k, v = (torch.from_numpy(a).to("cuda", td).transpose(1, 2)
                   for a in (qn, kn, vn))
        out, lse = fa.flash_attention_fwd(q, k, v, causal=False)
        want, want_lse = fa.flash_attention_fwd_plain(q, k, v, causal=False)
        close(out.cpu(), want.cpu().float().numpy(), TOL[dtype])
        close(lse.cpu(), want_lse.cpu().numpy(), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_kernel_matches_plain_version_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode "
                    "(chip_smoke.py runs it on the card)")
    td = DTYPES[dtype][1]
    ops.reset_launch_counts()
    for b, S, hq, hkv, hd, length, window in DECODE_SHAPES:
        q, k, v = (torch.from_numpy(a).to("cuda", td) for a in
                   decode_inputs(b, S, hq, hkv, hd, seed=S))
        got = ops.decode_attention(q, k, v, length, window=window)
        qs = (q * hd ** -0.5).to(td).transpose(1, 2)
        want = fd.flash_decode_plain(qs, k.transpose(1, 2), v.transpose(1, 2),
                                     length, window=window).transpose(1, 2)
        close(got.cpu(), want.cpu().float().numpy(), TOL[dtype])
        assert torch.equal(ops.decode_attention(q, k, v, length,
                                                window=window), got)
    assert ops.launch_counts()["flash_decode"] == 2 * len(DECODE_SHAPES)


@pytest.mark.cuda
def test_flash_decode_calls_on_two_streams_keep_their_own_counters():
    """Calls with the same batch and kv-head count in flight on two streams
    at once take separate arrival counters, so each gives the bits of the
    same call alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode "
                    "(chip_smoke.py runs it on the card)")
    b, S, hq, hkv, hd, length, window = DECODE_SHAPES[0]
    q, k, v = (torch.from_numpy(a).to("cuda", torch.bfloat16) for a in
               decode_inputs(b, S, hq, hkv, hd, seed=S))
    qs = (q * hd ** -0.5).to(torch.bfloat16).transpose(1, 2)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    alone = fd.flash_decode(qs, kt, vt, length, window=window)
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = []
    for _ in range(50):
        for s in streams:
            with torch.cuda.stream(s):
                outs.append(fd.flash_decode(qs, kt, vt, length,
                                            window=window))
    for s in streams:
        torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    assert all(torch.equal(o, alone) for o in outs)
    used = {key[1] for key in fd._COUNTERS if key[2] == b * hkv}
    assert {s.cuda_stream for s in streams} <= used
