"""Port K4 (SSD scan), the Mamba-2 layer and zamba2's accounting against the
reference.

On the CPU the port's ``ops.ssd`` runs the kernel's plain version (the
reference's ``_ssd_xla_chunked``, step by step); the reference runs its
Pallas kernel in interpret mode, its XLA chunked path and its sequential
oracle.  Inputs come from numpy seeds and go to both.  Tolerances: the SSD
forward uses tests/test_kernels.py's (atol 5e-4 / rtol 1e-5 in float32,
6e-2 / 3e-2 in bfloat16, whose contractions round operands to bfloat16);
the sequential oracles agree within 1e-5; gradients within 1e-4, relative
to each gradient's largest entry (float32 sums in another order, with
cancellation in A's and D's); the Mamba layer within 1e-5.  The CUDA
kernel itself runs only on the card (marker ``cuda``).
"""
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro.models.build import build as jbuild
from repro.models.common import SHAPES as JSHAPES
from repro_torch.configs import registry
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import ssm
from repro_torch.models.build import build
from repro_torch.models.common import SHAPES
from repro_torch.models.convert import params_from_reference

#: tests/test_kernels.py shapes: (b, s, nh, hd, ds, chunk)
SHAPES_SSD = [
    (2, 256, 4, 32, 16, 64),
    (1, 128, 8, 64, 64, 128),  # zamba2-like state size
    (1, 192, 2, 16, 8, 64),    # non-power-of-two length
    (2, 100, 2, 16, 8, 64),    # needs padding
]
TOL = {"float32": (5e-4, 1e-5), "bfloat16": (6e-2, 3e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def ssd_inputs(b, s, nh, hd, ds, seed):
    """tests/test_kernels.py's inputs: dt > 0 small, A < 0."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((b, s, nh, hd)).astype(f),
            np.abs(rng.standard_normal((b, s, nh))).astype(f) * f(0.1),
            -np.abs(rng.standard_normal(nh)).astype(f),
            rng.standard_normal((b, s, ds)).astype(f),
            rng.standard_normal((b, s, ds)).astype(f),
            rng.standard_normal(nh).astype(f))


def close(got, want, atol, rtol):
    np.testing.assert_allclose(
        got.detach().float().numpy() if isinstance(got, torch.Tensor)
        else np.asarray(got, np.float32),
        np.asarray(want, np.float32), atol=atol, rtol=rtol)


def mamba_config(reg, layers: int, dtype=None):
    """Reduced zamba2 with its Mamba pattern: the registry's reduced config
    (the reference's) keeps only attention layers for the hybrid family."""
    cfg = dataclasses.replace(reg.reduced_config("zamba2-1.2b", layers),
                              layer_pattern=("mamba",) * layers)
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


# ---------------------------------------------------------------------------
# (a) ops.ssd against the reference's three implementations
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,nh,hd,ds,chunk", SHAPES_SSD)
def test_ssd_matches_reference_backends(b, s, nh, hd, ds, chunk, dtype):
    x, dt, A, B, C, D = ssd_inputs(b, s, nh, hd, ds,
                                   seed=b * 1000 + s * 10 + nh)
    jd, td = DTYPES[dtype]
    xj = jnp.asarray(x, jd)
    rest_j = [jnp.asarray(a) for a in (dt, A, B, C, D)]
    got = ops.ssd(torch.from_numpy(x).to(td),
                  *map(torch.from_numpy, (dt, A, B, C, D)), chunk=chunk)
    assert got.shape == (b, s, nh, hd) and got.dtype == td
    atol, rtol = TOL[dtype]
    for backend in ("interpret", "xla"):
        want = jops.ssd(xj, *rest_j, chunk=chunk, backend=backend)
        close(got, want, atol, rtol)
    close(got, jref.ssd_ref(xj, *rest_j), atol, rtol)


# ---------------------------------------------------------------------------
# (b) the sequential oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,s,nh,hd,ds,chunk", SHAPES_SSD)
def test_ssd_ref_matches_reference_oracle(b, s, nh, hd, ds, chunk):
    args = ssd_inputs(b, s, nh, hd, ds, seed=s)
    got = ref.ssd_ref(*map(torch.from_numpy, args))
    close(got, jref.ssd_ref(*map(jnp.asarray, args)), 1e-5, 1e-5)
    y, h = ref.ssd_ref_with_state(*map(torch.from_numpy, args))
    yj, hj = jref.ssd_ref_with_state(*map(jnp.asarray, args))
    close(y, yj, 1e-5, 1e-5)
    close(h, hj, 1e-5, 1e-5)


# ---------------------------------------------------------------------------
# (c) gradients: the autograd Function's plain backward against jax.grad
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,s,nh,hd,ds,chunk", SHAPES_SSD)
def test_ssd_grad_matches_jax_grad(b, s, nh, hd, ds, chunk):
    args = ssd_inputs(b, s, nh, hd, ds, seed=s + 1)
    cot = np.random.default_rng(s).standard_normal(
        (b, s, nh, hd)).astype(np.float32)

    def f(*a):
        return jnp.sum(jops.ssd(*a, chunk=chunk, backend="interpret") * cot)

    want = jax.grad(f, argnums=tuple(range(6)))(*map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    y = ops.ssd(*leaves, chunk=chunk)
    got = torch.autograd.grad((y * torch.from_numpy(cot)).sum(), leaves)
    for g, w in zip(got, want):
        # A's and D's gradients sum b*s*hd terms that cancel: the absolute
        # tolerance is 1e-4 of each gradient's largest entry
        close(g, w, 1e-4 * max(1.0, float(np.abs(w).max())), 1e-4)


# ---------------------------------------------------------------------------
# (d) chunk invariance (tests/test_kernels.py's property)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s,nh,chunk,seed", [
    (8, 1, 32, 0), (37, 2, 32, 1), (64, 4, 64, 2), (130, 2, 32, 3),
    (200, 4, 64, 4), (100, 1, 64, 5)])
def test_ssd_chunk_invariance(s, nh, chunk, seed):
    args = [torch.from_numpy(a) for a in ssd_inputs(1, s, nh, 16, 8, seed)]
    a = ops.ssd(*args, chunk=chunk)
    b_ = ops.ssd(*args, chunk=16)
    close(a, b_.numpy(), 5e-4, 0.0)


# ---------------------------------------------------------------------------
# (e) the Mamba-2 layer
# ---------------------------------------------------------------------------
def _mamba_params(seed=4):
    cfg_j = mamba_config(jreg, 2)
    cfg_t = mamba_config(registry, 2)
    p = jbuild(cfg_j, num_stages=1).init_layer_params(
        jax.random.key(seed))["mamba"]
    # perturb the zero/one-initialised leaves so every path is exercised
    rng = np.random.default_rng(seed)
    p = {k: np.asarray(v) + (rng.standard_normal(v.shape).astype(v.dtype)
                             * np.float32(0.1)
                             if k in ("ln", "conv_b", "a_log", "dt_bias",
                                      "d_skip", "gate_ln") else 0)
         for k, v in p.items()}
    port = ssm.MambaLayer(cfg_t, None, "cpu")
    with torch.no_grad():
        for name, t in port.named_parameters():
            assert t.dtype == torch.from_numpy(p[name]).dtype, name
            t.copy_(torch.from_numpy(p[name]))
    return cfg_j, cfg_t, p, port


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 24, 40)).astype(np.float32)
    w = rng.standard_normal((4, 40)).astype(np.float32)
    b = rng.standard_normal(40).astype(np.float32)
    got = ssm._causal_conv(*map(torch.from_numpy, (x, w, b)))
    close(got, jssm._causal_conv(*map(jnp.asarray, (x, w, b))), 1e-5, 1e-5)


@pytest.mark.parametrize("s", [32, 40])
def test_mamba_layer_matches_reference(s):
    cfg_j, cfg_t, p, port = _mamba_params()
    x = np.random.default_rng(s).standard_normal(
        (2, s, cfg_t.d_model)).astype(np.float32)
    want = jssm.mamba_layer({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), cfg_j)
    with torch.no_grad():
        got = ssm.mamba_layer(port, torch.from_numpy(x), cfg_t)
    close(got, want, 1e-5, 1e-5)


def test_softplus_is_jax_softplus_beyond_twenty():
    x = np.array([-30.0, -1.0, 0.0, 3.0, 19.5, 20.5, 40.0], np.float32)
    close(ssm._softplus(torch.from_numpy(x)),
          jax.nn.softplus(jnp.asarray(x)), 1e-6, 1e-6)


# ---------------------------------------------------------------------------
# (i) bfloat16 models keep their float32 leaves; mismatches raise
# ---------------------------------------------------------------------------
def _reference_tree(cfg_j, stages):
    model_j = jbuild(cfg_j, num_stages=stages)
    key = jax.random.key(0)
    sp = jax.tree.map(np.asarray, model_j.init_stage_params(key))
    io = jax.tree.map(np.asarray,
                      model_j.init_io_params(jax.random.fold_in(key, 1)))
    return sp, io


def test_params_from_reference_keeps_float32_leaves_of_bf16_zamba2():
    sp, io = _reference_tree(mamba_config(jreg, 3, jnp.bfloat16), 2)
    model = build(mamba_config(registry, 3, torch.bfloat16), 2)
    stages, io_t = params_from_reference(model, sp, io, "cpu")
    layer = stages[0].slots[0].mamba
    for name in ("a_log", "dt_bias", "d_skip"):
        assert getattr(layer, name).dtype == torch.float32, name
    assert layer.in_proj.dtype == torch.bfloat16
    assert io_t.shared_blk.attn.wq.dtype == torch.bfloat16
    assert torch.equal(io_t.shared_blk.attn.wq.float(), torch.from_numpy(
        np.asarray(io["shared_blk"]["attn"]["wq"], np.float32)))
    assert torch.equal(stages[1].slots[0].mamba.in_proj.float(),
                       torch.from_numpy(np.asarray(
                           sp["mamba"]["in_proj"][1, 0], np.float32)))


def test_params_from_reference_rejects_a_dtype_mismatch():
    sp, io = _reference_tree(mamba_config(jreg, 3, jnp.bfloat16), 2)
    model = build(mamba_config(registry, 3), 2)  # float32 port
    with pytest.raises(TypeError, match="does not match"):
        params_from_reference(model, sp, io, "cpu")
    sp["mamba"]["a_log"] = sp["mamba"]["a_log"].astype(jnp.bfloat16)
    model = build(mamba_config(registry, 3, torch.bfloat16), 2)
    with pytest.raises(TypeError, match="a_log"):
        params_from_reference(model, sp, io, "cpu")


# ---------------------------------------------------------------------------
# (j) model FLOPs, for every arch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", jreg.ARCHS)
def test_model_flops_match_reference(arch):
    for stages in (4, 5):
        want = jbuild(jreg.get_arch(arch), stages).model_flops(
            JSHAPES["train_4k"])
        got = build(registry.get_arch(arch), stages).model_flops(
            SHAPES["train_4k"])
        assert got == want


def test_zamba2_layout_and_parameter_count():
    cfg = registry.get_arch("zamba2-1.2b")
    model = build(cfg, 4)
    assert model.counts.tolist() == [10, 10, 9, 9]
    assert int(model.shared_flags.sum()) == 7
    assert cfg.param_count() == 1_170_313_344


# ---------------------------------------------------------------------------
# wrappers and (k) the kernel on the card
# ---------------------------------------------------------------------------
def test_ssd_wrapper_counts_nothing_on_the_cpu_and_rejects_other_devices():
    ops.reset_launch_counts()
    args = [torch.from_numpy(a) for a in ssd_inputs(1, 64, 2, 16, 8, 0)]
    ops.ssd(*args, chunk=32)
    assert ops.launch_counts()["ssd_scan"] == 0
    # a device with neither a kernel nor a plain route (the wrapper reads
    # x's device first) is refused; a meta tensor takes the plain route,
    # which carries the shapes (the roofline's counts) and launches nothing
    class OnXPU:
        device = torch.device("xpu")

    with pytest.raises(RuntimeError, match="no kernel"):
        ssd.ssd_scan(OnXPU(), *args[1:], chunk=32)
    meta = [a.to("meta") for a in args]
    y = ssd.ssd_scan(*meta, chunk=32)
    assert y.shape == args[0].shape and y.device.type == "meta"
    assert ops.launch_counts()["ssd_scan"] == 0


# K4's tensor-core kernel (bf16): its plan and its arithmetic, mirrored in
# Python.  These tests check the design as the source states it (the plan's
# constants are read from the source), not the built binary: only the
# card's comparison with the plain version checks the kernel.
_K4_TC = (Path(ssd.__file__).parent / "csrc" / "ssd_scan.cu"
          ).read_text().split("namespace tc {", 1)[1]


def _k4_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _K4_TC)[1])


def _k4_widths(fn):
    """The padded widths of ``tc::padded_p`` / ``tc::padded_n``."""
    body = re.search(rf"inline int {fn}\(int \w+\) \{{(.*?)\}}", _K4_TC,
                     re.S)[1]
    return tuple(sorted({int(v) for v in re.findall(r"\? (\d+)", body)}
                        | {int(re.findall(r": (\d+);", body)[-1])}))


K4_WARPS = _k4_const("WARPS")
K4_HD_SLICE = _k4_const("HD_SLICE")
K4_STAGES = _k4_const("STAGES")
K4_PAD = _k4_const("PAD")
K4_MAX_CHUNK = _k4_const("MAX_CHUNK")
#: every shape a bf16 check runs: the reference tests', chip_smoke.py's
#: zamba2 shape and the zamba2-width emulation case
K4_CHECKED = SHAPES_SSD + [(1, 2048, 64, 64, 64, 64), (1, 256, 4, 64, 64, 64)]


def k4_w_blocks(warp, mtq):
    """The 16 x 16 blocks (mt, jb <= mt) of w that one compute warp builds:
    round robin over the blocks in row-major order."""
    blocks = [(mt, jb) for mt in range(mtq) for jb in range(mt + 1)]
    return blocks[warp::K4_WARPS]


def k4_y_tiles(warp, mtq, dp_tiles):
    """The (row tile, 16-column tile) tiles of y that one compute warp
    takes: the flattened row-major order, reversed every other round, so
    that long causal rows pair with short ones."""
    ny, tiles = mtq * dp_tiles, []
    for rnd in range(-(-ny // K4_WARPS)):
        k = rnd * K4_WARPS + (K4_WARPS - 1 - warp if rnd & 1 else warp)
        if k < ny:
            tiles.append(divmod(k, dp_tiles))
    return tiles


def k4_state_tiles(warp, pp, np_):
    """The 16 x 16 state tiles (row tile of the slice, column tile of ds)
    that one compute warp updates: k = warp + WARPS r."""
    kn, npair = np_ // 16, (pp // 16) * (np_ // 16)
    return [divmod(k, kn) for k in range(warp, npair, K4_WARPS)]


def test_k4_plan_constants_match_the_wrapper():
    assert (ssd.TC_WARPS, ssd.TC_HD_SLICE, ssd.TC_STAGES, ssd.TC_PAD,
            ssd.TC_MAX_CHUNK) == (K4_WARPS, K4_HD_SLICE, K4_STAGES, K4_PAD,
                                  K4_MAX_CHUNK)
    # WARPS compute warps and PRODUCERS warps that issue the copies
    assert re.search(r"constexpr int THREADS = 32 \* \(WARPS \+ PRODUCERS\);",
                     _K4_TC)
    assert ssd.TC_PRODUCERS == _k4_const("PRODUCERS") >= 1
    assert ssd.TC_WIDTHS_P == _k4_widths("padded_p")
    assert ssd.TC_WIDTHS_N == _k4_widths("padded_n")


def test_kernel_shared_memory_plan_fits_every_checked_shape():
    for _, _, _, hd, ds, chunk in K4_CHECKED:
        # the float32 scalar kernel
        p = ssd.hd_slice(hd)
        assert ssd.smem_bytes(chunk, p, ds) <= ssd.MAX_SMEM
        assert hd % p == 0 and chunk % 4 == 0 and p % 4 == 0 and ds % 4 == 0
        # the bf16 tensor-core kernel
        p = ssd.tc_slice(hd)
        pp = ssd.tc_padded(p, ssd.TC_WIDTHS_P)
        np_ = ssd.tc_padded(ds, ssd.TC_WIDTHS_N)
        assert chunk % 16 == 0 and chunk <= K4_MAX_CHUNK
        # 16-byte rows of x (slice), B and C
        assert (2 * p) % 16 == 0 and (2 * ds) % 16 == 0
        # the layout the source's comment states, byte by byte
        stage = chunk * (pp + K4_PAD) * 2 + 2 * chunk * (np_ + K4_PAD) * 2
        state = 2 * 2 * pp * (np_ + K4_PAD) * 2   # hi, lo; double-buffered
        w_tile = chunk * (chunk + K4_PAD) * 2     # bf16 w
        scan = 2 * 3 * chunk * 4   # dt, cum, wj; double-buffered
        total = K4_STAGES * stage + state + w_tile + scan
        assert ssd.tc_smem_bytes(chunk, pp, np_) == total <= ssd.MAX_SMEM
        # every row pitch is a whole number of 16-byte units whose 8 rows
        # of an ldmatrix phase fall on 8 distinct 16-byte bank groups
        for width in (pp, np_, chunk):
            pitch = (width + K4_PAD) * 2
            assert pitch % 16 == 0
            assert len({(r * pitch // 16) % 8 for r in range(8)}) == 8
        # the slices cover hd's columns once, each within the padded width
        cols = np.zeros(hd, np.int32)
        for p0 in range(0, hd, p):
            cols[p0:p0 + p] += 1
        assert hd % p == 0 and (cols == 1).all() and p <= pp
        assert ds <= np_
        # the compute warps build every block of w on and below the
        # diagonal once, and the y tiles cover y once, tile (mt, dp) taking
        # the column blocks 0..mt of w: every j <= i of its rows
        mtq = chunk // 16
        seen = np.zeros((chunk, chunk), np.int32)
        for w in range(K4_WARPS):
            for mt, jb in k4_w_blocks(w, mtq):
                seen[mt * 16:mt * 16 + 16, jb * 16:jb * 16 + 16] += 1
        assert (seen[np.tril_indices(chunk)] == 1).all()
        assert (seen <= 1).all()
        ys = np.zeros((chunk, pp), np.int32)
        used = np.zeros((chunk, chunk), np.int32)
        for w in range(K4_WARPS):
            for mt, dp in k4_y_tiles(w, mtq, pp // 16):
                ys[mt * 16:mt * 16 + 16, dp * 16:dp * 16 + 16] += 1
                if dp == 0:
                    used[mt * 16:mt * 16 + 16, :mt * 16 + 16] += 1
        assert (ys == 1).all()
        assert (used[np.tril_indices(chunk)] == 1).all()
        # ... and every 16 x 16 tile of the padded [pp, np] state once
        st = np.zeros((pp, np_), np.int32)
        for w in range(K4_WARPS):
            for ms, ns in k4_state_tiles(w, pp, np_):
                st[ms * 16:ms * 16 + 16, ns * 16:ns * 16 + 16] += 1
        assert (st == 1).all()


def _bf(t):
    return t.to(torch.bfloat16).float()


def _split(t):
    """t as bf16 hi + lo halves (the kernel's ``split_bf16``)."""
    hi = _bf(t)
    return hi, _bf(t - hi)


def k4_tc_emulation(x, dt, A, B, C, D, chunk, split=True):
    """The bf16 tensor-core kernel's arithmetic, in float32 on the CPU:
    B and C rounded to bf16; w = (C B^T) exp(cum_i - cum_j) dt_j rounded to
    bf16 against bf16 x; exp(cum) C state^T with the state as bf16 hi + lo;
    the state update with x dt exp(cum_Q - cum) as hi + lo against bf16 B;
    the state carried in float32 across chunks.  ``split=False`` takes the
    two state products in float32 instead (the reference's).  Pads s as
    ``ops.ssd``; returns float32 y before its cast to x's dtype."""
    b, s, nh, hd = x.shape
    ds = B.shape[-1]
    pad = (-s) % chunk
    x, dt, B, C = (torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2)
                                           + (0, pad))
                   for t in (x, dt, B, C))
    xq, Bq, Cq = x.float(), _bf(B), _bf(C)
    halves = _split if split else (lambda t: (t, torch.zeros_like(t)))
    h = torch.zeros((b, nh, hd, ds))
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    ys = []
    for c0 in range(0, x.shape[1], chunk):
        sl = slice(c0, c0 + chunk)
        xc, dtc, Bc, Cc = xq[:, sl], dt[:, sl].float(), Bq[:, sl], Cq[:, sl]
        cum = torch.cumsum(A.float() * dtc, dim=1)           # [b, Q, nh]
        g = torch.einsum("bis,bjs->bij", Cc, Bc)
        diff = cum[:, :, None, :] - cum[:, None, :, :]       # [b, i, j, nh]
        mask = tri[None, :, :, None]
        w = torch.where(mask, g[..., None] * torch.exp(
            torch.where(mask, diff, 0.0)) * dtc[:, None, :, :], 0.0)
        y = torch.einsum("bijn,bjnd->bind", _bf(w), xc)
        hh, hl = halves(h)
        y = y + (torch.einsum("bis,bnds->bind", Cc, hh)
                 + torch.einsum("bis,bnds->bind", Cc, hl)
                 ) * torch.exp(cum)[..., None]
        ys.append(y + D.float()[None, None, :, None] * xc)
        wj = dtc * torch.exp(cum[:, -1:] - cum)
        xh, xl = halves(xc * wj[..., None])
        h = (h * torch.exp(cum[:, -1])[:, :, None, None]
             + torch.einsum("bjnd,bjs->bnds", xh, Bc)
             + torch.einsum("bjnd,bjs->bnds", xl, Bc))
    return torch.cat(ys, dim=1)[:, :s]


@pytest.mark.parametrize("b,s,nh,hd,ds,chunk",
                         SHAPES_SSD + [(1, 256, 4, 64, 64, 64)])
def test_k4_tc_arithmetic_matches_the_reference(b, s, nh, hd, ds, chunk):
    """The bf16 kernel's rounding points against the Pallas kernel in
    interpret mode, ``_ssd_xla_chunked`` and the port's float32 plain
    version (chip_smoke.py's comparison), at the bf16 SSD tolerance."""
    x, dt, A, B, C, D = ssd_inputs(b, s, nh, hd, ds, seed=s * 7 + hd)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32)))  # bf16 values
    rest_t = [torch.from_numpy(a) for a in (dt, A, B, C, D)]
    y32 = k4_tc_emulation(xt, *rest_t, chunk)
    got = y32.to(torch.bfloat16)
    atol, rtol = TOL["bfloat16"]
    rest_j = [jnp.asarray(a) for a in (dt, A, B, C, D)]
    close(got, jops.ssd(xj, *rest_j, chunk=chunk, backend="interpret"),
          atol, rtol)
    close(got, jops._ssd_xla_chunked(xj, *rest_j, chunk), atol, rtol)
    close(got, ssd.ssd_chunked_plain(xt, *rest_t, chunk).to(torch.bfloat16)
          .float().numpy(), atol, rtol)
    # hi + lo halves against float32 state products: below bf16's own
    # rounding of y by far (2^-9 relative), at most 2^-14 of y's scale
    exact = k4_tc_emulation(xt, *rest_t, chunk, split=False)
    scale = float(exact.abs().max())
    assert float((y32 - exact).abs().max()) <= 2.0 ** -14 * scale


def test_tc_wrapper_refuses_misaligned_rows_and_other_plans():
    """The bf16 kernel's checks, made before any launch (so on CPU tensors
    too): 16-byte rows, chunk a multiple of 16 up to MAX_CHUNK, widths."""
    b, s, nh, hd, ds = 1, 64, 2, 64, 64
    xbc = torch.zeros((b, s, nh * hd + 2 * ds + 8), dtype=torch.bfloat16)
    x = xbc[..., :nh * hd].reshape(b, s, nh, hd)
    B, C = xbc[..., nh * hd:nh * hd + ds], xbc[..., nh * hd + ds:][..., :ds]
    assert ssd._check_tc(x, B, C, hd, ds, 64) == K4_HD_SLICE
    off = xbc[..., 4:4 + nh * hd].reshape(b, s, nh, hd)  # 8 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        ssd._check_tc(off, B, C, hd, ds, 64)
    with pytest.raises(ValueError, match="16-byte"):
        ssd._check_tc(x, xbc[..., 4:4 + ds], C, hd, ds, 64)
    odd = torch.zeros((b, s, 2 * ds + 4), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):  # seq stride 132
        ssd._check_tc(x, odd[..., :ds], odd[..., ds:2 * ds], hd, ds, 64)
    for chunk in (40, 256):
        with pytest.raises(ValueError, match="chunk"):
            ssd._check_tc(x, B, C, hd, ds, chunk)
    wide = torch.zeros((b, s, 2 * 256), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="ds up to"):
        ssd._check_tc(x, wide[..., :256], wide[..., 256:], hd, 256, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_matches_plain_version_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode "
                    "(chip_smoke.py runs it on the card)")
    td = DTYPES[dtype][1]
    atol, rtol = TOL[dtype]
    ops.reset_launch_counts()
    for b, s, nh, hd, ds, chunk in SHAPES_SSD:
        x, dt, A, B, C, D = (torch.from_numpy(a).cuda() for a in
                             ssd_inputs(b, s, nh, hd, ds, seed=s))
        got = ops.ssd(x.to(td), dt, A, B, C, D, chunk=chunk)
        want = ssd.ssd_chunked_plain(x.to(td).float(), dt, A, B, C, D, chunk)
        close(got.cpu(), want.cpu().numpy(), atol, rtol)
    assert ops.launch_counts()["ssd_scan"] == len(SHAPES_SSD)
