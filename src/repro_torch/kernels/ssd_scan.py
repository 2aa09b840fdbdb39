"""Mamba-2 chunked SSD scan (kernel K4): CUDA launcher, plain version, counter.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py`` (``ssd_scan`` /
``_kernel``) with the hand-written Hopper kernels in ``csrc/ssd_scan.cu``.
Contract as in the reference: x ``[b, s, nh, hd]`` in the model dtype, dt
``[b, s, nh]`` float32, A and D ``[nh]`` float32, B and C ``[b, s, ds]``;
``s`` a multiple of ``chunk`` (``ops.ssd`` pads).  Returns y ``[b, s, nh,
hd]`` in x's dtype.  Per chunk: the masked intra-chunk contraction ``(C
B^T) * exp(cum_i - cum_j) * dt_j`` against x, the inter-chunk term
``exp(cum) * C state^T``, ``D * x``, then the state update ``exp(cum_Q)
state + sum_j exp(cum_Q - cum_j) dt_j x_j B_j^T``.

Bound on the H100: bytes.  At the zamba2 shape (``[1, 2048, 64, 64]``, ds
64, chunk 64) it reads x and writes y once (2 x 16.8 MB in bf16) for about
4.3 GFLOP: 0.0103 ms of memory traffic against 0.0043 ms of bf16 tensor-core
work.  One block owns a (batch row, head, slice of hd) and walks the chunks
in order itself, carrying its float32 ``[hd_slice, ds]`` state (the TPU's
sequential chunk grid axis becomes that loop; rows of the state are
independent across hd, so slices need no reduction across blocks and the
result is deterministic).

- bfloat16 x (the main path): the tensor-core kernel (``namespace tc``).
  Its products are ``mma.sync`` m16n8k16 at the reference's rounding points
  (bf16 B and C, w rounded to bf16; the two state products take their
  float32 operand as bf16 hi + lo halves, and the state stays float32);
  producer warps bring the next chunk's tiles through a 2-stage
  ``cp.async`` ring while 8 compute warps work on the current one.  float32
  B and C are cast to bf16 first, as the reference's ``_ssd_xla_chunked``
  does (``B.astype(ct)``).  It copies 16-byte rows: x, B and C must start
  16-byte aligned, with hd and ds multiples of 8 and their batch, seq and
  head strides multiples of 8 elements, else ``ValueError``.
- float32 x: the scalar kernel of the first port (register tiles of
  float32 FMAs), with float32 or bf16 B and C.

The wrapper takes strides for x, B and C (the model passes views of its
``xbc`` projection); only their last axis must be contiguous.  dt, A and D
are made contiguous float32 (no copy for the model's dt); y is allocated
contiguous.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

COUNTER = _build.LaunchCounter("ssd_scan")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: dynamic shared memory a block may use on the H100 (227 KB)
MAX_SMEM = 232_448


def ssd_chunked_plain(x, dt, A, B, C, D, chunk: int):
    """Plain PyTorch version: the reference's ``_ssd_xla_chunked``.

    Chunked SSD batched over chunks, with the inter-chunk state passed by a
    Python loop over chunks (the reference's ``lax.scan``).  For bfloat16 x
    the contractions take operands rounded to bfloat16 and accumulate in
    float32 (the reference's ``preferred_element_type`` products); gates and
    cumulative sums are float32.  The decay's exponent is zeroed above the
    diagonal before ``exp``, so a masked entry cannot overflow into an
    ``inf * 0`` in the backward; the selected entries are the reference's.
    """
    b, s, nh, hd = x.shape
    ds = B.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    sp = x.shape[1]
    nc = sp // chunk
    ct = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    xc = x.reshape(b, nc, chunk, nh, hd)
    dtf = dt.float().reshape(b, nc, chunk, nh)
    Bc = B.to(ct).float().reshape(b, nc, chunk, ds)
    Cc = C.to(ct).float().reshape(b, nc, chunk, ds)

    a = A.float()[None, None, None, :] * dtf  # [b, nc, Q, nh]
    cum = torch.cumsum(a, dim=2)
    g = torch.einsum("bcid,bcjd->bcij", Cc, Bc)  # [b, nc, Q, Q]
    ii = torch.arange(chunk, device=x.device)
    tri = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    decay = torch.where(tri, torch.exp(torch.where(tri, diff, 0.0)), 0.0)
    w = (g[..., None] * decay * dtf[:, :, None, :, :]).to(ct).float()
    y_intra = torch.einsum("bcijn,bcjnd->bcind", w, xc.to(ct).float())

    xf = xc.float()
    chunk_in = torch.einsum(
        "bcjn,bcjnd,bcjs->bcnds", dtf * torch.exp(cum[:, :, -1:, :] - cum),
        xf, Bc)  # [b, nc, nh, hd, ds]
    total_decay = torch.exp(cum[:, :, -1])  # [b, nc, nh]
    h = torch.zeros((b, nh, hd, ds), dtype=torch.float32, device=x.device)
    h_in = []
    for c in range(nc):  # the state *entering* each chunk
        h_in.append(h)
        h = h * total_decay[:, c, :, None, None] + chunk_in[:, c]
    h_in = torch.stack(h_in, dim=1)  # [b, nc, nh, hd, ds]
    y_inter = torch.einsum("bcis,bcnds,bcin->bcind", Cc, h_in,
                           torch.exp(cum))
    y = (y_intra + y_inter).reshape(b, sp, nh, hd)
    y = y + D.float()[None, None, :, None] * x.float()
    return y[:, :s].to(x.dtype)


def hd_slice(hd: int) -> int:
    """The scalar (float32) kernel's head-dim columns per block: 32 where hd
    allows, else all of hd."""
    return 32 if hd % 32 == 0 else hd


def smem_bytes(chunk: int, p: int, ds: int) -> int:
    """Shared memory of one block of the scalar kernel (``f32::smem_floats``
    in ssd_scan.cu)."""
    floats = (chunk * (p + 1) + 2 * chunk * (ds + 1) + chunk * (chunk + 1)
              + p * (ds + 1) + 3 * chunk)
    return 4 * floats


# The tensor-core kernel's plan, ``namespace tc`` of csrc/ssd_scan.cu
# (tests/test_torch_ssm.py reads the source and checks these against it).
TC_WARPS = 8
TC_PRODUCERS = 4
TC_HD_SLICE = 32
TC_STAGES = 2
TC_PAD = 8
TC_MAX_CHUNK = 128
#: padded widths the kernel is built for (hd slice; ds)
TC_WIDTHS_P = (16, 32, 64)
TC_WIDTHS_N = (16, 32, 64, 128)


def tc_slice(hd: int) -> int:
    """Head-dim columns per block of the tensor-core kernel
    (``tc::slice_of``)."""
    return (TC_HD_SLICE if hd % TC_HD_SLICE == 0
            else 16 if hd % 16 == 0 else hd)


def tc_padded(n: int, widths) -> int | None:
    """The smallest of the kernel's widths that holds n columns."""
    return next((w for w in widths if n <= w), None)


def tc_smem_bytes(chunk: int, pp: int, np_: int) -> int:
    """Shared memory of one block of the tensor-core kernel at padded widths
    ``pp`` (hd slice) and ``np_`` (ds) (``tc::smem_bytes``)."""
    stage = 2 * chunk * (pp + TC_PAD) + 4 * chunk * (np_ + TC_PAD)
    return (TC_STAGES * stage + 8 * pp * (np_ + TC_PAD)
            + 2 * chunk * (chunk + TC_PAD) + 24 * chunk)


def _check_tc(x, B, C, hd, ds, chunk) -> int:
    """The tensor-core kernel's limits; returns its hd slice."""
    p = tc_slice(hd)
    pp, np_ = tc_padded(p, TC_WIDTHS_P), tc_padded(ds, TC_WIDTHS_N)
    if chunk % 16 or chunk > TC_MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk {chunk} must be a multiple of 16 "
                         f"up to {TC_MAX_CHUNK} for the bf16 kernel")
    if pp is None or np_ is None or p % 8 or ds % 8:
        raise ValueError(f"ssd_scan: the bf16 kernel takes an hd slice of "
                         f"at most {TC_WIDTHS_P[-1]} and ds up to "
                         f"{TC_WIDTHS_N[-1]}, both multiples of 8 (hd {hd}, "
                         f"slice {p}, ds {ds})")
    if tc_smem_bytes(chunk, pp, np_) > MAX_SMEM:
        raise ValueError(f"ssd_scan: chunk {chunk}, hd slice {p}, ds {ds} "
                         f"need {tc_smem_bytes(chunk, pp, np_)} B of shared "
                         f"memory (the card has {MAX_SMEM})")
    for name, t, n in (("x", x, 3), ("B", B, 2), ("C", C, 2)):
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:n]):
            raise ValueError(
                f"ssd_scan: the bf16 kernel copies 16-byte rows; {name} at "
                f"offset {t.data_ptr() % 16} B from 16-byte alignment with "
                f"strides {t.stride()} is not taken (its batch, seq and head "
                f"strides must be multiples of 8)")
    return p


def ssd_scan(x, dt, A, B, C, D, *, chunk: int):
    """K4 forward.  x: [b, s, nh, hd]; dt: [b, s, nh]; A, D: [nh];
    B, C: [b, s, ds]; ``s % chunk == 0``.  Returns y [b, s, nh, hd].

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.
    """
    if x.device.type in _build.PLAIN_DEVICES:
        return ssd_chunked_plain(x, dt, A, B, C, D, chunk)
    if x.device.type != "cuda":
        raise RuntimeError(f"ssd_scan: no kernel for {x.device}")
    b, s, nh, hd = x.shape
    ds = B.shape[-1]
    if x.dtype not in _DTYPES or B.dtype not in _DTYPES or C.dtype != B.dtype:
        raise TypeError(f"ssd_scan takes float32/bfloat16 x and B, C of one "
                        f"such dtype, not {x.dtype}/{B.dtype}/{C.dtype}")
    if (dt.shape != (b, s, nh) or A.shape != (nh,) or D.shape != (nh,)
            or B.shape != (b, s, ds) or C.shape != B.shape):
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}, D "
                         f"{tuple(D.shape)}")
    if s % chunk:
        raise ValueError(f"ssd_scan: length {s} is not a multiple of the "
                         f"chunk {chunk} (ops.ssd pads)")
    if any(t.device != x.device for t in (dt, A, B, C, D)):
        raise ValueError("ssd_scan: inputs on different devices")
    dt = dt.float().contiguous()
    A = A.float().contiguous()
    D = D.float().contiguous()
    if x.stride(-1) != 1 or B.stride(-1) != 1 or C.stride(-1) != 1:
        raise ValueError("ssd_scan: the last axis of x, B and C must be "
                         "contiguous")
    if x.dtype == torch.bfloat16:
        B, C = B.to(torch.bfloat16), C.to(torch.bfloat16)
        p = _check_tc(x, B, C, hd, ds, chunk)
    else:
        p = hd_slice(hd)
        if chunk % 4 or p % 4 or ds % 4:
            raise ValueError(f"ssd_scan: chunk {chunk}, hd slice {p} and "
                             f"d_state {ds} must be multiples of 4 (the "
                             f"float32 kernel's register tiles)")
        if smem_bytes(chunk, p, ds) > MAX_SMEM:
            raise ValueError(f"ssd_scan: chunk {chunk}, hd slice {p}, ds "
                             f"{ds} need {smem_bytes(chunk, p, ds)} B of "
                             f"shared memory (the card has {MAX_SMEM})")
    y = torch.empty((b, s, nh, hd), dtype=x.dtype, device=x.device)
    strides = (ctypes.c_longlong * 10)(
        x.stride(0), x.stride(1), x.stride(2),
        dt.stride(0), dt.stride(1), dt.stride(2),
        B.stride(0), B.stride(1), C.stride(0), C.stride(1))
    lib = _lib()
    err = lib.repro_ssd_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), D.data_ptr(), y.data_ptr(), _DTYPES[x.dtype],
        _DTYPES[B.dtype], b, s, nh, hd, ds, chunk, p, strides,
        x.device.index or 0, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "ssd_scan launch")
    COUNTER.add()
    return y


def _lib():
    lib = _build.library("ssd_scan")
    fn = lib.repro_ssd_scan
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I,
                       ctypes.POINTER(ctypes.c_longlong), I, P]
        fn.restype = I
    return lib
