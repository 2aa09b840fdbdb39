"""Mamba-2 chunked SSD scan (kernel K4): CUDA launcher, plain version, counter.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py`` (``ssd_scan`` /
``_kernel``) with the hand-written Hopper kernel in ``csrc/ssd_scan.cu``.
Contract as in the reference: x ``[b, s, nh, hd]`` in the model dtype, dt
``[b, s, nh]`` float32, A and D ``[nh]`` float32, B and C ``[b, s, ds]``;
``s`` a multiple of ``chunk`` (``ops.ssd`` pads).  Returns y ``[b, s, nh,
hd]`` in x's dtype; all arithmetic is float32, per chunk: the masked
intra-chunk contraction ``(C B^T) * exp(cum_i - cum_j) * dt_j`` against x,
the inter-chunk term ``exp(cum) * C state^T``, ``D * x``, then the state
update ``exp(cum_Q) state + sum_j exp(cum_Q - cum_j) dt_j x_j B_j^T``.

Bound on the H100: bytes.  At the zamba2 shape (``[1, 2048, 64, 64]``, ds
64, chunk 64) it reads x and writes y once (2 x 16.8 MB in bf16) for about
4.3 GFLOP: 0.0103 ms of memory traffic against 0.0043 ms of bf16 tensor-core
work.  The kernel keeps everything between those reads and writes on chip:
one block owns a (batch row, head, slice of hd) and walks the chunks in
order itself, holding its float32 ``[hd_slice, ds]`` state in shared memory
(the TPU's sequential chunk grid axis becomes that loop; rows of the state
are independent across hd, so slices need no reduction across blocks and
the result is deterministic).  Its products are scalar float32 FMAs in
per-thread register tiles, so it sits well above that bound (see PERF.md);
tensor-core tiles are later work.

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
    """Head-dim columns per block: 32 where hd allows, else all of hd
    (at the zamba2 shape, 2 slices x 64 heads = 128 blocks on 132 SMs)."""
    return 32 if hd % 32 == 0 else hd


def smem_bytes(chunk: int, p: int, ds: int) -> int:
    """Shared memory of one block (``smem_floats`` in ssd_scan.cu)."""
    floats = (chunk * (p + 1) + 2 * chunk * (ds + 1) + chunk * (chunk + 1)
              + p * (ds + 1) + 3 * chunk)
    return 4 * floats


def ssd_scan(x, dt, A, B, C, D, *, chunk: int):
    """K4 forward.  x: [b, s, nh, hd]; dt: [b, s, nh]; A, D: [nh];
    B, C: [b, s, ds]; ``s % chunk == 0``.  Returns y [b, s, nh, hd].

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.
    """
    if x.device.type == "cpu":
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
    p = hd_slice(hd)
    if chunk % 4 or p % 4 or ds % 4:
        raise ValueError(f"ssd_scan: chunk {chunk}, hd slice {p} and d_state "
                         f"{ds} must be multiples of 4 (the kernel's "
                         f"register tiles)")
    if smem_bytes(chunk, p, ds) > MAX_SMEM:
        raise ValueError(f"ssd_scan: chunk {chunk}, hd slice {p}, ds {ds} "
                         f"need {smem_bytes(chunk, p, ds)} B of shared "
                         f"memory (the card has {MAX_SMEM})")
    dt = dt.float().contiguous()
    A = A.float().contiguous()
    D = D.float().contiguous()
    if x.stride(-1) != 1 or B.stride(-1) != 1 or C.stride(-1) != 1:
        raise ValueError("ssd_scan: the last axis of x, B and C must be "
                         "contiguous")
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
