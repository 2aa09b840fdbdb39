"""Flash-attention forward (kernel K1): CUDA launcher, plain version, counter.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention_fwd`` / ``_kernel``) with the hand-written Hopper kernel
in ``csrc/flash_attention.cu``.  Contract as in the reference: layout
``[b, h, s, hd]``, q pre-scaled by ``hd**-0.5`` by the caller, query
positions ``arange(sq)``, causal and/or sliding-window masking, query head
``h`` reads kv head ``h // (hq // hkv)``.  It also returns the row
log-sum-exp ``lse`` (float32 ``[b, hq, sq]``) for the backward.

Bound on the H100: operations.  Causal training attention does
``2*b*hq*sq^2*hd`` FLOP on ``O(b*h*s*hd)`` bytes, so the floor is that
count over the bf16 tensor-core rate, 989 TFLOP/s.  For bfloat16 (the main
path) the kernel runs both products on the tensor cores (``mma.sync``
m16n8k16, bf16 in, float32 accumulate, ``ldmatrix`` fragments), keeps K
and V tiles as bf16 in shared memory filled by 16-byte ``cp.async`` copies
in a 2-stage ring, keeps the online softmax in float32 registers (no ``sq
x sk`` matrix in device memory), skips tiles above the diagonal or outside
the window, and launches the longest causal query tiles first.  Its
16-byte copies need every pointer 16-byte aligned and the batch, head and
seq strides of q, k, v and the output multiples of 8 elements; the wrapper
raises otherwise.  float32 runs a scalar kernel (float32 FMAs), which keeps
the float32 checks' tolerance that TF32 tensor cores could not meet.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import NEG_INF

COUNTER = _build.LaunchCounter("flash_attention_fwd")
HEAD_DIMS = (32, 64, 96, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_fwd_plain(q, k, v, *, causal: bool = True,
                              window: int = 0):
    """Plain PyTorch version of the kernel: dense float32 softmax.

    q: [b, hq, sq, hd] (pre-scaled); k, v: [b, hkv, sk, hd].
    Returns (out [b, hq, sq, hd] in q's dtype, lse [b, hq, sq] float32).
    """
    b, hq, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.float().reshape(b, hkv, g, sq, hd)
    s = torch.einsum("bkgqd,bkjd->bkgqj", qf, k.float())
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= qpos - kpos < window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgqj,bkjd->bkgqd", p, v.float()) / l
    lse = (m + torch.log(l))[..., 0]
    return (out.reshape(b, hq, sq, hd).to(q.dtype),
            lse.reshape(b, hq, sq))


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0):
    """K1 forward.  q: [b, hq, sq, hd] (pre-scaled); k, v: [b, hkv, sk, hd];
    any strides with a contiguous head_dim axis.

    Returns (out [b, hq, sq, hd], lse [b, hq, sq] float32).  On the kernel
    path ``out`` is a view of a ``[b, sq, hq, hd]``-contiguous buffer, the
    model's own layout.  CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise.
    """
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention_fwd: no kernel for {q.device}")
    b, hq, sq, hd = q.shape
    _, hkv, sk, _ = k.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fwd takes float32/bfloat16 q, k, v "
                        f"of one dtype, not {q.dtype}/{k.dtype}/{v.dtype}")
    if hd not in HEAD_DIMS or k.shape[-1] != hd or v.shape != k.shape:
        raise ValueError(f"flash_attention_fwd: head_dim {hd} (kernel takes "
                         f"{HEAD_DIMS}), k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if hq % hkv or k.shape[0] != b:
        raise ValueError(f"flash_attention_fwd: q heads {hq} not a multiple "
                         f"of kv heads {hkv}, or batch mismatch")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention_fwd: q, k, v on different devices")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention_fwd: head_dim must be contiguous")
    if q.dtype == torch.bfloat16:
        _check_aligned16(q, k, v)
    buf = torch.empty((b, sq, hq, hd), dtype=q.dtype, device=q.device)
    out = buf.transpose(1, 2)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2))
    lib = _lib()
    err = lib.repro_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), _DTYPES[q.dtype], b, hq, hkv, sq, sk, hd, strides,
        int(causal), int(window), q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_attention_fwd launch")
    COUNTER.add()
    return out, lse


def _check_aligned16(*tensors):
    """The bf16 kernel's 16-byte copies: every pointer 16-byte aligned, the
    batch, head and seq strides multiples of 8 elements (the output buffer
    the wrapper allocates is, for every head dim the kernel takes)."""
    for t in tensors:
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(
                f"flash_attention_fwd: the bf16 kernel copies 16-byte rows; "
                f"a view at offset {t.data_ptr() % 16} B from 16-byte "
                f"alignment with strides {t.stride()} is not taken (strides "
                f"of batch, head and seq must be multiples of 8)")


def _lib():
    lib = _build.library("flash_attention")
    fn = lib.repro_flash_attention_fwd
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I,
                       ctypes.POINTER(ctypes.c_longlong), I, I, I, P]
        fn.restype = I
    return lib


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, causal: bool = True,
                              window: int = 0, block: int = 256,
                              dq_scale: float = 1.0):
    """Gradient of K1 w.r.t. (q, k, v), streamed over key blocks.

    Port of the lse VJP ``repro.models.layers._blocked_attention_bwd``:
    p is recomputed per key block from the saved log-sum-exp, so the
    residency is O(s*d) plus one [sq, block] tile per head.  Inputs in the
    kernel's layout (q pre-scaled); returns (dq, dk, dv) w.r.t. those
    inputs, in their dtypes, with ``dq`` multiplied by ``dq_scale`` before
    rounding (the chain rule through the caller's pre-scaling).  Products
    run in float32 on operands rounded to the inputs' dtype, as the
    reference's ``preferred_element_type`` products do.
    """
    b, hq, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    cd = k.dtype
    qf = q.float().reshape(b, hkv, g, sq, hd)
    do = dout.float().reshape(b, hkv, g, sq, hd)
    of = out.float().reshape(b, hkv, g, sq, hd)
    delta = (do * of).sum(-1)
    lse5 = lse.reshape(b, hkv, g, sq, 1)
    qpos = torch.arange(sq, device=q.device)[:, None]
    dq = torch.zeros((b, hkv, g, sq, hd), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for j0 in range(0, sk, block):
        j1 = min(sk, j0 + block)
        kb = k[:, :, j0:j1].float()
        vb = v[:, :, j0:j1].float()
        kpos = torch.arange(j0, j1, device=q.device)[None, :]
        mask = torch.ones((sq, j1 - j0), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos >= kpos
        if window > 0:
            mask &= qpos - kpos < window
        s = torch.einsum("bkgqd,bkjd->bkgqj", qf, kb)
        p = torch.where(mask, torch.exp(s - lse5), torch.zeros_like(s))
        dvs.append(torch.einsum("bkgqj,bkgqd->bkjd", p.to(cd).float(), do))
        dp = torch.einsum("bkgqd,bkjd->bkgqj", do, vb)
        ds = (p * (dp - delta[..., None])).to(cd).float()
        dq = dq + torch.einsum("bkgqj,bkjd->bkgqd", ds, kb)
        dks.append(torch.einsum("bkgqj,bkgqd->bkjd", ds, qf))
    return ((dq * dq_scale).reshape(b, hq, sq, hd).to(q.dtype),
            torch.cat(dks, dim=2).to(k.dtype),
            torch.cat(dvs, dim=2).to(v.dtype))
