"""Split-KV flash decode (kernel K3): CUDA launcher, plain version, counter.

Replaces the Pallas TPU kernel ``repro/kernels/flash_decode.py``
(``flash_decode`` / ``_kernel``) with the hand-written Hopper kernel in
``csrc/flash_decode.cu``.  Contract as in the reference: q ``[b, hq, 1,
hd]`` pre-scaled by ``hd**-0.5`` by the caller, caches ``[b, hkv, S, hd]``,
one valid ``length`` for every row (keys ``[length - window, length)``, or
``[0, length)`` without a window), query head ``h`` reads kv head
``h // (hq // hkv)``; returns ``[b, hq, 1, hd]`` in q's dtype.

Bound on the H100: bytes.  One query row per head against ``length`` keys
is 4 FLOPs per K/V element read, so the floor is the valid part of K and V
read once over 3.35 TB/s.  The kernel splits the keys over blocks
(flash-decoding) so that a decode step with ``b * hkv`` far below the SM
count still fills the card, reads each K/V row once per kv head (not once
per query head) with 16-byte ``cp.async`` copies into a 2-stage ring, and
merges the splits' float32 partials in the same launch: the last split
block of each (batch row, kv head) to arrive, counted by an int32 arrival
counter, merges all of them in split index order, so the result does not
depend on the arrival order.  The split count comes from ``S`` and the SM
count, never from ``length``, and ``length`` is read on the device: one
launch, or one CUDA graph, serves every length without a host sync.

The caches may be any strided view with a contiguous head_dim axis whose
other strides are multiples of 16 bytes, on 16-byte aligned storage (the
model passes ``[b, S, hkv, hd]`` storage transposed), so no call copies a
cache.  The arrival counters are cached per device, stream and ``b *
hkv``, zeroed once, and left at zero by every launch: calls that share
them run in the order of their stream, so calls on two streams never mix
their tickets.  A CUDA graph keeps the counters of the stream it was
captured on; warm up on that stream before the capture, and do not call
the kernel there outside the graph while the graph replays elsewhere.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import NEG_INF

COUNTER = _build.LaunchCounter("flash_decode")
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 8  # query heads per kv head
TILE = 64  # keys per shared-memory tile (``TILE`` in flash_decode.cu)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: (device index, length) -> int32 device scalar, for lengths given as ints
#: (the ``dec`` branch's static ``enc_len``); never written after creation
_LENGTHS: dict[tuple[int, int], torch.Tensor] = {}
#: (device index, stream, b * hkv) -> the kernel's int32 arrival counters,
#: zeroed once; every launch leaves them at zero
_COUNTERS: dict[tuple[int, int, int], torch.Tensor] = {}


def flash_decode_plain(q, k_cache, v_cache, length, *, window: int = 0):
    """Plain PyTorch version of the kernel: dense float32 softmax over the
    valid keys.

    q: [b, hq, 1, hd] (pre-scaled); caches: [b, hkv, S, hd]; length: an int
    or an int tensor of one element.  Returns [b, hq, 1, hd] in q's dtype,
    0 where no key is valid.
    """
    b, hq, _, hd = q.shape
    hkv, S = k_cache.shape[1], k_cache.shape[2]
    qf = q.float().reshape(b, hkv, hq // hkv, hd)
    s = torch.einsum("bkgd,bkjd->bkgj", qf, k_cache.float())
    pos = torch.arange(S, device=q.device)
    length = torch.as_tensor(length, device=q.device).reshape(())
    mask = pos < length
    if window > 0:
        mask &= pos >= length - window
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgj,bkjd->bkgd", p, v_cache.float()) / l
    return out.reshape(b, hq, 1, hd).to(q.dtype)


def split_plan(S: int, b: int, hkv: int, sm_count: int) -> tuple[int, int]:
    """(splits, tiles per split) of a cache of capacity ``S``: about two
    blocks per SM, whole 64-key tiles per split, at most one split
    per tile.  Independent of the valid length."""
    tiles = math.ceil(S / TILE)
    want = min(tiles, max(1, math.ceil(2 * sm_count / (b * hkv))))
    per_split = math.ceil(tiles / want)
    return math.ceil(tiles / per_split), per_split


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _length_tensor(length, device: torch.device) -> torch.Tensor:
    """The int32 device scalar the kernel reads.  A tensor is taken as it
    is (write it in place to move a captured graph to another length); an
    int maps to one cached tensor per device and value, so a decode step
    makes no host-to-device copy."""
    if isinstance(length, torch.Tensor):
        if (length.device != device or length.dtype != torch.int32
                or length.numel() != 1):
            raise ValueError(f"flash_decode: length must be one int32 on "
                             f"{device}, not {length.dtype} "
                             f"{tuple(length.shape)} on {length.device}")
        return length
    key = (device.index, int(length))
    t = _LENGTHS.get(key)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"flash_decode: length {int(length)} is first seen inside a "
                f"CUDA graph capture; call once outside the capture, or pass "
                f"an int32 device tensor")
        t = torch.full((1,), int(length), dtype=torch.int32, device=device)
        _LENGTHS[key] = t
    return t


def _counters(n: int, device: torch.device, stream: int) -> torch.Tensor:
    """The arrival counters of ``n`` (batch row, kv head) pairs for calls
    on ``stream``: one set per stream, so that only calls in one stream's
    order share them."""
    key = (device.index, stream, n)
    t = _COUNTERS.get(key)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "flash_decode: first call for this batch and kv-head count "
                "on this stream inside a CUDA graph capture; call once on "
                "the capture stream outside the capture")
        t = torch.zeros((n,), dtype=torch.int32, device=device)
        _COUNTERS[key] = t
    return t


def flash_decode(q, k_cache, v_cache, length, *, window: int = 0):
    """K3.  q: [b, hq, 1, hd] (pre-scaled); caches: [b, hkv, S, hd], any
    strides with a contiguous head_dim axis; length: an int or an int32
    device tensor of one element.

    Returns [b, hq, 1, hd]; on the kernel path a view of a
    ``[b, 1, hq, hd]``-contiguous buffer, the model's own layout.  CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise.
    """
    if q.device.type in _build.PLAIN_DEVICES:
        return flash_decode_plain(q, k_cache, v_cache, length, window=window)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_decode: no kernel for {q.device}")
    b, hq, one, hd = q.shape
    _, hkv, S, _ = k_cache.shape
    if (q.dtype not in _DTYPES or k_cache.dtype != q.dtype
            or v_cache.dtype != q.dtype):
        raise TypeError(f"flash_decode takes float32/bfloat16 q and caches "
                        f"of one dtype, not {q.dtype}/{k_cache.dtype}/"
                        f"{v_cache.dtype}")
    if (one != 1 or hd not in HEAD_DIMS or k_cache.shape[0] != b
            or k_cache.shape[-1] != hd or v_cache.shape != k_cache.shape):
        raise ValueError(f"flash_decode: q {tuple(q.shape)} (head_dim one of "
                         f"{HEAD_DIMS}), k {tuple(k_cache.shape)}, v "
                         f"{tuple(v_cache.shape)}")
    if hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"flash_decode: {hq} query heads on {hkv} kv heads "
                         f"(at most {MAX_GROUP} per kv head)")
    if not (q.device == k_cache.device == v_cache.device):
        raise ValueError("flash_decode: q and caches on different devices")
    if q.stride(-1) != 1 or k_cache.stride(-1) != 1 or v_cache.stride(-1) != 1:
        raise ValueError("flash_decode: head_dim must be contiguous")
    vec = 16 // q.element_size()
    for name, t, n in (("q", q, 2), ("k_cache", k_cache, 3),
                       ("v_cache", v_cache, 3)):
        if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:n]):
            raise ValueError(
                f"flash_decode: the kernel copies 16-byte rows; {name} at "
                f"offset {t.data_ptr() % 16} B from 16-byte alignment with "
                f"strides {t.stride()} is not taken")
    len_t = _length_tensor(length, q.device)
    splits, per_split = split_plan(S, b, hkv, _sm_count(q.device.index))
    out = torch.empty((b, 1, hq, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    ws_acc = torch.empty((b, hq, splits, hd), dtype=torch.float32,
                         device=q.device)
    ws_ml = torch.empty((b, hq, splits, 2), dtype=torch.float32,
                        device=q.device)
    strides = (ctypes.c_longlong * 10)(
        q.stride(0), q.stride(1),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        out.stride(0), out.stride(1))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = _lib()
    err = lib.repro_flash_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        len_t.data_ptr(), out.data_ptr(), ws_acc.data_ptr(),
        ws_ml.data_ptr(), _counters(b * hkv, q.device, stream).data_ptr(),
        _DTYPES[q.dtype], b, hq, hkv, S, hd, splits,
        per_split, strides, int(window), q.device.index, stream)
    _build.check(lib, err, "flash_decode launch")
    COUNTER.add()
    return out


def _lib():
    lib = _build.library("flash_decode")
    fn = lib.repro_flash_decode
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I,
                       ctypes.POINTER(ctypes.c_longlong), I, I, P]
        fn.restype = I
    return lib
