"""Sharded checkpoint store: npz payloads + json manifest, async writes.

Port of ``repro.ckpt.store`` with the same on-disk format, so a checkpoint
that either package writes restores in the other, leaf for leaf:

  <dir>/step_<k>/manifest.json       — step, meta, leaf index
  <dir>/step_<k>/shard_<p>.npz       — one payload per writer process
  <dir>/LATEST                       — atomic pointer (rename) to the last
                                       fully-committed step

A tree is nested dicts, lists and tuples whose leaves are torch tensors or
numpy arrays; ``None`` is an empty subtree.  Each leaf is stored under the
name ``jax.tree_util.keystr`` gives its path (``['params']['sp']['blk']
['attn']['wq']``, ``['m']['x'][0]``; dict keys sorted), computed here
without JAX.  bfloat16 leaves are stored as float32 (npz has no bfloat16;
the widening is lossless) and cast back to the target leaf's dtype on
restore.

Fault-tolerance contract: a step directory is visible via LATEST only after
every shard landed (write-then-rename), so a crash mid-save can never corrupt
the restore point; restore() validates every leaf's shape against the target
tree.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import struct
import threading
import time
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # npz has no bf16 encoding; fp32 is lossless
        a = a.astype(np.float32)
    return a


def _leaves_with_path(tree, prefix: str = ""):
    """(keystr, leaf) pairs in ``jax.tree_util`` order (dict keys sorted)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _map_with_path(fn, tree, prefix: str = ""):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {k: _to_numpy(leaf) for k, leaf in _leaves_with_path(tree)}


def _unflatten_into(tree, arrays: dict):
    """``tree``'s structure filled from ``arrays``: a torch leaf (any
    device, ``meta`` included) becomes a CPU tensor of its dtype, a numpy
    leaf a numpy array of its dtype."""
    def fill(k, leaf):
        if k not in arrays:
            raise KeyError(f"checkpoint missing leaf {k}")
        a = arrays[k]
        if tuple(a.shape) != tuple(leaf.shape):
            raise ValueError(
                f"shape mismatch for {k}: {a.shape} vs {tuple(leaf.shape)}")
        if isinstance(leaf, torch.Tensor):
            return torch.from_numpy(a).to(leaf.dtype)
        return a.astype(leaf.dtype)

    return _map_with_path(fill, tree)


def npz_members(path: str) -> list[zipfile.ZipInfo]:
    """The members of an ``.npz`` file (one ``<leaf>.npy`` a leaf)."""
    with zipfile.ZipFile(path) as z:
        return z.infolist()


def read_member(path: str, info: zipfile.ZipInfo) -> np.ndarray:
    """One member of an ``.npz`` as its array.  ``np.savez`` (both
    packages' writer) stores members uncompressed: one is read by one
    ``np.fromfile`` into its array and checked against the zip's CRC-32
    (``np.load`` copies a member through the zip reader 256 KB at a time
    in Python, which holds the interpreter lock)."""
    if info.compress_type != zipfile.ZIP_STORED:
        raise ValueError(f"{path}: member {info.filename} is compressed; "
                         f"checkpoints are written with np.savez")
    fmt = np.lib.format
    with open(path, "rb") as f:
        f.seek(info.header_offset)
        local = f.read(30)  # the member's local header
        if local[:4] != b"PK\x03\x04":
            raise ValueError(f"{path}: no local header for {info.filename}")
        name_len, extra_len = struct.unpack("<HH", local[26:30])
        start = info.header_offset + 30 + name_len + extra_len
        f.seek(start)
        major, _ = fmt.read_magic(f)
        read_header = (fmt.read_array_header_1_0 if major == 1
                       else fmt.read_array_header_2_0)
        shape, fortran, dtype = read_header(f)
        n_head = f.tell() - start
        f.seek(start)
        head = f.read(n_head)
        a = np.fromfile(f, dtype=dtype, count=math.prod(shape))
    if n_head + a.nbytes != info.file_size or zlib.crc32(
            a.reshape(-1).view(np.uint8), zlib.crc32(head)) != info.CRC:
        raise ValueError(f"{path}: member {info.filename} is truncated or "
                         f"fails its CRC-32")
    return (a.reshape(shape[::-1]).transpose() if fortran
            else a.reshape(shape))


class CheckpointStore:
    def __init__(self, directory: str, keep: int = 3, process: int = 0):
        self.dir = directory
        self.keep = keep
        self.process = process
        os.makedirs(directory, exist_ok=True)
        self._pending: threading.Thread | None = None
        self._error: Exception | None = None
        #: the last write that landed: ``{"step", "seconds"}``
        self.last_write: dict | None = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree, meta: dict | None = None,
             asynchronous: bool = False):
        arrays = _flatten(tree)  # device -> host copy happens here
        if asynchronous:
            self.wait()
            self._pending = threading.Thread(
                target=self._write_noting_error,
                args=(step, arrays, meta or {}), daemon=True)
            self._pending.start()
        else:
            self._write(step, arrays, meta or {})

    def wait(self):
        """Wait for the pending asynchronous write; its error raises here
        (and LATEST still names the last step that landed)."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write_noting_error(self, step: int, arrays: dict, meta: dict):
        try:
            self._write(step, arrays, meta)
        except Exception as e:  # raised again by wait()
            self._error = e

    def _write(self, step: int, arrays: dict, meta: dict):
        t0 = time.perf_counter()
        tmp = os.path.join(self.dir, f".tmp_step_{step}_{time.time_ns()}")
        final = os.path.join(self.dir, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, f"shard_{self.process}.npz"), **arrays)
        manifest = {
            "step": step,
            "leaves": sorted(arrays),
            "meta": meta,
            "shards": 1,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        latest_tmp = os.path.join(self.dir, ".LATEST_tmp")
        with open(latest_tmp, "w") as f:
            f.write(str(step))
        os.rename(latest_tmp, os.path.join(self.dir, "LATEST"))
        self._gc()
        self.last_write = {"step": step, "seconds": time.perf_counter() - t0}

    def _gc(self):
        steps = self.list_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # ------------------------------------------------------------------
    def list_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        p = os.path.join(self.dir, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return int(f.read().strip())

    def restore(self, step: int, target_tree):
        """Load step into ``target_tree``'s structure and dtypes, on the
        host (the reference's ``restore`` without ``shardings``; the caller
        places the tensors)."""
        arrays, manifest = self._read_arrays(step)
        return _unflatten_into(target_tree, arrays), manifest["meta"]

    def restore_host(self, step: int, target_tree):
        """Load step into ``target_tree``'s structure as *host* arrays (no
        device placement) — the recovery coordinator's restore path: a
        respawned stage actor rebuilds its program from the last committed
        step without assuming any device is available yet."""
        arrays, manifest = self._read_arrays(step)
        return _unflatten_into(target_tree, arrays), manifest["meta"]

    def _read_arrays(self, step: int):
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        arrays: dict = {}
        for p in range(manifest["shards"]):
            path = os.path.join(d, f"shard_{p}.npz")
            infos = npz_members(path)
            with ThreadPoolExecutor(8) as pool:  # reads and CRCs in parallel
                got = pool.map(lambda i: read_member(path, i), infos)
                arrays.update({i.filename.removesuffix(".npy"): a
                               for i, a in zip(infos, got)})
        return arrays, manifest
