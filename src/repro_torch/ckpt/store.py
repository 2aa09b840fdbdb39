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
import os
import shutil
import threading
import time

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


class CheckpointStore:
    def __init__(self, directory: str, keep: int = 3, process: int = 0):
        self.dir = directory
        self.keep = keep
        self.process = process
        os.makedirs(directory, exist_ok=True)
        self._pending: threading.Thread | None = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree, meta: dict | None = None,
             asynchronous: bool = False):
        arrays = _flatten(tree)  # device -> host copy happens here
        if asynchronous:
            self.wait()
            self._pending = threading.Thread(
                target=self._write, args=(step, arrays, meta or {}),
                daemon=True)
            self._pending.start()
        else:
            self._write(step, arrays, meta or {})

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _write(self, step: int, arrays: dict, meta: dict):
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
            with np.load(os.path.join(d, f"shard_{p}.npz")) as z:
                arrays.update({k: z[k] for k in z.files})
        return arrays, manifest
