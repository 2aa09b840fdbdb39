"""Build the port's CUDA sources at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its
own with ``nvcc`` into ``build/repro_torch/lib<name>-<hash>.so`` (the hash
covers the source and the flags, so an edited source rebuilds and an
unchanged one is reused).  No PyTorch headers are compiled: a source builds
in seconds.  Every launcher returns its ``cudaError_t``; :func:`check`
raises on anything but 0.

Also home of :class:`LaunchCounter`, the per-kernel count of launches that
shows a run really went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"
#: ``-Xptxas -v`` puts each kernel's registers, shared memory and spills
#: into the build log (``BUILD_LOG``), which ``chip_smoke.py`` prints
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
#: name -> (seconds, compiler messages) of the builds made by this process
BUILD_LOG: dict[str, tuple[float, str]] = {}


class LaunchCounter:
    """Number of times a wrapper launched its kernel (thread-safe: the
    stage actors are threads)."""

    def __init__(self, name: str):
        self.name = name
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    @property
    def value(self) -> int:
        return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0


def nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found (set NVCC or put the CUDA toolkit's "
                       "bin/ on PATH); the port's CUDA kernels need it")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build_all(names) -> dict[str, float]:
    """Compile the named sources that are not built yet, one ``nvcc`` per
    source, all started together.  Returns seconds per source built."""
    with _LOCK:
        todo = [n for n in names if not _target(n).exists()]
        if not todo:
            return {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        for n in todo:
            tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        errors, secs = [], {}
        for n, (tmp, p) in procs.items():
            out, _ = p.communicate()
            secs[n] = time.perf_counter() - t0
            BUILD_LOG[n] = (secs[n], out)
            if p.returncode:
                errors.append(f"nvcc failed on {n}.cu:\n{out}")
            else:
                os.replace(tmp, _target(n))
        if errors:
            raise RuntimeError("\n".join(errors))
        return secs


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu`` (built if needed)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(str(_target(name)))
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            _LIBS[name] = lib
        return _LIBS[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
