"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` for ``sm_90a``
into one shared library with a plain C interface, and bound with
``ctypes``: pointers come from ``tensor.data_ptr()`` and the stream from
``torch.cuda.current_stream().cuda_stream``, both passed as
``c_void_p``.  Nothing includes PyTorch's headers, so a build takes
seconds.

The build happens at first use, from the sources in the checkout only,
into ``build/torch_kernels/`` beside the package.  The library's file
name carries a hash of the sources and flags, so an edited source never
loads a stale build.  Serving threads race the first forward, so the
build and load run once, under ``_BUILD_LOCK`` (the counterpart of
``_PROBE_LOCK`` in the JAX package's ``ops/pallas_convbn.py``).
There is no fallback: a failed build raises.
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
from typing import Optional

from .base import MXNetError

__all__ = ["load", "build", "BUILD_DIR", "last_build"]

_PKG = Path(__file__).resolve().parent
_SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
_SOURCES = ("fused_convbn.cu",)
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

_BUILD_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
# what the last build in this process did: seconds, command, compiler output
_LAST_BUILD: dict = {}

_VP = ctypes.c_void_p
_I = ctypes.c_int


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise MXNetError(
        "nvcc not found (CUDA_HOME, PATH, /usr/local/cuda/bin): the port's "
        "CUDA kernels are built from mxnet_tpu_torch/csrc at first use")


def _tag() -> str:
    h = hashlib.sha256()
    for name in _SOURCES:
        h.update((_SRC_DIR / name).read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path() -> Path:
    return BUILD_DIR / f"libmxnet_tpu_torch_kernels-{_tag()}.so"


def build(force: bool = False) -> Path:
    """Compile the sources into the library (skipped when a library of
    the same sources and flags exists, unless ``force``).  Caller holds
    no lock; the compile itself is serialised by ``_BUILD_LOCK``."""
    with _BUILD_LOCK:
        return _build_locked(force)


def _build_locked(force: bool) -> Path:
    out = _lib_path()
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    cmd = [_nvcc(), *_FLAGS, "-o", str(tmp),
           *[str(_SRC_DIR / s) for s in _SOURCES]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        raise MXNetError(f"nvcc failed (rc {proc.returncode}):\n"
                         f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    _LAST_BUILD.update(built=True, seconds=dt, path=str(out),
                       command=" ".join(cmd),
                       log=proc.stdout + proc.stderr)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.mx_fused_conv_unit.restype = _I
    lib.mx_fused_conv_unit.argtypes = (
        [_I] + [_VP] * 10 + [_I] * 14 + [_VP])
    lib.mx_fused_conv_unit_block_m.restype = _I
    lib.mx_fused_conv_unit_block_m.argtypes = []
    lib.mx_cuda_error_string.restype = ctypes.c_char_p
    lib.mx_cuda_error_string.argtypes = [_I]
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    lib = _LIB
    if lib is not None:
        return lib
    with _BUILD_LOCK:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(str(_build_locked(False))))
        return _LIB


def last_build() -> dict:
    """Seconds, command and compiler output (``-Xptxas -v``) of this
    process's last compile; empty when this process compiled nothing."""
    return dict(_LAST_BUILD)


def error_string(code: int) -> str:
    return load().mx_cuda_error_string(int(code)).decode()
