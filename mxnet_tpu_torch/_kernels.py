"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` for ``sm_90a``
into one shared library with a plain C interface, and bound with
``ctypes``: pointers come from ``tensor.data_ptr()`` and the stream from
``torch.cuda.current_stream().cuda_stream``, both passed as
``c_void_p``.  Nothing includes PyTorch's headers, so a build takes
seconds.

The build happens at first use, from the sources in the checkout only,
into ``build/torch_kernels/`` beside the package: one ``nvcc -c`` per
source, all started together, then one link.  The library's file
name carries a hash of every file under ``csrc/`` (sources and the
headers they include, such as ``conv_mainloop.cuh``) and of the flags,
so an edited source or header never loads a stale build.  Serving
threads race the first forward, so the build and load run once, under
``_BUILD_LOCK`` (the counterpart of ``_PROBE_LOCK`` in the JAX
package's ``ops/pallas_convbn.py``).
There is no fallback: a failed build raises.

Launch counters live here too, one per kernel by name: a wrapper adds
one where it launches its kernel (:func:`count_launch`).  While a CUDA
graph is being captured (``_graphs``), a wrapper called on the
capturing stream records into nothing: the launch runs only when the
graph replays, so the capture keeps a tally of its own
(:func:`capture_tally`) and the graph's owner adds it to the counters on
every replay (:func:`add_launches`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Optional

from .base import MXNetError

__all__ = ["load", "build", "BUILD_DIR", "last_build", "count_launch",
           "launch_count", "reset_launch_count", "capture_tally",
           "add_launches"]

_PKG = Path(__file__).resolve().parent
_SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
_SOURCES = ("fused_convbn.cu", "fused_convbn_bwd.cu", "attention.cu",
            "convbn_tap.cu", "int8_conv.cu", "nms.cu")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

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
    """Hash of every file under ``csrc/`` (the compiled ``.cu`` sources and
    the headers they include) and of the flags."""
    h = hashlib.sha256()
    for path in sorted(p for p in _SRC_DIR.rglob("*") if p.is_file()):
        h.update(path.relative_to(_SRC_DIR).as_posix().encode() + b"\0")
        h.update(path.read_bytes())
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
    nvcc = _nvcc()
    tag = f"{out.stem}.tmp{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in _SOURCES]
    cmds = [[nvcc, *_FLAGS, "-c", "-o", str(o), str(_SRC_DIR / s)]
            for s, o in zip(_SOURCES, objs)]
    tmp = BUILD_DIR / f"{tag}.so"
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
            "-o", str(tmp), *[str(o) for o in objs]]
    t0 = time.perf_counter()
    log, procs = [], []
    try:
        for c in cmds:  # every compile starts before any is waited on
            procs.append(subprocess.Popen(c, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
        for c, pr in zip(cmds, procs):
            text = pr.communicate()[0]
            log.append(text)
            if pr.returncode != 0:
                raise MXNetError(f"nvcc failed (rc {pr.returncode}):\n"
                                 f"{' '.join(c)}\n{text}")
        proc = subprocess.run(link, capture_output=True, text=True)
        log.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise MXNetError(f"nvcc link failed (rc {proc.returncode}):\n"
                             f"{' '.join(link)}\n{log[-1]}")
        os.replace(tmp, out)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
        for o in objs:
            if o.exists():
                o.unlink()
    dt = time.perf_counter() - t0
    _LAST_BUILD.update(built=True, seconds=dt, path=str(out),
                       command="\n".join(" ".join(c) for c in cmds + [link]),
                       log="".join(log))
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.mx_fused_conv_unit.restype = _I
    lib.mx_fused_conv_unit.argtypes = (
        [_I] + [_VP] * 10 + [_I] * 15 + [ctypes.c_longlong, _VP])
    lib.mx_fused_conv_unit_bwd.restype = _I
    lib.mx_fused_conv_unit_bwd.argtypes = (
        [_I] + [_VP] * 17 + [_I] * 16 + [ctypes.c_longlong, _VP])
    lib.mx_attention_fwd.restype = _I
    lib.mx_attention_fwd.argtypes = (
        [_I] + [_VP] * 5 + [_I] * 5 + [ctypes.c_longlong] * 12
        + [ctypes.c_float, _I, _I, _VP])
    lib.mx_convbn_tap.restype = _I
    lib.mx_convbn_tap.argtypes = (
        [_I] + [_VP] * 10 + [_I] * 16 + [ctypes.c_longlong, _VP])
    lib.mx_int8_conv.restype = _I
    lib.mx_int8_conv.argtypes = (
        [_VP] * 3 + [_I] * 17 + [ctypes.c_longlong] * 4 + [_VP])
    lib.mx_nms_keep.restype = _I
    lib.mx_nms_keep.argtypes = (
        [_VP] * 5 + [_I] * 4 + [ctypes.c_double] * 2 + [_I, _VP])
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


_COUNT_LOCK = threading.Lock()
_COUNTS: Dict[str, int] = {}
# the tally of the capture underway, if any (one capture at a time)
_TALLY: list = [None]


def count_launch(name: str) -> None:
    """One launch of kernel ``name``.  Called by its wrapper inside the
    launch's device scope: on a stream under capture the launch goes to
    the capture's tally, not to the counter."""
    import torch

    with _COUNT_LOCK:
        tally = _TALLY[0]
        if tally is not None and torch.cuda.is_current_stream_capturing():
            tally[name] = tally.get(name, 0) + 1
        else:
            _COUNTS[name] = _COUNTS.get(name, 0) + 1


def launch_count(name: str) -> int:
    with _COUNT_LOCK:
        return _COUNTS.get(name, 0)


def reset_launch_count(name: str) -> None:
    with _COUNT_LOCK:
        _COUNTS[name] = 0


def add_launches(tally: Dict[str, int]) -> None:
    """A replay's launches: the tally its capture recorded."""
    if tally:
        with _COUNT_LOCK:
            for k, v in tally.items():
                _COUNTS[k] = _COUNTS.get(k, 0) + v


@contextmanager
def capture_tally():
    """The launches recorded while the block captures, by kernel name."""
    tally: Dict[str, int] = {}
    with _COUNT_LOCK:
        if _TALLY[0] is not None:
            raise MXNetError("a CUDA graph capture is already underway")
        _TALLY[0] = tally
    try:
        yield tally
    finally:
        with _COUNT_LOCK:
            _TALLY[0] = None
