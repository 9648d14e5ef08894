"""The native layer of the port: builds the C++ under ``native/`` with
g++ at first use and binds it through ctypes (counterpart of
``mxnet_tpu/lib.py``; the reference binds its C ABI the same way).

``native/`` is the port's own copy of the host C++ it runs (``base.h``,
``engine.{h,cc}``, ``c_api.cc``, ``recordio.cc``, ``image_pipeline.cc``),
the JAX package's ``src/`` files unchanged.  They build into
``build/torch_native/`` of the checkout as two libraries:

* ``libmxnet_tpu_torch_native.so``: the dependency engine, the RecordIO
  writer and readers and the prefetching reader, with no dependency;
* ``libmxnet_tpu_torch_image.so``: the threaded decode, augment and
  batch pipeline over a ``.rec`` shard, linked with OpenCV.

A library is rebuilt when a source is newer than it, or when it does
not load (built on another machine).  Builds from
several processes at once (test workers) wait on a file lock, and a
build lands by ``os.replace``, so no process maps a half-written file.
``MXNET_USE_NATIVE=0`` turns every native path off (read at each call);
a build that fails is remembered with its compiler output
(:func:`image_error`, :func:`native_error`), and the callers take their
Python paths, never silently: ``io.ImageRecordIter`` reports its route.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
import weakref
from typing import List, Optional

import numpy as np

from .base import MXNetError
from .util import env

__all__ = ["available", "image_available", "native_error", "image_error",
           "NativeEngine", "NativeRecordWriter", "NativeRecordReader",
           "NativePrefetchReader", "NativeImagePipeline",
           "install_fork_handlers", "BUILD_DIR", "SOURCE_DIR"]

SOURCE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "native")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build", "torch_native")

EngineFnType = ctypes.CFUNCTYPE(None, ctypes.c_void_p)

_OPENCV_FLAGS = ["-I/usr/include/opencv4", "-lopencv_core",
                 "-lopencv_imgproc", "-lopencv_imgcodecs"]


def _src(*names: str) -> List[str]:
    return [os.path.join(SOURCE_DIR, n) for n in names]


class _NativeLib:
    """One library built on demand: staleness by mtime against its
    sources and every header, a build serialised by a file lock, one
    load a process (the outcome, library or error, is kept)."""

    def __init__(self, so_name: str, sources: List[str],
                 extra_flags: List[str], err_sym: str, what: str,
                 protos: dict):
        self.so_path = os.path.join(BUILD_DIR, so_name)
        self.sources = sources
        self._flags = extra_flags
        self._err_sym = err_sym
        self._protos = protos
        self._what = what
        self._lib: Optional[ctypes.CDLL] = None
        self.error: Optional[str] = None
        self._lock = threading.Lock()

    def _deps(self) -> List[str]:
        return self.sources + sorted(
            os.path.join(SOURCE_DIR, f) for f in os.listdir(SOURCE_DIR)
            if f.endswith(".h"))

    def _stale(self) -> bool:
        if not os.path.exists(self.so_path):
            return True
        mtime = os.path.getmtime(self.so_path)
        return any(os.path.getmtime(p) > mtime for p in self._deps())

    def _build(self, force: bool = False) -> None:
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(self.so_path + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not force and not self._stale():  # built meanwhile
                return
            tmp = f"{self.so_path}.{os.getpid()}.tmp"
            cmd = (["g++", "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-pthread", "-Wall", "-o", tmp] + self.sources +
                   self._flags)
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:  # no g++
                raise MXNetError(f"{self._what} build failed: {e}") from e
            if proc.returncode != 0:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise MXNetError(f"{self._what} build failed:\n"
                                 f"{' '.join(cmd)}\n{proc.stderr[-4000:]}")
            os.replace(tmp, self.so_path)

    def load(self) -> Optional[ctypes.CDLL]:
        if not env.get_bool("MXNET_USE_NATIVE"):
            return None
        with self._lock:
            if self._lib is None and self.error is None:
                try:
                    built = self._stale()
                    if built:
                        self._build()
                    try:
                        lib = ctypes.CDLL(self.so_path)
                    except OSError:
                        if built:
                            raise
                        # a library left by another machine (its OpenCV
                        # differs): build it here once
                        self._build(force=True)
                        lib = ctypes.CDLL(self.so_path)
                    getattr(lib, self._err_sym).restype = ctypes.c_char_p
                    getattr(lib, self._err_sym).argtypes = []
                    for name, argtypes in self._protos.items():
                        getattr(lib, name).argtypes = argtypes
                    self._lib = lib
                except (MXNetError, OSError) as e:
                    self.error = str(e)
        return self._lib

    def get(self) -> ctypes.CDLL:
        lib = self.load()
        if lib is None:
            raise MXNetError(f"{self._what} library unavailable: "
                             f"{self.error or 'MXNET_USE_NATIVE=0'}")
        return lib

    def check(self, ret: int) -> None:
        if ret != 0:
            raise MXNetError(getattr(self._lib, self._err_sym)()
                             .decode("utf-8", "replace"))


# the C ABI's argument types; every function returns int (0 on success)
_VP, _I64 = ctypes.c_void_p, ctypes.c_int64
_OUT_H = ctypes.POINTER(ctypes.c_void_p)
_NEXT = [_VP, ctypes.POINTER(ctypes.c_char_p),
         ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_int)]
_CORE_PROTOS = {
    "MXEngineCreate": [ctypes.c_int, _OUT_H],
    "MXEngineFree": [_VP],
    "MXEngineNewVariable": [_VP, ctypes.POINTER(_I64)],
    "MXEngineDeleteVariable": [_VP, _I64],
    "MXEnginePushAsync": [_VP, EngineFnType, _VP, ctypes.POINTER(_I64),
                          ctypes.c_int, ctypes.POINTER(_I64), ctypes.c_int,
                          ctypes.c_int],
    "MXEngineWaitForVar": [_VP, _I64],
    "MXEngineWaitForAll": [_VP],
    "MXEngineNumPending": [_VP, ctypes.POINTER(ctypes.c_int)],
    "MXEngineVarVersion": [_VP, _I64, ctypes.POINTER(ctypes.c_uint64)],
    "MXRecordIOWriterCreate": [ctypes.c_char_p, _OUT_H],
    "MXRecordIOWriterCreateEx": [ctypes.c_char_p, ctypes.c_size_t, _OUT_H],
    "MXRecordIOWriterWrite": [_VP, ctypes.c_char_p, ctypes.c_size_t,
                              ctypes.POINTER(_I64)],
    "MXRecordIOWriterFree": [_VP],
    "MXRecordIOReaderCreate": [ctypes.c_char_p, _OUT_H],
    "MXRecordIOReaderNext": _NEXT,
    "MXRecordIOReaderSeek": [_VP, _I64],
    "MXRecordIOReaderReset": [_VP],
    "MXRecordIOReaderFree": [_VP],
    "MXPrefetchReaderCreate": [ctypes.c_char_p, ctypes.c_int, _OUT_H],
    "MXPrefetchReaderNext": _NEXT,
    "MXPrefetchReaderReset": [_VP],
    "MXPrefetchReaderFree": [_VP]}
_IMAGE_PROTOS = {
    "MXImagePipelineCreate": [ctypes.c_char_p, ctypes.c_char_p,
                              ctypes.c_char_p, _OUT_H],
    "MXImagePipelineNext": [_VP, _OUT_H,
                            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                            ctypes.POINTER(ctypes.c_int)],
    "MXImagePipelineReleaseBatch": [_VP],
    "MXImagePipelineReset": [_VP],
    "MXImagePipelineFree": [_VP]}

_CORE = _NativeLib("libmxnet_tpu_torch_native.so",
                   _src("c_api.cc", "engine.cc", "recordio.cc"), [],
                   "MXGetLastError", "native", _CORE_PROTOS)
_IMAGE = _NativeLib("libmxnet_tpu_torch_image.so",
                    _src("image_pipeline.cc", "engine.cc"), _OPENCV_FLAGS,
                    "MXImageGetLastError", "image pipeline", _IMAGE_PROTOS)


def available() -> bool:
    """The core library (engine, RecordIO) builds and loads."""
    return _CORE.load() is not None


def image_available() -> bool:
    """The image pipeline library (OpenCV) builds and loads."""
    return _IMAGE.load() is not None


def _why(nl: _NativeLib) -> Optional[str]:
    if not env.get_bool("MXNET_USE_NATIVE"):
        return "MXNET_USE_NATIVE=0"
    return None if nl.load() is not None else nl.error


def native_error() -> Optional[str]:
    """Why the core library is unavailable: its build or load error,
    ``"MXNET_USE_NATIVE=0"``, or None when it loads."""
    return _why(_CORE)


def image_error() -> Optional[str]:
    """Why the image pipeline is unavailable, as :func:`native_error`."""
    return _why(_IMAGE)


def _check(ret: int) -> None:
    _CORE.check(ret)


# ---------------------------------------------------------------------------
# Fork safety: a forked child inherits the handles but not the native
# threads behind them, so every live object quiesces before the fork and
# is invalidated in the child (the reference's pthread_atfork role)
# ---------------------------------------------------------------------------

_FORK_REGISTRY: "weakref.WeakSet" = weakref.WeakSet()
_FORK_HOOKS_INSTALLED = False


def _each_guarded(method: str) -> None:
    for obj in list(_FORK_REGISTRY):
        try:
            getattr(obj, method)()
        except Exception:  # a fork hook must not stop the fork
            pass


def install_fork_handlers() -> None:
    """Register the atfork hooks once a process (they run on os.fork and
    the 'fork' start method, not on spawn).  Creating a native object
    installs them."""
    global _FORK_HOOKS_INSTALLED
    if _FORK_HOOKS_INSTALLED or not hasattr(os, "register_at_fork"):
        return
    _FORK_HOOKS_INSTALLED = True
    os.register_at_fork(
        before=lambda: _each_guarded("_quiesce_before_fork"),
        after_in_parent=lambda: _each_guarded("_after_fork_parent"),
        after_in_child=lambda: _each_guarded("_after_fork_child"))


def _register_fork_guard(obj) -> None:
    install_fork_handlers()
    _FORK_REGISTRY.add(obj)


class _HandleGuard:
    """``_hh()`` returns the live native handle or raises: a closed or
    fork-invalidated handle never reaches C++ as NULL."""

    _fork_invalid = False
    _h = None

    def _hh(self) -> ctypes.c_void_p:
        if not self._h:
            why = ("invalidated by fork (native threads and file offsets do "
                   "not survive into the child; recreate the object)"
                   if self._fork_invalid else "already closed")
            raise MXNetError(f"{type(self).__name__}: native handle {why}")
        return self._h

    def _quiesce_before_fork(self) -> None:
        pass

    def _after_fork_parent(self) -> None:
        pass

    def _after_fork_child(self) -> None:
        # leak the C++ object: freeing it here would join worker threads
        # that exist only in the parent
        self._h = None
        self._fork_invalid = True

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter shutdown
            pass


# ---------------------------------------------------------------------------
# The engine: host tasks scheduled by read/write variables
# ---------------------------------------------------------------------------

class NativeEngine(_HandleGuard):
    """Dependency-scheduled host task engine (the reference's
    ThreadedEngine contract).

    ``push(fn, read=[v1], write=[v2])`` runs ``fn()`` on a worker thread
    once every hazard on the named variables has cleared: reads run
    concurrently, writes exclusively and in push order.
    ``num_workers=0`` is the synchronous NaiveEngine.  The default is
    ``MXNET_CPU_WORKER_NTHREADS`` (max(2, cores) when unset), or 0 under
    ``MXNET_ENGINE_TYPE=NaiveEngine``."""

    def __init__(self, num_workers: Optional[int] = None):
        if num_workers is None:
            if env.get_str("MXNET_ENGINE_TYPE") == "NaiveEngine":
                num_workers = 0
            else:
                num_workers = env.get_int(
                    "MXNET_CPU_WORKER_NTHREADS",
                    default=max(2, os.cpu_count() or 2))
        self._lib = _CORE.get()
        self.num_workers = num_workers
        self._h = self._create()
        # the callables, kept alive until a worker pops them
        self._cb_lock = threading.Lock()
        self._cbs = {}
        self._next_id = 1  # never 0: ctypes passes a NULL void* as None
        self._tramp = EngineFnType(self._trampoline)
        _register_fork_guard(self)

    def _create(self) -> ctypes.c_void_p:
        h = ctypes.c_void_p()
        _check(self._lib.MXEngineCreate(ctypes.c_int(self.num_workers),
                                        ctypes.byref(h)))
        return h

    def _trampoline(self, arg) -> None:
        with self._cb_lock:
            fn = self._cbs.pop(int(arg or 0))
        try:
            fn()
        except Exception:  # a worker thread must never unwind into C++
            import traceback

            traceback.print_exc()

    def _quiesce_before_fork(self) -> None:
        # drain the work so no worker holds an engine mutex at the fork,
        # and hold the callback lock across it (the atfork protocol)
        if self._h:
            self.wait_for_all()
        self._cb_lock.acquire()
        self._cb_lock_held_for_fork = True

    def _after_fork_parent(self) -> None:
        if getattr(self, "_cb_lock_held_for_fork", False):
            self._cb_lock_held_for_fork = False
            self._cb_lock.release()

    def _after_fork_child(self) -> None:
        # the parent's workers do not exist here: leak the old engine and
        # build a new one at first use; variables made before the fork
        # belong to the old one and raise on the new
        self._h = None
        self._needs_rebuild = True
        self._cb_lock = threading.Lock()
        self._cb_lock_held_for_fork = False

    def _hh(self) -> ctypes.c_void_p:
        if getattr(self, "_needs_rebuild", False):
            self._needs_rebuild = False
            self._h = self._create()
            with self._cb_lock:
                self._cbs.clear()
        return super()._hh()

    def new_variable(self) -> int:
        v = ctypes.c_int64()
        _check(self._lib.MXEngineNewVariable(self._hh(), ctypes.byref(v)))
        return v.value

    def delete_variable(self, var: int) -> None:
        _check(self._lib.MXEngineDeleteVariable(self._hh(),
                                                ctypes.c_int64(var)))

    def push(self, fn, read=(), write=(), priority: int = 0) -> None:
        # convert before stashing: a bad variable id must not leak fn
        rv = (ctypes.c_int64 * len(read))(*read)
        wv = (ctypes.c_int64 * len(write))(*write)
        with self._cb_lock:
            key = self._next_id
            self._next_id += 1
            self._cbs[key] = fn
        try:
            _check(self._lib.MXEnginePushAsync(
                self._hh(), self._tramp, ctypes.c_void_p(key), rv,
                len(read), wv, len(write), ctypes.c_int(priority)))
        except BaseException:
            # a refused push never reaches the trampoline: drop fn here
            with self._cb_lock:
                self._cbs.pop(key, None)
            raise

    def wait_for_var(self, var: int) -> None:
        _check(self._lib.MXEngineWaitForVar(self._hh(), ctypes.c_int64(var)))

    def wait_for_all(self) -> None:
        _check(self._lib.MXEngineWaitForAll(self._hh()))

    def num_pending(self) -> int:
        out = ctypes.c_int()
        _check(self._lib.MXEngineNumPending(self._hh(), ctypes.byref(out)))
        return out.value

    def var_version(self, var: int) -> int:
        out = ctypes.c_uint64()
        _check(self._lib.MXEngineVarVersion(
            self._hh(), ctypes.c_int64(var), ctypes.byref(out)))
        return out.value

    def close(self) -> None:
        if self._h:
            self._lib.MXEngineFree(self._h)
            self._h = None


# ---------------------------------------------------------------------------
# RecordIO: the native writer, reader and prefetching reader
# ---------------------------------------------------------------------------

class NativeRecordWriter(_HandleGuard):
    """Appends records to a ``.rec`` file; ``write`` returns the record's
    offset.  ``max_chunk`` (0: the 29-bit length field's limit) splits
    longer records into a chain of chunks."""

    def __init__(self, path: str, max_chunk: int = 0):
        self._lib = _CORE.get()
        h = ctypes.c_void_p()
        if max_chunk:
            _check(self._lib.MXRecordIOWriterCreateEx(
                path.encode(), ctypes.c_size_t(max_chunk), ctypes.byref(h)))
        else:
            _check(self._lib.MXRecordIOWriterCreate(path.encode(),
                                                    ctypes.byref(h)))
        self._h = h
        _register_fork_guard(self)

    def write(self, buf: bytes) -> int:
        pos = ctypes.c_int64()
        _check(self._lib.MXRecordIOWriterWrite(
            self._hh(), buf, ctypes.c_size_t(len(buf)), ctypes.byref(pos)))
        return pos.value

    def close(self) -> None:
        if self._h:
            _check(self._lib.MXRecordIOWriterFree(self._h))
            self._h = None


class _ReaderBase(_HandleGuard):
    """A reader over the C ABI's ``<prefix>Create/Next/Reset/Free``."""

    _prefix = ""

    def __init__(self, path: str, *extra):
        self._lib = _CORE.get()
        fn = lambda name: getattr(self._lib, self._prefix + name)  # noqa: E731
        self._next, self._reset, self._free = fn("Next"), fn("Reset"), \
            fn("Free")
        h = ctypes.c_void_p()
        _check(fn("Create")(path.encode(), *extra, ctypes.byref(h)))
        self._h = h
        _register_fork_guard(self)

    def read(self) -> Optional[bytes]:
        """The next record, or None at the end of the file."""
        buf = ctypes.c_char_p()
        length = ctypes.c_size_t()
        eof = ctypes.c_int()
        _check(self._next(self._hh(), ctypes.byref(buf),
                          ctypes.byref(length), ctypes.byref(eof)))
        if eof.value:
            return None
        return ctypes.string_at(buf, length.value)

    def reset(self) -> None:
        _check(self._reset(self._hh()))

    def close(self) -> None:
        if self._h:
            _check(self._free(self._h))
            self._h = None


class NativeRecordReader(_ReaderBase):
    _prefix = "MXRecordIOReader"

    def seek(self, pos: int) -> None:
        _check(self._lib.MXRecordIOReaderSeek(self._hh(),
                                              ctypes.c_int64(pos)))


class NativePrefetchReader(_ReaderBase):
    """A record reader with a background thread reading ``capacity``
    records ahead (dmlc's ThreadedIter role)."""

    _prefix = "MXPrefetchReader"

    def __init__(self, path: str, capacity: int = 64):
        super().__init__(path, ctypes.c_int(capacity))


# ---------------------------------------------------------------------------
# The image pipeline
# ---------------------------------------------------------------------------

class NativeImagePipeline(_HandleGuard):
    """Threaded decode, augment and batch pipeline over a ``.rec`` shard
    (``native/image_pipeline.cc``; its decode tasks run on its own
    engine).  ``cfg`` holds the C++ ``PipelineCfg`` fields: ``batch``,
    ``channels``, ``height``, ``width``, ``label_width``,
    ``resize_short``, ``rand_crop``, ``rand_mirror``, ``shuffle`` (needs
    the ``.idx``), ``normalize`` (float32 NCHW with ``mean_*``/``std_*``
    instead of uint8 NHWC), ``threads``, ``prefetch`` and ``seed``."""

    def __init__(self, rec_path: str, idx_path: Optional[str], **cfg):
        self._lib = _IMAGE.get()
        self.cfg = cfg
        cfg_s = ";".join(f"{k}={int(v) if isinstance(v, bool) else v}"
                         for k, v in cfg.items())
        h = ctypes.c_void_p()
        _IMAGE.check(self._lib.MXImagePipelineCreate(
            rec_path.encode(), idx_path.encode() if idx_path else None,
            cfg_s.encode(), ctypes.byref(h)))
        self._h = h
        _register_fork_guard(self)

    def next(self):
        """``(data, label, pad)`` as numpy arrays, or None at the end of
        the epoch; data is uint8 NHWC, or float32 NCHW under
        ``normalize``; label is (batch, label_width) float32."""
        batch_h = ctypes.c_void_p()
        data_p = ctypes.POINTER(ctypes.c_uint8)()
        label_p = ctypes.POINTER(ctypes.c_float)()
        pad = ctypes.c_int()
        _IMAGE.check(self._lib.MXImagePipelineNext(
            self._hh(), ctypes.byref(batch_h), ctypes.byref(data_p),
            ctypes.byref(label_p), ctypes.byref(pad)))
        if not batch_h.value:
            return None
        cfg = self.cfg
        b, c = int(cfg.get("batch", 1)), int(cfg.get("channels", 3))
        hh, ww = int(cfg.get("height", 224)), int(cfg.get("width", 224))
        lw = int(cfg.get("label_width", 1))
        n_el = b * c * hh * ww
        try:
            if cfg.get("normalize", False):
                fp = ctypes.cast(data_p, ctypes.POINTER(ctypes.c_float))
                data = np.ctypeslib.as_array(fp, (n_el,)).reshape(
                    b, c, hh, ww).copy()
            else:
                data = np.ctypeslib.as_array(data_p, (n_el,)).reshape(
                    b, hh, ww, c).copy()
            label = np.ctypeslib.as_array(label_p, (b * lw,)).reshape(
                b, lw).copy()
        finally:
            _IMAGE.check(self._lib.MXImagePipelineReleaseBatch(batch_h))
        return data, label, pad.value

    def reset(self) -> None:
        """Start the next epoch (a new shuffle under ``shuffle``); clears
        an error of the last one."""
        _IMAGE.check(self._lib.MXImagePipelineReset(self._hh()))

    def close(self) -> None:
        if self._h:
            self._lib.MXImagePipelineFree(self._h)
            self._h = None
