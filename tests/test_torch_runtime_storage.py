"""The port's ``runtime``, ``storage``, ``initialize`` and ``rtc`` against
the JAX package's on the CPU.

``Features()`` has the JAX package's key set, each key answered for the
port (CUDA, CUDNN, NCCL from PyTorch; JAX, TPU, XLA_COLLECTIVES and
DIST_KVSTORE False; NATIVE_ENGINE from ``lib``).  ``memory_info(cpu())``
raises in both packages; ``live_array_bytes`` rises by an array's bytes
when it is made and falls back when it is deleted in both (a view adds
no bytes in the port); ``memory_summary`` has the JAX keys.
``configure`` refuses a bad reserve and any call after CUDA's
initialisation (the JAX one after its backend's), and otherwise queues
the per-process fraction and the preallocation for CUDA's first use
(held here with ``torch.cuda``'s calls replaced by recorders); the
reserve knob sets the fraction at import.  ``initialize`` follows
``MXNET_USE_SIGNAL_HANDLER`` and installs the fork hooks in both
packages; ``rtc``'s classes raise in both.
"""
import importlib

import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import lib, storage
from mxnet_tpu_torch.base import MXNetError


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_features_have_the_jax_key_set():
    jf, tf = mx.runtime.Features(), mt.runtime.Features()
    assert set(tf) == set(jf)
    want = {"JAX": False, "TPU": False, "XLA_COLLECTIVES": False,
            "DIST_KVSTORE": True, "CPU": True,
            "CUDA": torch.cuda.is_available(),
            "CUDNN": torch.backends.cudnn.is_available(),
            "NATIVE_ENGINE": lib.available()}
    for k, v in want.items():
        assert tf[k] == mt.runtime.Feature(k, v)
        assert tf.is_enabled(k.lower()) is v
    assert not tf.is_enabled("NO_SUCH_FEATURE")
    assert repr(tf) == repr(jf)
    assert {f.name for f in mt.runtime.feature_list()} == set(jf)


def test_memory_info_on_the_cpu_raises_in_both():
    with pytest.raises(mx.MXNetError):
        mx.storage.memory_info(mx.cpu())
    with pytest.raises(MXNetError, match="live tensors"):
        storage.memory_info(mt.cpu())


def test_live_array_bytes_deltas():
    nbytes = 1 << 20
    a = np.random.RandomState(0).rand(nbytes // 4).astype(np.float32)
    for m, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        n0, b0 = m.storage.live_array_bytes(ctx)
        x = m.nd.array(a, ctx=ctx)
        x.wait_to_read()
        n1, b1 = m.storage.live_array_bytes(ctx)
        assert n1 >= n0 + 1 and b1 - b0 >= nbytes, (m.__name__, b1 - b0)
        if m is mt:
            v = x[1:3]
            assert storage.live_array_bytes(ctx)[1] == b1
            del v
        del x
        n2, b2 = m.storage.live_array_bytes(ctx)
        assert b2 - b0 < nbytes, (m.__name__, b2 - b0)
    summary = storage.memory_summary(mt.cpu())
    assert set(summary) == set(mx.storage.memory_summary(mx.cpu()))
    assert summary["platform"] == "cpu" and summary["allocator_stats"] == {}
    (ctx, (n, b)), = storage.memory_summaries([mt.cpu()]).items()
    assert ctx == mt.cpu() and b >= 0 and n >= 0


@pytest.fixture
def pool(monkeypatch):
    """storage's pool state, restored after; torch.cuda's lazy queue
    replaced by a list."""
    queued = []
    monkeypatch.setattr(storage, "_POOL",
                        {"fraction": None, "preallocate": False})
    monkeypatch.setattr(storage, "_HOOKED", False)
    monkeypatch.setattr(torch.cuda, "_lazy_call", queued.append)
    return queued


def test_configure_refusals(pool, monkeypatch):
    with pytest.raises(mx.MXNetError, match="before"):
        mx.storage.configure(pool_reserve_pct=10)  # its backend is up
    with pytest.raises(mx.MXNetError):
        mx.storage.configure(pool_reserve_pct=100)
    for bad in (100, -1, 150):
        with pytest.raises(MXNetError, match=r"\[0, 100\)"):
            storage.configure(pool_reserve_pct=bad)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(MXNetError, match="before the first CUDA use"):
        storage.configure(pool_reserve_pct=10)
    assert pool == []


def test_configure_applies_at_the_first_cuda_use(pool, monkeypatch):
    storage.configure(pool_reserve_pct=25)
    storage.configure(preallocate=True)
    assert pool == [storage._apply_pool]  # queued once
    calls = []
    gib = 1 << 30
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d: (70 * gib, 80 * gib))
    monkeypatch.setattr(torch.cuda, "set_per_process_memory_fraction",
                        lambda f, d: calls.append(("fraction", f, d)))
    real_empty = torch.empty

    def empty(n, dtype, device):
        calls.append(("alloc", n, dtype, device))
        return real_empty(0, dtype=dtype)
    monkeypatch.setattr(torch, "empty", empty)
    pool[0]()
    assert calls == [("fraction", 0.75, 0), ("fraction", 0.75, 1),
                     ("alloc", 60 * gib - storage._PREALLOC_SLACK,
                      torch.uint8, torch.device("cuda", 1))]


def test_reserve_knob_sets_the_fraction_at_import(pool, monkeypatch):
    monkeypatch.setenv("MXNET_GPU_MEM_POOL_RESERVE", "10")
    try:
        importlib.reload(storage)
        assert storage._POOL == {"fraction": 0.9, "preallocate": False}
        assert pool == [storage._apply_pool]
        monkeypatch.setenv("MXNET_GPU_MEM_POOL_RESERVE", "100")
        with pytest.raises(MXNetError, match=r"\[0, 100\)"):
            importlib.reload(storage)
    finally:
        monkeypatch.delenv("MXNET_GPU_MEM_POOL_RESERVE")
        importlib.reload(storage)
    assert storage._POOL == {"fraction": None, "preallocate": False}


@pytest.mark.parametrize("knob", ["0", "1"])
def test_initialize_follows_the_signal_handler_knob(knob, monkeypatch):
    from mxnet_tpu import initialize as jinit
    from mxnet_tpu_torch import initialize as tinit

    monkeypatch.setenv("MXNET_USE_SIGNAL_HANDLER", knob)
    got = []
    for m in (jinit, tinit):
        monkeypatch.setattr(m, "_DONE", False)
        monkeypatch.setattr(m, "_FAULTHANDLER_ENABLED", False)
        m.initialize()
        got.append(m.signal_handlers_enabled())
        m.initialize()  # idempotent
    assert got == [knob == "1"] * 2
    assert lib._FORK_HOOKS_INSTALLED


def test_rtc_raises_in_both():
    with pytest.raises(mx.MXNetError, match="rtc"):
        mx.rtc.CudaModule("extern \"C\" __global__ void k() {}")
    for cls in (mt.rtc.CudaModule, mt.rtc.CudaKernel):
        with pytest.raises(MXNetError, match="csrc/.*CustomOp"):
            cls("extern \"C\" __global__ void k() {}")
