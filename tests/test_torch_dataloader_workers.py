"""The port's DataLoader worker pools and CIFAR, on the CPU, after
``tests/test_dataloader_process.py``.

* Order: thread and process pools give the sampler's batches in order,
  the process pool persists across epochs; the port's batches equal the
  JAX package's DataLoader's (sequential, and shuffled from the same
  ``np.random.seed``).
* Errors: an exception in ``__getitem__`` re-raises in the consumer
  (both pools); a killed child raises ``WorkerDied``; a slow batch
  raises after ``timeout``; a bad ``worker_pool``/``worker_transport``
  raises the JAX message.
* Transport: "pipe" gives the batches "shm" gives; no ``/dev/shm``
  segment is left after an early break.
* ``resume_from(k)``: the next epoch starts at batch k, the one after
  it at 0 (every pool).
* Random transforms inside a loader: the batches of
  ``RandomFlipLeftRight -> ToTensor -> Normalize`` on CIFAR-10 equal
  those of ``num_workers=0`` bit for bit with two threads and two
  processes under the same seed.
* CIFAR10/CIFAR100 (synthetic) give the JAX package's samples bit for
  bit, train and test.

The datasets the children unpickle live in this module, which imports
the JAX package only inside the tests that compare with it.  Two workers
and small datasets throughout.
"""
import glob
import os
import time

import numpy as np
import pytest

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader, WorkerDied
from mxnet_tpu_torch.gluon.data.vision import CIFAR10, CIFAR100
from mxnet_tpu_torch.gluon.data.vision import transforms as T

POOLS = {"thread": {}, "process": {"worker_pool": "process"}}


class _Failing:
    def __len__(self):
        return 6

    def __getitem__(self, i):
        if i == 3:
            raise ValueError("boom-3")
        return np.zeros(2, np.float32)


class _Dies:
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            os._exit(17)
        return np.zeros(2, np.float32)


class _Slow:
    def __len__(self):
        return 4

    def __getitem__(self, i):
        time.sleep(2.0 if i == 2 else 0.0)
        return np.zeros(2, np.float32)


def _xy(n=20):
    x = np.arange(n * 4, dtype=np.float32).reshape(n, 4)
    return x, np.arange(n, dtype=np.float32)


def _as_np(batches):
    return [tuple(a.asnumpy() for a in b) if isinstance(b, tuple)
            else b.asnumpy() for b in batches]


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g if isinstance(g, tuple) else (g,),
                        w if isinstance(w, tuple) else (w,)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_pool_order_and_reuse(pool):
    x, y = _xy()
    dl = DataLoader(ArrayDataset(x, y), batch_size=4, num_workers=2,
                    **POOLS[pool])
    first = None
    for _ in range(2):
        got = _as_np(dl)
        assert len(got) == 5
        _same(got, [(x[i:i + 4], y[i:i + 4]) for i in range(0, 20, 4)])
        if pool == "process":
            if first is None:
                first = dl._pool
            assert dl._pool is first  # persistent across epochs


@pytest.mark.parametrize("shuffle", [False, True])
def test_batches_equal_the_jax_loader(shuffle):
    from mxnet_tpu.gluon.data import ArrayDataset as JArrayDataset
    from mxnet_tpu.gluon.data import DataLoader as JDataLoader

    x, y = _xy(18)
    np.random.seed(3)
    want = _as_np(JDataLoader(JArrayDataset(x, y), batch_size=4,
                              shuffle=shuffle, last_batch="keep"))
    for kw in ({}, {"num_workers": 2}):
        np.random.seed(3)
        got = _as_np(DataLoader(ArrayDataset(x, y), batch_size=4,
                                shuffle=shuffle, last_batch="keep", **kw))
        _same(got, want)


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_worker_errors_reraise(pool):
    dl = DataLoader(_Failing(), batch_size=2, num_workers=2, **POOLS[pool])
    with pytest.raises(ValueError, match="boom-3"):
        list(dl)


def test_a_killed_child_raises_worker_died():
    dl = DataLoader(_Dies(), batch_size=2, num_workers=2,
                    worker_pool="process", timeout=60)
    t0 = time.monotonic()
    with pytest.raises(WorkerDied, match="died abnormally"):
        list(dl)
    assert time.monotonic() - t0 < 30
    assert dl._pool is None  # discarded; the next epoch starts a new one


def test_a_slow_batch_times_out():
    dl = DataLoader(_Slow(), batch_size=1, num_workers=2, timeout=0.5)
    with pytest.raises(MXNetError, match="timed out after 0.5s"):
        list(dl)


def test_bad_pool_and_transport_raise():
    with pytest.raises(MXNetError, match="worker_pool"):
        DataLoader(_Failing(), batch_size=2, worker_pool="greenlet")
    with pytest.raises(MXNetError, match="worker_transport"):
        DataLoader(_Failing(), batch_size=2, worker_transport="rdma")


def test_pipe_transport_matches_shm():
    x, y = _xy(12)
    runs = [_as_np(DataLoader(ArrayDataset(x, y), batch_size=3,
                              num_workers=2, worker_pool="process",
                              worker_transport=t)) for t in ("shm", "pipe")]
    _same(runs[1], runs[0])
    _same(runs[0], [(x[i:i + 3], y[i:i + 3]) for i in range(0, 12, 3)])


def test_shm_segments_reclaimed_on_early_break():
    def segs():
        return set(glob.glob("/dev/shm/psm_*"))

    x, _ = _xy(40)
    dl = DataLoader(ArrayDataset(x, x[:, 0]), batch_size=4, num_workers=2,
                    worker_pool="process")
    before = segs()
    it = iter(dl)
    next(it)
    it.close()  # the generator's finally drains what is in flight
    del it
    time.sleep(1)
    assert not segs() - before


@pytest.mark.parametrize("pool", ["serial"] + sorted(POOLS))
def test_resume_from(pool):
    x, y = _xy()
    kw = {} if pool == "serial" else dict(num_workers=2, **POOLS[pool])
    dl = DataLoader(ArrayDataset(x, y), batch_size=4, **kw)
    full = _as_np(dl)
    dl.resume_from(3)
    _same(_as_np(dl), full[3:])
    _same(_as_np(dl), full)  # one-shot


def _cifar_augmented():
    tf = T.Compose([T.RandomFlipLeftRight(), T.ToTensor(),
                    T.Normalize((0.49, 0.48, 0.45), (0.25, 0.24, 0.26))])
    return CIFAR10(train=False).take(96).transform_first(tf)


def test_random_transforms_give_the_same_batches_in_every_pool():
    ds = _cifar_augmented()
    runs = {}
    for name, kw in (("serial", {}), ("thread", {"num_workers": 2}),
                     ("process", {"num_workers": 2,
                                  "worker_pool": "process"})):
        np.random.seed(11)
        runs[name] = _as_np(DataLoader(ds, batch_size=16, shuffle=True,
                                       **kw))
    for name in ("thread", "process"):
        _same(runs[name], runs["serial"])
    # against the same pipeline without the flip: about half the images
    # are flipped (width is the last axis after ToTensor)
    tf = T.Compose([T.ToTensor(), T.Normalize((0.49, 0.48, 0.45),
                                              (0.25, 0.24, 0.26))])
    np.random.seed(11)
    plain = _as_np(DataLoader(CIFAR10(train=False).take(96)
                              .transform_first(tf), batch_size=16,
                              shuffle=True))
    flipped = kept = 0
    for (a, _), (b, _) in zip(runs["serial"], plain):
        for i in range(len(a)):
            if np.array_equal(a[i], b[i]):
                kept += 1
            else:
                np.testing.assert_array_equal(a[i], b[i][:, :, ::-1])
                flipped += 1
    assert flipped > 20 and kept > 20, (flipped, kept)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("cls", ["CIFAR10", "CIFAR100"])
def test_cifar_equals_the_jax_synthetic_set(cls, train, tmp_path):
    from mxnet_tpu.gluon.data import vision as jvision
    from mxnet_tpu_torch.gluon.data import vision as tvision

    j = getattr(jvision, cls)(root=str(tmp_path), train=train)
    t = getattr(tvision, cls)(root=str(tmp_path), train=train)
    assert j.synthetic and t.synthetic and len(j) == len(t)
    np.testing.assert_array_equal(t._data, j._data)
    np.testing.assert_array_equal(t._label, j._label)
    for i in (0, len(t) - 1):
        (ti, tl), (ji, jl) = t[i], j[i]
        assert ti.shape == (32, 32, 3) and ti.dtype == np.uint8
        np.testing.assert_array_equal(ti.asnumpy(), ji.asnumpy())
        assert int(tl) == int(jl)


def test_cifar_reads_binary_batches(tmp_path):
    rs = np.random.RandomState(0)
    rec = np.concatenate([rs.randint(0, 10, (5, 1)),
                          rs.randint(0, 256, (5, 3072))], 1).astype(np.uint8)
    rec.tofile(tmp_path / "test_batch.bin")
    ds = CIFAR10(root=str(tmp_path), train=False)
    assert not ds.synthetic and len(ds) == 5
    img, label = ds[2]
    np.testing.assert_array_equal(
        img.asnumpy(), rec[2, 1:].reshape(3, 32, 32).transpose(1, 2, 0))
    assert label == rec[2, 0]
    assert CIFAR100(root=str(tmp_path)).synthetic
