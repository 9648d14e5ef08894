"""``io.ImageRecordIter``, the native decode pipeline, the record and
folder datasets and the examples of mxnet_tpu_torch against the JAX
package on the CPU, at 24-40 pixel JPEGs and a few dozen records.

* The native pipeline (the port's own build of the same C++): its
  batches are the JAX package's bit for bit, uint8 NHWC with resize,
  random crops and mirrors, shuffled through the ``.idx`` over two
  epochs (the orders differ) with the last batch padded, and float32
  NCHW with mean and std; ``ImageRecordIter`` on that route likewise.
* The Python route (shuffled without an ``.idx``, or
  ``MXNET_USE_NATIVE=0``) and the native prefetch route: bit for bit
  the JAX package's same routes under the same ``np.random.seed``.
* The fault paths: an image that does not decode, a label count past
  the record, an error cleared by ``reset``, a shard that is not
  RecordIO, shuffle without an ``.idx``, an image narrower than the crop.
* RecordFileDataset, ImageRecordDataset and ImageFolderDataset against
  the JAX package's, and through the DataLoader's thread and spawned
  process pools.
* The slice: two ``SPMDTrainer`` steps of a small NHWC net in float64 in
  both packages, each fed by its own ``ImageRecordIter`` from one
  ``.rec`` (the loss within 1e-9 relative, every leaf within 1e-9 of its
  largest magnitude); ``Module.fit`` on ``ImageRecordIter``;
  ``examples/imagenet_train.py --cpu`` at 32² (its on-device permute and
  cast equal the host's transpose and bf16 rounding bit for bit);
  ``tests/test_torch_detection.py`` runs ``examples/ssd_train.py --rec``.
"""
import os
import struct

import ml_dtypes
import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as mx
from mxnet_tpu import lib as jlib
from mxnet_tpu import parallel as jpar
from mxnet_tpu.gluon import data as jdata
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.io import ImageRecordIter as JIter

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import lib, parallel as tpar, recordio as trio
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import data as tdata
from mxnet_tpu_torch.gluon import load_numpy_params
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.io import ImageRecordIter as TIter

CPU = mt.cpu()
MEAN = dict(mean_r=120.0, mean_g=115.0, mean_b=100.0, std_r=60.0,
            std_g=58.0, std_b=57.0)


def _photo(h, w, seed):
    import cv2

    rs = np.random.RandomState(seed)
    return cv2.GaussianBlur(rs.randint(0, 255, (h, w, 3), np.uint8),
                            (5, 5), 2)


def _jpeg(img, quality=90):
    import cv2

    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok
    return buf.tobytes()


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    """13 JPEGs of 30-40 x 32-38 pixels, labels i % 4, with its .idx."""
    d = tmp_path_factory.mktemp("shard")
    prefix = str(d / "s")
    w = trio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(13):
        img = _photo(30 + (i * 3) % 11, 32 + (i * 5) % 7, i)
        w.write_idx(i, trio.pack(trio.IRHeader(0, float(i % 4), i, 0),
                                 _jpeg(img)))
    w.close()
    return prefix + ".rec", prefix + ".idx"


def _drain(pipe):
    out = []
    while True:
        res = pipe.next()
        if res is None:
            return out
        out.append(res)


PIPES = {
    "u8_shuffle": dict(batch=5, channels=3, height=24, width=20,
                       label_width=1, resize_short=28, rand_crop=True,
                       rand_mirror=True, shuffle=True, threads=3, seed=3),
    "f32_norm": dict(batch=4, channels=3, height=24, width=24,
                     label_width=2, normalize=True, threads=2,
                     mean_r=120.0, mean_g=115.0, mean_b=100.0,
                     std_r=60.0, std_g=58.0, std_b=57.0),
}


@pytest.mark.parametrize("case", sorted(PIPES))
def test_native_pipeline_is_the_jax_packages_bit_for_bit(shard, case):
    rec, idx = shard
    cfg = PIPES[case]
    epochs = {}
    for name, mod in (("jax", jlib), ("port", lib)):
        pipe = mod.NativeImagePipeline(rec, idx if cfg.get("shuffle")
                                       else None, **cfg)
        epochs[name] = [_drain(pipe)]
        pipe.reset()
        epochs[name].append(_drain(pipe))
        pipe.close()
    for te, je in zip(epochs["port"], epochs["jax"]):
        assert len(te) == len(je) == 3 + (case == "f32_norm")
        for (td, tl, tpad), (jd, jl, jpad) in zip(te, je):
            assert td.dtype == jd.dtype and td.shape == jd.shape
            np.testing.assert_array_equal(td, jd)
            np.testing.assert_array_equal(tl, jl)
            assert tpad == jpad
    pads = [b[2] for b in epochs["port"][0]]
    assert pads == ([0, 0, 2] if case == "u8_shuffle" else [0, 0, 0, 3])
    if case == "u8_shuffle":
        orders = [np.concatenate([b[1][:5 - b[2], 0] for b in e])
                  for e in epochs["port"]]
        assert sorted(orders[0]) == sorted(orders[1])
        assert not np.array_equal(orders[0], orders[1])
        assert epochs["port"][0][0][0].shape == (5, 24, 20, 3)
    else:
        assert epochs["port"][0][0][0].shape == (4, 3, 24, 24)
        assert (epochs["port"][0][0][1][:, 1] == 0).all()


def _iter_batches(it, epochs=2):
    out = []
    for e in range(epochs):
        if e:
            it.reset()
        for b in it:
            out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
    return out


def _same(tb, jb):
    assert len(tb) == len(jb) > 0
    for (td, tl, tpad), (jd, jl, jpad) in zip(tb, jb):
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tl, jl)
        assert tpad == jpad


def test_image_record_iter_native_route_is_the_jax_packages(shard):
    rec, idx = shard
    kw = dict(path_imgrec=rec, path_imgidx=idx, data_shape=(3, 24, 24),
              batch_size=6, shuffle=True, rand_crop=True, rand_mirror=True,
              resize=28, preprocess_threads=2, seed=5, **MEAN)
    t, j = TIter(**kw), JIter(**kw)
    assert t.route == "native_pipeline" and t.route_reason is None
    assert j._pipe is not None
    tb, jb = _iter_batches(t), _iter_batches(j)
    _same(tb, jb)
    assert [b[2] for b in tb] == [0, 0, 5] * 2
    assert tb[0][0].dtype == np.float32 and tb[0][0].shape == (6, 3, 24, 24)
    assert t.provide_data[0].shape == (6, 3, 24, 24)
    assert t.provide_label[0].shape == (6,)


def test_python_routes_are_the_jax_packages(shard, monkeypatch):
    rec, idx = shard
    kw = dict(path_imgrec=rec, data_shape=(3, 20, 24), batch_size=5,
              rand_crop=True, rand_mirror=True, resize=26, **MEAN)
    # shuffled without an .idx: both read the records into memory
    np.random.seed(11)
    j = _iter_batches(JIter(shuffle=True, **kw))
    np.random.seed(11)
    t_it = TIter(shuffle=True, **kw)
    assert t_it.route == "python" and "path_imgidx" in t_it.route_reason
    _same(_iter_batches(t_it), j)
    # not shuffled: the JAX package streams from its prefetch reader when
    # its core library loads, the port likewise when its image library
    # is out of the way, and reads into memory under MXNET_USE_NATIVE=0
    monkeypatch.setattr(jlib, "image_available", lambda: False)
    np.random.seed(12)
    j = _iter_batches(JIter(**kw))
    monkeypatch.setattr(lib, "image_error", lambda: "no OpenCV")
    np.random.seed(12)
    t_it = TIter(**kw)
    assert t_it.route == "native_prefetch"
    assert t_it.route_reason == "no native pipeline: no OpenCV"
    _same(_iter_batches(t_it), j)
    monkeypatch.undo()
    monkeypatch.setenv("MXNET_USE_NATIVE", "0")
    np.random.seed(12)
    t_it = TIter(**kw)
    assert t_it.route == "python" and "MXNET_USE_NATIVE=0" in \
        t_it.route_reason
    _same(_iter_batches(t_it), j)


def test_decode_record_is_the_native_decode_without_resize(shard):
    """Centre crops, no resize and no mirror: the Python route's decode
    of a record is the native pipeline's float batch row bit for bit."""
    rec, _ = shard
    it = TIter(path_imgrec=rec, data_shape=(3, 24, 24), batch_size=13,
               **MEAN)
    assert it.route == "native_pipeline"
    batch = it.next()
    r = trio.MXRecordIO(rec, "r")
    for i in range(13):
        img, lab = it.decode_record(r.read())
        np.testing.assert_array_equal(batch.data[0].asnumpy()[i], img)
        assert lab[0] == i % 4


def _bad_rec(path, payload):
    w = trio.MXRecordIO(str(path), "w")
    w.write(payload)
    w.close()
    return str(path)


def _pipe(path, **kw):
    cfg = dict(batch=1, channels=3, height=8, width=8, label_width=1,
               threads=1)
    cfg.update(kw)
    return lib.NativeImagePipeline(path, None, **cfg)


@pytest.mark.parametrize("what,payload,match", [
    ("decode", trio.pack(trio.IRHeader(0, 0.0, 0, 0), b"not an image"),
     "decode failed"),
    # an IRHeader claiming 100000 labels before 4 bytes of payload
    ("labels", struct.pack("<IfQQ", 100000, 0.0, 0, 0) + b"\x00" * 4,
     "label count exceeds")])
def test_pipeline_faults_are_loud(tmp_path, what, payload, match):
    pipe = _pipe(_bad_rec(tmp_path / f"{what}.rec", payload))
    with pytest.raises(MXNetError, match=match):
        for _ in range(4):
            if pipe.next() is None:
                break
    pipe.close()


def test_pipeline_reset_clears_an_error(tmp_path):
    path = _bad_rec(tmp_path / "m.rec",
                    trio.pack(trio.IRHeader(0, 0.0, 0, 0), b"garbage"))
    pipe = _pipe(path)
    with pytest.raises(MXNetError):
        for _ in range(4):
            if pipe.next() is None:
                break
    _bad_rec(path, trio.pack(trio.IRHeader(0, 2.0, 0, 0),
                             _jpeg(_photo(8, 8, 0))))
    pipe.reset()
    data, label, pad = pipe.next()
    assert label[0, 0] == 2.0 and data.shape == (1, 8, 8, 3)
    pipe.close()


def test_pipeline_shard_and_config_faults(tmp_path):
    path = tmp_path / "z.rec"
    path.write_bytes(b"\x00" * 64)
    pipe = _pipe(str(path), batch=2)
    with pytest.raises(MXNetError, match="magic|truncated"):
        for _ in range(4):
            if pipe.next() is None:
                break
    pipe.close()
    with pytest.raises(MXNetError, match="requires a .idx"):
        _pipe(str(path), shuffle=True)
    narrow = _bad_rec(tmp_path / "n.rec", trio.pack(
        trio.IRHeader(0, 1.0, 0, 0), _jpeg(np.full((10, 40, 3), 99,
                                                   np.uint8), 100)))
    pipe = _pipe(narrow, height=24, width=24, resize_short=10)
    data, _, _ = pipe.next()
    assert data.shape == (1, 24, 24, 3) and np.abs(
        data.astype(int) - 99).max() <= 1
    pipe.close()


# ---------------------------------------------------------------------------
# the datasets
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("folder")
    for c, cat in enumerate(["b", "a"]):
        (root / cat).mkdir()
        for i in range(3):
            cv2.imwrite(str(root / cat / f"{i}.png"),
                        _photo(12, 12, 40 + 3 * c + i))
        np.save(root / cat / "x.npy", np.full((12, 12, 3), c, np.uint8))
    (root / "notes.txt").write_text("skipped")
    return str(root)


def _as_np(sample):
    img, label = sample
    return img.asnumpy(), float(label)


def test_datasets_are_the_jax_packages(shard, folder):
    rec, _ = shard
    t, j = tdata.RecordFileDataset(rec), jdata.RecordFileDataset(rec)
    assert len(t) == len(j) == 13
    assert [t[i] for i in range(13)] == [j[i] for i in range(13)]
    for make in (lambda m: m.vision.ImageRecordDataset(rec),
                 lambda m: m.vision.ImageFolderDataset(folder)):
        t, j = make(tdata), make(jdata)
        assert len(t) == len(j) > 0
        for i in range(len(t)):
            ti, tl = _as_np(t[i])
            ji, jl = _as_np(j[i])
            np.testing.assert_array_equal(ti, ji)
            assert tl == jl and t[i][0].ctx == CPU
    assert t.synsets == ["a", "b"] and len(t) == 8


def test_datasets_through_the_loader_pools(shard, folder):
    """Both image datasets through worker threads, the record dataset
    (a transform after it) through one spawned worker too (a child
    imports torch, so one pool): the serial loader's batches."""
    rec, _ = shard
    runs = [(tdata.vision.ImageFolderDataset(folder), dict(num_workers=3))]
    ds = tdata.vision.ImageRecordDataset(rec).transform_first(
        tdata.vision.transforms.Resize(10))
    runs += [(ds, dict(num_workers=3)),
             (ds, dict(num_workers=1, worker_pool="process"))]
    for ds, kw in runs:
        serial = [(x.asnumpy(), y.asnumpy())
                  for x, y in tdata.DataLoader(ds, batch_size=3)]
        got = [(x.asnumpy(), y.asnumpy())
               for x, y in tdata.DataLoader(ds, batch_size=3, **kw)]
        assert len(got) == len(serial) > 1
        for (gx, gy), (sx, sy) in zip(got, serial):
            np.testing.assert_array_equal(gx, sx)
            np.testing.assert_array_equal(gy, sy)


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------

def _net(nn):
    net = nn.HybridSequential()
    net.add(nn.Conv2D(4, 3, padding=1, layout="NHWC", in_channels=3),
            nn.BatchNorm(axis=3, in_channels=4), nn.Activation("relu"),
            nn.GlobalAvgPool2D(layout="NHWC"), nn.Dense(4, in_units=4))
    return net


def test_spmd_trainer_on_each_packages_iterator_float64(shard):
    rec, idx = shard
    kw = dict(path_imgrec=rec, path_imgidx=idx, data_shape=(3, 16, 16),
              batch_size=6, shuffle=True, rand_crop=True, rand_mirror=True,
              resize=20, seed=9, **MEAN)
    opt = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
    np.random.seed(0)
    mx.random.seed(0)
    jnet = _net(jnn)
    jnet.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    params = jnet._collect_params_with_prefix()
    vals = {k: p.data().asnumpy().copy() for k, p in params.items()}
    with jax.enable_x64(True):
        jnet.cast("float64")
        it = JIter(**kw)
        with jpar.make_mesh(dp=1):
            tr = jpar.SPMDTrainer(jnet, jloss.SoftmaxCrossEntropyLoss(),
                                  "sgd", dict(opt))
            jl = []
            for _ in range(2):
                b = it.next()
                x = b.data[0].asnumpy().transpose(0, 2, 3, 1)
                jl.append(float(tr.step(x.astype(np.float64),
                                        b.label[0].asnumpy().astype(
                                            np.int32)).asnumpy()))
        js = {k: np.asarray(tr.params[p.name]) for k, p in params.items()}
    from mxnet_tpu_torch.examples.imagenet_train import device_batch

    tnet = _net(tnn)
    tnet.initialize(ctx=CPU)
    load_numpy_params(tnet, vals)
    tnet.double()
    it = TIter(**kw)
    tr = tpar.SPMDTrainer(tnet, tloss.SoftmaxCrossEntropyLoss(), "sgd",
                          dict(opt), mesh=tpar.make_mesh(dp=1, devices=[CPU]))
    tl = [float(tr.step(*device_batch(it.next(), torch.device("cpu"),
                                      torch.float64))) for _ in range(2)]
    np.testing.assert_allclose(tl, jl, rtol=1e-9)
    ts = {k: v.detach().numpy() for k, v in tnet.state_dict().items()}
    assert set(ts) == set(js)
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=0, atol=1e-9 * max(
            1.0, float(np.abs(js[k]).max())), err_msg=k)
    assert not np.allclose(ts["0.weight"], vals["0.weight"])


def test_module_fits_on_image_record_iter(shard):
    rec, idx = shard
    sym = mt.sym
    data = sym.Variable("data")
    net = sym.FullyConnected(sym.Flatten(sym.Pooling(
        data, kernel=(4, 4), stride=(4, 4), pool_type="avg")),
        num_hidden=4, name="fc")
    net = sym.SoftmaxOutput(net, name="softmax")
    it = TIter(path_imgrec=rec, path_imgidx=idx, data_shape=(3, 16, 16),
               batch_size=4, shuffle=True, **MEAN)
    mod = mt.mod.Module(net, context=CPU)
    mod.fit(it, num_epoch=2, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1},
            initializer=mt.init.Xavier())
    score = dict(mod.score(it, "acc"))
    assert 0.0 <= score["accuracy"] <= 1.0
    args, _ = mod.get_params()
    assert args["fc_weight"].shape == (4, 48)
    assert np.isfinite(args["fc_weight"].asnumpy()).all()


def test_device_batch_is_the_host_transpose_and_bf16_cast(shard):
    from mxnet_tpu_torch.examples.imagenet_train import device_batch

    rec, idx = shard
    b = TIter(path_imgrec=rec, data_shape=(3, 16, 16), batch_size=4,
              **MEAN).next()
    x, y = device_batch(b, torch.device("cpu"), torch.bfloat16)
    want = b.data[0].asnumpy().transpose(0, 2, 3, 1).astype(
        ml_dtypes.bfloat16)
    assert x.shape == want.shape and x.is_contiguous()
    np.testing.assert_array_equal(x.view(torch.int16).numpy(),
                                  want.view(np.int16))
    assert y.dtype == torch.int32
    np.testing.assert_array_equal(y.numpy(), b.label[0].asnumpy())


def test_imagenet_example_on_the_cpu(tmp_path):
    """The example end to end: 8 synthetic JPEGs packed by im2rec, two
    epochs of one batch through ResNet-50 v1.  One intra-op thread: the
    suite's other workers hold the cores."""
    from mxnet_tpu_torch.examples import imagenet_train

    keep = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        epochs = imagenet_train.main(
            ["--cpu", "--classes", "2", "--per-class", "4", "--image-size",
             "32", "--batch-size", "8", "--epochs", "2", "--dtype",
             "float32", "--preprocess-threads", "2", "--workdir",
             str(tmp_path)], keep=keep)
    finally:
        torch.set_num_threads(threads)
    assert keep["iter"].route == "native_pipeline"
    assert [e["images"] for e in epochs] == [8, 8]
    assert [e["steps"] for e in epochs] == [1, 1]
    assert all(np.isfinite(e["losses"]).all() for e in epochs)
    assert sorted(epochs[0]["labels"]) == [0.0] * 4 + [1.0] * 4
    assert not np.array_equal(epochs[0]["labels"], epochs[1]["labels"])
    assert os.path.getsize(keep["prefix"] + ".rec") > 0
