"""The image ops, ``nd.image`` and ``mx.image`` of mxnet_tpu_torch against
the JAX package on the CPU.

* The 22 ``_image_*``/``image_*`` names: the deterministic ones on
  op_sweep's seeded cases through both registries (forward and
  gradient: exact for to_tensor's layout, crop and the flips, 4 ulps for
  to_tensor and normalize, resize within 2^-24 * n * S).
* ``resize`` enlarging and shrinking, at interp 0 and 1, uint8 and
  float32, HWC and NHWC, (w, h) and keep_ratio sizes.  Nearest is bit
  for bit.  Bilinear float32 is held within 2^-24 * taps * S, S the
  resize of |x| (the sum of the terms' magnitudes), taps the weights an
  output sums over: XLA's einsum sums the taps in another order, and
  the two differ by up to 4 ulps at values near 255.  Bilinear uint8
  rounds that sum to an integer: one step apart where the float value
  sits at a half (1 element of 1584 in one case here), never more.
* The random ops by their deterministic part: the JAX op under a key
  against the port's helper at the JAX key's coin or factor (bit for
  bit for the flips and brightness; contrast and saturation within 4
  ulps, and one uint8 step), the port's op against its helper at the
  generator's next draw (bit for bit), and the share of coins (0.5) and
  the range of the factors over many calls.
* ``nd.image``'s 11 functions against ``mxnet_tpu.nd.image``.
* ``mx.image``: the cv2 codecs, the crops and resizes, every augmenter
  and ``CreateAugmenter``, ``ImageIter`` over a ``.rec`` (shuffled) and
  over a ``.lst`` of files, ``CreateDetAugmenter`` and ``ImageDetIter``,
  each under a seeded ``np.random``, bit for bit.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import image as jimg
from mxnet_tpu import recordio as jrio
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import image as timg
from mxnet_tpu_torch import recordio as trio
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import image_ops as tops
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.tools import op_sweep

import torch_parity as tp

CPU = mt.cpu()
NAMES = [p + n for p in ("_image_", "image_") for n in (
    "crop", "flip_left_right", "flip_up_down", "normalize",
    "random_brightness", "random_contrast", "random_flip_left_right",
    "random_flip_up_down", "random_saturation", "resize", "to_tensor")]
RANDOM = [n for n in NAMES if "random" in n]


def test_the_22_names_are_registered_as_in_the_jax_package():
    assert len(set(NAMES)) == 22
    assert set(NAMES) <= set(treg.list_ops()) & set(jreg.list_ops())
    assert not set(NAMES) & set(treg.QUEUED)
    for n in NAMES:
        assert op_sweep.CASES[n].kind != "random", n
        assert (n in op_sweep.ELSEWHERE) == (n in RANDOM), n


@pytest.mark.parametrize("name", [n for n in NAMES if n not in RANDOM])
def test_image_op_matches_jax(name):
    tp.hold_case(name)


def _taps(m, n):
    return 1 if m == n else math.ceil(2 * max(m / n, 1.0)) + 1


RESIZES = [((20, 24, 3), (37, 31)), ((20, 24, 3), (9, 7)),
           ((2, 20, 24, 3), (24, 11)), ((2, 20, 24, 3), 13),
           ((20, 24, 3), 13)]


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("interp", [0, 1])
@pytest.mark.parametrize("shape,size", RESIZES)
def test_resize_against_jax(shape, size, interp, dtype):
    x = (np.random.RandomState(len(shape) + interp).rand(*shape)
         * 255).astype(dtype)
    kw = dict(size=size, interp=interp, keep_ratio=isinstance(size, int))
    j = jreg.invoke("_image_resize", mx.nd.array(x, dtype=x.dtype),
                    **kw).asnumpy()
    t = treg.invoke("_image_resize", mt.nd.array(x, ctx=CPU, dtype=x.dtype),
                    **kw).asnumpy()
    assert t.shape == j.shape and t.dtype == j.dtype
    if interp == 0:
        np.testing.assert_array_equal(t, j)
        return
    h_ax = x.ndim - 3
    n = _taps(x.shape[h_ax], t.shape[h_ax]) * \
        _taps(x.shape[h_ax + 1], t.shape[h_ax + 1])
    if dtype == np.float32:
        terms = tops._resize(torch.from_numpy(np.abs(x)), **kw).double()
        tp.hold_array("sum", t, j, n, terms.numpy(), what=str(kw))
    else:
        d = np.abs(t.astype(np.int16) - j.astype(np.int16))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-2, (d.max(),
                                                         (d > 0).sum())


def _img(dtype, shape=(2, 5, 6, 3), seed=0):
    return (np.random.RandomState(seed).rand(*shape) * 255).astype(dtype)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("kind", ["flip_left_right", "flip_up_down",
                                  "brightness", "contrast", "saturation"])
def test_random_ops_deterministic_part_against_jax(kind, dtype):
    x = _img(dtype)
    xt = torch.from_numpy(x)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        j = np.asarray(jreg.get_op(f"_image_random_{kind}").fn(
            jnp.asarray(x), key))
        if kind.startswith("flip"):
            coin = bool(jax.random.bernoulli(key, 0.5))
            flip = tops._flip_lr if kind == "flip_left_right" \
                else tops._flip_ud
            t = (flip(xt) if coin else xt).numpy()
            np.testing.assert_array_equal(t, j)
            continue
        f = torch.tensor(float(jax.random.uniform(key, (), minval=0.5,
                                                  maxval=1.5)))
        t = getattr(tops, kind)(xt, f).numpy()
        assert t.dtype == j.dtype
        if kind == "brightness":
            np.testing.assert_array_equal(t, j)
        elif dtype == np.uint8:  # a float that lands on an integer
            assert np.abs(t.astype(int) - j.astype(int)).max() <= 1
        else:
            assert op_sweep.ulps(t, j) <= 4


@pytest.mark.parametrize("name", RANDOM)
def test_random_op_draws_from_the_generator(name):
    x = _img(np.float32, (4, 5, 3), seed=1)
    xt = torch.from_numpy(x)
    op = treg.get_op(name).fn
    kind = name.split("random_")[1]
    gen = torch.Generator().manual_seed(5)
    flips, outs = 0, 0
    for _ in range(400):
        u = torch.rand((), generator=torch.Generator().set_state(
            gen.get_state()))
        got = op(xt, gen)
        if kind.startswith("flip"):
            flip = tops._flip_lr if kind == "flip_left_right" \
                else tops._flip_ud
            want = flip(xt) if u < 0.5 else xt
            flips += bool(u < 0.5)
        else:
            f = 0.5 + u
            want = getattr(tops, kind)(xt, f)
            outs += bool(0.5 <= f < 1.5)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    if kind.startswith("flip"):
        assert abs(flips / 400 - 0.5) < 4 * math.sqrt(0.25 / 400)
    else:
        assert outs == 400


def test_nd_image_against_jax_nd_image():
    x8 = _img(np.uint8, (6, 8, 3), seed=2)
    j8 = mx.nd.array(x8, dtype=np.uint8)
    t8 = mt.nd.array(x8, ctx=CPU, dtype=np.uint8)
    f = mx.nd.image.to_tensor(j8)
    tf = mt.nd.image.to_tensor(t8)
    assert tf.ctx == CPU
    # XLA divides by 255 as a product with its reciprocal: an ulp apart,
    # so normalize takes the same input in both
    f_t = mt.nd.array(f.asnumpy().copy(), ctx=CPU)
    pairs = [(f, tf),
             (mx.nd.image.normalize(f, (0.4, 0.5, 0.6), (0.2, 0.3, 0.4)),
              mt.nd.image.normalize(f_t, (0.4, 0.5, 0.6), (0.2, 0.3, 0.4))),
             (mx.nd.image.resize(j8, size=(4, 3), interp=0),
              mt.nd.image.resize(t8, size=(4, 3), interp=0)),
             (mx.nd.image.crop(j8, 1, 2, 5, 3),
              mt.nd.image.crop(t8, 1, 2, 5, 3)),
             (mx.nd.image.flip_left_right(j8),
              mt.nd.image.flip_left_right(t8)),
             (mx.nd.image.flip_up_down(j8), mt.nd.image.flip_up_down(t8))]
    for j, t in pairs:
        tp.hold_array("ulp", t.asnumpy(), j.asnumpy())
    for fn in ("random_flip_left_right", "random_flip_up_down",
               "random_brightness", "random_contrast", "random_saturation"):
        out = getattr(mt.nd.image, fn)(t8)
        assert out.shape == t8.shape and out.dtype == t8.dtype, fn
        assert out.ctx == CPU


# ---------------------------------------------------------------------------
# mx.image
# ---------------------------------------------------------------------------

def _photo(h, w, seed):
    import cv2

    rs = np.random.RandomState(seed)
    return cv2.GaussianBlur(rs.randint(0, 255, (h, w, 3), np.uint8),
                            (5, 5), 2)


def test_codecs_are_the_jax_packages():
    img = _photo(14, 18, 0)
    for fmt in (".jpg", ".png"):
        buf = timg.imencode(img, quality=80, fmt=fmt)
        assert buf == jimg.imencode(img, quality=80, fmt=fmt)
        np.testing.assert_array_equal(timg.imdecode_np(buf),
                                      jimg.imdecode_np(buf))
        np.testing.assert_array_equal(timg.imdecode_np(buf, 0),
                                      jimg.imdecode_np(buf, 0))
        got = timg.imdecode(buf)
        assert got.ctx == CPU and got.dtype == np.uint8
    with pytest.raises(MXNetError, match="cannot decode"):
        timg.imdecode_np(b"not an image")
    with pytest.raises(MXNetError, match="channels"):
        timg.imencode(np.zeros((4, 4, 4), np.uint8))


def test_crops_and_resizes_are_the_jax_packages():
    a = _photo(20, 26, 1).astype(np.float32)
    np.random.seed(3)
    jr = [jimg.random_crop(a, (9, 7))[1] for _ in range(4)]
    np.random.seed(3)
    tr = [timg.random_crop(a, (9, 7))[1] for _ in range(4)]
    assert tr == jr
    cases = [(timg.imresize(a, 11, 7), jimg.imresize(a, 11, 7)),
             (timg.resize_short(a, 12), jimg.resize_short(a, 12)),
             (timg.fixed_crop(a, 2, 3, 8, 6, size=(5, 4)),
              jimg.fixed_crop(a, 2, 3, 8, 6, size=(5, 4))),
             (timg.center_crop(a, (10, 8))[0],
              jimg.center_crop(a, (10, 8))[0]),
             (timg.color_normalize(a, (1.0, 2.0, 3.0), (2.0, 3.0, 4.0)),
              jimg.color_normalize(a, (1.0, 2.0, 3.0), (2.0, 3.0, 4.0)))]
    for t, j in cases:
        np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


def _augment(mod, src, auglist):
    out = mod.__dict__["nd_array" if mod is jimg else "_cpu_array"](src)
    for aug in auglist:
        out = aug(out)
    return out.asnumpy()


def test_augmenters_are_the_jax_packages():
    src = _photo(30, 34, 2).astype(np.float32)
    kw = dict(resize=28, rand_crop=True, rand_mirror=True, mean=True,
              std=True, brightness=0.3, contrast=0.3, saturation=0.3)
    for shape in ((3, 24, 20), (3, 16, 16)):
        for seed in range(3):
            np.random.seed(seed)
            j = _augment(jimg, src, jimg.CreateAugmenter(shape, **kw))
            np.random.seed(seed)
            t = _augment(timg, src, timg.CreateAugmenter(shape, **kw))
            np.testing.assert_array_equal(t, j)
    t_names = [type(a).__name__ for a in timg.CreateAugmenter((3, 8, 8),
                                                              **kw)]
    assert t_names == [type(a).__name__ for a in jimg.CreateAugmenter(
        (3, 8, 8), **kw)]
    assert timg.ForceResizeAug((5, 4)).dumps() == \
        jimg.ForceResizeAug((5, 4)).dumps()
    np.testing.assert_array_equal(
        _augment(timg, src, [timg.ForceResizeAug((5, 4))]),
        _augment(jimg, src, [jimg.ForceResizeAug((5, 4))]))


def _rec(mod, path, n=11, det=False):
    w = mod.MXIndexedRecordIO(path[:-4] + ".idx", path, "w")
    rs = np.random.RandomState(4)
    for i in range(n):
        img = _photo(18 + i % 3, 22, 10 + i)
        if det:
            k = 1 + i % 3
            xy = rs.uniform(0, 0.5, (k, 2))
            objs = np.concatenate([rs.randint(0, 3, (k, 1)), xy,
                                   xy + rs.uniform(0.1, 0.4, (k, 2))], 1)
            label = np.concatenate([[2, 5], objs.ravel()])
        else:
            label = float(i % 4)
        w.write_idx(i, mod.pack_img(mod.IRHeader(0, label, i, 0), img))
    w.close()


def _batches(it, n):
    out = []
    for _ in range(n):
        b = it.next()
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
    return out


def _same(tb, jb):
    assert len(tb) == len(jb)
    for (td, tl, tpad), (jd, jl, jpad) in zip(tb, jb):
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tl, jl)
        assert tpad == jpad


def test_image_iter_over_a_rec_is_the_jax_packages(tmp_path):
    path = str(tmp_path / "c.rec")
    _rec(trio, path)
    kw = dict(batch_size=4, data_shape=(3, 12, 14), path_imgrec=path,
              shuffle=True, seed=2)
    runs = {}
    for name, mod in (("jax", jimg), ("port", timg)):
        np.random.seed(7)
        it = mod.ImageIter(aug_list=mod.CreateAugmenter(
            (3, 12, 14), rand_crop=True, rand_mirror=True, mean=True,
            std=True), **kw)
        runs[name] = _batches(it, 3)
        it.reset()
        runs[name] += _batches(it, 3)
        with pytest.raises(StopIteration):
            it.next()
        assert it.provide_data[0].shape == (4, 3, 12, 14)
    _same(runs["port"], runs["jax"])
    assert runs["port"][2][2] == 1  # 11 images: the last batch pads one


def test_image_iter_over_a_list_is_the_jax_packages(tmp_path):
    import cv2

    rows = []
    for i in range(5):
        cv2.imwrite(str(tmp_path / f"{i}.png"), _photo(16, 16, 20 + i))
        rows.append(f"{i}\t{i % 2}\t{1.5 * i}\t{i}.png\n")
    (tmp_path / "x.lst").write_text("".join(rows))
    runs = {}
    for name, mod in (("jax", jimg), ("port", timg)):
        it = mod.ImageIter(batch_size=2, data_shape=(3, 8, 8),
                           label_width=2, path_root=str(tmp_path),
                           path_imglist=str(tmp_path / "x.lst"))
        runs[name] = _batches(it, 3)
    _same(runs["port"], runs["jax"])
    with pytest.raises(MXNetError, match="data_shape"):
        timg.ImageIter(batch_size=2, data_shape=(2, 8, 8),
                       imglist=[(0, "x")])
    with pytest.raises(MXNetError, match="needs"):
        timg.ImageIter(batch_size=2, data_shape=(3, 8, 8))


def test_image_det_iter_is_the_jax_packages(tmp_path):
    path = str(tmp_path / "d.rec")
    _rec(trio, path, n=7, det=True)
    runs = {}
    for name, mod in (("jax", jimg), ("port", timg)):
        it = mod.ImageDetIter(
            batch_size=3, data_shape=(3, 10, 12), path_imgrec=path,
            aug_list=mod.CreateDetAugmenter((3, 10, 12), rand_mirror=True,
                                            mean=True, std=True))
        runs[name] = _batches(it, 3)
        assert it.provide_label[0].shape == (3, 3, 5)
    _same(runs["port"], runs["jax"])
    labels = runs["port"][0][1]
    assert (labels[0, 1:] == -1).all() and (labels[0, 0] != -1).all()
    with pytest.raises(MXNetError, match="DetAugmenters"):
        timg.ImageDetIter(batch_size=2, data_shape=(3, 8, 8),
                          path_imgrec=path,
                          aug_list=[timg.CastAug()])
    plain = str(tmp_path / "p.rec")
    _rec(jrio, plain, n=2)
    with pytest.raises(MXNetError, match="pack-label"):
        timg.ImageDetIter(batch_size=2, data_shape=(3, 8, 8),
                          path_imgrec=plain)
