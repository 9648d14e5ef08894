"""The port's ``gluon.data.vision.transforms`` against the JAX package's,
on the CPU.

Every transform of the JAX file runs on the same image (a seeded uint8
HWC 12x10x3 image; Normalize on ToTensor's CHW output) through both
packages.  The random ones run after the same ``np.random.seed``, so
both draw the same numbers from numpy's global generator; with an
explicit ``numpy.random.RandomState`` the port draws what the JAX
transform draws from the global generator seeded alike.  Results are
held bit for bit (dtype, shape and values): both compute in numpy.  A
``torch.Generator`` gives the same result from the same seed.  Called on
an NDArray a transform returns an NDArray; on a tensor, a tensor.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.data.vision import transforms as J

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.gluon.data.vision import transforms as T

# name -> (constructor args, random)
CASES = {
    "Cast": ((), False),
    "ToTensor": ((), False),
    "Resize": (((7, 5),), False),
    "CenterCrop": ((6,), False),
    "CenterCrop_larger": ((16,), False),
    "RandomResizedCrop": ((8,), True),
    "RandomFlipLeftRight": ((), True),
    "RandomFlipTopBottom": ((), True),
    "RandomBrightness": ((0.4,), True),
    "RandomContrast": ((0.4,), True),
    "RandomSaturation": ((0.4,), True),
    "RandomHue": ((0.3,), True),
    "RandomColorJitter": ((0.3, 0.3, 0.3, 0.2), True),
    "RandomLighting": ((0.1,), True),
}


def _img():
    return np.random.RandomState(0).randint(0, 256, (12, 10, 3)).astype(
        np.uint8)


def _cls(mod, name):
    return getattr(mod, name.split("_")[0])


def _hold(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(CASES))
def test_transform_matches_jax(name, seed):
    args, random = CASES[name]
    img = _img()
    np.random.seed(seed)
    want = _cls(J, name)(*args)(mx.nd.array(img, dtype=np.uint8)).asnumpy()
    np.random.seed(seed)
    out = _cls(T, name)(*args)(mt.nd.array(img, ctx=mt.cpu(),
                                           dtype="uint8"))
    assert isinstance(out, mt.nd.NDArray)
    _hold(out.asnumpy(), want)
    if random:  # an explicit RandomState draws what the global one drew
        got = _cls(T, name)(*args, generator=np.random.RandomState(seed))(
            torch.from_numpy(img))
        assert isinstance(got, torch.Tensor)
        _hold(got.numpy(), want)


def test_normalize_and_compose_match_jax():
    img = _img()
    mean, std = (0.49, 0.48, 0.45), (0.25, 0.24, 0.26)
    np.random.seed(4)
    want = J.Compose([J.RandomFlipLeftRight(), J.ToTensor(),
                      J.Normalize(mean, std)])(
        mx.nd.array(img, dtype=np.uint8)).asnumpy()
    np.random.seed(4)
    got = T.Compose([T.RandomFlipLeftRight(), T.ToTensor(),
                     T.Normalize(mean, std)])(
        mt.nd.array(img, ctx=mt.cpu(), dtype="uint8")).asnumpy()
    _hold(got, want)
    for m, s in ((0.5, 2.0), (mean, std)):
        x = J.ToTensor()(mx.nd.array(img, dtype=np.uint8))
        _hold(T.Normalize(m, s)(torch.from_numpy(x.asnumpy().copy())).numpy(),
              J.Normalize(m, s)(x).asnumpy())


@pytest.mark.parametrize("name", sorted(n for n, c in CASES.items() if c[1]))
def test_torch_generator_is_reproducible(name):
    args, _ = CASES[name]
    img = torch.from_numpy(_img())
    outs = [_cls(T, name)(*args, generator=torch.Generator().manual_seed(7))(
        img) for _ in range(2)]
    assert torch.equal(outs[0], outs[1])


def test_the_port_has_every_jax_transform():
    assert sorted(T.__all__) == sorted(J.__all__)


def test_cast_to_bfloat16():
    img = torch.from_numpy(_img())
    out = T.Cast("bfloat16")(img)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out.float(), img.float())
