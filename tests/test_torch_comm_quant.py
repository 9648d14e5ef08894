"""The port's quantized collectives (``optimizer/comm.py``) and 2-bit
compressor (``kvstore_compression.py``) against the JAX package's, bit
for bit, on the same seeded numpy inputs.

* ``encode``/``decode`` for int8 and fp8 (e4m3): the codes, the fp32
  scales (one per 512-element block of a row) and the decoded values,
  on rows of several lengths (one block, a ragged last block, an
  all-zero block, large and tiny magnitudes).
* ``wire_nbytes``, ``QuantConfig`` from the environment and its refusal
  of an unknown mode, ``canonical_residuals``.
* ``TwoBitCompressor``: the packed codes, the residual carried over
  three steps and the decoded values against the JAX numpy quantizer;
  odd lengths (the pad of the last byte); the refusals of ``create``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu import kvstore_compression as jkc
from mxnet_tpu.optimizer import comm as jcomm
from mxnet_tpu_torch import kvstore_compression as tkc
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.optimizer import comm as tcomm

ROWS = [(1, 5), (2, 512), (3, 1300), (2, 2049)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows(shape, seed):
    rs = np.random.RandomState(seed)
    x = (rs.randn(*shape) * rs.rand(shape[0], 1) * 5).astype(np.float32)
    if shape[1] > 600:
        x[-1, 512:1024] = 0.0        # an all-zero block
    x[0, 0] = 1e-20                  # a tiny value beside large ones
    return x


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("shape", ROWS)
def test_encode_decode_bit_for_bit(mode, shape):
    x = _rows(shape, seed=shape[1] + len(mode))
    jc, js = jcomm.encode(jnp.asarray(x), mode)
    tc, ts = tcomm.encode(torch.from_numpy(x), mode)
    assert tc.dtype == {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[mode]
    assert tuple(tc.shape) == shape
    assert tuple(ts.shape) == (shape[0], -(-shape[1] // tcomm.BLOCK))
    np.testing.assert_array_equal(tc.float().numpy(),
                                  np.asarray(jc.astype(jnp.float32)))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tcomm.decode(tc, ts).numpy(),
                                  np.asarray(jcomm.decode(jc, js)))


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_error_feedback_round_trip(mode):
    """acc = payload + residual; residual = acc - decode(encode(acc)):
    three steps of the scheme give the JAX package's residuals."""
    jr = np.zeros((2, 700), np.float32)
    tr = torch.zeros(2, 700)
    for step in range(3):
        x = _rows((2, 700), seed=40 + step)
        jacc = jnp.asarray(x) + jnp.asarray(jr)
        jc, js = jcomm.encode(jacc, mode)
        jr = np.asarray(jacc - jcomm.decode(jc, js))
        tacc = torch.from_numpy(x) + tr
        tc, ts = tcomm.encode(tacc, mode)
        tr = tacc - tcomm.decode(tc, ts)
        np.testing.assert_array_equal(tr.numpy(), jr)


@pytest.mark.parametrize("total,rows,mode", [(4096, 2, "int8"),
                                             (100, 4, "fp8"),
                                             (513, 1, "int8")])
def test_wire_nbytes(total, rows, mode):
    assert tcomm.wire_nbytes(total, rows, mode) == \
        jcomm.wire_nbytes(total, rows, mode)


def test_config_from_the_environment(monkeypatch):
    monkeypatch.setenv("MXNET_COMM_QUANT", "FP8")
    monkeypatch.setenv("MXNET_COMM_QUANT_MIN_SIZE", "64")
    monkeypatch.setenv("MXNET_COMM_QUANT_EF", "0")
    q = tcomm.config()
    assert tuple(q) == tuple(jcomm.config()) == ("fp8", 64, False)
    assert q.active and q.applies(64) and not q.applies(63)
    monkeypatch.setenv("MXNET_COMM_QUANT", "int4")
    with pytest.raises(MXNetError, match="MXNET_COMM_QUANT"):
        tcomm.config()
    monkeypatch.delenv("MXNET_COMM_QUANT")
    assert not tcomm.config().active
    assert tcomm.RESIDUAL_KEY == jcomm.RESIDUAL_KEY
    assert tcomm.ENCODINGS == jcomm.ENCODINGS
    g, w = {0: np.ones(3)}, {0: np.zeros(3)}
    assert tcomm.canonical_residuals(g, w, "int8") == \
        jcomm.canonical_residuals(g, w, "int8")


@pytest.mark.parametrize("shape", [(7, 5), (13,), (4,)])
@pytest.mark.parametrize("threshold", [0.5, 0.25])
def test_two_bit_codes_and_residuals(shape, threshold):
    jc, tc = jkc.TwoBitCompressor(threshold), tkc.TwoBitCompressor(threshold)
    rs = np.random.RandomState(len(shape) + int(threshold * 100))
    for step in range(3):
        g = (rs.randn(*shape) * 0.6).astype(np.float32)
        jp, js = jc.compress("k", g)
        tp, ts = tc.compress("k", torch.from_numpy(g))
        assert js == ts
        assert tp.dtype == torch.uint8
        np.testing.assert_array_equal(tp.numpy(), jp)
        np.testing.assert_array_equal(tc._residual["k"].numpy(),
                                      jc._residual["k"])
        np.testing.assert_array_equal(tc.decompress(tp, ts).numpy(),
                                      jc.decompress(jp, js))
        # the port decodes the JAX package's codes too
        np.testing.assert_array_equal(tc.decompress(jp, js).numpy(),
                                      jc.decompress(jp, js))


def test_two_bit_create_refusals():
    for params, what in (({"type": "1bit"}, "'1bit' is not implemented"),
                         ({"type": "fp4"}, "unknown gradient compression"),
                         ({}, "unknown gradient compression"),
                         ({"type": "2bit", "threshold": -1},
                          "threshold must be > 0")):
        with pytest.raises(MXNetError, match=what):
            tkc.create(params)
    c = tkc.create({"type": "2-bit", "threshold": 2.0})
    assert c.threshold == jkc.create({"type": "2-bit",
                                      "threshold": 2.0}).threshold
