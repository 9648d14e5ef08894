"""The fused ``RNN`` op of mxnet_tpu_torch against the JAX package's, on
the CPU (``mxnet_tpu_torch/ops/rnn.py`` against ``mxnet_tpu/ops/rnn.py``).

* LSTM, GRU, rnn_tanh and rnn_relu, one and two directions, one and two
  layers, from given states: the outputs (out, h, and c for LSTM) and
  the gradients of data, parameters and both states under seeded
  cotangents, fp32, within ``torch_parity``'s RNN_FWD and RNN_BWD of
  (1 + |want|).
* Every mode with its states left out (zeros in the data's dtype),
  with and without ``state_outputs``: the 1, 2 or 3 outputs and the
  gradients of data and parameters.
* ``rnn_param_size`` and the packed layout: the port's size is the JAX
  package's for every mode, direction and depth.
* bf16 data, parameters and states: the outputs within
  RNN_BF16_ULPS bf16 ulps of the JAX package's.
* ``sym.RNN``: the inferred shapes of ``{name}_parameters`` and of the
  outputs equal the JAX package's, and the executor's forward equals
  the op's.
* The attributes the JAX op accepts and ignores (``projection_size``,
  ``lstm_state_clip_*``, ``use_sequence_length``) change nothing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.ops import rnn as jrnn

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import rnn as trnn

import torch_parity as tp

T, N, I, H = 6, 3, 4, 5
MODES = ("lstm", "gru", "rnn_tanh", "rnn_relu")


def _inputs(mode, bi, layers, seed, states=True):
    rng = np.random.RandomState(seed)
    d = 2 if bi else 1
    size = trnn.rnn_param_size(mode, I, H, layers, bi)
    f32 = np.float32
    x = (rng.randn(T, N, I) * 0.8).astype(f32)
    w = (rng.randn(size) * 0.3).astype(f32)
    h0 = (rng.randn(layers * d, N, H) * 0.5).astype(f32) if states else None
    c0 = (rng.randn(layers * d, N, H) * 0.5).astype(f32) \
        if states and mode == "lstm" else None
    return [x, w, h0, c0]


def _cts(shapes, seed):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jax(arrays, kw, cts=None):
    """The JAX op's outputs, and with ``cts`` the gradients of the given
    inputs by jax.vjp (jitted)."""
    idx = [i for i, a in enumerate(arrays) if a is not None]

    def f(*xs):
        full = [None] * len(arrays)
        for i, v in zip(idx, xs):
            full[i] = v
        r = jrnn._rnn(*full, **kw)
        return tuple(r) if isinstance(r, (tuple, list)) else (r,)

    xs = [jnp.asarray(arrays[i]) for i in idx]
    if cts is None:
        return [np.asarray(o) for o in jax.jit(f)(*xs)], []

    @jax.jit
    def both(xs, cts):
        out, vjp = jax.vjp(f, *xs)
        return out, vjp(tuple(cts))

    out, grads = both(xs, [jnp.asarray(c) for c in cts])
    return [np.asarray(o) for o in out], [np.asarray(g) for g in grads]


def _port(arrays, kw, cts=None, dtype=torch.float32):
    leaves = [None if a is None else torch.from_numpy(a).to(dtype)
              .requires_grad_() for a in arrays]
    out = trnn.rnn(*leaves, **kw)
    outs = list(out) if isinstance(out, tuple) else [out]
    if cts is None:
        return [o.detach().float().numpy() for o in outs], []
    grads = torch.autograd.grad(
        outs, [t for t in leaves if t is not None],
        [torch.from_numpy(c).to(dtype) for c in cts])
    return ([o.detach().numpy() for o in outs],
            [g.numpy() for g in grads])


def _hold(arrays, kw, seed):
    j_outs, _ = _port(arrays, kw)
    cts = _cts([o.shape for o in j_outs], seed)
    j_outs, j_grads = _jax(arrays, kw, cts)
    t_outs, t_grads = _port(arrays, kw, cts)
    assert len(t_outs) == len(j_outs) == trnn._rnn_nout(kw)
    for i, (t, j) in enumerate(zip(t_outs, j_outs)):
        tp.hold_close(t, j, tp.RNN_FWD, f"output {i}")
    assert len(t_grads) == len(j_grads)
    for i, (t, j) in enumerate(zip(t_grads, j_grads)):
        tp.hold_close(t, j, tp.RNN_BWD, f"gradient {i}")


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("bi", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_rnn_op_matches_jax_from_given_states(mode, bi, layers):
    kw = dict(state_size=H, num_layers=layers, mode=mode, bidirectional=bi)
    _hold(_inputs(mode, bi, layers, seed=layers + 2 * bi), kw, seed=7)


@pytest.mark.parametrize("state_outputs", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_rnn_op_matches_jax_with_default_states(mode, state_outputs):
    kw = dict(state_size=H, num_layers=2, mode=mode, bidirectional=True,
              state_outputs=state_outputs)
    _hold(_inputs(mode, True, 2, seed=11, states=False), kw, seed=8)


def test_rnn_param_size_is_the_jax_package_s():
    for mode in MODES:
        for bi in (False, True):
            for layers in (1, 2, 3):
                assert trnn.rnn_param_size(mode, 7, 9, layers, bi) == \
                    jrnn.rnn_param_size(mode, 7, 9, layers, bi)
    # the packed layout: layer 0's W_i2h leads, the biases close the vector
    w = np.arange(trnn.rnn_param_size("gru", I, H, 1, False),
                  dtype=np.float32)
    mats, biases = trnn._unpack_params(torch.from_numpy(w), "gru", I, H, 1,
                                       1)
    jm, jb = jrnn._unpack_params(jnp.asarray(w), "gru", I, H, 1, 1)
    for a, b in zip(mats[0] + biases[0], jm[0] + jb[0]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("mode", MODES)
def test_rnn_op_bf16_matches_jax(mode):
    arrays = _inputs(mode, True, 2, seed=13)
    kw = dict(state_size=H, num_layers=2, mode=mode, bidirectional=True)
    import ml_dtypes

    bf = [None if a is None else a.astype(ml_dtypes.bfloat16)
          for a in arrays]
    j = jrnn._rnn(*[None if a is None else jnp.asarray(a) for a in bf],
                  **kw)
    t, _ = _port(arrays, kw, dtype=torch.bfloat16)
    assert all(np.asarray(o).dtype == ml_dtypes.bfloat16 for o in j)
    for i, (a, b) in enumerate(zip(t, j)):
        tp.hold_bf16(a, np.asarray(b).astype(np.float32),
                     what=f"{mode} output {i}")


def test_the_ignored_attributes_change_nothing():
    arrays = _inputs("lstm", False, 1, seed=17)
    kw = dict(state_size=H, num_layers=1, mode="lstm")
    plain, _ = _port(arrays, kw)
    odd, _ = _port(arrays, dict(kw, projection_size=3,
                                lstm_state_clip_min=-0.1,
                                lstm_state_clip_max=0.1,
                                lstm_state_clip_nan=True,
                                use_sequence_length=True))
    for a, b in zip(plain, odd):
        np.testing.assert_array_equal(a, b)
    j, _ = _jax(arrays, dict(kw, projection_size=3, lstm_state_clip_min=-0.1,
                             lstm_state_clip_max=0.1))
    for a, b in zip(plain, j):
        tp.hold_close(a, b, tp.RNN_FWD)


def test_sym_rnn_infers_the_jax_shapes_and_runs_the_op():
    shapes = {}
    for m in (mx, mt):
        data = m.sym.var("data")
        out = m.sym.RNN(data, state_size=H, num_layers=2, mode="gru",
                        bidirectional=True, state_outputs=False, name="gru")
        assert out.list_arguments() == ["data", "gru_parameters"]
        shapes[m.__name__] = out.infer_shape(data=(T, N, I))
    assert shapes["mxnet_tpu"] == shapes["mxnet_tpu_torch"]
    arrays = _inputs("gru", True, 2, seed=19, states=False)
    ex = out.bind(mt.cpu(), {"data": mt.nd.array(arrays[0], ctx=mt.cpu()),
                             "gru_parameters": mt.nd.array(arrays[1],
                                                           ctx=mt.cpu())})
    got = ex.forward()[0].asnumpy()
    want, _ = _jax(arrays, dict(state_size=H, num_layers=2, mode="gru",
                                bidirectional=True, state_outputs=False))
    tp.hold_close(got, want[0], tp.RNN_FWD)
