"""The port's ``test_utils`` against the JAX package's on the CPU.

The same calls, with numpy's global generator seeded alike before each,
give the same verdicts (pass, or the first mismatch raising) and the
same numbers: ``check_numeric_gradient``'s numeric gradients (taken from
its comparisons; float32 central differences, equal within 1e-3 of their
scale) and autograd gradients (within 1e-5), the symbolic forward and
backward checks on a Symbol and on a callable, ``check_consistency``
(float64 locations cast to float32, the gradient of ``outs[0].sum()`` in
training mode; a callable that changes between calls fails it), the
comparison helpers, the random helpers (bit for bit) and
``default_rtol_atol``.  A Symbol's gradients are zeros in both packages
(its executor runs outside autograd), so its numeric check fails in
both.  ``default_context`` follows ``MXNET_TEST_DEFAULT_CONTEXT``
(``cpu`` in both; ``gpu`` is the port's spelling, ``tpu`` the JAX one's)
and the ``with ctx:`` scope.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import test_utils as jtu

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import test_utils as ttu


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


PKGS = ((mx, jtu, mx.cpu), (mt, ttu, mt.cpu))


def _fc_tanh(m):
    def f(x, w, b):
        return m.nd.tanh(m.nd.FullyConnected(x, w, b, num_hidden=4))
    return f


def _fc_sym(m):
    return m.sym.FullyConnected(m.sym.var("x"), m.sym.var("w"),
                                m.sym.var("b"), num_hidden=4, name="fc")


def _location(seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, 3).astype(np.float32),
            rng.randn(4, 3).astype(np.float32),
            rng.randn(4).astype(np.float32)]


def _recorded(tu, monkeypatch, call):
    """Run call() with tu.assert_almost_equal recording its (a, b) and
    still checking; returns (verdict, recorded pairs)."""
    seen = []
    real = tu.assert_almost_equal

    def rec(a, b, *args, **kw):
        seen.append((tu._as_numpy(a).astype(np.float64),
                     tu._as_numpy(b).astype(np.float64)))
        return real(a, b, *args, **kw)
    monkeypatch.setattr(tu, "assert_almost_equal", rec)
    try:
        call()
        verdict = "pass"
    except AssertionError:
        verdict = "fail"
    monkeypatch.setattr(tu, "assert_almost_equal", real)
    return verdict, seen


@pytest.mark.parametrize("case", ["callable", "symbol", "grad_nodes",
                                  "float64"])
def test_numeric_gradient_same_numbers_and_verdicts(case, monkeypatch):
    got = []
    for m, tu, cpu in PKGS:
        f = _fc_sym(m) if case == "symbol" else _fc_tanh(m)
        kw = dict(ctx=cpu())
        if case == "grad_nodes":
            kw["grad_nodes"] = [1]
        if case == "float64":
            kw["dtype"] = "float64"
        loc = _location()
        np.random.seed(11)
        got.append(_recorded(tu, monkeypatch, lambda: (
            tu.check_numeric_gradient(f, loc, **kw))))
    (jv, jseen), (tv, tseen) = got
    assert tv == jv == ("fail" if case == "symbol" else "pass")
    assert len(tseen) == len(jseen) >= 1
    for (ja, jn), (ta, tn) in zip(jseen, tseen):
        scale = max(np.abs(jn).max(), 1e-6)
        assert np.abs(tn - jn).max() <= 1e-3 * scale
        assert np.abs(ta - ja).max() <= 1e-5 * max(np.abs(ja).max(), 1e-6)


def test_symbolic_forward_and_backward():
    loc = _location()
    x, w, b = (a.astype(np.float64) for a in loc)
    want = x @ w.T + b
    og = np.ones_like(want)
    for m, tu, cpu in PKGS:
        ctx = cpu()
        for f in (_fc_sym(m), lambda x_, w_, b_, m=m: m.nd.FullyConnected(
                x_, w_, b_, num_hidden=4)):
            tu.check_symbolic_forward(f, loc, want, rtol=1e-5, atol=1e-6,
                                      ctx=ctx)
            with pytest.raises(AssertionError, match="differ beyond"):
                tu.check_symbolic_forward(f, loc, want + 1e-2, ctx=ctx)
        d = dict(zip(("x", "w", "b"), loc))
        tu.check_symbolic_forward(_fc_sym(m), d, want, rtol=1e-5, atol=1e-6,
                                  ctx=ctx)
        with pytest.raises(KeyError, match="missing"):
            tu.check_symbolic_forward(_fc_sym(m), {"x": loc[0]}, want,
                                      ctx=ctx)
        f = lambda x_, w_, b_, m=m: m.nd.FullyConnected(  # noqa: E731
            x_, w_, b_, num_hidden=4)
        tu.check_symbolic_backward(f, loc, og, [og @ w, og.T @ x,
                                                og.sum(0)],
                                   rtol=1e-5, atol=1e-6, ctx=ctx)
        with pytest.raises(AssertionError):
            tu.check_symbolic_backward(f, loc, og, [og @ w + 1, None, None],
                                       ctx=ctx)


class _Drifting:
    """A callable whose output moves by one each call: two contexts never
    agree."""

    def __init__(self, m):
        self.m, self.calls = m, 0

    def __call__(self, x):
        self.calls += 1
        return x * float(self.calls)


def test_check_consistency_verdicts(monkeypatch):
    loc64 = [a.astype(np.float64) for a in _location()]
    for m, tu, cpu in PKGS:
        for f in (_fc_tanh(m), _fc_sym(m)):
            verdict, seen = _recorded(tu, monkeypatch, lambda: (
                tu.check_consistency(f, [cpu(0), cpu(0)], loc64)))
            assert verdict == "pass"
            # outputs, then the three gradients
            assert len(seen) == 4 and all(a.dtype == np.float64
                                          for a, _ in seen)
        with pytest.raises(AssertionError, match="cpu\\(0\\)"):
            tu.check_consistency(_Drifting(m), [cpu(0), cpu(0)], loc64[:1])
        tu.check_consistency(_Drifting(m), [cpu(0)], loc64[:1], grad=False)


def test_comparison_helpers_agree():
    rng = np.random.RandomState(5)
    a = rng.rand(3, 4).astype(np.float32)
    cases = [(a, a), (a, a + 1e-7), (a, a + 1e-3), (a, a[:2]),
             (a, np.where(a > 0.5, np.nan, a))]
    for x, y in cases:
        out = []
        for m, tu, cpu in PKGS:
            nx, ny = m.nd.array(x, ctx=cpu()), y
            try:
                tu.assert_almost_equal(nx, ny)
                verdict = "pass"
            except AssertionError as e:
                verdict = str(e)
            out.append((verdict, tu.same(nx, ny) if x.shape == y.shape
                        else None, tu.almost_equal(x, y)
                        if x.shape == y.shape else None))
        assert out[0] == out[1]
    for dt in ("float16", "float32", "float64", "bfloat16"):
        assert ttu.default_rtol_atol(dt) == jtu.default_rtol_atol(dt)


def test_random_helpers_are_bit_for_bit():
    for fn in ("rand_shape_2d", "rand_shape_3d"):
        np.random.seed(2)
        j = getattr(jtu, fn)()
        np.random.seed(2)
        assert getattr(ttu, fn)() == j
    np.random.seed(2)
    j = jtu.rand_shape_nd(4)
    np.random.seed(2)
    assert ttu.rand_shape_nd(4) == j
    np.random.seed(4)
    j = jtu.rand_ndarray((3, 5), ctx=mx.cpu(), scale=2.0).asnumpy()
    np.random.seed(4)
    t = ttu.rand_ndarray((3, 5), ctx=mt.cpu(), scale=2.0).asnumpy()
    assert np.array_equal(t, j)
    x = _location()[0]
    np.testing.assert_array_equal(
        ttu.simple_forward(lambda v: mt.nd.relu(v), x, ctx=mt.cpu()),
        jtu.simple_forward(lambda v: mx.nd.relu(v), x, ctx=mx.cpu()))


def test_default_context_follows_the_knob(monkeypatch):
    monkeypatch.setattr(ttu, "_DEFAULT_CTX", None)
    monkeypatch.setattr(jtu, "_DEFAULT_CTX", None)
    monkeypatch.setenv("MXNET_TEST_DEFAULT_CONTEXT", "cpu")
    assert str(ttu.default_context()) == str(jtu.default_context()) \
        == "cpu(0)"
    monkeypatch.setenv("MXNET_TEST_DEFAULT_CONTEXT", "")
    with mt.cpu(), mx.cpu():
        assert str(ttu.default_context()) == str(jtu.default_context()) \
            == "cpu(0)"
    monkeypatch.setenv("MXNET_TEST_DEFAULT_CONTEXT", "gpu")
    assert ttu.default_context() == mt.gpu(0)
    ttu.set_default_context(mt.cpu(1))
    assert ttu.default_context() == mt.cpu(1)
    assert ttu.list_gpus() == list(range(torch.cuda.device_count()))
