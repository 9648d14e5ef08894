"""The rest of the JAX package's tensor ops, its unary table, and the
NDArray front end over them, against ``mxnet_tpu`` on the CPU.

* Every op name added from ``mxnet_tpu/ops/tensor.py`` (55, with the
  unary table's 37 beside them) on its case's seeded inputs
  (``mxnet_tpu_torch.tools.op_sweep.CASES``) through both registries:
  forward values and dtype, and the gradient of each float input under a
  seeded cotangent, held by the case's class (``torch_parity``: exact
  bits for index and data-movement ops; 4 ulps forward and 16 backward
  for elementwise math; 2^-24 · n · S for sums and products; the lgamma
  family within 2^-16 · (1 + |want|), XLA's own accuracy).
* The unary table on int32 input: the output dtype (an inexact function
  is float32, a rounding one keeps int32) and its values.
* The points the JAX ops define and the port copies: take's modes out of
  range, one_hot's rows off the end, SequenceReverse's padding, split's
  refusal, gamma at negative x, round half to even, cbrt of negatives.
* Every JAX op name is registered in the port or queued with its ROADMAP
  item; the error of a queued name names it.
* The repairs: log_softmax of int32 is float32, clip with no bound,
  the gradient of ``_rmod_scalar``.
* The 38 NDArray methods, the ``nd`` functions (linspace, power,
  modulo, logical_*, stack) with the JAX scalar-or-array dispatch, and
  ``mx.waitall``.
"""
import re

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import registry as treg

import torch_parity as tp

CPU = tp.CPU

UNARY = ("sign round rint ceil floor trunc fix rsqrt cbrt rcbrt log10 log2 "
         "log1p expm1 sin cos tan arcsin arccos arctan sinh cosh arcsinh "
         "arccosh arctanh degrees radians softsign reciprocal erf erfinv "
         "gamma gammaln logical_not identity arctan2 broadcast_hypot").split()
TENSOR = ("prod nansum nanprod argmin argmax_channel broadcast_to "
          "broadcast_like broadcast_axis broadcast_axes swapaxes SwapAxis "
          "slice slice_like stack split SliceChannel tile repeat reverse "
          "flip take one_hot gather_nd scatter_nd SequenceMask sequence_mask "
          "SequenceLast sequence_last SequenceReverse sequence_reverse dot "
          "batch_dot L2Normalization diag cumsum cumprod isnan isinf "
          "isfinite trace _ravel_multi_index ravel_multi_index "
          "_unravel_index unravel_index digamma bitwise_and bitwise_or "
          "bitwise_xor all_finite multi_all_finite shape_array size_array "
          "copy _copy _hypot_scalar").split()


def test_the_slice_counts():
    assert len(UNARY) == 37 and len(TENSOR) == 55
    assert len(set(UNARY + TENSOR)) == 92


@pytest.mark.parametrize("name", UNARY + TENSOR)
def test_op_matches_jax(name):
    tp.hold_case(name)


INT_IN = np.array([[-3, 0, 2, 7], [1, -1, 4, 9]], np.int32)


@pytest.mark.parametrize("name", [n for n in UNARY if n not in (
    "rsqrt", "arctan2", "broadcast_hypot")])
def test_unary_of_int32_has_the_jax_dtype(name):
    """jnp promotes an integer input of an inexact function to float32
    and keeps it for a rounding one (rsqrt of an integer raises there).
    Values within 16 ulps: at x = 9 XLA's sinh and cosh are 8 ulps off
    the float64 truth."""
    x = INT_IN if name not in ("arccosh", "gamma", "gammaln", "log10",
                               "log2", "cbrt", "rcbrt", "reciprocal") \
        else np.abs(INT_IN) + 1
    if name in ("arcsin", "arccos", "arctanh", "erfinv"):
        x = np.clip(INT_IN, -1, 1) * 0
    (j,), _ = tp.jax_run(name, [x], {})
    (t,), _ = tp.port_run(name, [x], {})
    kind = "lgamma" if name in tp.LGAMMA else "ulp"
    tp.hold_array(kind if j.dtype.kind == "f" else "exact", t, j,
                  ulps=tp.BWD_ULPS, what=name)


@pytest.mark.parametrize("name", ["arctan2", "broadcast_hypot"])
def test_binary_of_int32_is_float32(name):
    a, b = INT_IN, np.abs(INT_IN) + 1
    (j,), _ = tp.jax_run(name, [a, b], {})
    (t,), _ = tp.port_run(name, [a, b], {})
    tp.hold_array("ulp", t, j, what=name)


@pytest.mark.parametrize("name,arrays,attrs", [
    ("prod", [INT_IN], {"axis": 1}),
    ("nansum", [INT_IN], {}),
    ("cumsum", [INT_IN], {"axis": 0}),
    ("cumsum", [INT_IN > 0], {}),
    ("cumsum", [INT_IN], {"dtype": "float32"}),
    ("cumprod", [INT_IN], {"axis": 1}),
    ("trace", [INT_IN[:, :2]], {}),
    ("dot", [INT_IN, INT_IN.T.copy()], {}),
    ("batch_dot", [INT_IN[None], INT_IN.T.copy()[None]], {}),
    ("L2Normalization", [INT_IN], {}),
    ("argmin", [INT_IN], {"axis": 1, "keepdims": True}),
    ("argmin", [INT_IN], {}),
    ("one_hot", [INT_IN], {"depth": 6, "dtype": "int32"}),
    ("one_hot", [INT_IN], {"depth": 6, "dtype": "float16",
                           "on_value": 3.0}),
    ("isnan", [INT_IN], {}),
    ("shape_array", [INT_IN], {}),
    ("size_array", [INT_IN], {}),
    ("bitwise_and", [INT_IN.astype(np.float32) + 0.7, INT_IN], {}),
    ("_hypot_scalar", [INT_IN], {"scalar": 2.7}),
    ("reciprocal", [np.abs(INT_IN) + 1], {}),
    ("rint", [INT_IN], {}),
    ("ravel_multi_index", [np.array([[1, 2, 0], [3, 0, 2]], np.int32)],
     {"shape": (3, 4)}),
    ("unravel_index", [np.array([-1, 7, 30, 0], np.int32)],
     {"shape": (3, 4)}),
])
def test_dtype_rules(name, arrays, attrs):
    (j, *_), _ = tp.jax_run(name, arrays, attrs)
    (t, *_), _ = tp.port_run(name, arrays, attrs)
    tp.hold_array("sum" if j.dtype.kind == "f" else "exact", t, j,
                  n=8, what=name)


@pytest.mark.parametrize("mode", ["clip", "raise", "wrap"])
def test_take_out_of_range(mode):
    x = np.arange(15, dtype=np.float32).reshape(5, 3)
    idx = np.array([[-7, -1, 0, 2.7], [4, 5, 9, -0.5]], np.float32)
    for axis in (0, 1):
        (j,), _ = tp.jax_run("take", [x, idx], {"axis": axis, "mode": mode})
        (t,), _ = tp.port_run("take", [x, idx], {"axis": axis,
                                                  "mode": mode})
        tp.hold_array("exact", t, j, what=f"take {mode} axis {axis}")


def test_one_hot_rows_off_the_end_are_off_value():
    idx = np.array([0, 4, 5, -1, 17, 2], np.float32)
    kw = {"depth": 5, "on_value": 2.5, "off_value": -1.0}
    (j,), _ = tp.jax_run("one_hot", [idx], kw)
    (t,), _ = tp.port_run("one_hot", [idx], kw)
    tp.hold_array("exact", t, j)
    assert (t[[2, 3, 4]] == -1.0).all()


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("name", ["SequenceReverse", "SequenceMask",
                                  "SequenceLast"])
def test_sequence_ops_along_either_axis(name, axis):
    """A length reverses (masks, picks the last of) only its own steps;
    the padding after them stays where it is."""
    rs = np.random.RandomState(7)
    data = rs.randn(*((6, 3, 2) if axis == 0 else (3, 6, 2))).astype(
        np.float32)
    lens = np.array([3, 6, 1], np.float32)
    for kw in ({"use_sequence_length": True, "axis": axis},
               {"axis": axis}):
        arrays = [data, lens] if kw.get("use_sequence_length") else [data]
        (j,), _ = tp.jax_run(name, arrays, kw)
        (t,), _ = tp.port_run(name, arrays, kw)
        tp.hold_array("exact", t, j, what=f"{name} {kw}")
    if name == "SequenceReverse":
        (t,), _ = tp.port_run(name, [data, lens], {
            "use_sequence_length": True, "axis": axis})
        moved, src = np.moveaxis(t, axis, 0), np.moveaxis(data, axis, 0)
        np.testing.assert_array_equal(moved[3:, 0], src[3:, 0])
        np.testing.assert_array_equal(moved[:3, 0], src[:3, 0][::-1])


def test_split_refuses_an_axis_it_does_not_divide():
    x = mt.nd.array(np.zeros((2, 5), np.float32), ctx=CPU)
    with pytest.raises(MXNetError, match="equal parts"):
        mt.nd.split(x, num_outputs=2, axis=1)
    with pytest.raises(ValueError):
        mx.nd.split(mx.nd.array(np.zeros((2, 5), np.float32)),
                    num_outputs=2, axis=1)
    parts = mt.nd.SliceChannel(mt.nd.array(np.ones((2, 6)), ctx=CPU),
                               num_outputs=3, squeeze_axis=False)
    assert len(parts) == 3 and parts[0].shape == (2, 2)


def test_reference_behaviour_the_port_copies():
    """gamma is exp(gammaln(x)), so |Γ(x)| at negative x; round and
    rint round half to even (reference MXNet rounds ``round`` half away
    from zero); cbrt is real for negative x."""
    x = np.array([-1.5, -2.5, 0.5, 2.5, -0.5, 1.5], np.float32)
    (g,), _ = tp.port_run("gamma", [x], {})
    assert g[0] > 0 and g[1] > 0
    (r,), _ = tp.port_run("round", [x], {})
    (jr,), _ = tp.jax_run("round", [x], {})
    np.testing.assert_array_equal(r, jr)
    assert r.tolist() == [-2.0, -2.0, 0.0, 2.0, -0.0, 2.0]
    (c,), _ = tp.port_run("cbrt", [np.array([-8.0, -27.0], np.float32)],
                          {})
    np.testing.assert_allclose(c, [-2.0, -3.0], rtol=2 ** -23)


# ---------------------------------------------------------------------------
# registry coverage
# ---------------------------------------------------------------------------

def test_every_jax_op_is_ported_or_queued():
    jax_names, port_names = set(jreg.list_ops()), set(treg.list_ops())
    left = jax_names - port_names
    assert not left - set(treg.QUEUED), sorted(left - set(treg.QUEUED))
    assert set(treg.QUEUED) == left
    assert set(treg.QUEUED.values()) == {"9"}
    assert len(port_names) == 384 and len(jax_names & port_names) == 383
    assert port_names - jax_names == {"reshape_like"}


@pytest.mark.parametrize("name,item", [("_contrib_quantize", "9"),
                                       ("_contrib_fft", "9"),
                                       ("Proposal", "9"),
                                       ("Custom", "9"), ("ROIAlign", "9")])
def test_a_queued_op_names_its_item(name, item):
    with pytest.raises(MXNetError, match=re.escape(f"queue A item {item}")):
        treg.get_op(name)
    with pytest.raises(MXNetError, match="registers an op of that name"):
        treg.get_op("no_such_op")


# ---------------------------------------------------------------------------
# the repairs
# ---------------------------------------------------------------------------

def test_log_softmax_of_int32_is_float32():
    x = np.array([[-1, -8, -4, 0]], np.int32)
    (j,), _ = tp.jax_run("log_softmax", [x], {})
    (t,), _ = tp.port_run("log_softmax", [x], {})
    assert t.dtype == np.float32 == j.dtype
    np.testing.assert_allclose(t, j, rtol=2 ** -22)
    for name in ("softmax", "softmin"):
        (j,), _ = tp.jax_run(name, [x], {})
        (t,), _ = tp.port_run(name, [x], {})
        assert t.dtype == j.dtype == np.float32, name
        np.testing.assert_allclose(t, j, rtol=2 ** -22, atol=2 ** -30)


def test_rmod_scalar_has_the_jax_gradient():
    """scalar % x is differentiable in x, as jnp.mod (the port took
    torch.remainder's scalar overload, which has no derivative)."""
    tp.hold_case("_rmod_scalar")
    tp.hold_case("_mod_scalar")


def test_clip_without_bounds_is_a_copy():
    x = np.array([[1.5, -2.0, 3.0]], np.float32)
    for kw in ({}, {"a_min": 0.0}, {"a_max": 1.0}, {"a_min": -1.0,
                                                    "a_max": 2.0}):
        (j,), _ = tp.jax_run("clip", [x], kw)
        (t,), _ = tp.port_run("clip", [x], kw)
        tp.hold_array("exact", t, j, what=str(kw))
    a = mt.nd.array(x, ctx=CPU)
    b = mt.nd.clip(a)
    b[0, 0] = 9.0
    assert a.asnumpy()[0, 0] == 1.5


# ---------------------------------------------------------------------------
# the NDArray front end
# ---------------------------------------------------------------------------

RS = np.random.RandomState(11)
M = RS.uniform(-2, 2, (4, 6)).astype(np.float32)
POS = RS.uniform(0.5, 2, (4, 6)).astype(np.float32)
IDX = np.array([3, 0, 5, 1], np.float32)

METHODS = [
    ("abs", M, (), {}), ("argmin", M, (), {"axis": 1}),
    ("argsort", M, (), {"axis": 1}), ("broadcast_to", M[:1], ((3, 6),), {}),
    ("ceil", M, (), {}), ("clip", M, (-0.5, 0.7), {}),
    ("exp", M, (), {}), ("floor", M, (), {}), ("log", POS, (), {}),
    ("log_softmax", M, (), {}), ("one_hot", IDX, (6,), {}),
    ("ones_like", M, (), {}), ("pad", M[None, None], ("constant",),
                               {"pad_width": (0, 0, 0, 0, 1, 1, 2, 0)}),
    ("prod", POS, (), {"axis": 0}), ("relu", M, (), {}),
    ("repeat", M, (2,), {"axis": 0}), ("round", M, (), {}),
    ("sigmoid", M, (), {}), ("sign", M, (), {}),
    ("slice", M, ((1, 0), (3, 6), (1, 2)), {}),
    ("softmax", M, (), {"axis": 0}), ("sort", M, (), {}),
    ("split", M, (3,), {"axis": 1}), ("sqrt", POS, (), {}),
    ("square", M, (), {}), ("swapaxes", M, (0, 1), {}),
    ("tanh", M, (), {}), ("tile", M, ((2, 1),), {}),
    ("topk", M, (), {"k": 2, "ret_typ": "value"}),
    ("zeros_like", M, (), {}),
]


def _both(a):
    return mx.nd.array(a, dtype=a.dtype), mt.nd.array(a, ctx=CPU,
                                                      dtype=a.dtype)


def _np_list(r):
    return [o.asnumpy() for o in r] if isinstance(r, list) else [r.asnumpy()]


@pytest.mark.parametrize("name,a,args,kw", METHODS,
                         ids=[m[0] for m in METHODS])
def test_ndarray_method_matches_jax(name, a, args, kw):
    j, t = _both(a)
    for got, want in zip(_np_list(getattr(t, name)(*args, **kw)),
                         _np_list(getattr(j, name)(*args, **kw))):
        tp.hold_array("exact" if want.dtype.kind != "f" else "ulp", got,
                      want, what=name)


@pytest.mark.parametrize("name", ["take", "dot", "slice_like",
                                  "broadcast_like"])
def test_ndarray_methods_of_two_arrays(name, ):
    other = {"take": IDX, "dot": M.T.copy(), "slice_like": M[:2, :3],
             "broadcast_like": np.zeros((3, 4, 6), np.float32)}[name]
    j, t = _both(M)
    jo, to = _both(other)
    want = getattr(j, name)(jo).asnumpy()
    got = getattr(t, name)(to).asnumpy()
    tp.hold_array("sum" if name == "dot" else "exact", got, want, n=6,
                  what=name)


def test_ndarray_views_and_storage_methods():
    j, t = _both(M)
    assert t.as_nd_ndarray() is t and j.as_nd_ndarray() is j
    assert t.tostype("default") is t
    tc, jc = t.tostype("csr"), j.tostype("csr")
    assert tc.stype == jc.stype == "csr"
    np.testing.assert_array_equal(tc.asnumpy(), jc.asnumpy())
    assert not t.is_view and not j.is_view
    for view in (t[1:3], t.at(1), t.reshape((6, 4))):
        assert view.is_view
    row = t.at(2)
    np.testing.assert_array_equal(row.asnumpy(), j.at(2).asnumpy())
    row[:] = 0.0
    assert (t.asnumpy()[2] == 0).all()


@pytest.mark.parametrize("fn", ["power", "modulo", "logical_and",
                                "logical_or", "logical_xor", "maximum",
                                "minimum"])
def test_nd_binary_functions_dispatch_as_jax(fn):
    """Array with array, array with a number, a number with an array (the
    reversed op for power and modulo)."""
    a = POS if fn in ("power", "modulo") else np.round(M)
    b = np.round(POS * 2) if fn != "power" else M
    ja, ta = _both(a)
    jb, tb = _both(b)
    for jl, jr, tl, tr in ((ja, jb, ta, tb), (ja, 1.5, ta, 1.5),
                           (2.0, jb, 2.0, tb)):
        want = getattr(mx.nd, fn)(jl, jr).asnumpy()
        got = getattr(mt.nd, fn)(tl, tr).asnumpy()
        tp.hold_array("ulp" if fn in ("power", "modulo") else "exact", got,
                      want, what=fn)


def test_nd_stack_and_linspace():
    arrays = [M, M * 2, M - 1]
    want = mx.nd.stack(*[mx.nd.array(a) for a in arrays], axis=1)
    got = mt.nd.stack(*[mt.nd.array(a, ctx=CPU) for a in arrays], axis=1)
    tp.hold_array("exact", got.asnumpy(), want.asnumpy())
    got = mt.nd.stack([mt.nd.array(a, ctx=CPU) for a in arrays])
    assert got.shape == (3, 4, 6)
    for kw in ({}, {"endpoint": False}, {"dtype": "int32"}):
        want = mx.nd.linspace(-1, 3, 7, **kw).asnumpy()
        got = mt.nd.linspace(-1, 3, 7, ctx=CPU, **kw).asnumpy()
        tp.hold_array("exact", got, want, what=str(kw))


def test_waitall():
    assert mt.waitall is mt.nd.waitall
    mt.waitall()
    mx.waitall()
