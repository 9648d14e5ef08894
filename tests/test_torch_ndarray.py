"""mxnet_tpu_torch's NDArray and op registry against the JAX package.

The same numpy inputs go through ``mxnet_tpu.nd`` and
``mxnet_tpu_torch.nd`` on the CPU: construction and the dtype defaults,
reshape's special codes, arithmetic with arrays and scalars (both
sides), broadcasting, comparisons, reductions, views that write
through, in-place operators, ``astype`` (bf16's ``asnumpy`` included),
and ops of the ``nd`` namespace that the registry generates.  Integer
results must match exactly and floating ones within 1e-6 (relative and
absolute: the last bit of a division, a transcendental or a reduction
depends on the library); dtypes must match always.
"""
import ast
import pathlib

import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = mt.cpu()
RS = np.random.RandomState(3)
A = RS.uniform(-3, 3, (3, 4)).astype(np.float32)
B = RS.uniform(0.5, 2, (3, 4)).astype(np.float32)
I = RS.randint(-9, 9, (3, 4)).astype(np.int32)
J = RS.randint(1, 5, (3, 4)).astype(np.int32)


def _pair(a, **kw):
    return mx.nd.array(a, **kw), mt.nd.array(a, ctx=CPU, **kw)


def _same(j, t):
    """Values and dtype of a JAX NDArray and a port NDArray: integer
    results exactly, floating ones within 1e-6."""
    jn, tn = j.asnumpy(), t.asnumpy()
    assert tn.dtype == jn.dtype, (tn.dtype, jn.dtype)
    assert tn.shape == jn.shape
    if not np.issubdtype(jn.dtype, np.floating):
        np.testing.assert_array_equal(tn, jn)
    else:
        np.testing.assert_allclose(tn, jn, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("src", [
    [[1.5, 2.0], [3.0, 4.0]], np.arange(6, dtype=np.float64),
    np.arange(6, dtype=np.int64), np.arange(4, dtype=np.uint8), I, A])
def test_array_construction_and_dtype_defaults(src):
    j, t = _pair(src)
    _same(j, t)
    assert t.ctx == CPU and t.context == CPU
    assert t.ndim == j.ndim and t.size == j.size and len(t) == len(j)


def test_creation_functions():
    for jf, tf in [(mx.nd.zeros((2, 3)), mt.nd.zeros((2, 3), ctx=CPU)),
                   (mx.nd.ones(4), mt.nd.ones(4, ctx=CPU)),
                   (mx.nd.full((2, 2), 7.0), mt.nd.full((2, 2), 7.0,
                                                        ctx=CPU)),
                   (mx.nd.arange(0, 5, 1.0), mt.nd.arange(0, 5, 1.0,
                                                          ctx=CPU)),
                   (mx.nd.zeros((2,), dtype="int32"),
                    mt.nd.zeros((2,), ctx=CPU, dtype="int32"))]:
        _same(jf, tf)


def test_creation_without_a_context_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(MXNetError, match="CUDA"):
        mt.nd.zeros((2,))
    with pytest.raises(MXNetError, match="CUDA"):
        mt.nd.array([1.0])


@pytest.mark.parametrize("shape,codes", [
    ((2, 3, 4), (-1,)), ((2, 3, 4), (0, -1)), ((2, 3, 4), (-2,)),
    ((2, 3, 4), (-3, 4)), ((2, 3, 4), (0, -3)), ((2, 3, 4), (-4, 1, 2, -2)),
    ((2, 3, 4), (0, 0, -4, 2, -1)), ((6, 4), (-4, -1, 3, 0)),
    ((2, 3, 4), (4, 0, -1)), ((2, 3, 4), (-1, 2, 2))])
def test_reshape_special_codes(shape, codes):
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    j, t = _pair(x)
    _same(j.reshape(codes), t.reshape(codes))
    _same(mx.nd.reshape(j, shape=codes), mt.nd.reshape(t, shape=codes))


OPS = [lambda a, b: a + b, lambda a, b: a - b, lambda a, b: a * b,
       lambda a, b: a / b, lambda a, b: a % b, lambda a, b: a ** 2,
       lambda a, b: a + 2.5, lambda a, b: 2.5 - a, lambda a, b: a * -3,
       lambda a, b: 7 / b, lambda a, b: a / 2.7, lambda a, b: b % 3,
       lambda a, b: 2 ** b, lambda a, b: -a, lambda a, b: abs(a),
       lambda a, b: a - 1.5]


@pytest.mark.parametrize("op", range(len(OPS)))
@pytest.mark.parametrize("kind", ["f32", "i32"])
def test_arithmetic(op, kind):
    a, b = (A, B) if kind == "f32" else (I, J)
    (ja, ta), (jb, tb) = _pair(a), _pair(b)
    _same(OPS[op](ja, jb), OPS[op](ta, tb))


def test_broadcasting_and_mixed_dtypes():
    x = RS.uniform(-1, 1, (3, 1)).astype(np.float32)
    y = RS.uniform(-1, 1, (1, 4)).astype(np.float32)
    (jx, tx), (jy, ty) = _pair(x), _pair(y)
    for f in (lambda a, b: a + b, lambda a, b: a * b, lambda a, b: a - b,
              lambda a, b: a > b):
        _same(f(jx, jy), f(tx, ty))
    (ji, ti) = _pair(J)
    _same(jx + ji, tx + ti)  # float32 + int32 -> float32
    # an array-like right operand is a float32 array in both
    _same(jx + [[1.0, 2.0, 3.0, 4.0]], tx + [[1.0, 2.0, 3.0, 4.0]])


CMPS = [lambda a, b: a == b, lambda a, b: a != b, lambda a, b: a > b,
        lambda a, b: a >= b, lambda a, b: a < b, lambda a, b: a <= b,
        lambda a, b: a > 0.5, lambda a, b: a <= 1, lambda a, b: a == 2]


@pytest.mark.parametrize("op", range(len(CMPS)))
@pytest.mark.parametrize("kind", ["f32", "i32"])
def test_comparisons_return_ones_and_zeros_in_the_operand_dtype(op, kind):
    a = A.round() if kind == "f32" else I
    b = np.roll(a, 1)
    (ja, ta), (jb, tb) = _pair(a), _pair(b)
    _same(CMPS[op](ja, jb), CMPS[op](ta, tb))


REDUCTIONS = [("sum", {}), ("sum", {"axis": 1}),
              ("sum", {"axis": (0, 1), "keepdims": True}),
              ("mean", {"axis": 0}), ("max", {}), ("max", {"axis": 1}),
              ("min", {"axis": 0, "keepdims": True}),
              ("argmax", {"axis": 1}), ("argmax", {}),
              ("argmax", {"axis": 0, "keepdims": True})]


@pytest.mark.parametrize("name,kw,src", [
    (n, kw, src) for n, kw in REDUCTIONS for src in ("f32", "i32")] + [
    ("norm", {}, "f32"), ("norm", {"axis": 1}, "f32")])
def test_reductions(name, kw, src):
    j, t = _pair(A if src == "f32" else I)
    _same(getattr(j, name)(**kw), getattr(t, name)(**kw))


def test_shape_methods():
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    j, t = _pair(x)
    _same(j.T, t.T)
    _same(j.transpose((1, 0, 2)), t.transpose((1, 0, 2)))
    _same(j.flatten(), t.flatten())
    _same(j.expand_dims(1), t.expand_dims(1))
    _same(j.expand_dims(0).squeeze(0), t.expand_dims(0).squeeze(0))
    _same(j.slice_axis(2, 1, 3), t.slice_axis(2, 1, 3))
    idx = np.array([1, 0, 1], np.int32)
    _same(j[mx.nd.array(idx)], t[mt.nd.array(idx, ctx=CPU)])
    _same(j[1, 2], t[1, 2])
    _same(j[:, 1:3], t[:, 1:3])
    # a 1-d array stays as it is (the port's flatten once made it (N, 1))
    _same(j[0, 0].flatten(), t[0, 0].flatten())


def test_views_write_through():
    x = np.zeros((3, 4), np.float32)
    j, t = _pair(x)
    for a in (j, t):
        row = a[1]
        row[:] = 5.0
        col = a[:, 2:4]
        col[0] = 7.0
        flat = a.reshape(-1)
        flat[11] = 9.0
        a[2, 0] = -1.0
    _same(j, t)
    assert t.asnumpy()[1, 0] == 5.0 and t.asnumpy()[0, 3] == 7.0
    assert t.asnumpy()[2, 3] == 9.0


def test_in_place_operators():
    (ja, ta), (ji, ti) = _pair(A), _pair(I)
    for a, i in ((ja, ji), (ta, ti)):
        a += 1.5
        a *= 2
        a -= a
        a += 3
        a /= 4
        i += 2
        i *= 3
    _same(ja, ta)
    _same(ji, ti)
    # through a view into the base
    (jb, tb) = _pair(np.zeros((2, 3), np.float32))
    for b in (jb, tb):
        v = b[0]
        v += 2.0
    _same(jb, tb)
    # an integer array divided in place becomes float32 in both
    (jc, tc) = _pair(J)
    jc /= 2
    tc /= 2
    _same(jc, tc)


@pytest.mark.parametrize("src,dt", [(A, "int32"), (I, "float32"),
                                    (A, "bfloat16"), (A, "float16"),
                                    (I, "uint8")])
def test_astype(src, dt):
    j, t = _pair(src)
    _same(j.astype(dt), t.astype(dt))


def test_bf16_asnumpy_is_what_the_jax_package_returns():
    j, t = _pair(A)
    jb, tb = j.astype("bfloat16"), t.astype("bfloat16")
    jn, tn = jb.asnumpy(), tb.asnumpy()
    assert jn.dtype == tn.dtype == np.dtype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(tn.view(np.uint16), jn.view(np.uint16))
    assert tb.dtype == jb.dtype
    # and back: an ml_dtypes bf16 array goes in with the same bits
    _same(mx.nd.array(jn), mt.nd.array(jn, ctx=CPU))


@pytest.mark.parametrize("name,args,kw", [
    ("abs", ("a",), {}), ("negative", ("a",), {}),
    ("broadcast_add", ("a", "b"), {}), ("broadcast_sub", ("a", "b"), {}),
    ("broadcast_mul", ("a", "b"), {}), ("broadcast_div", ("a", "b"), {}),
    ("broadcast_mod", ("a", "b"), {}), ("broadcast_power", ("b", "b"), {}),
    ("broadcast_greater", ("a", "b"), {}),
    ("_plus_scalar", ("a",), {"scalar": 2.0}),
    ("_rdiv_scalar", ("b",), {"scalar": 3.0}),
    ("_rpower_scalar", ("a",), {"scalar": 2.0}),
    ("_lesser_equal_scalar", ("a",), {"scalar": 0.5}),
    ("sum", ("a",), {"axis": 1, "exclude": True}),
    ("mean", ("a",), {"axis": (0,), "keepdims": True}),
    ("max", ("a",), {"axis": 0}), ("norm", ("a",), {"ord": 1}),
    ("log_softmax", ("a",), {}), ("transpose", ("a",), {"axes": (1, 0)}),
    ("cast", ("a",), {"dtype": "int32"}), ("reshape", ("a",),
                                            {"shape": (0, -4, 2, -1)}),
    ("Activation", ("a",), {"act_type": "relu"}),
    ("Activation", ("a",), {"act_type": "tanh"}),
    ("Flatten", ("a",), {}), ("expand_dims", ("a",), {"axis": 1})])
def test_nd_namespace_from_the_registry(name, args, kw):
    arrs = {"a": A, "b": B}
    j = getattr(mx.nd, name)(*[mx.nd.array(arrs[a]) for a in args], **kw)
    t = getattr(mt.nd, name)(*[mt.nd.array(arrs[a], ctx=CPU)
                               for a in args], **kw)
    _same(j, t)


def test_fully_connected_and_pick_through_the_namespace():
    x = RS.uniform(-1, 1, (5, 6)).astype(np.float32)
    w = RS.uniform(-1, 1, (3, 6)).astype(np.float32)
    b = RS.uniform(-1, 1, (3,)).astype(np.float32)
    j = mx.nd.FullyConnected(mx.nd.array(x), mx.nd.array(w),
                             mx.nd.array(b), num_hidden=3)
    t = mt.nd.FullyConnected(*[mt.nd.array(v, ctx=CPU) for v in (x, w, b)],
                             num_hidden=3)
    _same(j, t)
    idx = np.array([0, 2, 1, 1, 0], np.float32)
    _same(mx.nd.pick(j, mx.nd.array(idx), axis=1),
          mt.nd.pick(t, mt.nd.array(idx, ctx=CPU), axis=1))
    # out= writes into an existing array
    out = mt.nd.zeros((5, 3), ctx=CPU)
    mt.nd.Activation(t, act_type="relu", out=out)
    _same(mx.nd.Activation(j, act_type="relu"), out)


def test_registry_refuses_unknown_ops_and_attributes():
    from mxnet_tpu_torch.ops import registry

    op = registry.get_op("FullyConnected")
    assert op.input_names == ["data", "weight"]
    assert {"bias", "num_hidden", "no_bias", "flatten"} <= set(
        op.attr_defaults)
    assert "broadcast_add" in registry.list_ops()
    with pytest.raises(MXNetError, match="no attribute 'bogus'"):
        mt.nd.negative(mt.nd.ones(2, ctx=CPU), bogus=1)
    with pytest.raises(MXNetError, match="not ported"):
        registry.get_op("Deconvolution")
    with pytest.raises(AttributeError):
        mt.nd.Deconvolution
    # reference-style string attributes are coerced, as in the JAX package
    t = mt.nd.expand_dims(mt.nd.array(A, ctx=CPU), axis="1")
    _same(mx.nd.expand_dims(mx.nd.array(A), axis="1"), t)


def test_save_load_round_trip_with_the_jax_package(tmp_path):
    vals = {"w": A, "i": I}
    f1, f2 = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    mx.nd.save(f1, {k: mx.nd.array(v) for k, v in vals.items()})
    mt.nd.save(f2, {k: mt.nd.array(v, ctx=CPU) for k, v in vals.items()})
    for f in (f1, f2):
        got_t, got_j = mt.nd.load(f), mx.nd.load(f)
        for k in vals:
            _same(got_j[k], got_t[k])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_asnumpy_of_a_cpu_parameter_is_a_copy(dtype):
    """``asnumpy()`` returns a copy, as MXNet and the JAX package do: an
    in-place update of the parameter afterwards (a ``gluon.Trainer``
    step, then an in-place operator on the array) leaves the array that
    was read unchanged."""
    net = mt.gluon.nn.Dense(3, in_units=4, dtype=dtype)
    net.initialize(ctx=CPU)
    p = net.collect_params()["weight"]
    held = p.data().asnumpy()
    kept = held.copy()
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.5})
    x = mt.nd.array(A[:, :4], ctx=CPU, dtype=dtype)
    with mt.autograd.record():
        loss = (net(x) * net(x)).sum()
    loss.backward()
    trainer.step(1)
    now = p.data().asnumpy()
    assert not np.array_equal(now.view(np.uint8), kept.view(np.uint8))
    np.testing.assert_array_equal(held.view(np.uint8), kept.view(np.uint8))
    arr = mt.nd.array(B, ctx=CPU, dtype=dtype)
    held = arr.asnumpy()
    kept = held.copy()
    arr += 1.0
    np.testing.assert_array_equal(held.view(np.uint8), kept.view(np.uint8))


NEW_MODULES = ["ndarray/__init__.py", "ndarray/ndarray.py",
               "ndarray/register.py", "ops/registry.py", "autograd.py",
               "random.py", "kvstore.py", "metric.py", "gluon/parameter.py",
               "gluon/trainer.py", "gluon/utils.py", "gluon/data/__init__.py",
               "gluon/data/dataset.py", "gluon/data/sampler.py",
               "gluon/data/dataloader.py", "gluon/data/vision/__init__.py",
               "gluon/data/vision/datasets.py", "examples/mnist.py"]


@pytest.mark.parametrize("path", NEW_MODULES)
def test_new_module_imports_neither_jax_nor_the_jax_package(path):
    f = REPO / "mxnet_tpu_torch" / path
    tree = ast.parse(f.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            assert mod.split(".")[0] not in ("jax", "jaxlib", "mxnet_tpu"), \
                f"{path} imports {mod}"
