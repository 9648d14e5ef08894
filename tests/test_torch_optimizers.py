"""Every optimizer of mxnet_tpu_torch against the JAX package's, on the CPU.

* The 18 update ops of the JAX ``ops/optimizer_ops.py`` that the port
  added (19 names with ``_sparse_adagrad_update``) against the JAX
  functions run op by op on the same numpy inputs: fp32 within 1e-6 of
  each output's largest magnitude; float64 (``jax.enable_x64``) within 4
  ulps of it, since PyTorch's vectorised CPU square root is not
  correctly rounded where XLA's is; bf16 bit for bit, with ``lr`` given
  to the JAX op as the fp32 array ``SPMDTrainer``'s functional forms
  pass (the port's ``lr`` promotes a half operand, as the SGD ops' does).
  The multi-tensor ops at 1 and 3 weights, and their registered names
  and attributes.
* The 15 cases of the JAX ``tests/test_fused_step.py`` (``CASES``), three
  steps from the same numpy weights and gradients (``SHAPES``): the
  port's eager per-parameter ``Updater`` and its ``FusedUpdater`` against
  the JAX package's eager ``Updater``, weights, states and the
  ``get_states`` payload: fp32 within 1e-6 of each tensor's largest
  magnitude; float64 within 8 ulps of it (the JAX update jit-compiles
  each op, and XLA contracts products into FMAs and divides by a
  constant through its reciprocal); bf16 with ``multi_precision``, the
  fp32 master and states within 1e-6 and the bf16 weight the master
  rounded.  The port's fused update equals its eager loop bit for bit
  (fp32, float64, bf16 with and without ``multi_precision``), and the
  optimizers whose update depends on t take the eager loop on bf16
  weights without a master copy (``FusedUnsupported``), in both
  packages.
* ``SPMDTrainer`` with each functional form (RMSProp plain and centred,
  AdaGrad, Signum, SignSGD, AdaDelta, Adamax, Ftrl) against the JAX
  ``SPMDTrainer`` on a small MLP, three steps: losses and parameters
  within 1e-5; the optimizers without a form raise the JAX message.
* ``Trainer.save_states`` of every case written by one package and read
  by the other, then one more step in both; ``optimizer_state_bytes``.
"""
import pickle

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import parallel as jpar
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.parameter import Parameter as JParameter
from mxnet_tpu.ops import optimizer_ops as jops
from mxnet_tpu.optimizer import fused as jfused
from mxnet_tpu.optimizer import optimizer as jopt

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.gluon import load_numpy_params
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.ops import optimizer_ops as tops
from mxnet_tpu_torch.ops.registry import get_op, invoke

CPU = mt.cpu()
SHAPES = [(4, 3), (7,), (2, 3, 2), (1,)]
# the JAX package's tests/test_fused_step.py CASES
CASES = [
    ("sgd", {"momentum": 0.9, "wd": 0.01}),
    ("sgd", {}),
    ("nag", {"momentum": 0.9}),
    ("adam", {}),
    ("adagrad", {}),
    ("adadelta", {}),
    ("adamax", {}),
    ("nadam", {}),
    ("rmsprop", {}),
    ("rmsprop", {"centered": True}),
    ("ftrl", {}),
    ("signum", {"momentum": 0.9}),
    ("signsgd", {}),
    ("lamb", {}),
    ("test", {}),
]
IDS = [f"{n}-{i}" for i, (n, _) in enumerate(CASES)]
STEPS = 3
F64_ULPS = 8
FP32_REL = 1e-6


def _np_dtype(dtype):
    return ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)


def _t(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(x).astype(np.float64)


def _kind(x):
    return {torch.bfloat16: "bfloat16", torch.float64: "float64"}.get(
        x.dtype, "float32") if isinstance(x, torch.Tensor) else {
        "bfloat16": "bfloat16", "float64": "float64"}.get(
        str(np.asarray(x).dtype), "float32")


def _hold(got, want, dtype, what, f64_ulps=4):
    """bf16 bit for bit; fp32 within 1e-6 and float64 within f64_ulps
    ulps of the largest magnitude of ``want``."""
    a, b = _f64(got), _f64(want)
    assert a.shape == b.shape, what
    if dtype == "bfloat16":
        np.testing.assert_array_equal(a, b, err_msg=what)
        return
    mag = max(np.abs(b).max(), np.finfo(np.float64).tiny)
    tol = FP32_REL if dtype == "float32" else f64_ulps * 2.0 ** -52
    assert np.abs(a - b).max() <= tol * mag, (what, np.abs(a - b).max() / mag)


# ---------------------------------------------------------------------------
# the update ops
# ---------------------------------------------------------------------------

def _arr(rs, scale=1.0, positive=False, n=257):
    a = scale * rs.randn(n)
    return np.abs(a) if positive else a


# op -> (inputs: scale, positive), attributes; every case clips, decays
# and rescales where the op takes it
OPS = {
    "rmsprop_update": ([(1, 0), (.1, 0), (1e-2, 1)],
                       dict(lr=0.01, gamma1=0.9, epsilon=1e-8, wd=1e-2,
                            rescale_grad=0.5, clip_gradient=0.15,
                            clip_weights=2.0)),
    "rmspropalex_update": ([(1, 0), (.1, 0), (1e-1, 1), (1e-3, 0),
                            (1e-2, 0)],
                           dict(lr=0.01, gamma1=0.95, gamma2=0.9,
                                epsilon=1e-8, wd=1e-2, rescale_grad=0.5,
                                clip_gradient=0.15)),
    "ftrl_update": ([(1, 0), (.1, 0), (.1, 0), (1e-2, 1)],
                    dict(lr=0.1, lamda1=0.01, beta=1.0, wd=1e-2,
                         rescale_grad=0.5, clip_gradient=0.15)),
    "signsgd_update": ([(1, 0), (.1, 0)],
                       dict(lr=0.01, wd=1e-2, rescale_grad=0.5,
                            clip_gradient=0.15)),
    "signum_update": ([(1, 0), (.1, 0), (1e-2, 0)],
                      dict(lr=0.01, momentum=0.9, wd=1e-2, wd_lh=1e-3,
                           rescale_grad=0.5, clip_gradient=0.15)),
    "adagrad_update": ([(1, 0), (.1, 0), (1e-2, 1)],
                       dict(lr=0.01, epsilon=1e-7, wd=1e-2, rescale_grad=0.5,
                            clip_gradient=0.15)),
    "adadelta_update": ([(1, 0), (.1, 0), (1e-2, 1), (1e-2, 1)],
                        dict(lr=1.0, rho=0.9, epsilon=1e-5, wd=1e-2,
                             rescale_grad=0.5, clip_gradient=0.15)),
    "adamax_update": ([(1, 0), (.1, 0), (1e-2, 0), (1e-2, 1)],
                      dict(lr=0.002, beta1=0.9, beta2=0.999, epsilon=1e-8,
                           wd=1e-2, rescale_grad=0.5, clip_gradient=0.15,
                           t=3)),
    "nadam_update": ([(1, 0), (.1, 0), (1e-2, 0), (1e-3, 1)],
                     dict(lr=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                          wd=1e-2, rescale_grad=0.5, clip_gradient=0.15,
                          t=3, schedule_decay=0.004)),
    "lamb_update_phase1": ([(1, 0), (.1, 0), (1e-2, 0), (1e-3, 1)],
                           dict(beta1=0.9, beta2=0.999, epsilon=1e-6, t=3,
                                bias_correction=True, wd=1e-2,
                                rescale_grad=0.5, clip_gradient=0.15)),
}
DTYPES = ["float32", "float64", "bfloat16"]


def _jax_op(name, arrays, attrs, dtype):
    """The JAX function, op by op; lr as the functional forms' fp32 array
    next to bf16 operands (the port's op takes the same as a 0-d
    tensor)."""
    attrs = dict(attrs)
    if dtype == "bfloat16" and "lr" in attrs:
        attrs["lr"] = jnp.asarray(attrs["lr"], jnp.float32)
    with jax.enable_x64(dtype == "float64"):
        out = getattr(jops, "_" + name)(*map(jnp.asarray, arrays), **attrs)
        out = out if isinstance(out, tuple) else (out,)
        return [np.asarray(o) for o in out]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(OPS))
def test_update_op_matches_jax(name, dtype):
    specs, attrs = OPS[name]
    rs = np.random.RandomState(sorted(OPS).index(name))
    arrays = [_arr(rs, s, p).astype(_np_dtype(dtype)) for s, p in specs]
    want = _jax_op(name, arrays, attrs, dtype)
    if dtype == "bfloat16" and "lr" in attrs:
        attrs = dict(attrs, lr=torch.tensor(attrs["lr"]))
    got = get_op(name).fn(*map(_t, arrays), **attrs)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want) == get_op(name).nout(attrs)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _kind(g) == _kind(w), (name, i)
        _hold(g, w, _kind(w), f"{name} output {i}")


def test_sparse_adagrad_is_adagrad():
    assert get_op("_sparse_adagrad_update") is get_op("adagrad_update")
    specs, attrs = OPS["adagrad_update"]
    rs = np.random.RandomState(1)
    arrays = [_t(_arr(rs, s, p).astype(np.float32)) for s, p in specs]
    out = invoke("_sparse_adagrad_update",
                 *[mt.nd.NDArray(a) for a in arrays], **attrs)
    for a, b in zip(out, tops.adagrad_update(*arrays, **attrs)):
        assert torch.equal(a._data, b)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("bounds", [(-1.0, -1.0), (0.5, 2.0)])
def test_lamb_phase2_matches_jax(bounds, dtype):
    rs = np.random.RandomState(3)
    w = _arr(rs).astype(dtype)
    g = _arr(rs, 0.1).astype(dtype)
    kw = dict(lr=0.01, lower_bound=bounds[0], upper_bound=bounds[1])
    cases = [(np.linalg.norm(w), np.linalg.norm(g)), (0.0, 1.0), (1.0, 0.0)]
    for r1, r2 in cases:
        r1a, r2a = np.asarray([r1], dtype), np.asarray([r2], dtype)
        want = _jax_op("lamb_update_phase2", [w, g, r1a, r2a], kw, dtype)[0]
        got = tops.lamb_update_phase2(*map(_t, (w, g, r1a, r2a)), **kw)
        _hold(got, want, dtype, f"phase2 r1={r1} r2={r2}")


def _multi_inputs(n, per, dtype, seed, master=False):
    rs = np.random.RandomState(seed)
    arrays = []
    for i in range(n):
        shape = SHAPES[i % len(SHAPES)]
        w = rs.randn(*shape)
        group = [w, 0.3 * rs.randn(*shape)]
        group += [0.1 * rs.randn(*shape)] * (per - 2 - int(master))
        arrays += [a.astype(_np_dtype(dtype)) for a in group]
        if master:  # the fp32 master copy, off the half weight
            arrays.append((w + 1e-4).astype(np.float32))
    return arrays


MULTI = {"multi_sgd_update": (2, False), "multi_sgd_mom_update": (3, False),
         "multi_mp_sgd_update": (3, True),
         "multi_mp_sgd_mom_update": (4, True)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("name", sorted(MULTI))
def test_multi_tensor_update_matches_jax(name, n, dtype):
    per, master = MULTI[name]
    arrays = _multi_inputs(n, per, dtype, n, master)
    attrs = dict(lrs=tuple(0.01 * (i + 1) for i in range(n)),
                 wds=tuple(1e-3 * (i + 1) for i in range(n)),
                 rescale_grad=0.5, clip_gradient=0.2, num_weights=n)
    if "mom" in name:
        attrs["momentum"] = 0.9
    with jax.enable_x64(dtype == "float64"):
        want = getattr(jops, "_" + name)(*map(jnp.asarray, arrays), **attrs)
        want = [np.asarray(w) for w in want]
    got = get_op(name).fn(*map(_t, arrays), **attrs)
    assert len(got) == len(want) == get_op(name).nout(attrs) == n
    for i, (g, w) in enumerate(zip(got, want)):
        assert _kind(g) == _kind(w) == dtype
        _hold(g, w, dtype, f"{name} weight {i}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 3])
def test_preloaded_multi_sgd_and_lars_match_jax(n, dtype):
    arrays = _multi_inputs(n, 2, dtype, 10 + n)
    lrs = (0.01 * (np.arange(n) + 1)).astype(np.float32)
    wds = (1e-3 * (np.arange(n) + 1)).astype(np.float32)
    attrs = dict(rescale_grad=0.5, clip_gradient=0.2, num_weights=n)
    full = arrays + [lrs, wds]
    with jax.enable_x64(dtype == "float64"):
        want = jops._preloaded_multi_sgd_update(*map(jnp.asarray, full),
                                                **attrs)
        sums = jops._multi_sum_sq(*map(jnp.asarray, arrays[0::2]),
                                  num_arrays=n)
        gsums = jops._multi_sum_sq(*map(jnp.asarray, arrays[1::2]),
                                   num_arrays=n)
        wsq = jnp.concatenate(sums)
        gsq = jnp.concatenate(gsums)
        lars = jops._multi_lars(jnp.asarray(lrs), wsq, gsq, jnp.asarray(wds),
                                eta=0.01, eps=1e-8, rescale_grad=0.5)
    got = tops.preloaded_multi_sgd_update(*map(_t, full), **attrs)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _kind(g) == _kind(w)  # fp32 lrs promote a bf16 weight
        _hold(g, w, _kind(w), f"preloaded weight {i}")
    tsums = get_op("multi_sum_sq").fn(*map(_t, arrays[0::2]), num_arrays=n)
    tgsums = tops.multi_sum_sq(*map(_t, arrays[1::2]), num_arrays=n)
    assert len(tsums) == get_op("multi_sum_sq").nout({"num_arrays": n}) == n
    for a, b in zip(tsums + tgsums, list(sums) + list(gsums)):
        assert a.shape == (1,) and a.dtype == torch.float32
        _hold(a, b, "float32", "multi_sum_sq")
    tl = tops.multi_lars(_t(lrs), torch.cat(tsums), torch.cat(tgsums),
                         _t(wds), eta=0.01, eps=1e-8, rescale_grad=0.5)
    _hold(tl, lars, "float32", "multi_lars")
    # a layer whose weights are all zero keeps its lr
    zero = tops.multi_lars(_t(lrs), torch.zeros(n), torch.cat(tgsums),
                           _t(wds))
    assert torch.equal(zero, _t(lrs))


def test_every_update_op_is_registered_with_the_jax_attributes():
    from mxnet_tpu.ops.registry import get_op as jget_op

    names = sorted(OPS) + sorted(MULTI) + [
        "lamb_update_phase2", "adagrad_update", "_sparse_adagrad_update",
        "preloaded_multi_sgd_update", "multi_sum_sq", "multi_lars"]
    assert len(set(names)) == 19
    for name in names:
        t, j = get_op(name), jget_op(name)
        assert set(t.attr_defaults) == set(j.attr_defaults), name
        for k, v in j.attr_defaults.items():
            assert t.attr_defaults[k] == v, (name, k)
        assert t.differentiable == j.differentiable, name


# ---------------------------------------------------------------------------
# the optimizers: eager and fused against the JAX package's
# ---------------------------------------------------------------------------

def test_every_registered_optimizer_has_a_parity_case():
    """The port registers what the JAX package registers, and CASES
    names every one of them."""
    assert set(topt.optimizer._REG) == set(jopt._REG.list())
    assert {n for n, _ in CASES} >= set(topt.optimizer._REG)


def _opt_kwargs(kwargs, mp=False):
    return dict(kwargs, rescale_grad=0.5, wd=kwargs.get("wd", 0.01),
                multi_precision=mp)


def _inputs(dtype, through=None):
    """Weights and the gradients of STEPS steps (numpy, the JAX test's
    seeds), rounded to ``through`` first when given."""
    np_dt = _np_dtype(dtype)
    rnd = (lambda a: a.astype(_np_dtype(through)).astype(np_dt)) \
        if through else (lambda a: a.astype(np_dt))
    rs = np.random.RandomState(0)
    w0 = [rnd(rs.randn(*s)) for s in SHAPES]
    grads = [[rnd(np.random.RandomState(1000 + st).randn(*s))
              for s in SHAPES] for st in range(STEPS)]
    return w0, grads


def _flat(s):
    if s is None:
        return []
    if isinstance(s, (tuple, list)):
        return [x for v in s for x in _flat(v)]
    return [s]


def _jax_run(name, kwargs, dtype, mp, through=None):
    w0, grads = _inputs(dtype, through)
    if name == "nag" and mp:
        # the JAX NAG runs SGD's momentum update on its master copy (it
        # inherits SGD._update_mp); the port runs NAG's there (ROADMAP
        # §C), which is the JAX NAG on the fp32 values the master holds
        w, s, _ = _jax_run(name, kwargs, "float32", False, dtype)
        return w, [si + [wi] for si, wi in zip(s, w)], \
            _jax_run("sgd", kwargs, dtype, mp)[2]
    jdt = "bfloat16" if dtype == "bfloat16" else dtype
    with jax.enable_x64(dtype == "float64"):
        upd = jopt.Updater(jopt.create(name, **_opt_kwargs(kwargs, mp)))
        ws = [mx.nd.array(a, dtype=jdt) for a in w0]
        for g in grads:
            for i, (w, a) in enumerate(zip(ws, g)):
                upd(i, mx.nd.array(a, dtype=jdt), w)
        return ([w.asnumpy() for w in ws],
                [[x.asnumpy() for x in _flat(upd.states[i])]
                 for i in range(len(ws))], upd.get_states())


def _port_run(name, kwargs, dtype, mp, fused):
    w0, grads = _inputs(dtype)
    upd = topt.FusedUpdater(topt.create(name, **_opt_kwargs(kwargs, mp)))
    ws = [mt.nd.NDArray(_t(a)) for a in w0]
    idx = list(range(len(ws)))
    for g in grads:
        gs = [mt.nd.NDArray(_t(a)) for a in g]
        if fused:
            upd.update_all(idx, gs, ws)
        else:
            for i, w, gg in zip(idx, ws, gs):
                upd(i, gg, w)
    return ([w._data for w in ws],
            [[x._data for x in _flat(upd.states[i])] for i in idx],
            upd.get_states(), upd)


def _same_payload_shape(a, b):
    """Two get_states payloads: the same indices, nesting, dtypes and
    shapes."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same_payload_shape(a[k], b[k])
    elif isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_payload_shape(x, y)
    elif a is None:
        assert b is None
    else:
        assert a.dtype == b.dtype and a.shape == b.shape


@pytest.mark.parametrize("dtype", ["float32", "float64", "bf16-mp"])
@pytest.mark.parametrize("name,kwargs", CASES, ids=IDS)
def test_eager_and_fused_updates_match_jax(name, kwargs, dtype):
    mp = dtype == "bf16-mp"
    dt = "bfloat16" if mp else dtype
    jw, js, jbytes = _jax_run(name, kwargs, dt, mp)
    eager = _port_run(name, kwargs, dt, mp, fused=False)
    fused = _port_run(name, kwargs, dt, mp, fused=True)
    hold_dt = "float32" if mp else dtype
    for i in range(len(SHAPES)):
        assert len(eager[1][i]) == len(js[i]), (name, i)
        for a, b in zip(eager[1][i], js[i]):
            _hold(a, b, hold_dt, f"{name} state {i}", F64_ULPS)
        if mp:  # the bf16 weight is its fp32 master rounded
            assert eager[1][i][-1].dtype == torch.float32
            assert torch.equal(eager[0][i],
                               eager[1][i][-1].to(torch.bfloat16))
        else:
            _hold(eager[0][i], jw[i], hold_dt, f"{name} weight {i}",
                  F64_ULPS)
    _same_payload_shape(pickle.loads(eager[2]), pickle.loads(jbytes))
    # the fused update is the eager loop, bit for bit
    for a, b in zip(eager[0] + sum(eager[1], []),
                    fused[0] + sum(fused[1], [])):
        assert torch.equal(a, b), name
    assert eager[2] == fused[2]


T_HYPER = {"adamax", "nadam", "lamb"}


@pytest.mark.parametrize("name,kwargs", CASES, ids=IDS)
def test_fused_bf16_without_a_master_is_the_eager_loop(name, kwargs):
    """bf16 weights without multi_precision: the fused update gives the
    eager loop's bits, except where the update depends on t, which
    raises FusedUnsupported in both packages before changing anything."""
    if name in T_HYPER:
        w0, grads = _inputs("bfloat16")
        for pkg, fused_mod, arr in (
                (topt, topt, lambda a: mt.nd.NDArray(_t(a))),
                (jopt, jfused, lambda a: mx.nd.array(a, dtype="bfloat16"))):
            upd = fused_mod.FusedUpdater(pkg.create(name, **_opt_kwargs(
                kwargs)))
            with pytest.raises(fused_mod.FusedUnsupported):
                upd.update_all(list(range(len(SHAPES))),
                               [arr(a) for a in grads[0]],
                               [arr(a) for a in w0])
        return
    eager = _port_run(name, kwargs, "bfloat16", False, fused=False)
    fused = _port_run(name, kwargs, "bfloat16", False, fused=True)
    for a, b in zip(eager[0] + sum(eager[1], []),
                    fused[0] + sum(fused[1], [])):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_fused_step_builds_once_for_a_new_rate():
    """A t-dependent optimizer's per-step factors and a new lr are host
    scalars: one build for four steps of LAMB."""
    from mxnet_tpu_torch.optimizer import fused as tfused

    s0 = tfused.compile_stats()["count"]
    w0, grads = _inputs("float32")
    opt = topt.create("lamb", learning_rate=0.01)
    upd = topt.FusedUpdater(opt)
    ws = [mt.nd.NDArray(_t(a)) for a in w0]
    for step in range(4):
        if step == 2:
            opt.set_learning_rate(0.002)
        upd.update_all(list(range(len(ws))),
                       [mt.nd.NDArray(_t(a)) for a in grads[step % STEPS]],
                       ws)
    assert tfused.compile_stats()["count"] - s0 == 1
    assert not topt.LAMB._FUSED_ELEMENTWISE and topt.Adam._FUSED_ELEMENTWISE


# ---------------------------------------------------------------------------
# SPMDTrainer's functional forms
# ---------------------------------------------------------------------------

FORMS = [("rmsprop", {}), ("rmsprop", {"centered": True}), ("adagrad", {}),
         ("signum", {"momentum": 0.9}), ("signsgd", {}), ("adadelta", {}),
         ("adamax", {}), ("ftrl", {})]


def _mlp(nn):
    net = nn.HybridSequential()
    net.add(nn.Dense(32, activation="relu", in_units=16),
            nn.Dense(10, in_units=32))
    return net


@pytest.mark.parametrize("name,kwargs", FORMS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(FORMS)])
def test_spmd_trainer_forms_match_jax(name, kwargs):
    rs = np.random.RandomState(7)
    x = rs.randn(8, 16).astype(np.float32)
    y = (np.arange(8) % 10).astype(np.int32)
    opt = dict(kwargs, learning_rate=0.01, wd=1e-3, clip_gradient=1.0)
    jnet = _mlp(jnn)
    jnet.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    jnet(mx.nd.array(x))
    params = jnet._collect_params_with_prefix()
    vals = {k: (0.3 * rs.randn(*p.shape)).astype(np.float32)
            for k, p in params.items()}
    for k, p in params.items():
        p.set_data(mx.nd.array(vals[k]))
    with jpar.make_mesh(dp=1):
        jtr = jpar.SPMDTrainer(jnet, jloss.SoftmaxCrossEntropyLoss(), name,
                               dict(opt))
        jl = [float(jtr.step(x, y).asnumpy()) for _ in range(3)]
    tnet = _mlp(tnn)
    tnet.initialize(ctx=CPU)
    load_numpy_params(tnet, vals)
    ttr = tpar.SPMDTrainer(tnet, tloss.SoftmaxCrossEntropyLoss(), name,
                           dict(opt), mesh=tpar.make_mesh(dp=1,
                                                          devices=[CPU]))
    tl = [float(ttr.step(torch.from_numpy(x), torch.from_numpy(y)))
          for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for k, p in params.items():
        want = np.asarray(jtr.params[p.name])
        got = tnet.state_dict(keep_vars=True)[k].detach().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(), err_msg=k)
        jst = [np.asarray(s) for s in jtr.opt_state[p.name]]
        assert len(ttr.opt_state[k]) == len(jst), k


@pytest.mark.parametrize("name", ["nadam", "lamb", "test"])
def test_optimizers_without_a_form_raise_as_in_jax(name):
    with pytest.raises(mx.base.MXNetError) as want:
        jpar.functional_optimizer(jopt.create(name))
    with pytest.raises(mt.MXNetError) as got:
        tpar.functional_optimizer(topt.create(name))
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Trainer.save_states across the packages
# ---------------------------------------------------------------------------

def _jax_trainer(name, kwargs, ws):
    params = []
    for i, w in enumerate(ws):
        p = JParameter(f"w{i}", shape=w.shape)
        p.initialize(ctx=[mx.cpu()])
        p.set_data(mx.nd.array(w))
        params.append(p)
    tr = mx.gluon.Trainer(params, name, dict(kwargs), fuse_step=False)
    return tr, params


def _port_trainer(name, kwargs, ws):
    params = []
    for i, w in enumerate(ws):
        p = mt.gluon.Parameter(f"w{i}", shape=w.shape)
        p.initialize(ctx=CPU)
        p.set_data(w)
        params.append(p)
    return mt.gluon.Trainer(params, name, dict(kwargs)), params


def _step(tr, params, grads, jax_side):
    for p, g in zip(params, grads):
        if jax_side:
            p.list_grad()[0]._data = mx.nd.array(g).data
        else:
            p.grad()._data.copy_(torch.from_numpy(g))
    tr.step(2)


@pytest.mark.parametrize("name,kwargs", CASES, ids=IDS)
def test_save_states_across_the_packages(name, kwargs, tmp_path):
    w0, grads = _inputs("float32")
    jtr, jp = _jax_trainer(name, kwargs, w0)
    ttr, tp = _port_trainer(name, kwargs, w0)
    for g in grads[:2]:
        _step(jtr, jp, g, True)
        _step(ttr, tp, g, False)
    jfile, tfile = str(tmp_path / "j.states"), str(tmp_path / "t.states")
    jtr.save_states(jfile)
    ttr.save_states(tfile)
    _same_payload_shape(pickle.load(open(tfile, "rb")),
                        pickle.load(open(jfile, "rb")))
    # each package continues from the other's file, from the other's
    # weights, one step with the same gradient
    jw = [p.data().asnumpy() for p in jp]
    tw = [p.data().asnumpy() for p in tp]
    jtr2, jp2 = _jax_trainer(name, kwargs, tw)
    ttr2, tp2 = _port_trainer(name, kwargs, jw)
    jtr2.load_states(tfile)
    ttr2.load_states(jfile)
    for tr, ps, side in ((jtr2, jp2, True), (ttr2, tp2, False),
                         (jtr, jp, True), (ttr, tp, False)):
        _step(tr, ps, grads[2], side)
    # the reloaded trainers restart their counts at t = 1, the first
    # ones go on at t = 3
    for ta, ja in ((tp2, jp2), (tp, jp)):
        for a, b in zip(ta, ja):
            _hold(a.data().asnumpy(), b.data().asnumpy(), "float32", name)
    jb, tb = jtr.optimizer_state_bytes(), ttr.optimizer_state_bytes()
    assert tb == jb and tb[1] == 1
