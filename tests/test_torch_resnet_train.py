"""mxnet_tpu_torch's training slice against the JAX package.

A narrow ResNet V1 is built in both packages with the same weights —
``resnet18_v1(classes=10)`` at 32x32 and
``ResNetV1(BottleneckV1, [1,1,1,1], [8,32,64,128,256])`` — and trained
two steps through ``make_mesh(dp=1)`` + ``SPMDTrainer`` with SGD
(momentum 0.9, wd 1e-4): op-granular, fused (MXNET_FUSED_CONVBN=1), and
fused with the fused backward (MXNET_FUSED_CONVBN_BWD=1, whose plain
version serves CPU tensors) against the JAX trainer op-granular and
fused.

The running means start warm (at the first batch's means, as in any
training past its first steps) and lr is 1e-3.  From cold statistics or
at lr 0.1 on these tiny batches, BatchNorm over a few samples amplifies
fp32 rounding so much that either package's second step moves away from
a float64 run of itself by percents; warm and at lr 1e-3 both packages
stay within ~1.4e-3 of it.

Tolerances (fp32): each step's loss rtol 1e-4; parameters and running
statistics rtol 1e-4 with atol 1e-4·max|tensor| + 1e-6 (the absolute
floor covers the gluon bottleneck's conv biases, whose gradient is
analytically zero behind BatchNorm and whose values are pure rounding
noise ~1e-8 in both packages); momentum rtol 1e-4 with atol
5e-3·max|tensor| + 1e-7 (momentum is the update itself: measured against
a float64 run of the same two steps, the JAX package's fp32 momentum is
off by up to 3.0e-3 of a tensor's largest element, the port's by
1.7e-5; the conv biases' momenta are rounding noise ~1e-9).

One bf16 step (fused, fused backward): the loss within 1e-2, and the
momentum of every weight (the step's gradient) within a relative L2 of
0.6 of the JAX package's.  At this size bf16 BatchNorm over 16 samples
puts either package's bf16 gradient 0.1-0.4 (relative L2) from an fp32
run of the same step, and the two frameworks round at different points
(eager PyTorch after every op, XLA after its fusions); the bound is
that spread with room, and catches a wrong or missing term.

Unit tests: sgd_mom_update on bf16 weights against the JAX functional
optimizer bit for bit (the promotion trap), the loss and its ops,
BatchNorm's train flag from the trace, the mesh, the optimizer registry.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import parallel as jpar
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon.model_zoo.vision import resnet as jres
from mxnet_tpu.optimizer import optimizer as jopt

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import ActiveTrace, load_numpy_params
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
from mxnet_tpu_torch.ops import fused_convbn as tfc

BATCH, SIZE, STEPS = 16, 32, 2
OPT = {"learning_rate": 1e-3, "momentum": 0.9, "wd": 1e-4}
ARCHS = {
    "resnet18": lambda r: r.get_resnet(1, 18, classes=10, layout="NHWC"),
    "bottleneck": lambda r: r.ResNetV1(r.BottleneckV1, [1, 1, 1, 1],
                                       [8, 32, 64, 128, 256], classes=10,
                                       layout="NHWC"),
}
# port mode -> (MXNET_FUSED_CONVBN, MXNET_FUSED_CONVBN_BWD)
MODES = {"unfused": ("0", "0"), "fused": ("1", "0"), "fused_bwd": ("1", "1")}


def _data(dtype=np.float32):
    x = np.random.RandomState(7).rand(BATCH, SIZE, SIZE, 3).astype(dtype)
    y = (np.arange(BATCH) % 10).astype(np.int32)
    return x, y


def _to_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def weights():
    """Per architecture: the JAX net's Xavier weights by structural name,
    with each running mean set to its layer's mean over the batch."""
    out = {}
    x, _ = _data()
    for arch, make in ARCHS.items():
        np.random.seed(0)
        mx.random.seed(0)
        net = make(jres)
        net.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
        net(mx.nd.array(x))
        vals = {k: p.data().asnumpy().copy()
                for k, p in net._collect_params_with_prefix().items()}
        # one float64 train forward from zero running means leaves
        # 0.1 x each layer's batch mean in them (momentum 0.9)
        warm = make(tres)
        warm.initialize(ctx=mt.cpu())
        load_numpy_params(warm, vals)
        warm.double()
        with torch.no_grad(), ActiveTrace(train=True):
            warm(torch.from_numpy(x).double())
        for k, v in warm.state_dict(keep_vars=True).items():
            if k.endswith("running_mean"):
                vals[k] = (v.numpy() / 0.1).astype(np.float32)
        out[arch] = vals
    return out


_JAX_RUNS = {}


def _jax_run(arch, vals, fused, dtype, steps, monkeypatch):
    """JAX SPMDTrainer: per-step losses, then params, running statistics
    and momentum by structural name (fp32 numpy)."""
    key = (arch, fused, dtype, steps)
    if key in _JAX_RUNS:
        return _JAX_RUNS[key]
    monkeypatch.setenv("MXNET_FUSED_CONVBN", "1" if fused else "0")
    x, y = _data()
    net = ARCHS[arch](jres)
    net.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    net(mx.nd.array(x))
    params = net._collect_params_with_prefix()
    for k, p in params.items():
        p.set_data(mx.nd.array(vals[k]))
    xin = x
    if dtype == "bfloat16":
        net.cast("bfloat16")
        xin = x.astype(ml_dtypes.bfloat16)
    with jpar.make_mesh(dp=1):
        tr = jpar.SPMDTrainer(net, jloss.SoftmaxCrossEntropyLoss(), "sgd",
                              dict(OPT))
        losses = [float(tr.step(xin, y).asnumpy()) for _ in range(steps)]
    f32 = lambda v: np.asarray(v).astype(np.float32)
    state = {k: f32(tr.params[p.name]) for k, p in params.items()}
    mom = {k: f32(tr.opt_state[p.name][0]) for k, p in params.items()
           if p.name in tr.opt_state}
    _JAX_RUNS[key] = (losses, state, mom)
    return _JAX_RUNS[key]


def _port_run(arch, vals, mode, dtype, steps, monkeypatch):
    fused, bwd = MODES[mode]
    monkeypatch.setenv("MXNET_FUSED_CONVBN", fused)
    monkeypatch.setenv("MXNET_FUSED_CONVBN_BWD", bwd)
    x, y = _data()
    net = ARCHS[arch](tres)
    net.initialize(ctx=mt.cpu())
    load_numpy_params(net, vals)
    xin = torch.from_numpy(x)
    if dtype == "bfloat16":
        net.cast("bfloat16")
        xin = xin.bfloat16()
    mesh = tpar.make_mesh(dp=1, devices=[mt.cpu()])
    tr = tpar.SPMDTrainer(net, tloss.SoftmaxCrossEntropyLoss(), "sgd",
                          dict(OPT), mesh=mesh)
    tfc.reset_launch_count()
    tfc.reset_bwd_launch_count()
    calls = []
    real = tfc.fused_conv_unit_bwd
    monkeypatch.setattr(tfc, "fused_conv_unit_bwd",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    losses = [float(tr.step(xin, y)) for _ in range(steps)]
    assert tfc.launch_count() == tfc.bwd_launch_count() == 0  # CPU
    state = {k: v.detach().float().numpy()
             for k, v in net.state_dict(keep_vars=True).items()}
    mom = {k: s[0].float().numpy() for k, s in tr.opt_state.items()}
    return losses, state, mom, len(calls)


# fused-unit backward calls per step that take the kernel's wrapper
# (stride-1 units; the strided ones keep the dgrad/wgrad convolutions)
STRIDE1_UNITS = {"resnet18": 11 + 8 - 3 - 3, "bottleneck": 16 - 6}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_spmd_trainer_matches_jax_two_steps_fp32(arch, mode, weights,
                                                 monkeypatch):
    vals = weights[arch]
    jl, js, jm = _jax_run(arch, vals, mode != "unfused", "float32", STEPS,
                          monkeypatch)
    tl, ts, tm, bwd_calls = _port_run(arch, vals, mode, "float32", STEPS,
                                      monkeypatch)
    assert bwd_calls == (STEPS * STRIDE1_UNITS[arch]
                         if mode == "fused_bwd" else 0)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert set(ts) == set(js) and set(tm) == set(jm)
    for k in js:
        np.testing.assert_allclose(
            ts[k], js[k], rtol=1e-4,
            atol=1e-4 * float(np.abs(js[k]).max()) + 1e-6, err_msg=k)
    for k in jm:
        np.testing.assert_allclose(
            tm[k], jm[k], rtol=1e-4,
            atol=5e-3 * float(np.abs(jm[k]).max()) + 1e-7,
            err_msg=f"mom {k}")


def test_spmd_trainer_matches_jax_one_step_bf16(weights, monkeypatch):
    arch = "bottleneck"
    vals = weights[arch]
    jl, _, jm = _jax_run(arch, vals, True, "bfloat16", 1, monkeypatch)
    tl, ts, tm, bwd_calls = _port_run(arch, vals, "fused_bwd", "bfloat16",
                                      1, monkeypatch)
    assert bwd_calls == STRIDE1_UNITS[arch]
    assert abs(tl[0] - jl[0]) <= 1e-2 * abs(jl[0])
    assert all(np.isfinite(v).all() for v in ts.values())
    for k in jm:
        if k.endswith("bias") and not jm[k].any():
            continue  # conv biases behind BatchNorm: no gradient
        err = np.linalg.norm(tm[k] - jm[k]) / np.linalg.norm(jm[k])
        assert err <= 0.6, f"{k}: momentum rel L2 {err:.3g}"


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("master", [False, True])
def test_sgd_mom_update_bf16_bit_for_bit(master):
    """bf16 weight and momentum, the fp32 lr of the SPMD step: the JAX
    functional optimizer promotes to fp32 and casts back; so must the
    port (PyTorch alone would stay in bf16 and differ)."""
    rs = np.random.RandomState(31)
    w = (rs.randn(257) * 0.5).astype(ml_dtypes.bfloat16)
    g = (rs.randn(257) * 2.0).astype(ml_dtypes.bfloat16)
    m = (rs.randn(257) * 0.01).astype(ml_dtypes.bfloat16)
    kw = dict(learning_rate=0.1, momentum=0.9, wd=1e-4,
              multi_precision=master)
    jfo = jpar.functional_optimizer(jopt.SGD(**kw))
    tfo = tpar.functional_optimizer(topt.SGD(**kw))
    jw, tw = jnp.asarray(w), _to_torch(w)
    js, ts = jfo.init(jw), tfo.init(tw)
    if not master:
        js, ts = (jnp.asarray(m),), (_to_torch(m),)
    for _ in range(3):
        jg, tg = jnp.asarray(g), _to_torch(g)
        if master:
            nw32, ns = jfo.apply(js[-1], jg, js[:-1],
                                 jnp.asarray(0.1, jnp.float32), 1)
            jw, js = nw32.astype(jw.dtype), ns + (nw32,)
            tw32, tns = tfo.apply(ts[-1], tg, ts[:-1], 0.1, 1)
            tw, ts = tw32.to(tw.dtype), tns + (tw32,)
        else:
            nw, ns = jfo.apply(jw, jg, js, jnp.asarray(0.1, jnp.float32), 1)
            assert nw.dtype == jnp.float32  # the promotion
            jw = nw.astype(jnp.bfloat16)
            js = tuple(s.astype(jnp.bfloat16) for s in ns)
            tnw, tns = tfo.apply(tw, tg, ts, 0.1, 1)
            assert tnw.dtype == torch.float32
            tw = tnw.to(torch.bfloat16)
            ts = tuple(s.to(torch.bfloat16) for s in tns)
        np.testing.assert_array_equal(
            tw.view(torch.int16).numpy(),
            np.asarray(jw).view(np.int16))
        for a, b in zip(ts, js):
            np.testing.assert_array_equal(a.float().numpy(),
                                          np.asarray(b, np.float32))


@pytest.mark.parametrize("momentum", [False, True])
def test_mp_sgd_ops_match_jax_bit_for_bit(momentum):
    """The multi-precision ops: fp32 master math, the bf16 weight cast
    from it."""
    from mxnet_tpu.ops import optimizer_ops as joo

    rs = np.random.RandomState(36)
    w32 = (rs.randn(129) * 0.5).astype(np.float32)
    w = w32.astype(ml_dtypes.bfloat16)
    g = (rs.randn(129) * 2.0).astype(ml_dtypes.bfloat16)
    m = (rs.randn(129) * 0.01).astype(np.float32)
    kw = dict(lr=0.1, wd=1e-4, clip_gradient=3.0)
    if momentum:
        ref = joo._mp_sgd_mom_update(jnp.asarray(w), jnp.asarray(g),
                                     jnp.asarray(m), jnp.asarray(w32),
                                     momentum=0.9, **kw)
        got = mt.ops.mp_sgd_mom_update(_to_torch(w), _to_torch(g),
                                       torch.from_numpy(m),
                                       torch.from_numpy(w32), momentum=0.9,
                                       **kw)
    else:
        ref = joo._mp_sgd_update(jnp.asarray(w), jnp.asarray(g),
                                 jnp.asarray(w32), **kw)
        got = mt.ops.mp_sgd_update(_to_torch(w), _to_torch(g),
                                   torch.from_numpy(w32), **kw)
    assert got[0].dtype == torch.bfloat16
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b).astype(np.float32))


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("name", ["sgd", "nag"])
def test_functional_optimizer_fp32_matches_jax(name, momentum):
    rs = np.random.RandomState(32)
    w, g, m = (rs.randn(64).astype(np.float32) for _ in range(3))
    kw = dict(learning_rate=0.05, momentum=momentum, wd=1e-3,
              clip_gradient=1.5)
    jfo = jpar.functional_optimizer(jopt.create(name, **kw))
    tfo = tpar.functional_optimizer(topt.create(name, **kw))
    st_j = (jnp.asarray(m),) if momentum else ()
    st_t = (torch.from_numpy(m),) if momentum else ()
    jw, js = jfo.apply(jnp.asarray(w), jnp.asarray(g), st_j,
                       jnp.asarray(0.05, jnp.float32), 1)
    tw, ts = tfo.apply(torch.from_numpy(w), torch.from_numpy(g), st_t, 0.05,
                       1)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_optimizer_registry_and_learning_rate():
    opt = topt.create("SGD", learning_rate=0.5, momentum=0.9)
    assert isinstance(opt, topt.SGD) and topt.create(opt) is opt
    opt.set_learning_rate(0.25)
    assert opt.learning_rate == 0.25
    sched = lambda n: 1.0 / (n + 1)
    opt = topt.create("sgd", learning_rate=1.0, lr_scheduler=sched)
    opt._update_count(0)
    opt._update_count(0)
    assert opt.num_update == 2 and opt.learning_rate == pytest.approx(1 / 3)
    with pytest.raises(MXNetError):
        topt.create("rmsprop")
    with pytest.raises(MXNetError):
        tpar.functional_optimizer(topt.Optimizer())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_ce_loss_matches_jax(dtype):
    rs = np.random.RandomState(33)
    pred = (rs.randn(6, 10) * 3).astype(np.float32)
    label = np.array([0, 3, 9, 12, -2, 5], np.float32)  # clipped into range
    sw = rs.rand(6, 1).astype(np.float32)
    jp, tp = mx.nd.array(pred), torch.from_numpy(pred)
    if dtype == "bfloat16":
        jp = jp.astype("bfloat16")
        tp = tp.bfloat16()
    jl = jloss.SoftmaxCrossEntropyLoss(weight=0.5)(
        jp, mx.nd.array(label), mx.nd.array(sw))
    tl = tloss.SoftmaxCrossEntropyLoss(weight=0.5)(
        tp, torch.from_numpy(label), torch.from_numpy(sw))
    assert tuple(tl.shape) == (6,)
    tol = 1e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(tl.float().numpy(),
                               jl.asnumpy().astype(np.float32), rtol=tol,
                               atol=tol)


def test_softmax_ce_loss_dense_labels_and_from_logits():
    """Dense labels (the JAX package's own dense path calls an op it does
    not register, so the reference here is the formula) and
    from_logits."""
    rs = np.random.RandomState(35)
    pred = rs.randn(4, 3, 5).astype(np.float32)
    label = rs.rand(4, 3, 5).astype(np.float32)
    logp = pred - np.log(np.exp(pred).sum(-1, keepdims=True))
    want = (-(logp * label).sum(-1)).mean(-1)
    got = tloss.SoftmaxCrossEntropyLoss(sparse_label=False)(
        torch.from_numpy(pred), torch.from_numpy(label))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    got = tloss.SoftmaxCrossEntropyLoss(from_logits=True)(
        torch.from_numpy(logp[:, 0]), torch.tensor([4, 0, 2, 1]))
    np.testing.assert_allclose(got.numpy(),
                               -logp[np.arange(4), 0, [4, 0, 2, 1]],
                               rtol=1e-6)
    with pytest.raises(MXNetError):
        mt.ops.pick(torch.zeros(2, 3), torch.zeros(2), mode="wrap")


def test_batch_norm_follows_the_trace_train_flag():
    """Eval mode outside a trace uses the moving statistics; a trace with
    train=True (as SPMDTrainer opens) uses the batch's and updates them,
    whatever the module's mode — as the JAX package's BatchNorm does."""
    bn = tnn.BatchNorm(axis=3, in_channels=4)
    bn.initialize(ctx=mt.cpu())
    bn.eval()
    x = torch.from_numpy(
        np.random.RandomState(34).randn(2, 3, 3, 4).astype(np.float32) + 5)
    out = bn(x)
    torch.testing.assert_close(out, x / np.sqrt(1 + 1e-5))
    assert not bn.running_mean.any()
    with ActiveTrace(train=True):
        out = bn(x)
    assert abs(float(out.mean())) < 1e-4
    torch.testing.assert_close(bn.running_mean, 0.1 * x.mean(dim=(0, 1, 2)))
    bn.train()
    with ActiveTrace(train=False):
        out = bn(x)
    torch.testing.assert_close(out, (x - bn.running_mean) / torch.sqrt(
        bn.running_var + 1e-5))


def test_mesh_is_one_device_and_a_scope(monkeypatch):
    cpu = [mt.cpu()]
    mesh = tpar.make_mesh(dp=1, devices=cpu)
    assert mesh.devices == [torch.device("cpu")] and mesh.size() == 1
    assert tpar.current_mesh() is None
    with mesh:
        assert tpar.current_mesh() is mesh and tpar.get_mesh() is mesh
    assert tpar.current_mesh() is None
    with pytest.raises(MXNetError, match="process group"):
        tpar.make_mesh(dp=2, devices=cpu * 2)
    with pytest.raises(MXNetError):
        tpar.make_mesh(xx=1, devices=cpu)
    with pytest.raises(MXNetError):
        tpar.get_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        tpar.make_mesh(dp=1)


def test_trainer_surface(weights, monkeypatch):
    """learning_rate, set_learning_rate, forward (moving statistics),
    sync_to_block (nothing to copy), and a 0-d loss on the device."""
    monkeypatch.setenv("MXNET_FUSED_CONVBN", "1")
    net = ARCHS["bottleneck"](tres)
    net.initialize(ctx=mt.cpu())
    load_numpy_params(net, weights["bottleneck"])
    x, y = _data()
    with tpar.make_mesh(dp=1, devices=[mt.cpu()]):
        tr = tpar.SPMDTrainer(net, tloss.SoftmaxCrossEntropyLoss(), "sgd",
                              dict(OPT))
    assert tr.learning_rate == OPT["learning_rate"]
    tr.set_learning_rate(0.0)
    before = {k: v.detach().clone()
              for k, v in net.state_dict(keep_vars=True).items()}
    loss = tr.step(x, y)
    assert loss.dim() == 0 and not loss.requires_grad
    after = net.state_dict(keep_vars=True)
    for k, v in before.items():
        if "running" in k:
            continue
        # lr 0: only weight decay's lr*wd*w = 0 moves nothing
        torch.testing.assert_close(after[k].detach(), v, rtol=0, atol=0)
    tr.sync_to_block()
    net.eval()
    with torch.no_grad(), ActiveTrace(train=False):
        want = net(torch.from_numpy(x))
    torch.testing.assert_close(tr.forward(x), want)
    with pytest.raises(MXNetError):
        tpar.SPMDTrainer(net, tloss.SoftmaxCrossEntropyLoss(),
                         topt.SGD(), {"learning_rate": 0.1},
                         mesh=tpar.make_mesh(dp=1, devices=[mt.cpu()]))
