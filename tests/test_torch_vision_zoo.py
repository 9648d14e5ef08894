"""The port's vision model zoo against the JAX package's, on the CPU.

* For all 34 names of ``vision._models``: the structural parameter
  names equal the JAX net's, and every dim the JAX net knows before its
  first forward (a deferred input width is 0 there) equals the port's.
* One member of each family (ResNet V2 basic and bottleneck, NCHW and
  NHWC; VGG-11 with BatchNorm; AlexNet; SqueezeNet 1.0 and 1.1;
  DenseNet; Inception V3), fp32, batch 2 (Inception batch 1 at 299²,
  the smallest input it takes), weights carried across by name: the
  eval forward from the initial running statistics, a training forward
  (batch statistics, running statistics updated) and an eval forward
  after it (Inception the eval forward only: its JAX forward on the CPU
  takes about 20 s a mode).  Dropout is set to 0 in both nets (the two packages' random
  streams differ).  DenseNet runs a narrow ``DenseNet(8, 4, [2, 2])``
  through the same class, since densenet121's JAX forward on the CPU
  takes about half a minute.
* ``build(net._arch)`` rebuilds every zoo network with the same
  parameter names and shapes.

Tolerance (fp32): outputs and running statistics within 1e-4 of the
largest |JAX value| of the tensor plus 1e-6 (PyTorch and XLA sum the
convolutions in different orders; through up to 94 layers the logits
agree to ~1e-5 of their scale).
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.gluon.model_zoo.vision import resnet as jres
from mxnet_tpu.gluon.model_zoo.vision import densenet as jdense

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.gluon import load_numpy_params
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
from mxnet_tpu_torch.gluon.model_zoo.vision import densenet as tdense

TOL = 1e-4

# family -> (constructor over a vision module (resnet, densenet), input)
FAMILIES = {
    "resnet18_v2": (lambda v, r, d: v.get_model("resnet18_v2", classes=10),
                    (2, 3, 64, 64)),
    "resnet_v2_bottleneck": (
        lambda v, r, d: r.ResNetV2(r.BottleneckV2, [1, 1, 1, 1],
                                   [8, 32, 64, 128, 256], classes=10),
        (2, 3, 64, 64)),
    "resnet18_v2_thumbnail_nhwc": (
        lambda v, r, d: v.get_model("resnet18_v2", classes=10,
                                    thumbnail=True, layout="NHWC"),
        (2, 16, 16, 3)),
    "vgg11_bn": (lambda v, r, d: v.get_model("vgg11_bn", classes=10),
                 (2, 3, 64, 64)),
    "alexnet": (lambda v, r, d: v.get_model("alexnet", classes=10),
                (2, 3, 64, 64)),
    # 65: the first pool's full convention gives 15 windows (floor: 14)
    "squeezenet1.0": (lambda v, r, d: v.get_model("squeezenet1.0",
                                                  classes=10),
                      (2, 3, 65, 65)),
    "squeezenet1.1": (lambda v, r, d: v.get_model("squeezenet1.1",
                                                  classes=10),
                      (2, 3, 64, 64)),
    "densenet_narrow": (lambda v, r, d: d.DenseNet(8, 4, [2, 2], classes=10),
                        (2, 3, 56, 56)),
    "inceptionv3": (lambda v, r, d: v.get_model("inceptionv3", classes=10),
                    (1, 3, 299, 299)),
}
# families held in eval mode only: Inception's JAX forward on the CPU
# takes about 20 s a mode (its BatchNorm in training is the layer the
# other families hold)
EVAL_ONLY = {"inceptionv3"}


def _no_dropout(net, attr):
    for blk in attr(net):
        if type(blk).__name__ == "Dropout":
            blk._rate = 0.0


def _jax_blocks(b):
    yield b
    for c in b._children.values():
        yield from _jax_blocks(c)


def hold(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = TOL * np.abs(want).max(initial=0.0) + 1e-6
    err = np.abs(got - want).max(initial=0.0)
    assert err <= bound, f"{what}: {err:.3g} > {bound:.3g}"


def _running(vals):
    return {k: v for k, v in vals.items() if k.endswith(("running_mean",
                                                         "running_var"))}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_forward_matches_jax(family):
    make, shape = FAMILIES[family]
    x = np.random.RandomState(3).standard_normal(shape).astype(np.float32)
    np.random.seed(0)
    mx.random.seed(0)
    jnet = make(jvision, jres, jdense)
    jnet.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    _no_dropout(jnet, _jax_blocks)
    jx = mx.nd.array(x)
    j_eval0 = jnet(jx).asnumpy()  # resolves the deferred widths
    jparams = jnet._collect_params_with_prefix()
    vals = {k: p.data().asnumpy().copy() for k, p in jparams.items()}

    tnet = make(tvision, tres, tdense)
    tnet.initialize(ctx=mt.cpu())
    _no_dropout(tnet, lambda n: n.modules())
    tx = mt.nd.array(x, ctx=mt.cpu())
    tnet(tx)  # resolves the port's deferred widths
    load_numpy_params(tnet, vals)
    hold(tnet(tx).asnumpy(), j_eval0, f"{family} eval")
    if family in EVAL_ONLY:
        return

    with mx.autograd.record():
        j_train = jnet(jx).asnumpy()
    with mt.autograd.record():
        t_train = tnet(tx).asnumpy()
    hold(t_train, j_train, f"{family} train")
    jrun = _running({k: p.data().asnumpy() for k, p in jparams.items()})
    trun = _running({k: v.detach().numpy()
                     for k, v in tnet.state_dict().items()})
    assert sorted(jrun) == sorted(trun)
    for k in jrun:
        hold(trun[k], jrun[k], f"{family} {k}")
    hold(tnet(tx).asnumpy(), jnet(jx).asnumpy(), f"{family} eval after")


def _port_shapes(net):
    return {k: tuple(v.shape) for k, v in net.state_dict().items()}


@pytest.mark.parametrize("name", sorted(jvision._models))
def test_parameter_names_and_shapes_match_jax(name):
    """Before any forward: the same structural names, and every dim the
    JAX net knows (a deferred width is 0 there) equal to the port's; a
    dim the port defers is one the JAX net defers too."""
    assert name in tvision._models
    jnet = jvision.get_model(name, classes=10)
    tnet = tvision.get_model(name, classes=10)
    js = {k: tuple(p.shape) for k, p in
          jnet._collect_params_with_prefix().items()}
    ts = _port_shapes(tnet)
    assert sorted(js) == sorted(ts), name
    for k, jshape in js.items():
        assert len(ts[k]) == len(jshape), (name, k, ts[k], jshape)
        for jd, td in zip(jshape, ts[k]):
            assert jd == td or jd == 0, (name, k, ts[k], jshape)


def test_the_zoos_have_the_same_names():
    assert sorted(tvision._models) == sorted(jvision._models)
    assert len(tvision._models) == 34


@pytest.mark.parametrize("name", sorted(tvision._models))
def test_build_round_trips(name):
    net = tvision.get_model(name, classes=7)
    again = tvision.build(net._arch)
    assert type(again) is type(net)
    assert _port_shapes(again) == _port_shapes(net)


def test_resnet_v2_stem_batchnorm_is_not_trained():
    """The V2 stem's BatchNorm(scale=False, center=False): gamma and beta
    exist (the JAX names) and take no gradient, as ``grad_req="null"``
    there; the trainable sets of the two packages agree."""
    tnet = tvision.get_model("resnet50_v2")
    jnet = jvision.get_model("resnet50_v2")
    sd = tnet.state_dict(keep_vars=True)
    assert not sd["features.0.gamma"].requires_grad
    assert not sd["features.0.beta"].requires_grad
    t_trained = sorted(k for k, v in sd.items()
                       if getattr(v, "requires_grad", False))
    j_trained = sorted(k for k, p in
                       jnet._collect_params_with_prefix().items()
                       if p.grad_req != "null")
    assert t_trained == j_trained


def test_resnet_v2_serves_through_export_model(tmp_path):
    """export_model -> ModelRepository -> InferenceServer on the CPU
    for a ResNet V2 and a VGG (whose Dense widths are deferred)."""
    import torch

    from mxnet_tpu_torch.contrib import deploy
    from mxnet_tpu_torch import serving

    x = np.random.RandomState(1).standard_normal(
        (2, 3, 32, 32)).astype(np.float32)
    for name in ("resnet18_v2", "vgg11"):
        net = tvision.get_model(name, classes=5)
        net.initialize(mt.initializer.Xavier(), ctx=mt.cpu())
        net.hybridize()
        net.eval()
        with torch.no_grad():
            want = net(torch.from_numpy(x)).numpy()
        path = deploy.export_model(net, str(tmp_path / name),
                                   [torch.from_numpy(x[:1])],
                                   dynamic_batch=True)
        repo = serving.ModelRepository(ctx=mt.cpu())
        repo.add(name, path)
        server = serving.InferenceServer(
            repo, serving.ServingConfig(max_batch_size=2,
                                        batch_timeout_ms=50))
        try:
            got = [server.infer(name, [torch.from_numpy(x[i:i + 1])])
                   for i in range(2)]
        finally:
            server.shutdown(drain=True)
        for i, g in enumerate(got):
            hold(g.numpy(), want[i:i + 1], f"{name} served {i}")
