"""The compiled step of mxnet_tpu_torch (``_graphs``' cache behind
``SPMDTrainer.step`` and the hybridized forward) against the JAX package,
on the CPU.  CPU entries run eagerly through the same cache as the CUDA
graphs, so the cache's logic is held here; ``chip_smoke.py`` holds the
graphs' bits on the card.

* The JAX package's cache behaviour: one sequence of steps on a small
  MLP, batch shapes A, A, B, A, with ``set_learning_rate`` between the
  second and the third, through both packages' ``SPMDTrainer`` (SGD with
  momentum, wd): each builds 2 entries (``step_compile_stats``), none
  after the lr change, and the losses agree to 1e-6 relative, the
  parameters and momenta to 1e-5 relative + 1e-6 of the tensor's
  largest magnitude (fp32).
* lr and t as the step's 0-d device tensors give the bits of the Python
  float and int the eager step passed before: SGD, NAG and Adam, fp32
  and bf16, with and without mults, three applications (bit for bit).
* Each parameter's ``lr_mult``/``wd_mult`` (``wd_mult = 0`` on the
  biases, ``lr_mult = 0.5`` on the first weight): SGD with momentum and
  Adam, three steps through both packages' ``SPMDTrainer`` (the
  tolerances above) and through the port's ``gluon.Trainer`` against
  the port's ``SPMDTrainer`` (the same bounds: the summed loss rescaled
  by 1/8 against the mean loss, and Adam's bias correction folded on the
  host against on the device).
* The returned loss is a fresh tensor: step 1's value is unchanged
  after step 2.
* Stale addresses: ``load_parameters`` or a ``cast`` round trip between
  two steps builds a new entry (counted, and the stale one evicted), and
  the step equals the step of a twin net that was not touched, bit for
  bit.
* The hybridized inference forward (the port's ``CachedOp``): one build
  per input shape (4, 4, 8, 4 builds 2), none under
  ``autograd.record()`` or in training through the trainer, outputs
  equal to the block's forward without ``hybridize()`` and within 1e-6
  relative of the JAX package's hybridized forward, fresh tensors each
  call; the NDArray entry point outside ``record()`` takes the same
  cache; ``MXNET_FUSED_CACHE_MAX`` evicts the least recently used entry.
* The launch tally: a capture's launches go to its tally, and a replay
  adds them to the counters.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import parallel as jpar
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.parallel import spmd as jspmd

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _graphs, _kernels
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.gluon import block as tblock
from mxnet_tpu_torch.gluon import load_numpy_params
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.parallel import spmd as tspmd

CPU = mt.cpu()
OPTS = {"sgd": dict(learning_rate=0.05, momentum=0.9, wd=1e-3),
        "adam": dict(learning_rate=0.01, wd=1e-3)}


def _mlp(nn, **kw):
    net = nn.HybridSequential()
    net.add(nn.Dense(32, activation="relu", **kw.get("a", {})),
            nn.Dense(10, **kw.get("b", {})))
    return net


def _data(n, seed=7):
    rs = np.random.RandomState(seed)
    return rs.randn(n, 16).astype(np.float32), \
        (np.arange(n) % 10).astype(np.int32)


def _values():
    rs = np.random.RandomState(3)
    shapes = {"0.weight": (32, 16), "0.bias": (32,), "1.weight": (10, 32),
              "1.bias": (10,)}
    return {k: (0.3 * rs.randn(*s)).astype(np.float32)
            for k, s in shapes.items()}


def _jax_net(vals, mults=False):
    net = _mlp(jnn)
    net.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    net(mx.nd.zeros((1, 16)))
    params = net._collect_params_with_prefix()
    for k, p in params.items():
        p.set_data(mx.nd.array(vals[k]))
        if mults:
            _set_mults(k, p)
    return net, params


def _port_net(vals, mults=False):
    net = _mlp(tnn, a={"in_units": 16}, b={"in_units": 32})
    net.initialize(ctx=CPU)
    load_numpy_params(net, vals)
    if mults:
        for k, p in net.collect_params().items():
            _set_mults(k, p)
    net.hybridize()
    return net


def _set_mults(name, p):
    if name.endswith("bias"):
        p.wd_mult = 0.0
    if name == "0.weight":
        p.lr_mult = 0.5


def _close(got, want, what):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max(), err_msg=what)


def _port_trainer(net, opt):
    return tpar.SPMDTrainer(net, tloss.SoftmaxCrossEntropyLoss(), opt,
                            dict(OPTS[opt]),
                            mesh=tpar.make_mesh(dp=1, devices=[CPU]))


def _check_against_jax(jtr, jparams, tnet, ttr, opt):
    tp = tnet.state_dict(keep_vars=True)
    for k, p in jparams.items():
        _close(tp[k].detach().numpy(), np.asarray(jtr.params[p.name]), k)
        for i in range(len(ttr.opt_state[k])):
            _close(ttr.opt_state[k][i].numpy(),
                   np.asarray(jtr.opt_state[p.name][i]), f"state {i} {k}")


def test_step_cache_builds_as_the_jax_package():
    vals = _values()
    seq = [_data(8, 1), _data(8, 2), _data(4, 3), _data(8, 4)]
    jnet, jparams = _jax_net(vals)
    j0 = jspmd.step_compile_stats()["count"]
    jl = []
    with jpar.make_mesh(dp=1):
        jtr = jpar.SPMDTrainer(jnet, jloss.SoftmaxCrossEntropyLoss(), "sgd",
                               dict(OPTS["sgd"]))
        for i, (x, y) in enumerate(seq):
            if i == 2:
                jtr.set_learning_rate(0.02)
            jl.append(float(jtr.step(x, y).asnumpy()))
    j_built = jspmd.step_compile_stats()["count"] - j0
    tnet = _port_net(vals)
    ttr = _port_trainer(tnet, "sgd")
    t0 = tspmd.step_compile_stats()
    tl, built = [], []
    for i, (x, y) in enumerate(seq):
        if i == 2:
            ttr.set_learning_rate(0.02)
        tl.append(float(ttr.step(torch.from_numpy(x), torch.from_numpy(y))))
        built.append(tspmd.step_compile_stats()["count"] - t0["count"])
    assert j_built == 2
    assert built == [1, 1, 2, 2]  # no build on the lr change, B once
    assert tspmd.step_compile_stats()["evictions"] == t0["evictions"]
    assert len(ttr.graphs()) == 2
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    _check_against_jax(jtr, jparams, tnet, ttr, "sgd")


@pytest.mark.parametrize("opt", ["sgd", "nag", "adam"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mults", [(1.0, 1.0), (0.5, 0.0)])
def test_lr_and_t_tensors_give_the_float_bits(opt, dtype, mults):
    kw = dict(learning_rate=0.01, wd=1e-3)
    if opt != "adam":
        kw["momentum"] = 0.9
    fo = tpar.functional_optimizer(mt.optimizer.create(opt, **kw))
    gen = torch.Generator().manual_seed(5)
    w0 = torch.randn(64, 33, generator=gen).to(dtype)
    grads = [torch.randn(64, 33, generator=gen).to(dtype) for _ in range(3)]
    runs = []
    for as_tensor in (False, True):
        w, state = w0.clone(), fo.init(w0)
        lr_buf = torch.zeros((), dtype=torch.float32)
        t_buf = torch.zeros((), dtype=torch.int32)
        for t, g in enumerate(grads, 1):
            fo.begin_step()
            if as_tensor:
                lr_buf.fill_(0.01)
                t_buf.fill_(t)
                lr, tt = lr_buf, t_buf
            else:
                lr, tt = 0.01, t
            nw, ns = fo.apply(w, g, state, lr, tt, lr_mult=mults[0],
                              wd_mult=mults[1])
            w = nw.to(dtype)
            state = tuple(v.to(s.dtype) for s, v in zip(state, ns))
        runs.append((w, state))
    (wa, sa), (wb, sb) = runs
    assert torch.equal(wa, wb)
    assert all(torch.equal(a, b) for a, b in zip(sa, sb))


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_lr_mult_and_wd_mult_match_jax(opt):
    vals = _values()
    x, y = _data(8)
    jnet, jparams = _jax_net(vals, mults=True)
    with jpar.make_mesh(dp=1):
        jtr = jpar.SPMDTrainer(jnet, jloss.SoftmaxCrossEntropyLoss(), opt,
                               dict(OPTS[opt]))
        jl = [float(jtr.step(x, y).asnumpy()) for _ in range(3)]
    tnet = _port_net(vals, mults=True)
    ttr = _port_trainer(tnet, opt)
    tl = [float(ttr.step(torch.from_numpy(x), torch.from_numpy(y)))
          for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    _check_against_jax(jtr, jparams, tnet, ttr, opt)
    # the port's gluon.Trainer takes the same mults
    gnet = _port_net(vals, mults=True)
    params = gnet.collect_params()
    gtr = mt.gluon.Trainer(params, opt, dict(OPTS[opt]))
    lf = tloss.SoftmaxCrossEntropyLoss()
    xs, ys = mt.nd.array(x, ctx=CPU), mt.nd.array(y, ctx=CPU)
    for _ in range(3):
        with mt.autograd.record():
            loss = lf(gnet(xs), ys)
        loss.backward()
        gtr.step(8)
    tp = tnet.state_dict(keep_vars=True)
    for k, p in params.items():
        _close(p.data().asnumpy(), tp[k].detach().numpy(), k)
    # and the mults took: wd off the biases, half the lr on 0.weight
    plain = _port_net(vals)
    ptr = _port_trainer(plain, opt)
    for _ in range(3):
        ptr.step(torch.from_numpy(x), torch.from_numpy(y))
    pp = plain.state_dict(keep_vars=True)
    moved = {k: float((tp[k].detach() - torch.from_numpy(vals[k])).abs()
                      .max()) for k in vals}
    moved_plain = {k: float((pp[k].detach() - torch.from_numpy(vals[k]))
                            .abs().max()) for k in vals}
    assert moved["0.weight"] < 0.75 * moved_plain["0.weight"]
    assert not torch.equal(tp["1.bias"], pp["1.bias"])


def test_returned_loss_is_fresh():
    vals = _values()
    tr = _port_trainer(_port_net(vals), "sgd")
    x, y = (torch.from_numpy(a) for a in _data(8))
    l1 = tr.step(x, y)
    v1 = l1.clone()
    l2 = tr.step(x, y)
    assert l1.data_ptr() != l2.data_ptr()
    assert torch.equal(l1, v1) and not torch.equal(l1, l2)


@pytest.mark.parametrize("how", ["load_parameters", "cast"])
def test_moved_storage_builds_again(how, tmp_path):
    vals = _values()
    net, twin = _port_net(vals), _port_net(vals)
    tr, ttr = _port_trainer(net, "sgd"), _port_trainer(twin, "sgd")
    x, y = (torch.from_numpy(a) for a in _data(8))
    tr.step(x, y)
    ttr.step(x, y)
    before = {k: v.data_ptr() for k, v in
              net.state_dict(keep_vars=True).items()}
    if how == "load_parameters":
        f = str(tmp_path / "w.params")
        net.save_parameters(f)
        net.load_parameters(f)
    else:
        net.cast("float64")
        net.cast("float32")
    assert any(v.data_ptr() != before[k] for k, v in
               net.state_dict(keep_vars=True).items())
    s0 = tspmd.step_compile_stats()
    got = tr.step(x, y)
    s1 = tspmd.step_compile_stats()
    assert s1["count"] - s0["count"] == 1
    assert s1["evictions"] - s0["evictions"] == 1
    assert len(tr.graphs()) == 1
    want = ttr.step(x, y)
    assert torch.equal(got, want)
    tw = twin.state_dict(keep_vars=True)
    for k, v in net.state_dict(keep_vars=True).items():
        assert torch.equal(v, tw[k]), k


def test_cached_op_builds_one_entry_per_shape():
    vals = _values()
    net = _port_net(vals)
    net.eval()  # a tensor caller's train flag: the NDArray path's, here
    plain = _mlp(tnn, a={"in_units": 16}, b={"in_units": 32})
    plain.initialize(ctx=CPU)
    load_numpy_params(plain, vals)
    jnet, _ = _jax_net(vals)
    jnet.hybridize()
    s0 = tblock.cached_op_stats()
    outs = []
    with torch.no_grad():
        for n in (4, 4, 8, 4):
            x = torch.from_numpy(_data(n, n)[0])
            got = net(x)
            outs.append(got)
            assert torch.equal(got, plain(x))
            np.testing.assert_allclose(
                got.numpy(), jnet(mx.nd.array(x.numpy())).asnumpy(),
                rtol=1e-6, atol=1e-6)
    assert tblock.cached_op_stats()["count"] - s0["count"] == 2
    assert outs[0].data_ptr() != outs[1].data_ptr()
    # the NDArray entry point outside record() takes the same entry
    x = mt.nd.array(_data(4, 4)[0], ctx=CPU)
    assert torch.equal(net(x)._data, outs[0])
    assert tblock.cached_op_stats()["count"] - s0["count"] == 2
    # under record() the training-mode entry of the shape is built once
    # (test_torch_cached_op.py holds it); inside the trainer's step and
    # under no_capture nothing is built
    with mt.autograd.record():
        net(x)
    assert tblock.cached_op_stats()["count"] - s0["count"] == 3
    _port_trainer(net, "sgd").step(torch.from_numpy(_data(4)[0]),
                                   torch.from_numpy(_data(4)[1]))
    with _graphs.no_capture(), torch.no_grad():
        net(torch.from_numpy(_data(16)[0]))
    assert tblock.cached_op_stats()["count"] - s0["count"] == 3


def test_cache_evicts_the_least_recently_used(monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_CACHE_MAX", "2")
    net = _port_net(_values())
    s0 = tblock.cached_op_stats()
    with torch.no_grad():
        for n in (1, 2, 1, 3, 1):
            net(torch.zeros(n, 16))
        assert tblock.cached_op_stats()["count"] - s0["count"] == 3
        assert tblock.cached_op_stats()["size"] <= 2
        assert len(tblock._FWD_CACHE.entries(net)) == 2
        net(torch.zeros(1, 16))  # the most recent two stay: 1 and 3
        net(torch.zeros(3, 16))
        assert tblock.cached_op_stats()["count"] - s0["count"] == 3
        net(torch.zeros(2, 16))  # 2 went for 3: built again
        assert tblock.cached_op_stats()["count"] - s0["count"] == 4
    assert tblock.cached_op_stats()["evictions"] > s0["evictions"]


def test_a_replay_counts_its_capture_launches():
    _kernels.reset_launch_count("probe")
    with _kernels.capture_tally() as tally:
        tally["probe"] = 3  # what a capture of three launches records
    assert _kernels.launch_count("probe") == 0
    for _ in range(2):
        _kernels.add_launches(tally)
    assert _kernels.launch_count("probe") == 6
    _kernels.count_launch("probe")  # an eager launch, no capture underway
    assert _kernels.launch_count("probe") == 7
