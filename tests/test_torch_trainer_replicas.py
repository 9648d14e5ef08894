"""``gluon.Trainer`` over replicas on ``[cpu(0), cpu(1)]`` against the JAX
package's, on the same seeded weights and batches (``split_and_load`` of
one batch, the per-sample loss, ``loss.backward()`` per replica,
``trainer.step``).

* An MLP (5 -> 16 -> 3, L2 loss) through ``Trainer(kvstore='device')``
  for three steps in each case of ``CASES``: SGD with momentum and Adam
  (Adam's t differs between replicas: the update count is shared and
  moves once a replica); the update on the store; ``fuse_step`` on and
  off; ``spmd=True`` (ZeRO-1 over the two replicas, tensors of at least
  16 elements in buckets), with ``MXNET_ZERO_STATES=0``, with LAMB (its
  tensors split alone), with int8 and fp8 collectives and their
  error-feedback residuals, with ``MXNET_COMM_OVERLAP`` and buckets of
  64 bytes, and through ``MXNET_SPMD=1``.  Each replica's weights, the
  optimizer's update count and the states (per replica, or the SPMD
  updater's canonical payload) within 1e-5 relative + 1e-6 (fp32; the
  update ops are the same, XLA fuses them).
* The SPMD plan (buckets, small groups, singles) and the state bytes
  and shard factor of ``optimizer_state_bytes``.
* The hand-off: once the SPMD step holds the states, a step whose
  gradients it cannot take (a row-sparse gradient) hands them to the
  per-replica updaters, as in the JAX package.
* ``save_states``/``load_states``: two replicas' states load into the
  other package's trainer; into one replica only with ``allow_resize``
  (then replica 0's); the SPMD updater's canonical file loads into one
  replica.
* A small fused-V1 ResNet (kernels 1-2's plain versions on the CPU),
  hybridized, two SGD steps (lr 0.01) on two replicas of 8 images each:
  each replica's weights and running statistics bit for bit against one
  single-context net per half-batch, their gradients summed and the
  eager update copied over; and each replica's update (over all trained
  leaves) within 1e-3 relative L2 of the JAX package's op-granular net
  on the same replicas, its running statistics within 1e-4 (measured
  5.2e-5 and 2.4e-6: the fused unit sums its statistics in another
  order than XLA, and BatchNorm's backward over 8 images amplifies it).
* dp = 2 over two gloo ranks started by the port's ``tools/launch.py``
  (``tests/torch_ranks.py``), ``Trainer(kvstore='dist_sync')`` on the
  MLP, each rank half the batch: the update on the store (the default),
  ``update_on_kvstore=False`` (``pushpull_fused``), ``spmd=True``, int8
  collectives under ``spmd=True``, each against the JAX trainer over the
  two replicas (the same sums); 2-bit compression against a replay of
  each rank's gradients through the JAX package's compressor and SGD.
"""
import os
import pickle
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_ranks import WORLD, Launched, jax_free, rank_setup  # noqa: E402

BATCH, STEPS = 8, 3
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
ADAM = {"learning_rate": 0.01}
LAMB = {"learning_rate": 0.01}
SMALL = {"MXNET_ZERO_MIN_SIZE": "16"}
CASES = {
    "sgd": ("sgd", SGD, {}, {}),
    "adam": ("adam", ADAM, {}, {}),
    "sgd-update_on_kvstore": ("sgd", SGD, {"update_on_kvstore": True}, {}),
    "adam-fuse_off": ("adam", ADAM, {"fuse_step": False}, {}),
    "sgd-fuse_on": ("sgd", SGD, {"fuse_step": True}, {}),
    "spmd-sgd": ("sgd", SGD, {"spmd": True}, SMALL),
    "spmd-adam": ("adam", ADAM, {"spmd": True}, SMALL),
    "spmd-zero_off": ("adam", ADAM, {"spmd": True},
                      dict(SMALL, MXNET_ZERO_STATES="0")),
    "spmd-lamb": ("lamb", LAMB, {"spmd": True}, SMALL),
    "spmd-int8": ("sgd", SGD, {"spmd": True},
                  dict(SMALL, MXNET_COMM_QUANT="int8",
                       MXNET_COMM_QUANT_MIN_SIZE="16")),
    "spmd-fp8": ("adam", ADAM, {"spmd": True},
                 dict(SMALL, MXNET_COMM_QUANT="fp8",
                      MXNET_COMM_QUANT_MIN_SIZE="16")),
    "spmd-overlap": ("sgd", SGD, {"spmd": True},
                     dict(SMALL, MXNET_COMM_OVERLAP="1",
                          MXNET_SPMD_BUCKET_BYTES="64")),
    "env-spmd": ("adam", ADAM, {}, dict(SMALL, MXNET_SPMD="1")),
}
# the dist cases (each rank: one replica, half the batch)
DIST_CASES = {
    "default": ({}, {}),
    "no_kvstore_update": ({"update_on_kvstore": False}, {}),
    "spmd": ({"spmd": True, "update_on_kvstore": False}, SMALL),
    "2bit": ({"compression_params": {"type": "2bit", "threshold": 0.05}},
             {}),
    "spmd-int8": ({"spmd": True, "update_on_kvstore": False},
                  dict(SMALL, MXNET_COMM_QUANT="int8",
                       MXNET_COMM_QUANT_MIN_SIZE="16")),
}
DIST_STEPS = 2


def _data():
    rs = np.random.RandomState(3)
    return (rs.rand(BATCH, 5).astype(np.float32),
            rs.rand(BATCH, 3).astype(np.float32))


def _w0():
    rs = np.random.RandomState(4)
    shapes = {"0.weight": (16, 5), "0.bias": (16,), "1.weight": (3, 16),
              "1.bias": (3,)}
    return {k: (rs.randn(*s) * 0.3).astype(np.float32)
            for k, s in shapes.items()}


def _params(pkg, net):
    return net.collect_params() if pkg.__name__ == "mxnet_tpu_torch" \
        else net._collect_params_with_prefix()


def _mlp(pkg, ctx, w0):
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(16, in_units=5, activation="relu"),
            nn.Dense(3, in_units=16))
    net.initialize(ctx=ctx)
    for k, p in _params(pkg, net).items():
        p.set_data(pkg.nd.array(w0[k], ctx=ctx[0]))
    return net


def _steps(pkg, net, tr, ctx, x, y, steps, batch=BATCH, loss=None):
    loss_fn = loss or pkg.gluon.loss.L2Loss()
    for _ in range(steps):
        xs = pkg.gluon.utils.split_and_load(pkg.nd.array(x, ctx=ctx[0]),
                                            ctx)
        ys = pkg.gluon.utils.split_and_load(pkg.nd.array(y, ctx=ctx[0]),
                                            ctx)
        with pkg.autograd.record():
            losses = [loss_fn(net(a), b) for a, b in zip(xs, ys)]
        for loss in losses:
            loss.backward()
        tr.step(batch)


def _replicas(pkg, net):
    return {k: [d.asnumpy() for d in p.list_data()]
            for k, p in _params(pkg, net).items()}


def _close(got, want, rtol=1e-5, atol=1e-6, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _same_tree(a, b, what, **tol):
    if isinstance(a, dict):
        assert sorted(map(str, a)) == sorted(map(str, b)), what
        for k in a:
            if not isinstance(a[k], str):
                _same_tree(a[k], b[k], f"{what}/{k}", **tol)
        return
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, z) in enumerate(zip(a, b)):
            _same_tree(x, z, f"{what}/{i}", **tol)
        return
    if a is None:
        assert b is None, what
        return
    _close(np.asarray(a), np.asarray(b), what=what, **tol)


def _states(tr):
    """The trainer's states: the SPMD updater's canonical payload, else
    each replica updater's."""
    if tr._spmd_updater is not None:
        return [pickle.loads(tr._spmd_updater.get_states())]
    return [pickle.loads(u.get_states()) for u in tr._updaters]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_arrays_keep_the_context_they_were_placed_on():
    """``cpu(1)`` names a replica although every CPU context shares the
    host device: creation, ``split_and_load``, an op's result, a copy,
    ``as_in_context`` and a parameter's replica say so, as in the JAX
    package."""
    import mxnet_tpu as mx
    import mxnet_tpu_torch as mt

    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    got = {}
    for pkg in (mt, mx):
        c0, c1 = pkg.cpu(0), pkg.cpu(1)
        z = pkg.nd.zeros((2, 3), ctx=c1)
        parts = pkg.gluon.utils.split_and_load(pkg.nd.array(x, ctx=c0),
                                               [c0, c1])
        moved = parts[0].as_in_context(c1)
        net = pkg.gluon.nn.Dense(2, in_units=4)
        net.initialize(ctx=[c0, c1, c1])
        w = net.weight
        got[pkg.__name__] = (
            str(z.ctx), [str(p.ctx) for p in parts],
            str((parts[1] * 2 + 1).ctx), str(parts[1].copy().ctx),
            str(moved.ctx), [str(c) for c in w.list_ctx()],
            str(w.data(c1).ctx), str(w.grad(c1).ctx))
        np.testing.assert_array_equal(moved.asnumpy(), x[:3])
    assert got["mxnet_tpu_torch"] == got["mxnet_tpu"]
    assert got["mxnet_tpu_torch"][1] == ["cpu(0)", "cpu(1)"]
    # a copy, not the same array (another replica's storage)
    import mxnet_tpu_torch as mt
    a = mt.nd.ones((2,), ctx=mt.cpu(0))
    b = a.as_in_context(mt.cpu(1))
    b[:] = 5
    assert a.asnumpy().tolist() == [1.0, 1.0]


def test_replicas_load_cast_and_reset(tmp_path):
    """``load_parameters`` fills every replica (each with its own
    storage), ``cast`` casts every replica, ``reset_ctx`` re-places them
    from the first; a file the JAX package saved loads as well."""
    import mxnet_tpu as mx
    import mxnet_tpu_torch as mt

    jnet = _mlp(mx, [mx.cpu()], _w0())
    fname = str(tmp_path / "mlp.params")
    jnet.save_parameters(fname)
    net = _mlp(mt, [mt.cpu(0), mt.cpu(1)], {k: np.zeros_like(v)
                                            for k, v in _w0().items()})
    net.load_parameters(fname)
    for k, p in net.collect_params().items():
        reps = p.list_data()
        assert [str(r.ctx) for r in reps] == ["cpu(0)", "cpu(1)"]
        for r in reps:
            np.testing.assert_array_equal(r.asnumpy(), _w0()[k])
        assert reps[0]._data.data_ptr() != reps[1]._data.data_ptr()
    net.cast("float64")
    assert {str(r._data.dtype) for p in net.collect_params().values()
            for r in p.list_data()} == {"torch.float64"}
    p = net.collect_params()["0.weight"]
    p.list_data()[1][:] = 7.0
    p.reset_ctx([mt.cpu(2), mt.cpu(0)])
    assert p.list_ctx() == [mt.cpu(2), mt.cpu(0)]
    np.testing.assert_array_equal(p.data(mt.cpu(0)).asnumpy(), _w0()["0.weight"])


@pytest.fixture(scope="module")
def runs():
    """Every case of CASES on both packages, once."""
    import mxnet_tpu as mx
    import mxnet_tpu_torch as mt

    x, y = _data()
    w0 = _w0()
    out = {}
    for case, (opt, oparams, kw, env) in CASES.items():
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            got = {}
            for pkg, ctx in ((mt, [mt.cpu(0), mt.cpu(1)]),
                             (mx, [mx.cpu(0), mx.cpu(1)])):
                net = _mlp(pkg, ctx, w0)
                tr = pkg.gluon.Trainer(net.collect_params(), opt,
                                       dict(oparams), **kw)
                _steps(pkg, net, tr, ctx, x, y, STEPS)
                got[pkg.__name__] = (net, tr)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        out[case] = got
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_replicas_match_the_jax_trainer(runs, case):
    import mxnet_tpu as mx
    import mxnet_tpu_torch as mt

    (tnet, ttr), (jnet, jtr) = (runs[case]["mxnet_tpu_torch"],
                                runs[case]["mxnet_tpu"])
    tw, jw = _replicas(mt, tnet), _replicas(mx, jnet)
    for k in jw:
        assert len(tw[k]) == len(jw[k]) == 2
        for r in range(2):
            _close(tw[k][r], jw[k][r], what=f"{case} {k} replica {r}")
    # the store's updater counts one update a step, the replicas' one a
    # replica
    store = bool(CASES[case][2].get("update_on_kvstore"))
    assert ttr.optimizer.num_update == jtr.optimizer.num_update \
        == (1 if store else 2) * STEPS
    assert (ttr._spmd_updater is None) == (jtr._spmd_updater is None)
    if CASES[case][2].get("update_on_kvstore"):
        _same_tree(pickle.loads(ttr._kvstore._updater.get_states()),
                   pickle.loads(jtr._kvstore._updater.get_states()),
                   f"{case} store states")
        return
    ts, js = _states(ttr), _states(jtr)
    assert len(ts) == len(js)
    for r, (a, b) in enumerate(zip(ts, js)):
        _same_tree(a, b, f"{case} states {r}")


def test_adam_t_skew_between_replicas(runs):
    """Replica 1's Adam update runs one count later than replica 0's,
    so the replicas' weights part, in both packages alike."""
    (tnet, ttr) = runs["adam"]["mxnet_tpu_torch"]
    w = tnet.collect_params()["0.weight"].list_data()
    assert np.abs(w[0].asnumpy() - w[1].asnumpy()).max() > 1e-7
    assert ttr.optimizer._index_update_count[0] == 2 * STEPS
    # the SPMD step keeps the replicas equal (replica 0's trajectory)
    (snet, _) = runs["spmd-adam"]["mxnet_tpu_torch"]
    s = snet.collect_params()["0.weight"].list_data()
    np.testing.assert_array_equal(s[0].asnumpy(), s[1].asnumpy())


@pytest.mark.parametrize("case", ["spmd-sgd", "spmd-adam", "spmd-zero_off",
                                  "spmd-lamb", "spmd-int8", "spmd-overlap"])
def test_spmd_plan_and_state_size(runs, case):
    (_, ttr), (_, jtr) = (runs[case]["mxnet_tpu_torch"],
                          runs[case]["mxnet_tpu"])
    tp, jp = ttr._spmd_updater._plan, jtr._spmd_updater._plan
    assert [b.pos for b in tp.buckets] == [b.pos for b in jp.buckets]
    assert [b.total for b in tp.buckets] == [b.total for b in jp.buckets]
    assert [g.pos for g in tp.smalls] == [g.pos for g in jp.smalls]
    assert tuple(tp.singles) == tuple(jp.singles)
    assert ttr.optimizer_state_bytes() == jtr.optimizer_state_bytes()
    zero = CASES[case][3].get("MXNET_ZERO_STATES", "1") == "1"
    assert ttr._spmd_updater.shard_factor() == (2 if zero else 1)
    if zero:
        # each replica holds half of every split state
        u = ttr._spmd_updater
        per = [sum(x.numel() for t in ts[s:s + 1] for x in
                   __import__("mxnet_tpu_torch.optimizer.spmd", fromlist=[
                       "_tree_leaves"])._tree_leaves(t))
               for ts in list(u._bstate.values()) + list(u._sstate.values())
               for s in range(2)]
        assert per[0::2] == per[1::2]


def _plain_int8(x):
    """int8 round trip per row, per block of 512 (plain)."""
    rows, n = x.shape
    nb = -(-n // 512)
    xb = torch.nn.functional.pad(x, (0, nb * 512 - n)).reshape(rows, nb,
                                                                512)
    scale = torch.clamp_min(xb.abs().amax(dim=-1, keepdim=True),
                            1e-30) / torch.tensor(127.0)
    q = torch.clamp(torch.round(xb / scale), -127.0, 127.0)
    return (q * scale).reshape(rows, nb * 512)[:, :n]


def test_spmd_int8_on_bf16_weights_is_a_plain_replay(monkeypatch):
    """SpmdUpdater's int8 bucket over two replicas of bf16 weights, bit
    for bit a plain replay: each replica's padded gradient row (plus its
    residual) through the int8 round trip, the rows summed, the eager SGD
    update in bf16, then each shard's block of the bf16-rounded delta
    (plus its residual) through the round trip onto the old weights."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import optimizer as opt_mod

    for k, v in dict(SMALL, MXNET_COMM_QUANT="int8",
                     MXNET_COMM_QUANT_MIN_SIZE="16").items():
        monkeypatch.setenv(k, v)
    nd = mt.nd.NDArray
    gen = torch.Generator().manual_seed(5)
    shapes = [(40, 30), (701,), (5,), (64, 33)]
    w0 = [torch.randn(*s, generator=gen).to(torch.bfloat16) for s in shapes]
    reps = [[nd(w.clone(), ctx=mt.cpu(r)) for r in range(2)] for w in w0]
    sgd = dict(SGD, rescale_grad=1 / 64)
    u = opt_mod.SpmdUpdater(opt_mod.create("sgd", **sgd))
    upd = opt_mod.Updater(opt_mod.create("sgd", **sgd))
    ref = [nd(w.clone()) for w in w0]
    res = {}
    for step in range(3):
        g = [[(torch.randn(*s, generator=gen) * 3).to(torch.bfloat16)
              for s in shapes] for _ in range(2)]
        u.update_all_mesh(list(range(4)), [[nd(g[r][p], ctx=mt.cpu(r))
                                            for r in range(2)]
                                           for p in range(4)], reps)
        (b,), small = u._plan.buckets, u._plan.smalls
        assert [q.pos for q in small] == [(2,)]

        def cat(ts, b=b):
            return torch.cat([torch.nn.functional.pad(t.reshape(-1), (
                0, n - t.numel())) for t, n in zip(ts, b.sizes)]).float()

        total = 0
        for r in range(2):
            acc = cat([g[r][p] for p in b.pos]) + res.get(("g", r), 0.0)
            dec = _plain_int8(acc[None])[0]
            res[("g", r)] = acc - dec
            total = total + dec
        old = [w._data.clone() for w in ref]
        for p in range(4):
            gp = g[0][p] + g[1][p] if p not in b.pos else \
                total[b.offsets[b.pos.index(p)]:][:g[0][p].numel()] \
                .view(shapes[p]).to(torch.bfloat16)
            upd(p, nd(gp), ref[p])
        acc = (cat([ref[p]._data for p in b.pos])
               - cat([old[p] for p in b.pos])).view(2, -1) \
            + res.get("w", 0.0)
        dec = _plain_int8(acc)
        res["w"] = acc - dec
        full = cat([old[p] for p in b.pos]) + dec.reshape(-1)
        for p, off in zip(b.pos, b.offsets):
            ref[p]._data.copy_(full[off:off + ref[p].size].view(shapes[p]))
        for p in range(4):
            for r in range(2):
                assert torch.equal(reps[p][r]._data, ref[p]._data), \
                    (step, p, r)


def test_spmd_hands_its_states_over():
    """Two SPMD steps, then a step with a row-sparse gradient, which the
    SPMD step cannot take: the states go to the per-replica updaters,
    the same in both packages."""
    import mxnet_tpu as mx
    import mxnet_tpu_torch as mt

    x, y = _data()
    w0 = _w0()
    os.environ["MXNET_ZERO_MIN_SIZE"] = "16"
    try:
        got = {}
        for pkg, ctx in ((mt, [mt.cpu(0), mt.cpu(1)]),
                         (mx, [mx.cpu(0), mx.cpu(1)])):
            net = _mlp(pkg, ctx, w0)
            tr = pkg.gluon.Trainer(net.collect_params(), "adam", dict(ADAM),
                                   spmd=True)
            _steps(pkg, net, tr, ctx, x, y, 2)
            assert tr._spmd_updater is not None
            p = [q for q in tr._params if q.name.endswith("bias")][-1]
            dense = p.list_grad
            p.list_grad = lambda dense=dense: [g.tostype("row_sparse")
                                               for g in dense()]
            try:
                assert tr._dense_uniform_params() is None
                assert tr._step_spmd() is False
            finally:
                del p.list_grad
            assert tr._spmd_updater is None and len(tr._updaters) == 2
            got[pkg.__name__] = [pickle.loads(u.get_states())
                                 for u in tr._updaters]
    finally:
        os.environ.pop("MXNET_ZERO_MIN_SIZE", None)
    for r, (a, b) in enumerate(zip(got["mxnet_tpu_torch"],
                                   got["mxnet_tpu"])):
        _same_tree(a, b, f"handed-over states {r}")
    _same_tree(got["mxnet_tpu_torch"][0], got["mxnet_tpu_torch"][1],
               "the replicas' states", rtol=0, atol=0)


def test_save_and_load_states(runs, tmp_path):
    import mxnet_tpu as mx
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.base import MXNetError

    w0 = _w0()
    (_, ttr), (_, jtr) = (runs["adam"]["mxnet_tpu_torch"],
                          runs["adam"]["mxnet_tpu"])
    ours, theirs = tmp_path / "port.states", tmp_path / "jax.states"
    ttr.save_states(str(ours))
    jtr.save_states(str(theirs))
    assert len(pickle.load(open(ours, "rb"))["__mx_replica_states__"]) == 2
    for pkg, ctx, fname, src in (
            (mx, [mx.cpu(0), mx.cpu(1)], ours, ttr),
            (mt, [mt.cpu(0), mt.cpu(1)], theirs, jtr)):
        net = _mlp(pkg, ctx, w0)
        tr = pkg.gluon.Trainer(net.collect_params(), "adam", dict(ADAM))
        tr.load_states(str(fname))
        tr._init_kvstore()
        for r in range(2):
            _same_tree(pickle.loads(tr._updaters[r].get_states()),
                       pickle.loads(src._updaters[r].get_states()),
                       f"loaded replica {r}", rtol=0, atol=0)
    one = _mlp(mt, [mt.cpu(0)], w0)
    tr1 = mt.gluon.Trainer(one.collect_params(), "adam", dict(ADAM))
    tr1._init_kvstore()
    with pytest.raises(MXNetError, match="2 replica states"):
        tr1.load_states(str(ours))
    tr1.load_states(str(ours), allow_resize=True)
    assert len(tr1._updaters) == 1
    _same_tree(pickle.loads(tr1._updaters[0].get_states()),
               pickle.loads(ttr._updaters[0].get_states()),
               "replica 0 on one replica", rtol=0, atol=0)
    # the SPMD updater's canonical file: one replica, no wrapper
    (_, str_) = runs["spmd-adam"]["mxnet_tpu_torch"]
    canon = tmp_path / "spmd.states"
    str_.save_states(str(canon))
    payload = pickle.load(open(canon, "rb"))
    assert "__mx_replica_states__" not in payload
    tr2 = mt.gluon.Trainer(_mlp(mt, [mt.cpu(0)], w0).collect_params(),
                           "adam", dict(ADAM))
    tr2.load_states(str(canon))
    tr2._init_kvstore()
    _same_tree(pickle.loads(tr2._updaters[0].get_states()), payload,
               "canonical on one replica", rtol=0, atol=0)


def _resnet(pkg, ctx, x, seed=None):
    from importlib import import_module

    r = import_module(pkg.__name__ + ".gluon.model_zoo.vision.resnet")
    net = r.ResNetV1(r.BottleneckV1, [1, 1, 1, 1], [8, 32, 64, 128, 256],
                     classes=10, layout="NHWC")
    kw = {} if seed is None else {"seed": seed}
    net.initialize(pkg.initializer.Xavier(), ctx=ctx, **kw)
    net.hybridize()
    net(pkg.nd.array(x, ctx=ctx[0]))  # the deferred shapes
    return net


def _resnet_steps(pkg, net, ctx, x, y, steps=2):
    tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                           dict(SGD, learning_rate=0.01))
    _steps(pkg, net, tr, ctx, x, y, steps, batch=len(x),
           loss=pkg.gluon.loss.SoftmaxCrossEntropyLoss())
    return _replicas(pkg, net)


def test_fused_resnet_on_two_replicas(monkeypatch):
    import mxnet_tpu as mx
    import mxnet_tpu_torch as mt

    rs = np.random.RandomState(9)
    x = rs.rand(16, 32, 32, 3).astype(np.float32)
    y = (np.arange(16) % 10).astype(np.float32)
    ctx = [mt.cpu(0), mt.cpu(1)]
    monkeypatch.setenv("MXNET_FUSED_CONVBN", "1")
    monkeypatch.setenv("MXNET_FUSED_CONVBN_BWD", "1")
    net = _resnet(mt, ctx, x, seed=0)
    w0 = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    # the reference in the port: one net per half-batch on one context,
    # their gradients summed, the eager update, the weights copied over
    halves = [_resnet(mt, [mt.cpu()], x, seed=0) for _ in range(2)]
    opt = mt.optimizer.create("sgd", **dict(SGD, learning_rate=0.01))
    opt.rescale_grad = 1.0 / len(x)
    upd = mt.optimizer.Updater(opt)
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    plist = [list(h.collect_params().values()) for h in halves]
    for _ in range(2):
        for r, h in enumerate(halves):
            sl = slice(8 * r, 8 * (r + 1))
            with mt.autograd.record():
                loss = loss_fn(h(mt.nd.array(x[sl], ctx=mt.cpu())),
                               mt.nd.array(y[sl], ctx=mt.cpu()))
            loss.backward()
        for i, (pa, pb) in enumerate(zip(*plist)):
            if pa.grad_req == "null":
                continue
            g = mt.nd.NDArray(pa.grad()._data + pb.grad()._data)
            upd(i, g, pa.data())
            pb.set_data(pa.data())
    got = _resnet_steps(mt, net, ctx, x, y)
    for k, p in halves[0].collect_params().items():
        for r in range(2):
            want = halves[r].collect_params()[k].data().asnumpy()
            np.testing.assert_array_equal(got[k][r], want, err_msg=k)
    # against the JAX package's op-granular net on the same replicas
    monkeypatch.setenv("MXNET_FUSED_CONVBN", "0")
    monkeypatch.setenv("MXNET_FUSED_CONVBN_BWD", "0")
    jctx = [mx.cpu(0), mx.cpu(1)]
    jnet = _resnet(mx, jctx, x)
    for k, p in _params(mx, jnet).items():
        p.set_data(mx.nd.array(w0[k]))
    want = _resnet_steps(mx, jnet, jctx, x, y)
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    trained = [k for k in want if k not in stats]

    def rel(keys, r, base):
        a = np.concatenate([(got[k][r] - base(k)).ravel() for k in keys])
        b = np.concatenate([(want[k][r] - base(k)).ravel() for k in keys])
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    for r in range(2):
        assert rel(trained, r, lambda k: w0[k]) <= 1e-3, r
        assert rel(stats, r, lambda k: 0.0) <= 1e-4, r
    # each replica's statistics are its own half-batch's
    assert np.abs(got[stats[0]][0] - got[stats[0]][1]).max() > 0


# ---------------------------------------------------------------------------
# dp = 2 over gloo ranks
# ---------------------------------------------------------------------------

def _rank_main():
    rank, out_dir = rank_setup()
    import mxnet_tpu_torch as mt

    x, y = _data()
    half = slice(rank * BATCH // WORLD, (rank + 1) * BATCH // WORLD)
    ctx = [mt.cpu()]
    res = {}
    for case, (kw, env) in DIST_CASES.items():
        os.environ.update(env)
        net = _mlp(mt, ctx, _w0())
        tr = mt.gluon.Trainer(net.collect_params(), "sgd", dict(SGD),
                              kvstore="dist_sync", **kw)
        loss_fn = mt.gluon.loss.L2Loss()
        for step in range(DIST_STEPS):
            xb = mt.nd.array(x[half], ctx=ctx[0])
            yb = mt.nd.array(y[half], ctx=ctx[0])
            with mt.autograd.record():
                loss = loss_fn(net(xb), yb)
            loss.backward()
            for k, p in net.collect_params().items():
                res[f"{case}/grad/{step}/{k}"] = p.grad().asnumpy()
            tr.step(BATCH)
        for k, p in net.collect_params().items():
            res[f"{case}/w/{k}"] = p.data().asnumpy()
        res[f"{case}/update_on_kvstore"] = np.array(
            bool(tr._update_on_kvstore))
        res[f"{case}/spmd"] = np.array(tr._spmd_updater is not None)
        for k in env:
            os.environ.pop(k, None)
    from mxnet_tpu_torch.parallel import dist

    dist.barrier()
    dist.shutdown()
    res["jax_free"] = np.array(jax_free())
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    group = Launched(__file__, tmp_path_factory.mktemp("trainer_dp2"))
    yield group
    group.stop()


def _jax_dp2(kw, env):
    """The JAX trainer over two replicas: the same sums as two ranks."""
    import mxnet_tpu as mx

    x, y = _data()
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        ctx = [mx.cpu(0), mx.cpu(1)]
        net = _mlp(mx, ctx, _w0())
        tr = mx.gluon.Trainer(net.collect_params(), "sgd", dict(SGD), **kw)
        _steps(mx, net, tr, ctx, x, y, DIST_STEPS)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return {k: v[0] for k, v in _replicas(mx, net).items()}


def _two_bit_replay(ranks):
    """SGD on the sum of each rank's 2-bit-coded gradients, by the JAX
    package's compressor (a residual per rank and key) and optimizer."""
    import mxnet_tpu as mx
    from mxnet_tpu.kvstore_compression import TwoBitCompressor

    w0 = _w0()
    keys = sorted(w0, key=list(w0).index)
    opt = mx.optimizer.create("sgd", **SGD)
    opt.rescale_grad = 1.0 / BATCH
    upd = mx.optimizer.get_updater(opt)
    comps = [TwoBitCompressor(0.05) for _ in range(WORLD)]
    ws = {k: mx.nd.array(w0[k]) for k in keys}
    for step in range(DIST_STEPS):
        for i, k in enumerate(keys):
            total = 0
            for r, c in enumerate(comps):
                g = ranks[r][f"2bit/grad/{step}/{k}"]
                packed, shape = c.compress(i, g)
                total = total + c.decompress(packed, shape)
            upd(i, mx.nd.array(total), ws[k])
    return {k: v.asnumpy() for k, v in ws.items()}


@pytest.mark.parametrize("case", sorted(DIST_CASES))
def test_dist_sync_dp2_matches(dp2, case):
    ranks = dp2.results()
    kw, env = DIST_CASES[case]
    for res in ranks:
        assert bool(res["jax_free"])
        assert bool(res[f"{case}/update_on_kvstore"]) == (
            case in ("default", "2bit"))
        assert bool(res[f"{case}/spmd"]) == case.startswith("spmd")
    if case == "2bit":
        want = _two_bit_replay(ranks)
    else:
        jkw = dict(kw)
        if case == "default":
            jkw["update_on_kvstore"] = True
        want = _jax_dp2(jkw, env)
    for k, v in want.items():
        for r, res in enumerate(ranks):
            _close(res[f"{case}/w/{k}"], v, what=f"{case} rank {r} {k}")
        np.testing.assert_array_equal(ranks[0][f"{case}/w/{k}"],
                                      ranks[1][f"{case}/w/{k}"])


if __name__ == "__main__":
    _rank_main()
