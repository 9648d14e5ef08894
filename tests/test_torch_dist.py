"""mxnet_tpu_torch data parallel (dp=2) against the JAX package's dp=2 mesh.

The port runs in two rank processes of this file
(``python tests/test_torch_dist.py <dir> <rank>``), joined by a gloo
process group on the CPU through ``parallel.dist.init()`` (the DMLC_*
contract, rendezvous through a ``file://`` in the test's tmp dir).  The
ranks import neither jax nor mxnet_tpu, and check that; they run every
case below in one spawn and write their results to the tmp dir.  The JAX
package runs in the pytest process on a ``make_mesh(dp=2)`` mesh over
the host devices of ``tests/conftest.py``, meanwhile.

* The fused unit (row 3/4 of PERF.md's kernel table): on (8,8,8,16) ->
  Co 32, 3x3 stride 1, act_in, statistics, each rank holds half the
  rows.  The
  oracle is ``pcb.fused_conv_unit`` under ``make_mesh(dp=2)`` in
  interpret mode, which takes ``_pallas_unit_sharded`` and (with
  MXNET_FUSED_CONVBN_BWD=1) ``_pallas_unit_bwd_sharded``.  The loss is
  test_pallas_convbn's, Σy² + 1e-3·Σs1² + 1e-3·Σs2; each rank adds the
  replicated terms divided by the world size.  y and gx concatenated
  over the ranks, s1 and s2, and dw, gscale and gbias summed over the
  ranks (the trainer's gradient sum) within 1e-5 of the largest
  magnitude (fp32).  Also a 1x1 stride-2 case (the plain backward) and
  one without statistics.
* BatchNorm in training (single-pass shifted and exact two-pass
  variance): dp=2 against the port's dp=1 on the whole batch and the JAX
  package's ``_batch_norm`` on a dp=2-sharded input under jit; output,
  moving statistics and the gradients of x, gamma and beta, 1e-5.
* SPMDTrainer, dp=2, two steps on test_torch_resnet_train's small nets
  (batch 16, warm running means, lr 1e-3) op-granular, fused and fused
  with the fused backward, against the JAX SPMDTrainer on
  ``make_mesh(dp=2)`` (resnet18 op-granular excepted, see
  JAX_TRAIN_RUNS) and the port's dp=1 run on the whole batch, at
  test_torch_resnet_train's tolerances; both ranks bit-identical.
* Dropout under dp=2: a tiny BERT (2 layers, 32 units, dropout 0.1 on
  the embeddings, the attention probabilities and the sublayer
  outputs) with an NSP-style per-sample cross entropy trains two SGD
  steps, dp=2 against the port's dp=1 on the whole batch from the same
  seed: each rank draws the masks of the global batch and keeps its
  rows, so the two runs drop the same positions.  Losses, parameters
  and momenta within 1e-5 of max(1, largest magnitude) (fp32: the
  gradient sum over the ranks adds in another order, and the key biases,
  whose gradient is zero but for rounding, stay near 1e-10); both ranks
  bit-identical;
  the dp=2 steps are counted as eager in ``step_compile_stats``.
* The surface: ``dist.init`` from the DMLC_* environment, rank and
  num_workers, ``make_mesh()`` defaulting to dp = world size, a tp=2
  mesh (rank r at tp coordinate r), ``forward`` under dp=2 giving the
  global batch, and what raises (dp other than the world size, a batch
  dp does not divide); ``dist.resolve`` of the DMLC_* variables in the
  pytest process.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

WORLD = 2
BATCH, SIZE, STEPS = 16, 32, 2
OPT = {"learning_rate": 1e-3, "momentum": 0.9, "wd": 1e-4}
# arch -> how both packages build it (test_torch_resnet_train's nets)
ARCHS = {
    "resnet18": lambda r: r.get_resnet(1, 18, classes=10, layout="NHWC"),
    "bottleneck": lambda r: r.ResNetV1(r.BottleneckV1, [1, 1, 1, 1],
                                       [8, 32, 64, 128, 256], classes=10,
                                       layout="NHWC"),
}
# port mode -> (MXNET_FUSED_CONVBN, MXNET_FUSED_CONVBN_BWD)
MODES = {"unfused": ("0", "0"), "fused": ("1", "0"), "fused_bwd": ("1", "1")}
# fused-unit backward calls per step that take the kernel's wrapper
STRIDE1_UNITS = {"resnet18": 11 + 8 - 3 - 3, "bottleneck": 16 - 6}
# (name, NHWC shape, Co, kernel, stride, pad, want_stats, bwd knob)
UNIT_CASES = [
    ("3x3s1", (8, 8, 8, 16), 32, (3, 3), (1, 1), (1, 1), True, "1"),
    ("1x1s2", (4, 8, 8, 8), 16, (1, 1), (2, 2), (0, 0), True, "0"),
    ("nostats", (4, 6, 6, 8), 8, (3, 3), (1, 1), (1, 1), False, "1"),
]
BN_SHAPE = (8, 4, 4, 6)
SPAWN_TIMEOUT = 240.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _data():
    x = np.random.RandomState(7).rand(BATCH, SIZE, SIZE, 3).astype(
        np.float32)
    y = (np.arange(BATCH) % 10).astype(np.int32)
    return x, y


def _unit_arrays(shape, co, kernel):
    rs = np.random.RandomState(11)
    x = rs.randn(*shape).astype(np.float32)
    w = (rs.randn(co, shape[-1], *kernel) * 0.2).astype(np.float32)
    sc = (rs.randn(shape[-1]) ** 2 + 0.5).astype(np.float32)
    bi = rs.randn(shape[-1]).astype(np.float32)
    sh = rs.randn(co).astype(np.float32)
    return x, w, sc, bi, sh


def _bn_arrays():
    rs = np.random.RandomState(12)
    c = BN_SHAPE[-1]
    x = (rs.randn(*BN_SHAPE) * 1.5 + 3.0).astype(np.float32)
    gamma = (rs.rand(c) + 0.5).astype(np.float32)
    beta = rs.randn(c).astype(np.float32)
    mm = (x.mean(axis=(0, 1, 2)) + 0.1 * rs.randn(c)).astype(np.float32)
    mv = (rs.rand(c) + 0.5).astype(np.float32)
    r = rs.randn(*BN_SHAPE).astype(np.float32)
    return x, gamma, beta, mm, mv, r


def _rows(a, rank):
    n = a.shape[0] // WORLD
    return a[rank * n:(rank + 1) * n]


# ---------------------------------------------------------------------------
# the rank processes (port only)
# ---------------------------------------------------------------------------

def _port_unit(case, rank, mesh):
    """One rank's forward and backward of the fused unit; its loss is
    its rows' Σy² plus the replicated terms over the world size."""
    from mxnet_tpu_torch.ops import fused_convbn as tfc

    name, shape, co, kernel, stride, pad, stats, knob = case
    os.environ["MXNET_FUSED_CONVBN_BWD"] = knob
    x, w, sc, bi, sh = (torch.from_numpy(a) for a in
                        _unit_arrays(shape, co, kernel))
    xr = _rows(x, rank).clone().requires_grad_(True)
    leaves = [xr] + [t.clone().requires_grad_(True) for t in (w, sc, bi)]
    calls = []
    real = tfc.fused_conv_unit_bwd
    tfc.fused_conv_unit_bwd = lambda *a, **k: calls.append(1) or real(*a,
                                                                      **k)
    try:
        with mesh:
            y, s1, s2 = tfc.fused_conv_unit(
                leaves[0], leaves[1], leaves[2], leaves[3], sh,
                kernel=kernel, stride=stride, pad=pad, act_in=True,
                want_stats=stats)
        loss = (y.float() ** 2).sum()
        if stats:
            loss = loss + ((s1 * s1).sum() * 1e-3 + s2.sum() * 1e-3) / WORLD
        grads = torch.autograd.grad(loss, leaves)
    finally:
        tfc.fused_conv_unit_bwd = real
    out = {"y": y, "s1": s1, "s2": s2, "gx": grads[0], "dw": grads[1],
           "gscale": grads[2], "gbias": grads[3]}
    res = {f"unit/{name}/{k}": v.detach().numpy() for k, v in out.items()}
    res[f"unit/{name}/kernel_bwd_calls"] = np.array(len(calls))
    return res


def _port_bn(rank, mesh, exact):
    import mxnet_tpu_torch as mt

    x, gamma, beta, mm, mv, r = (torch.from_numpy(a) for a in _bn_arrays())
    xr = _rows(x, rank).clone().requires_grad_(True)
    g = gamma.clone().requires_grad_(True)
    b = beta.clone().requires_grad_(True)
    with mesh:
        out, nm, nv = mt.ops.batch_norm(xr, g, b, mm, mv, axis=3, train=True,
                                        exact_var=exact)
    gx, gg, gb = torch.autograd.grad((out * _rows(r, rank)).sum(),
                                     (xr, g, b))
    tag = f"bn/{'exact' if exact else 'shifted'}"
    return {f"{tag}/{k}": v.detach().numpy() for k, v in
            dict(out=out, mean=nm, var=nv, gx=gx, ggamma=gg,
                 gbeta=gb).items()}


def _port_train(arch, mode, steps, mesh, vals):
    """Losses, then parameters and running statistics, momentum and the
    backward kernel wrapper's calls of one port SPMDTrainer run."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.gluon import load_numpy_params
    from mxnet_tpu_torch.gluon import loss as tloss
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
    from mxnet_tpu_torch.ops import fused_convbn as tfc

    fused, bwd = MODES[mode]
    os.environ["MXNET_FUSED_CONVBN"] = fused
    os.environ["MXNET_FUSED_CONVBN_BWD"] = bwd
    x, y = _data()
    net = ARCHS[arch](tres)
    net.initialize(ctx=mt.cpu())
    load_numpy_params(net, vals)
    tr = parallel.SPMDTrainer(net, tloss.SoftmaxCrossEntropyLoss(), "sgd",
                              dict(OPT), mesh=mesh)
    calls = []
    real = tfc.fused_conv_unit_bwd
    tfc.fused_conv_unit_bwd = lambda *a, **k: calls.append(1) or real(*a,
                                                                      **k)
    try:
        losses = [float(tr.step(x, y)) for _ in range(steps)]
    finally:
        tfc.fused_conv_unit_bwd = real
    tag = f"train/{arch}/{mode}/dp{mesh.size()}"
    res = {f"{tag}/losses": np.array(losses),
           f"{tag}/kernel_bwd_calls": np.array(len(calls))}
    for k, v in net.state_dict(keep_vars=True).items():
        res[f"{tag}/state/{k}"] = v.detach().numpy()
    for k in tr.opt_state:  # full size (gathered under ZeRO)
        res[f"{tag}/mom/{k}"] = tr.state_full(k)[0].numpy()
    return res


BERT_DROPOUT = dict(batch=4, seq=16, vocab=100, steps=2)


def _port_bert_dropout(mesh):
    """Two SGD steps of a tiny BERT at dropout 0.1 with a per-sample
    loss, from seed 0 (weights and the dropout generator)."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.gluon import HybridBlock
    from mxnet_tpu_torch.gluon import loss as tloss
    from mxnet_tpu_torch.gluon.model_zoo.bert import get_bert_model

    class Cls(HybridBlock):
        def __init__(self):
            super().__init__()
            self.bert = get_bert_model(
                "bert_12_768_12", vocab_size=BERT_DROPOUT["vocab"],
                dropout=0.1, num_layers=2, units=32, hidden_size=64,
                num_heads=4, max_length=BERT_DROPOUT["seq"])

        def hybrid_forward(self, F, tokens, segments, vlen):
            return self.bert.classify_nsp(
                self.bert(tokens, segments, vlen)[1])

    b, s = BERT_DROPOUT["batch"], BERT_DROPOUT["seq"]
    rs = np.random.RandomState(3)
    tokens = torch.from_numpy(rs.randint(5, BERT_DROPOUT["vocab"], (b, s)))
    segments = torch.zeros((b, s), dtype=torch.int32)
    vlen = torch.from_numpy(rs.randint(s // 2, s + 1, b).astype(np.float32))
    labels = torch.from_numpy(rs.randint(0, 2, b).astype(np.int32))
    net = Cls()
    net.initialize(mt.init.Normal(0.02), ctx=mt.cpu(), seed=0)
    for k, p in net.collect_params().items():
        if k.startswith("bert.mlm_decoder.") and k != \
                "bert.mlm_decoder.embed_weight":  # tied: word_embed
            p.grad_req = "null"  # the MLM head is off this loss's path
    net.hybridize()
    mt.random.seed(0)
    tr = parallel.SPMDTrainer(net, tloss.SoftmaxCrossEntropyLoss(), "sgd",
                              {"learning_rate": 0.05, "momentum": 0.9},
                              mesh=mesh)
    losses = [float(tr.step(tokens, segments, vlen, labels))
              for _ in range(BERT_DROPOUT["steps"])]
    tag = f"bert_dropout/dp{mesh.size()}"
    res = {f"{tag}/losses": np.array(losses)}
    for k, v in net.state_dict(keep_vars=True).items():
        res[f"{tag}/state/{k}"] = v.detach().numpy()
    for k in tr.opt_state:  # full size (gathered under ZeRO)
        res[f"{tag}/mom/{k}"] = tr.state_full(k)[0].numpy()
    return res


def _port_surface(rank, mesh):
    """What must raise, and what the group reports."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.gluon import loss as tloss
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres

    cpu = mt.cpu()

    def raises(fn, text):
        try:
            fn()
        except MXNetError as e:
            return text in str(e)
        return False
    net = ARCHS["bottleneck"](tres)
    net.initialize(ctx=cpu)
    tr = parallel.SPMDTrainer(net, tloss.SoftmaxCrossEntropyLoss(), "sgd",
                              dict(OPT), mesh=mesh)
    x, y = _data()
    default = parallel.make_mesh(devices=[cpu] * WORLD)
    checks = {
        "initialized": mt.dist.initialized(),
        "rank": mt.dist.rank() == rank,
        "num_workers": mt.dist.num_workers() == WORLD,
        "backend_gloo": mt.dist.backend() == "gloo",
        "default_mesh_dp_world": default.size("dp") == WORLD,
        "local_device": mesh.local_device == torch.device("cpu")
        and mesh.devices == [torch.device("cpu")] * WORLD,
        "dp_not_world_raises": raises(
            lambda: parallel.make_mesh(dp=4, devices=[cpu] * 4),
            "process group has 2 rank"),
        "tp_mesh": parallel.make_mesh(dp=1, tp=2, devices=[cpu] * 2
                                      ).coord("tp") == rank,
        "indivisible_batch_raises": raises(
            lambda: tr.step(x[:BATCH - 1], y[:BATCH - 1]), "does not divide"),
        "forward_gathers": tuple(tr.forward(x).shape) == (BATCH, 10),
        "shard_batch_rows": bool(np.array_equal(
            parallel.shard_batch(torch.from_numpy(x), mesh).numpy(),
            _rows(x, rank))),
    }
    return {f"surface/{k}": np.array(bool(v)) for k, v in checks.items()}


def _rank_main(out_dir, rank):
    """One rank: join the group from the DMLC_* environment, run every
    case, write rank<r>.npz."""
    torch.set_num_threads(1)
    from mxnet_tpu_torch import cpu, parallel

    parallel.dist.init(backend="gloo", timeout=120)
    mesh = parallel.make_mesh(dp=WORLD, devices=[cpu()] * WORLD)
    res = {}
    for case in UNIT_CASES:
        res.update(_port_unit(case, rank, mesh))
    for exact in (False, True):
        res.update(_port_bn(rank, mesh, exact))
    weights = np.load(os.path.join(out_dir, "weights.npz"))
    one = parallel.make_mesh(dp=1, devices=[cpu()])
    for i, arch in enumerate(sorted(ARCHS)):
        vals = {k[len(arch) + 1:]: weights[k] for k in weights.files
                if k.startswith(arch + "/")}
        for mode in sorted(MODES):
            res.update(_port_train(arch, mode, STEPS, mesh, vals))
        if i % WORLD == rank:  # the dp=1 runs, split over the ranks
            for mode in sorted(MODES):
                res.update(_port_train(arch, mode, STEPS, one, vals))
    res.update(_port_surface(rank, mesh))
    eager0 = parallel.spmd.step_compile_stats()["eager"]
    res.update(_port_bert_dropout(mesh))
    res["surface/dp2_steps_eager"] = np.array(
        parallel.spmd.step_compile_stats()["eager"] - eager0
        == BERT_DROPOUT["steps"])
    if rank == 0:
        res.update(_port_bert_dropout(one))
    parallel.dist.barrier()
    parallel.dist.shutdown()
    clean = not any(m == "jax" or m.startswith(("jax.", "mxnet_tpu."))
                    or m == "mxnet_tpu" for m in sys.modules)
    res["surface/no_jax_imported"] = np.array(clean)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)


# ---------------------------------------------------------------------------
# the pytest side
# ---------------------------------------------------------------------------

def _weights():
    """Per architecture: the port net's Xavier weights by structural name,
    each running mean at its layer's mean over the batch (one float64
    train forward from zero means leaves 0.1x it)."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.gluon import ActiveTrace
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres

    x, _ = _data()
    out = {}
    for arch, make in ARCHS.items():
        net = make(tres)
        net.initialize(mt.init.Xavier(), ctx=mt.cpu(), seed=0)
        vals = {k: v.detach().numpy().copy()
                for k, v in net.state_dict(keep_vars=True).items()}
        net.double()
        with torch.no_grad(), ActiveTrace(train=True):
            net(torch.from_numpy(x).double())
        for k, v in net.state_dict(keep_vars=True).items():
            if k.endswith("running_mean"):
                vals[k] = (v.numpy() / 0.1).astype(np.float32)
        out.update({f"{arch}/{k}": v for k, v in vals.items()})
    return out


class _Ranks:
    """The two rank processes: started at once, read when done; a rank
    that fails or outlives the timeout fails the group and its peer is
    killed."""

    def __init__(self, out_dir):
        self.dir = out_dir
        self.t0 = time.monotonic()
        env = dict(os.environ,
                   PYTHONPATH=os.pathsep.join(
                       [REPO] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]),
                   COORDINATOR_ADDRESS=f"file://{out_dir}/rendezvous",
                   DMLC_NUM_WORKER=str(WORLD))
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(out_dir),
             str(r)], env=dict(env, DMLC_WORKER_ID=str(r)), cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(WORLD)]
        self._res = None

    def results(self):
        if self._res is not None:
            return self._res
        errors = []
        while any(p.poll() is None for p in self.procs):
            if any(p.poll() not in (None, 0) for p in self.procs) or \
                    time.monotonic() - self.t0 > SPAWN_TIMEOUT:
                break
            time.sleep(0.1)
        for r, p in enumerate(self.procs):
            if p.poll() is None:
                p.kill()
                errors.append(f"rank {r}: killed (peer failed or timeout "
                              f"{SPAWN_TIMEOUT} s)")
            out = p.communicate()[0]
            if p.returncode != 0:
                errors.append(f"rank {r} exit {p.returncode}:\n{out[-3000:]}")
        if errors:
            pytest.fail("\n".join(errors))
        self._res = [dict(np.load(os.path.join(self.dir, f"rank{r}.npz")))
                     for r in range(WORLD)]
        return self._res


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    np.savez(d / "weights.npz", **_weights())
    group = _Ranks(d)
    yield group
    for p in group.procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def weights(ranks):
    w = np.load(os.path.join(ranks.dir, "weights.npz"))
    return {arch: {k[len(arch) + 1:]: w[k] for k in w.files
                   if k.startswith(arch + "/")} for arch in ARCHS}


def _close(got, want, tol=1e-5, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: {err:.3g} of max|ref| > {tol}"


def _cat(res, key):
    return np.concatenate([r[key] for r in res])


def _sum(res, key):
    return sum(np.asarray(r[key], np.float64) for r in res)


@pytest.mark.parametrize("case", UNIT_CASES, ids=[c[0] for c in UNIT_CASES])
def test_sharded_unit_matches_jax_dp2(case, ranks, monkeypatch):
    import jax
    import jax.numpy as jnp

    from mxnet_tpu import parallel as jpar
    from mxnet_tpu.ops import pallas_convbn as pcb

    name, shape, co, kernel, stride, pad, stats, knob = case
    x, w, sc, bi, sh = (jnp.asarray(a) for a in
                        _unit_arrays(shape, co, kernel))
    monkeypatch.setenv("MXNET_USE_PALLAS", "1")
    monkeypatch.setenv("MXNET_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("MXNET_FUSED_CONVBN_BWD", knob)
    monkeypatch.setitem(pcb._STATE, "enabled", None)
    calls = {"fwd": 0, "bwd": 0}
    for fn, key in (("_pallas_unit_sharded", "fwd"),
                    ("_pallas_unit_bwd_sharded", "bwd")):
        real = getattr(pcb, fn)
        monkeypatch.setattr(pcb, fn, lambda *a, _r=real, _k=key, **k: (
            calls.__setitem__(_k, calls[_k] + 1), _r(*a, **k))[1])

    def unit(x, w, sc, bi):
        return pcb.fused_conv_unit(x, w, sc, bi, sh, kernel=kernel,
                                   stride=stride, pad=pad, act_in=True,
                                   want_stats=stats)

    with jpar.make_mesh(dp=WORLD):
        (y, s1, s2), vjp = jax.vjp(unit, x, w, sc, bi)
        # the cotangents of Σy² + 1e-3·Σs1² + 1e-3·Σs2
        k = 1e-3 if stats else 0.0
        grads = vjp((2.0 * y, 2.0 * k * s1, jnp.full_like(s2, k)))
    assert calls["fwd"] >= 1
    assert calls["bwd"] == (1 if knob == "1" and stride == (1, 1) else 0)
    res = ranks.results()
    p = f"unit/{name}/"
    _close(_cat(res, p + "y"), y, what="y")
    _close(_cat(res, p + "gx"), grads[0], what="gx")
    for k, ref in (("s1", s1), ("s2", s2)):
        for r in res:
            _close(r[p + k], ref, what=k)
    for k, ref in zip(("dw", "gscale", "gbias"), grads[1:]):
        _close(_sum(res, p + k), ref, what=f"Σ_ranks {k}")
    want_calls = int(knob == "1" and stride == (1, 1))
    assert all(int(r[p + "kernel_bwd_calls"]) == want_calls for r in res)


@pytest.mark.parametrize("exact", [False, True], ids=["shifted", "exact"])
def test_synced_batch_norm_matches_dp1_and_jax(exact, ranks):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import mxnet_tpu_torch as mt
    from mxnet_tpu import parallel as jpar
    from mxnet_tpu.ops.nn import _batch_norm

    x, gamma, beta, mm, mv, r = _bn_arrays()
    # the port, one process, the whole batch
    tx, tg, tb = (torch.from_numpy(a).requires_grad_(True)
                  for a in (x, gamma, beta))
    out, nm, nv = mt.ops.batch_norm(tx, tg, tb, torch.from_numpy(mm),
                                    torch.from_numpy(mv), axis=3, train=True,
                                    exact_var=exact)
    g1 = torch.autograd.grad((out * torch.from_numpy(r)).sum(), (tx, tg, tb))
    dp1 = dict(out=out, mean=nm, var=nv, gx=g1[0], ggamma=g1[1], gbeta=g1[2])
    dp1 = {k: v.detach().numpy() for k, v in dp1.items()}
    # the JAX package, x sharded over dp=2 under jit

    def f(x, g, b):
        o, m_, v_ = _batch_norm(x, g, b, jnp.asarray(mm), jnp.asarray(mv),
                                axis=3, _train=True, exact_var=exact)
        return (o * jnp.asarray(r)).sum(), (o, m_, v_)
    mesh = jpar.make_mesh(dp=WORLD)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh.mesh, P("dp")))
    (_, (o, m_, v_)), gj = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(xs, jnp.asarray(gamma),
                                              jnp.asarray(beta))
    jx = dict(out=o, mean=m_, var=v_, gx=gj[0], ggamma=gj[1], gbeta=gj[2])
    res = ranks.results()
    p = f"bn/{'exact' if exact else 'shifted'}/"
    got = {"out": _cat(res, p + "out"), "gx": _cat(res, p + "gx"),
           "ggamma": _sum(res, p + "ggamma"), "gbeta": _sum(res, p + "gbeta")}
    for k in ("mean", "var"):
        assert np.array_equal(res[0][p + k], res[1][p + k]), k
        got[k] = res[0][p + k]
    for k, v in got.items():
        _close(v, dp1[k], what=f"{k} vs port dp=1")
        _close(v, np.asarray(jx[k]), what=f"{k} vs JAX dp=2")


def _jax_train(arch, vals, fused, monkeypatch):
    """JAX SPMDTrainer on make_mesh(dp=2): per-step losses, then params,
    running statistics and momentum by structural name."""
    import mxnet_tpu as mx
    from mxnet_tpu import parallel as jpar
    from mxnet_tpu.gluon import loss as jloss
    from mxnet_tpu.gluon.model_zoo.vision import resnet as jres

    monkeypatch.setenv("MXNET_FUSED_CONVBN", "1" if fused else "0")
    x, y = _data()
    net = ARCHS[arch](jres)
    net.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    net(mx.nd.array(x))
    params = net._collect_params_with_prefix()
    for k, p in params.items():
        p.set_data(mx.nd.array(vals[k]))
    with jpar.make_mesh(dp=WORLD):
        tr = jpar.SPMDTrainer(net, jloss.SoftmaxCrossEntropyLoss(), "sgd",
                              dict(OPT))
        losses = [float(tr.step(x, y).asnumpy()) for _ in range(STEPS)]
    f32 = lambda v: np.asarray(v).astype(np.float32)
    state = {k: f32(tr.params[p.name]) for k, p in params.items()}
    mom = {k: f32(tr.opt_state[p.name][0]) for k, p in params.items()
           if p.name in tr.opt_state}
    return losses, state, mom


_JAX_TRAIN = {}
# (arch, fused) of the JAX dp=2 runs: each compiles a sharded step of
# 6-15 s on the CPU, so resnet18 op-granular is held against the port's
# dp=1 run only (which test_torch_resnet_train holds against JAX dp=1)
JAX_TRAIN_RUNS = {("bottleneck", False), ("bottleneck", True),
                  ("resnet18", True)}


def _assert_train_close(losses, state, mom, ref, what):
    """test_torch_resnet_train's tolerances."""
    rl, rs, rm = ref
    np.testing.assert_allclose(losses, rl, rtol=1e-4, err_msg=what)
    assert set(state) == set(rs) and set(mom) == set(rm), what
    for k in rs:
        np.testing.assert_allclose(
            state[k], rs[k], rtol=1e-4,
            atol=1e-4 * float(np.abs(rs[k]).max()) + 1e-6,
            err_msg=f"{what}: {k}")
    for k in rm:
        np.testing.assert_allclose(
            mom[k], rm[k], rtol=1e-4,
            atol=5e-3 * float(np.abs(rm[k]).max()) + 1e-7,
            err_msg=f"{what}: mom {k}")


def _unpack(res, tag):
    losses = res[f"{tag}/losses"]
    state = {k[len(tag) + 7:]: v for k, v in res.items()
             if k.startswith(f"{tag}/state/")}
    mom = {k[len(tag) + 5:]: v for k, v in res.items()
           if k.startswith(f"{tag}/mom/")}
    return losses, state, mom


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_dp2_trainer_matches_jax_dp2_and_port_dp1(arch, mode, weights, ranks,
                                                  monkeypatch):
    fused = mode != "unfused"
    key = (arch, fused)
    if key in JAX_TRAIN_RUNS and key not in _JAX_TRAIN:
        _JAX_TRAIN[key] = _jax_train(arch, weights[arch], fused, monkeypatch)
    res = ranks.results()
    tag = f"train/{arch}/{mode}/dp{WORLD}"
    r0 = res[0]
    for k in r0:
        if k.startswith(tag + "/"):
            assert np.array_equal(r0[k], res[1][k]), f"ranks differ: {k}"
    got = _unpack(r0, tag)
    if key in JAX_TRAIN_RUNS:
        _assert_train_close(*got, _JAX_TRAIN[key],
                            f"{arch} {mode} vs JAX dp=2")
    one = f"train/{arch}/{mode}/dp1"
    owner = next(r for r in res if f"{one}/losses" in r)
    _assert_train_close(*got, _unpack(owner, one),
                        f"{arch} {mode} vs port dp=1")
    want = STEPS * STRIDE1_UNITS[arch] if mode == "fused_bwd" else 0
    assert int(r0[f"{tag}/kernel_bwd_calls"]) == want
    assert int(owner[f"{one}/kernel_bwd_calls"]) == want


def test_dropout_dp2_matches_dp1(ranks):
    """The dp=2 run drops what the dp=1 run drops (see the module
    docstring); under the per-rank draw it did not."""
    r0, r1 = ranks.results()
    dp2 = {k[len("bert_dropout/dp2/"):]: v for k, v in r0.items()
           if k.startswith("bert_dropout/dp2/")}
    assert dp2 and "losses" in dp2
    for k, v in dp2.items():
        np.testing.assert_array_equal(r1[f"bert_dropout/dp2/{k}"], v,
                                      err_msg=f"ranks differ: {k}")
        ref = r0[f"bert_dropout/dp1/{k}"]
        err = float(np.abs(v - ref).max())
        assert err <= 1e-5 * max(1.0, float(np.abs(ref).max())), (k, err)


def test_dist_surface(ranks):
    res = ranks.results()
    for r, got in enumerate(res):
        bad = [k for k, v in got.items()
               if k.startswith("surface/") and not bool(v)]
        assert not bad, f"rank {r}: {bad}"


def test_dist_resolve_reads_the_dmlc_contract(monkeypatch):
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.parallel import dist

    for k in ("DMLC_PS_ROOT_URI", "DMLC_PS_ROOT_PORT", "DMLC_NUM_WORKER",
              "DMLC_WORKER_ID", "COORDINATOR_ADDRESS", "NUM_PROCESSES",
              "PROCESS_ID", "OMPI_COMM_WORLD_RANK", "PMI_RANK",
              "SLURM_PROCID"):
        monkeypatch.delenv(k, raising=False)
    assert dist.resolve() == (None, None, None)
    monkeypatch.setenv("DMLC_PS_ROOT_URI", "10.0.0.7")
    monkeypatch.setenv("DMLC_NUM_WORKER", "4")
    monkeypatch.setenv("DMLC_WORKER_ID", "3")
    assert dist.resolve() == ("tcp://10.0.0.7:9091", 4, 3)
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", "9200")
    assert dist.resolve(process_id=1) == ("tcp://10.0.0.7:9200", 4, 1)
    assert dist.resolve("file:///tmp/x", 2, 0) == ("file:///tmp/x", 2, 0)
    with pytest.raises(MXNetError, match="backend"):
        dist.init(backend="mpi")
    assert dist.rank() == 0 and dist.num_workers() == 1


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
