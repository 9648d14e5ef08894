"""SPMDTrainer's JAX keywords and state features in the port, on the CPU.

Net: test_torch_resnet_train's narrow ``ResNetV1(BottleneckV1, [1, 1, 1,
1], [8, 32, 64, 128, 256])``, NHWC, batch 16 at 32x32, SGD (momentum
0.9, wd 1e-4, lr 1e-3), weights from the port's Xavier (seed 0) with
warm running means, carried to the JAX package by structural name.

* remat: two steps with and without ``remat=True`` give the same bits
  (loss, parameters, running statistics, momentum), op-granular, fused
  and fused with the fused backward, and on the same widths in ResNet V2
  (every conv and BatchNorm a segment).
* ZeRO-1 (``MXNET_ZERO_STATES``) at dp = 2: two rank processes of this
  file (``python tests/test_torch_spmd_features.py <dir> <rank>``, gloo
  on the CPU, as ``tests/test_torch_dist.py``).  On and off give the
  same bits, op-granular and fused with the fused backward; each split
  state holds 1/2 of its dim, on the dim the JAX trainer's state
  sharding splits; ``MXNET_ZERO_MIN_SIZE`` keeps smaller tensors
  replicated; the ZeRO run is held against the JAX ``SPMDTrainer`` on
  ``make_mesh(dp=2)`` at test_torch_resnet_train's tolerances.
* batch/label specs: ``P()`` for both at dp = 2 gives every rank the
  whole batch, and the step is the dp = 1 step on it, bit for bit; so
  does ``P(None, "dp")`` for the input (its dim 1 split, the label's
  rows not alone split), which is also the JAX trainer's dp = 2 step
  with the same spec; at dp = 1 a spec changes nothing.
* Checkpoints: five steps uninterrupted at dp = 1 and at dp = 2, each
  saved after step 3.  Resuming a checkpoint on the same dp size gives
  the uninterrupted run's bits; dp 1 -> 2 and 2 -> 1 land within the
  dp = 1 vs dp = 2 tolerances of the uninterrupted run (the two sizes
  sum the batch in different orders).  A checkpoint of another
  parameter set raises the JAX package's message.
* ``multi_precision=True`` on a bf16 MLP: two SGD steps through both
  packages' ``SPMDTrainer``.  In each package the bf16 weight is its
  fp32 master (the last state) rounded.  The momentum and the master's
  update within 2^-6 of the tensor's largest magnitude (the two
  packages round a bf16 gradient at different points: the layer's own
  product and the cotangent it receives, each step; measured up to
  1.0%, on the first layer's bias), the bf16 weights
  within one bf16 ulp of the JAX package's plus that bound of the
  masters.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

WORLD = 2
BATCH, SIZE = 16, 32
OPT = {"learning_rate": 1e-3, "momentum": 0.9, "wd": 1e-4}
MODES = {"unfused": ("0", "0"), "fused": ("1", "0"), "fused_bwd": ("1", "1")}
ZERO_MIN = 20000  # the MXNET_ZERO_MIN_SIZE of the min-size check
CKPT_STEPS, CKPT_AT = 5, 3
SPAWN_TIMEOUT = 240.0
MP_TOL = 2.0 ** -6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _make(r):
    return r.ResNetV1(r.BottleneckV1, [1, 1, 1, 1], [8, 32, 64, 128, 256],
                      classes=10, layout="NHWC")


def _data():
    x = np.random.RandomState(7).rand(BATCH, SIZE, SIZE, 3).astype(
        np.float32)
    y = (np.arange(BATCH) % 10).astype(np.int32)
    return x, y


def _weights():
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.gluon import ActiveTrace
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres

    x, _ = _data()
    net = _make(tres)
    net.initialize(mt.init.Xavier(), ctx=mt.cpu(), seed=0)
    vals = {k: v.detach().numpy().copy()
            for k, v in net.state_dict(keep_vars=True).items()}
    net.double()
    with torch.no_grad(), ActiveTrace(train=True):
        net(torch.from_numpy(x).double())
    for k, v in net.state_dict(keep_vars=True).items():
        if k.endswith("running_mean"):
            vals[k] = (v.numpy() / 0.1).astype(np.float32)
    return vals


def _trainer(vals, mesh, **kw):
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.gluon import load_numpy_params
    from mxnet_tpu_torch.gluon import loss as tloss
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres

    net = _make(tres)
    net.initialize(ctx=mt.cpu())
    load_numpy_params(net, vals)
    return parallel.SPMDTrainer(net, tloss.SoftmaxCrossEntropyLoss(), "sgd",
                                dict(OPT), mesh=mesh, **kw)


def _record(tr, losses):
    """Losses, parameters and buffers, full-size momentum (a collective
    under ZeRO: every rank calls it)."""
    out = {"losses": np.array(losses)}
    for k, v in tr.block.state_dict(keep_vars=True).items():
        out[f"state/{k}"] = v.detach().numpy().copy()
    for k in tr.opt_state:
        out[f"mom/{k}"] = tr.state_full(k)[0].numpy().copy()
    return out


def _steps(tr, n):
    x, y = _data()
    return [float(tr.step(x, y)) for _ in range(n)]


def _set_modes(mode):
    fused, bwd = MODES[mode]
    os.environ["MXNET_FUSED_CONVBN"] = fused
    os.environ["MXNET_FUSED_CONVBN_BWD"] = bwd


def _ckpt_run(vals, mesh, save_dir):
    """Five steps, saved after step 3 when ``save_dir`` is given."""
    tr = _trainer(vals, mesh)
    losses = _steps(tr, CKPT_AT)
    if save_dir is not None:
        tr.save_checkpoint(save_dir)
    losses += _steps(tr, CKPT_STEPS - CKPT_AT)
    return _record(tr, losses)


def _resume(vals, mesh, ckpt):
    tr = _trainer(vals, mesh)
    tr.load_checkpoint(ckpt)
    assert tr._t == CKPT_AT
    return _record(tr, _steps(tr, CKPT_STEPS - CKPT_AT))


# ---------------------------------------------------------------------------
# the rank processes (port only)
# ---------------------------------------------------------------------------

def _raises(fn, text):
    from mxnet_tpu_torch.base import MXNetError

    try:
        fn()
    except MXNetError as e:
        return text in str(e)
    return False


def _rank_main(out_dir, rank):
    torch.set_num_threads(1)
    from mxnet_tpu_torch import cpu, parallel
    from mxnet_tpu_torch.parallel.sharding import P, ShardingRules

    parallel.dist.init(backend="gloo", timeout=120)
    mesh = parallel.make_mesh(dp=WORLD, devices=[cpu()] * WORLD)
    w = np.load(os.path.join(out_dir, "weights.npz"))
    vals = {k: w[k] for k in w.files}
    res = {}

    def put(tag, rec):
        res.update({f"{tag}/{k}": v for k, v in rec.items()})

    for mode in ("unfused", "fused_bwd"):
        _set_modes(mode)
        for zero in ("1", "0"):
            os.environ["MXNET_ZERO_STATES"] = zero
            tr = _trainer(vals, mesh)
            put(f"zero{zero}/{mode}", _record(tr, _steps(tr, 2)))
            if zero == "1" and mode == "unfused":
                for n, st in tr.opt_state.items():
                    res[f"blocks/{n}"] = np.array(st[0].shape)
                    res[f"dims/{n}"] = np.array(tr._zero_dims.get(n, -1))
    _set_modes("unfused")
    os.environ["MXNET_ZERO_STATES"] = "1"
    os.environ["MXNET_ZERO_MIN_SIZE"] = str(ZERO_MIN)
    tr = _trainer(vals, mesh)
    res["min_size_split"] = np.array(sorted(tr._zero_dims), dtype=object)
    del os.environ["MXNET_ZERO_MIN_SIZE"]
    tr = _trainer(vals, mesh, rules=ShardingRules(
        [(r".*weight$", P("dp", None, None, None))]))
    res["surface/rule_splitting_a_parameter_keeps_a_block"] = np.array(
        bool(tr._specs) and all(
            tr.params[n].shape[0] * WORLD == tr._shapes[n][0]
            for n in tr._specs))
    # a spec splitting dim 1 over dp: the input placed whole, and with
    # the label's rows not alone split, the step runs whole on each rank
    tr = _trainer(vals, mesh, batch_spec=[P(None, "dp")])
    put("spec_dim1", _record(tr, _steps(tr, 2)))
    tr = _trainer(vals, mesh, batch_spec=[P()], label_spec=[P()])
    put("replicated", _record(tr, _steps(tr, 2)))
    # the dp = 1 step it must equal, on a rank's single thread (the
    # pytest process sums a convolution over several threads)
    tr = _trainer(vals, parallel.make_mesh(dp=1, devices=[cpu()]))
    put("dp1", _record(tr, _steps(tr, 2)))
    put("ckpt/dp2", _ckpt_run(vals, mesh, os.path.join(out_dir, "ckpt2")))
    put("resume/2to2", _resume(vals, mesh, os.path.join(out_dir, "ckpt2")))
    put("resume/1to2", _resume(vals, mesh, os.path.join(out_dir, "ckpt1")))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)


class _Ranks:
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
        self._res = [dict(np.load(os.path.join(self.dir, f"rank{r}.npz"),
                                  allow_pickle=True)) for r in range(WORLD)]
        return self._res


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The weights, the dp = 1 uninterrupted run with its checkpoint
    (which the ranks resume at dp = 2), then the ranks, started."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import parallel

    for k in ("MXNET_FUSED_CONVBN", "MXNET_FUSED_CONVBN_BWD",
              "MXNET_ZERO_STATES", "MXNET_ZERO_MIN_SIZE"):
        os.environ.pop(k, None)
    d = tmp_path_factory.mktemp("spmd_features")
    vals = _weights()
    np.savez(d / "weights.npz", **vals)
    one = parallel.make_mesh(dp=1, devices=[mt.cpu()])
    dp1 = _ckpt_run(vals, one, str(d / "ckpt1"))
    group = _Ranks(d)
    yield d, vals, one, dp1, group
    for p in group.procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


def _sub(res, tag):
    return {k[len(tag) + 1:]: v for k, v in res.items()
            if k.startswith(tag + "/")}


def _same(a, b, what):
    assert sorted(a) == sorted(b), what
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what}: {k}")


def _close_run(got, ref, what):
    """test_torch_resnet_train's tolerances (loss 1e-4; parameters and
    statistics 1e-4 + 1e-4 of the largest; momentum 1e-4 + 5e-3)."""
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4,
                               err_msg=what)
    for k, v in ref.items():
        if k == "losses":
            continue
        atol = (5e-3 if k.startswith("mom/") else 1e-4) * float(
            np.abs(v).max()) + 1e-6
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=atol,
                                   err_msg=f"{what}: {k}")


def _tail(run):
    """An uninterrupted run as a resumed one records it: the losses of
    the steps after the checkpoint."""
    return dict(run, losses=run["losses"][CKPT_AT:])


def _ranks_agree(res, tag):
    a, b = _sub(res[0], tag), _sub(res[1], tag)
    assert a
    _same(a, b, f"ranks differ in {tag}")
    return a


# ---------------------------------------------------------------------------
# dp = 1 in this process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", sorted(MODES))
def test_remat_is_bit_identical(mode, setup, monkeypatch):
    _, vals, one, _, _ = setup
    fused, bwd = MODES[mode]
    monkeypatch.setenv("MXNET_FUSED_CONVBN", fused)
    monkeypatch.setenv("MXNET_FUSED_CONVBN_BWD", bwd)
    runs = []
    for remat in (False, True):
        tr = _trainer(vals, one, remat=remat)
        runs.append(_record(tr, _steps(tr, 2)))
    _same(runs[1], runs[0], f"remat {mode}")


def test_remat_is_bit_identical_on_resnet_v2():
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.gluon import load_numpy_params
    from mxnet_tpu_torch.gluon import loss as tloss
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet

    x, y = _data()
    mesh = parallel.make_mesh(dp=1, devices=[mt.cpu()])
    vals, runs = None, []
    for remat in (False, True):
        net = resnet.ResNetV2(resnet.BottleneckV2, [1, 1, 1, 1],
                              [8, 32, 64, 128, 256], classes=10,
                              layout="NHWC")
        net.initialize(mt.init.Xavier(), ctx=mt.cpu(), seed=1)
        if vals is None:
            vals = {k: v.detach().numpy().copy()
                    for k, v in net.state_dict().items()}
        load_numpy_params(net, vals)
        tr = parallel.SPMDTrainer(net, tloss.SoftmaxCrossEntropyLoss(),
                                  "sgd", dict(OPT), mesh=mesh, remat=remat)
        runs.append(_record(tr, [float(tr.step(x, y)) for _ in range(2)]))
    _same(runs[1], runs[0], "remat ResNetV2")


def test_specs_change_nothing_at_dp1(setup):
    from mxnet_tpu_torch.parallel.sharding import P, ShardingRules

    _, vals, one, _, _ = setup
    runs = []
    for kw in ({}, {"batch_spec": [P("dp")], "label_spec": [P()]},
               {"donate": False,
                "rules": ShardingRules([(r".*weight$", P("dp", None))])}):
        tr = _trainer(vals, one, **kw)
        runs.append(_record(tr, _steps(tr, 2)))
    _same(runs[1], runs[0], "batch/label specs at dp=1")
    _same(runs[2], runs[0], "rules/donate at dp=1")


def test_checkpoint_resume_same_dp_is_bit_identical(setup):
    d, vals, one, dp1, _ = setup
    _same(_resume(vals, one, str(d / "ckpt1")), _tail(dp1), "resume 1->1")
    import json
    with open(d / "ckpt1" / "manifest.json") as f:
        man = json.load(f)
    assert man["step"] == CKPT_AT and man["dp"] == 1


def test_checkpoint_of_another_parameter_set_raises(setup, tmp_path):
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.gluon import loss as tloss
    from mxnet_tpu_torch.gluon.model_zoo import vision

    d, _, one, _, _ = setup
    net = vision.resnet18_v1(classes=10, layout="NHWC")
    net.initialize(ctx=mt.cpu())
    tr = parallel.SPMDTrainer(net, tloss.SoftmaxCrossEntropyLoss(), "sgd",
                              dict(OPT), mesh=one)
    with pytest.raises(MXNetError, match="checkpoint parameter set does "
                                         "not match the model: missing "
                                         "from checkpoint"):
        tr.load_checkpoint(str(d / "ckpt1"))


# ---------------------------------------------------------------------------
# dp = 2 (the ranks)
# ---------------------------------------------------------------------------

def _jax_dp2(vals, monkeypatch, batch_spec=None):
    import mxnet_tpu as mx
    from mxnet_tpu import parallel as jpar
    from mxnet_tpu.gluon import loss as jloss
    from mxnet_tpu.gluon.model_zoo.vision import resnet as jres

    monkeypatch.setenv("MXNET_FUSED_CONVBN", "0")
    monkeypatch.delenv("MXNET_ZERO_STATES", raising=False)
    x, y = _data()
    net = _make(jres)
    net.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    net(mx.nd.array(x))
    params = net._collect_params_with_prefix()
    for k, p in params.items():
        p.set_data(mx.nd.array(vals[k]))
    with jpar.make_mesh(dp=WORLD):
        tr = jpar.SPMDTrainer(net, jloss.SoftmaxCrossEntropyLoss(), "sgd",
                              dict(OPT), batch_spec=batch_spec)
        losses = [float(tr.step(x, y).asnumpy()) for _ in range(2)]
    rec = {"losses": np.array(losses)}
    dims = {}
    for k, p in params.items():
        rec[f"state/{k}"] = np.asarray(tr.params[p.name]).astype(np.float32)
        if p.name in tr.opt_state:
            rec[f"mom/{k}"] = np.asarray(tr.opt_state[p.name][0]).astype(
                np.float32)
            spec = tr._state_shardings[p.name].spec
            split = [i for i, e in enumerate(spec) if e is not None]
            dims[k] = split[0] if split else -1
    return rec, dims


def test_zero_dp2_matches_zero_off_and_jax(setup, monkeypatch):
    _, vals, _, _, group = setup
    jrec, jdims = _jax_dp2(vals, monkeypatch)
    res = group.results()
    for mode in ("unfused", "fused_bwd"):
        on = _ranks_agree(res, f"zero1/{mode}")
        off = _ranks_agree(res, f"zero0/{mode}")
        _same(on, off, f"ZeRO on vs off, {mode}")
    _close_run(_sub(res[0], "zero1/unfused"), jrec, "ZeRO dp=2 vs JAX dp=2")
    r0 = res[0]
    names = sorted(k[len("dims/"):] for k in r0 if k.startswith("dims/"))
    assert names and set(names) == set(jdims)
    split = 0
    for n in names:
        d = int(r0[f"dims/{n}"])
        assert d == jdims[n], (n, d, jdims[n])
        full = vals[n].shape
        want = list(full)
        if d >= 0:
            want[d] //= WORLD
            split += 1
        assert tuple(r0[f"blocks/{n}"]) == tuple(want), n
        assert (d >= 0) == (vals[n].size >= 2048), n
    assert 0 < split < len(names)
    big = sorted(n for n in names if vals[n].size >= ZERO_MIN)
    assert list(r0["min_size_split"]) == big


def test_replicated_specs_dp2_are_the_dp1_step(setup):
    res = setup[4].results()
    _same(_ranks_agree(res, "replicated"), _ranks_agree(res, "dp1"),
          "P() specs at dp=2 vs dp=1")


def test_spec_splitting_dim1_is_the_global_step(setup, monkeypatch):
    from mxnet_tpu.parallel.sharding import P as JP

    res = setup[4].results()
    got = _ranks_agree(res, "spec_dim1")
    _same(got, _ranks_agree(res, "dp1"), "P(None, 'dp') at dp=2 vs dp=1")
    jrec, _ = _jax_dp2(setup[1], monkeypatch, batch_spec=[JP(None, "dp")])
    _close_run(got, jrec, "P(None, 'dp') at dp=2 vs JAX dp=2, same spec")


def test_what_raises_at_dp2(setup):
    for r, res in enumerate(setup[4].results()):
        bad = [k for k, v in res.items()
               if k.startswith("surface/") and not bool(v)]
        assert not bad, f"rank {r}: {bad}"


def test_checkpoint_resume_across_dp_sizes(setup):
    d, vals, one, dp1, group = setup
    res = group.results()
    dp2 = _ranks_agree(res, "ckpt/dp2")
    _same(_ranks_agree(res, "resume/2to2"), _tail(dp2), "resume 2->2")
    _close_run(_ranks_agree(res, "resume/1to2"), _tail(dp1), "resume 1->2")
    _close_run(_resume(vals, one, str(d / "ckpt2")), _tail(dp2),
               "resume 2->1")
    _close_run(dp2, dp1, "dp=2 vs dp=1 uninterrupted")


# ---------------------------------------------------------------------------
# multi_precision
# ---------------------------------------------------------------------------

def test_multi_precision_matches_jax():
    import ml_dtypes
    import mxnet_tpu as mx
    from mxnet_tpu import parallel as jpar
    from mxnet_tpu.gluon import loss as jloss
    from mxnet_tpu.gluon import nn as jnn

    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.gluon import load_numpy_params
    from mxnet_tpu_torch.gluon import loss as tloss
    from mxnet_tpu_torch.gluon import nn as tnn

    rs = np.random.RandomState(4)
    x = rs.standard_normal((32, 24)).astype(np.float32)
    y = (np.arange(32) % 5).astype(np.int32)
    opt = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4,
           "multi_precision": True}

    def mlp(nn):
        net = nn.HybridSequential()
        net.add(nn.Dense(64, activation="relu", in_units=24))
        net.add(nn.Dense(5, in_units=64))
        return net

    tnet = mlp(tnn)
    tnet.initialize(mt.init.Xavier(), ctx=mt.cpu(), seed=2)
    vals = {k: v.detach().numpy().copy() for k, v in
            tnet.state_dict().items()}
    tnet.cast("bfloat16")
    tr = parallel.SPMDTrainer(tnet, tloss.SoftmaxCrossEntropyLoss(), "sgd",
                              dict(opt), mesh=parallel.make_mesh(
                                  dp=1, devices=[mt.cpu()]))
    xb = torch.from_numpy(x).bfloat16()
    for _ in range(2):
        tr.step(xb, torch.from_numpy(y))

    jnet = mlp(jnn)
    jnet.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    jparams = jnet._collect_params_with_prefix()
    for k, p in jparams.items():
        p.set_data(mx.nd.array(vals[k]))
    jnet.cast("bfloat16")
    with jpar.make_mesh(dp=1):
        jtr = jpar.SPMDTrainer(jnet, jloss.SoftmaxCrossEntropyLoss(), "sgd",
                               dict(opt))
        for _ in range(2):
            jtr.step(mx.nd.array(x.astype(ml_dtypes.bfloat16),
                                 dtype=ml_dtypes.bfloat16), y)
    for k, p in jparams.items():
        jst = [np.asarray(s, np.float32) for s in jtr.opt_state[p.name]]
        tst = [s.float().numpy() for s in tr.opt_state[k]]
        assert len(jst) == len(tst) == 2, k  # momentum, fp32 master
        w0 = vals[k]
        for what, got, want in (("momentum", tst[0], jst[0]),
                                ("master update", tst[1] - w0, jst[1] - w0)):
            np.testing.assert_allclose(
                got, want, rtol=0, atol=MP_TOL * float(np.abs(want).max()),
                err_msg=f"{k} {what}")
        w = tr.params[k]
        assert w.dtype == torch.bfloat16
        # each package's bf16 weight is its master rounded
        assert torch.equal(w, tr.opt_state[k][1].bfloat16()), k
        jw = np.asarray(jtr.params[p.name])
        np.testing.assert_array_equal(jw, jst[1].astype(jw.dtype))
        jw = jw.astype(np.float32)
        tw = w.detach().float().numpy()
        big = np.maximum(np.abs(jw), np.abs(tw))
        ulp = 2.0 ** (np.floor(np.log2(big + 1e-30)) - 7)
        # one rounding of masters that lie the update bound apart
        bad = np.abs(tw - jw) > ulp + MP_TOL * float(
            np.abs(jst[1] - w0).max())
        assert not bad.any(), (k, tw[bad][:5], jw[bad][:5], ulp[bad][:5])


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
