"""The long-context LM of ``mxnet_tpu_torch/examples/long_context_lm.py``
against the JAX package's ``examples/long_context_lm.py`` on the CPU.

The port's side runs in gloo rank processes of this file, started by
``tests/torch_ranks.py``: two ranks for dp = 1 x sp = 2, four for
dp = 2 x sp = 2.  The JAX side runs the JAX script's ``LM`` (copied in
``tests/torch_lm_jax.py``) through its ``SPMDTrainer`` on the same mesh
over the conftest's virtual CPU devices.  Both start from the JAX
block's Xavier weights, carried across by structural name, on the
script's synthetic next-token task (``RandomState(1)``), at 16 units, 4
heads, 2 layers, vocabulary 64, batch 4 x 32 tokens.

* dp = 1 x sp = 2, ring and Ulysses: the first loss within 1e-5
  (relative, fp32) of the JAX trainer's at the same weights on the same
  mesh, and the loss falling over 10 Adam steps (lr 3e-3, the script's).
  The example's ``main`` runs once under the same ranks (ring, 3 steps).
* dp = 2 x sp = 2, ring, SGD (lr 0.1) for 3 steps: rank positions and
  groups as the JAX mesh lays out its devices; every parameter within
  1e-4 of its largest magnitude, and the losses within 1e-5, of the JAX
  trainer's on the same mesh and of the port's dp = 1 run (this
  process).  The gradient sums over ``dp`` only: a sum over ``sp`` too
  would double every step.  Inputs given ``shard_batch(seq_axis=1)``'s
  layout, ``P(("dp",), "sp")``, take the same step bit for bit (outside
  attention the sp ranks hold the whole sequence); a spec that splits
  dim 2 of the 2-D tokens raises as the JAX trainer does on the same
  mesh and specs (a spec longer than the value's rank).
"""
import os
import re
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_ranks import Launched, jax_free, rank_setup  # noqa: E402

W = dict(units=16, heads=4, vocab=64, layers=2)
BATCH, SEQ = 4, 32
ADAM_STEPS, SGD_STEPS = 10, 3
SGD = {"learning_rate": 0.1}
LOSS_RTOL, W_TOL = 1e-5, 1e-4
# what both packages say of P(None, None, "sp") on the [B, L] tokens
DIM2_REFUSAL = (r"PartitionSpec\(None, None, 'sp'\).* is only valid for "
                r"values of rank at least 3, but was applied to a value of "
                r"rank 2")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data():
    from mxnet_tpu_torch.examples import long_context_lm as lm

    return lm.lm_data(BATCH, SEQ, W["vocab"])


# ---------------------------------------------------------------------------
# the rank processes (port only)
# ---------------------------------------------------------------------------

def _port_net(method, w0):
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.examples import long_context_lm as lm
    from mxnet_tpu_torch.gluon import load_numpy_params

    net = lm.LM(method, **W)
    net.initialize(ctx=mt.cpu())
    load_numpy_params(net, w0)
    return net


def _sgd_run(net, mesh, batch_spec=None):
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.examples import bench_steps as bs

    tr = parallel.SPMDTrainer(net, bs.Identity(), "sgd", dict(SGD),
                              mesh=mesh, n_labels=0, batch_spec=batch_spec)
    tokens, labels = _data()
    out = {"losses": np.array([float(tr.step(tokens, labels))
                               for _ in range(SGD_STEPS)])}
    for n, t in net.state_dict(keep_vars=True).items():
        out[f"w/{n}"] = t.detach().numpy().copy()
    return out


def _rank_main():
    rank, out_dir = rank_setup()
    from mxnet_tpu_torch import cpu, parallel
    from mxnet_tpu_torch.examples import long_context_lm as lm

    w = np.load(os.path.join(out_dir, "..", "weights.npz"))
    w0 = {k: w[k] for k in w.files}
    world = parallel.dist.num_workers()
    res = {}
    if world == 2:
        mesh = parallel.make_mesh(dp=1, sp=2, devices=[cpu()] * 2)
        tokens, labels = _data()
        for method in ("ring", "ulysses"):
            tr = lm.trainer_for(_port_net(method, w0), mesh)
            res[f"{method}/losses"] = np.array(
                [float(tr.step(tokens, labels)) for _ in range(ADAM_STEPS)])
        out = lm.main(["--cpu", "--dp", "1", "--sp", "2", "--steps", "3",
                       "--seq-len", str(SEQ), "--units", "16", "--vocab",
                       "64"])
        res["main/losses"] = np.array(out["losses"])
    else:
        mesh = parallel.make_mesh(dp=2, sp=2, devices=[cpu()] * 4)
        res["coords"] = np.array([mesh.coord("dp"), mesh.coord("sp")])
        res["group/dp"] = np.array(mesh.group_ranks("dp"))
        res["group/sp"] = np.array(mesh.group_ranks("sp"))
        res.update({f"sgd/{k}": v for k, v in
                    _sgd_run(_port_net("ring", w0), mesh).items()})
        # shard_batch(seq_axis=1)'s layout: the same step
        seq = parallel.P(("dp",), "sp")
        res.update({f"seq_spec/{k}": v for k, v in _sgd_run(
            _port_net("ring", w0), mesh, [seq, seq]).items()})
        try:
            _sgd_run(_port_net("ring", w0), mesh,
                     [parallel.P(None, None, "sp")] * 2)
            res["dim2_refused"] = np.array("")
        except Exception as e:  # noqa: BLE001 - the message is the check
            res["dim2_refused"] = np.array(str(e))
    res["jax_free"] = np.array(jax_free())
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)


# ---------------------------------------------------------------------------
# the pytest process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The JAX LM's weights, written where the ranks read them."""
    import mxnet_tpu as mx
    from torch_lm_jax import jax_lm

    d = tmp_path_factory.mktemp("long_context_lm")
    np.random.seed(0)
    mx.random.seed(0)
    net = jax_lm("ring", **W)
    net.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    w0 = {k: p.data().asnumpy().copy()
          for k, p in net._collect_params_with_prefix().items()}
    np.savez(d / "weights.npz", **w0)
    return d, w0


def _group(weights, name, world):
    (weights[0] / name).mkdir()
    return Launched(__file__, weights[0] / name, world=world)


@pytest.fixture(scope="module")
def two(weights):
    group = _group(weights, "sp2", 2)
    yield group
    group.stop()


@pytest.fixture(scope="module")
def four(weights):
    """Started when its test runs, after the two-rank group is done."""
    group = _group(weights, "dp2sp2", 4)
    yield group
    group.stop()


def _jax_run(w0, method, axes, opt, opt_params, steps, batch_spec=None):
    """(losses, {structural name: parameter}) of the JAX script's LM
    through its SPMDTrainer on make_mesh(**axes)."""
    import mxnet_tpu as mx
    from mxnet_tpu import parallel as jpar
    from torch_lm_jax import Identity, jax_lm

    net = jax_lm(method, **W)
    net.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    params = net._collect_params_with_prefix()
    for k, p in params.items():
        p.set_data(mx.nd.array(w0[k]))
    tokens, labels = _data()
    with jpar.make_mesh(**axes):
        tr = jpar.SPMDTrainer(net, Identity(), opt, dict(opt_params),
                              n_labels=0, batch_spec=batch_spec)
        losses = [float(tr.step(tokens, labels).asnumpy())
                  for _ in range(steps)]
    return losses, {k: np.asarray(tr.params[p.name])
                    for k, p in params.items()}


@pytest.mark.parametrize("method", ["ring", "ulysses"])
def test_sp2_first_loss_matches_jax_and_falls(method, weights, two):
    want, _ = _jax_run(weights[1], method, dict(dp=1, sp=2), "adam",
                       {"learning_rate": 3e-3}, 1)
    for res in two.results():
        losses = res[f"{method}/losses"]
        np.testing.assert_allclose(losses[0], want[0], rtol=LOSS_RTOL)
        assert losses[-1] < losses[0] - 0.1, losses
        assert bool(res["jax_free"])


def test_the_example_runs_under_the_launcher(two):
    for res in two.results():
        losses = res["main/losses"]
        assert len(losses) == 3 and losses[-1] < losses[0]


def test_dp2_sp2_ring_sums_over_dp_only(weights, four):
    import jax
    from mxnet_tpu import parallel as jpar
    from mxnet_tpu.parallel.sharding import P as JP
    from mxnet_tpu_torch import cpu, parallel

    w0 = weights[1]
    with pytest.raises(ValueError, match=DIM2_REFUSAL):
        _jax_run(w0, "ring", dict(dp=2, sp=2), "sgd", SGD, 1,
                 [JP(None, None, "sp")] * 2)
    grid = jpar.make_mesh(dp=2, sp=2).mesh.devices
    devs = jax.devices()
    jl, jw = _jax_run(w0, "ring", dict(dp=2, sp=2), "sgd", SGD, SGD_STEPS)
    one = _sgd_run(_port_net("ring", w0),
                   parallel.make_mesh(dp=1, devices=[cpu()]))
    for r, res in enumerate(four.results()):
        assert list(res["coords"]) == [int(i) for i in
                                       np.argwhere(grid == devs[r])[0]]
        dp, sp = (int(c) for c in res["coords"])
        assert list(res["group/dp"]) == [sp, 2 + sp]
        assert list(res["group/sp"]) == [2 * dp, 2 * dp + 1]
        got = {k[len("sgd/"):]: v for k, v in res.items()
               if k.startswith("sgd/")}
        for k, v in got.items():
            np.testing.assert_array_equal(res[f"seq_spec/{k}"], v)
        assert re.search(DIM2_REFUSAL, str(res["dim2_refused"]))
        for what, wl, ww in (("JAX dp=2 x sp=2", jl, jw),
                             ("port dp=1", one["losses"],
                              {k[2:]: v for k, v in one.items()
                               if k.startswith("w/")})):
            np.testing.assert_allclose(got["losses"], wl, rtol=LOSS_RTOL,
                                       err_msg=what)
            for k, v in ww.items():
                np.testing.assert_allclose(
                    got[f"w/{k}"], v, rtol=0,
                    atol=W_TOL * float(np.abs(v).max()),
                    err_msg=f"rank {r} vs {what}: {k}")
        assert bool(res["jax_free"])


if __name__ == "__main__":
    _rank_main()
