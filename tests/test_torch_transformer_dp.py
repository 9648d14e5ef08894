"""Config 5's Transformer step under a split batch, and an input layout
that splits dim 0 over one batch axis of two, in the port against the
JAX package on the CPU.

The net is ``bench_all.py``'s config-5 step at its ``--cpu-smoke`` size
(2 layers, 64 units, 4 heads, vocabulary 1000; ``examples/bench_steps``'s
``TransformerNMTStep``, the JAX step from ``test_torch_transformer``),
dropout 0, Adam (lr 1e-3, wd 1e-2), from random weights drawn by numpy
and carried across by structural name, on a batch of 4 x 16 tokens whose
target lengths differ between the rows (16, 12, 5, 3): at dp = 2 rank 0
holds 28 valid target tokens and rank 1 holds 8, so a loss divided by a
rank's own count is not the global token mean.

* dp = 2 (two gloo rank processes of this file, ``tests/torch_ranks.py``)
  against the JAX ``SPMDTrainer`` on ``make_mesh(dp=2)`` and against the
  port's dp = 1 run (this process), three steps.
* dp = 2 x fsdp = 2 (four ranks) with every input's spec ``P("dp")``:
  JAX places each input's rows over ``dp`` and replicates them over
  ``fsdp``; the port cuts the rows over both batch axes (the same global
  step), against the JAX trainer on the same mesh and specs and against
  the port's dp = 1 run.

Held as ``test_torch_sharded_trainer`` holds its steps: the losses within
1e-5 relative; each parameter within 1e-4 of its largest magnitude plus
2e-2 * lr; each Adam moment within 1e-4 of the largest moment of its
kind over all tensors.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_ranks import Groups, jax_free, rank_setup  # noqa: E402

SIZE = "cpu_smoke"
OPT = {"learning_rate": 1e-3, "wd": 1e-2}
STEPS = 3
TGT_VALID = (16, 12, 5, 3)
LOSS_RTOL, W_TOL, STATE_TOL, LR_NOISE = 1e-5, 1e-4, 1e-4, 2e-2
CASES = [("dp2", 2, dict(dp=2), None),
         ("dp2fsdp2", 4, dict(dp=2, fsdp=2), "dp")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch():
    """(src, tgt_in, src_valid, tgt_valid, tgt_out): 4 rows of 16 tokens
    drawn as ``bench_steps.transformer_batch`` draws them, the target
    lengths TGT_VALID."""
    from mxnet_tpu_torch.examples import bench_steps as bs

    cfg = bs.TRANSFORMER_SIZES[SIZE]
    n, s, vocab = len(TGT_VALID), cfg["seq"], cfg["vocab"]
    rng = np.random.RandomState(0)
    src, tgt_in, tgt_out = (rng.randint(4, vocab, (n, s)).astype(np.int32)
                            for _ in range(3))
    return (src, tgt_in, np.full((n,), s, np.float32),
            np.array(TGT_VALID, np.float32), tgt_out)


def _specs(axis):
    if axis is None:
        return None
    from mxnet_tpu_torch.parallel import P

    return [P(axis)] * 5


# ---------------------------------------------------------------------------
# the rank processes (port only)
# ---------------------------------------------------------------------------

def _port_run(w0, mesh, axis=None):
    """Losses, parameters and Adam moments (global tensors) after STEPS
    steps on ``mesh``."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.examples import bench_steps as bs
    from mxnet_tpu_torch.gluon import load_numpy_params

    step = bs.transformer_step(SIZE, dropout=0.0)
    step.initialize(ctx=mt.cpu())
    load_numpy_params(step, w0)
    tr = parallel.SPMDTrainer(step, bs.Identity(), "adam", dict(OPT),
                              mesh=mesh, n_labels=0, batch_spec=_specs(axis))
    batch = tuple(torch.from_numpy(a) for a in _batch())
    out = {"losses": np.array([float(tr.step(*batch))
                               for _ in range(STEPS)])}
    for n, t in tr.block.state_dict(keep_vars=True).items():
        out[f"w/{n}"] = tr.value_full(t).numpy().copy()
    for n in tr.opt_state:
        for i, s in enumerate(tr.state_full(n)):
            out[f"s{i}/{n}"] = s.numpy().copy()
    return out


def _rank_main():
    rank, out_dir = rank_setup()
    from mxnet_tpu_torch import cpu, parallel

    w = np.load(os.path.join(out_dir, "..", "weights.npz"))
    w0 = {k: w[k] for k in w.files}
    world = parallel.dist.num_workers()
    res = {}
    for name, n, axes, axis in CASES:
        if n == world:
            mesh = parallel.make_mesh(axes, devices=[cpu()] * n)
            res.update({f"{name}/{k}": v
                        for k, v in _port_run(w0, mesh, axis).items()})
    res["jax_free"] = np.array(jax_free())
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)


# ---------------------------------------------------------------------------
# the JAX package and the port's dp = 1 in the pytest process
# ---------------------------------------------------------------------------

def _jax_weights():
    """Random weights by structural name of the step, the JAX test's
    (``test_torch_transformer._random_values`` on the bare model)."""
    import mxnet_tpu as mx
    from mxnet_tpu import nd as jnd
    from mxnet_tpu.gluon.model_zoo import transformer as jtr
    from test_torch_transformer import TINY, _random_values

    np.random.seed(0)
    mx.random.seed(0)
    net = jtr.get_transformer_model("transformer_base", **TINY)
    net.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    net(*(jnd.array(a) for a in _batch()[:4]))
    vals = _random_values(net._collect_params_with_prefix())
    return {"net." + k: v for k, v in vals.items()}


def _jax_run(w0, axes, axis):
    import mxnet_tpu as mx
    from mxnet_tpu import nd as jnd
    from mxnet_tpu import parallel as jpar
    from mxnet_tpu.parallel.sharding import P
    from test_torch_transformer import JaxNMTStep, _Identity

    batch = _batch()
    step = JaxNMTStep()
    step.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    step.net(*(jnd.array(a) for a in batch[:4]))
    params = step._collect_params_with_prefix()
    for k, p in params.items():
        p.set_data(mx.nd.array(w0[k]))
    specs = None if axis is None else [P(axis)] * 5
    with jpar.make_mesh(**axes):
        tr = jpar.SPMDTrainer(step, _Identity(), "adam", dict(OPT),
                              n_labels=0, batch_spec=specs)
        losses = [float(tr.step(*batch).asnumpy()) for _ in range(STEPS)]
    rec = {"losses": np.array(losses)}
    for k, p in params.items():
        rec[f"w/{k}"] = np.asarray(tr.params[p.name])
        if p.name in tr.opt_state:
            for i, s in enumerate(tr.opt_state[p.name]):
                rec[f"s{i}/{k}"] = np.asarray(s)
    return rec


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("transformer_dp")
    w0 = _jax_weights()
    np.savez(d / "weights.npz", **w0)
    groups = Groups(__file__, d)  # each started when a test asks for it
    yield w0, groups
    groups.stop()


@pytest.fixture(scope="module")
def port_dp1(setup):
    from mxnet_tpu_torch import cpu, parallel

    return _port_run(setup[0], parallel.make_mesh(dp=1, devices=[cpu()]))


def _close_run(got, want, what):
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL, err_msg=what)
    states = [k for k in want if k.startswith("s") and k in got]
    assert states, what
    scale = {i: max(float(np.abs(want[k]).max()) for k in states
                    if k.startswith(f"s{i}/")) for i in (0, 1)}
    for k, v in want.items():
        if k.startswith("w/"):
            atol = W_TOL * float(np.abs(v).max()) + LR_NOISE * \
                OPT["learning_rate"]
        elif k in states:
            atol = STATE_TOL * scale[int(k[1])]
        else:
            continue
        np.testing.assert_allclose(got[k], v, rtol=0, atol=atol,
                                   err_msg=f"{what}: {k}")


def test_the_ranks_hold_different_token_counts():
    b = _batch()[3]
    assert b[:2].sum() != b[2:].sum()


@pytest.mark.parametrize("name,world,axes,axis", CASES)
def test_split_batch_steps_match_jax_and_dp1(name, world, axes, axis,
                                             setup, port_dp1):
    w0, groups = setup
    group = groups[world]  # started before the JAX run
    want = _jax_run(w0, axes, axis)
    _close_run(port_dp1, want, f"port dp=1 vs JAX {name}")
    for r, res in enumerate(group.results()):
        assert bool(res["jax_free"])
        got = {k.split("/", 1)[1]: v for k, v in res.items()
               if k.startswith(name + "/")}
        _close_run(got, want, f"rank {r} {name} vs JAX {name}")
        _close_run(got, port_dp1, f"rank {r} {name} vs port dp=1")


if __name__ == "__main__":
    _rank_main()
