"""``Module.fit`` over two ranks with a ``dist_sync`` store, against a
plain one-process step on the summed batch.

The ranks are two gloo processes of this file, started by
``tests/torch_ranks.py``.  Each binds ``Module`` (an MLP of 10 -> 16 ->
4 with ``SoftmaxOutput``) on ``cpu()`` and fits two epochs of its half
of every global batch of 8 (its 4 rows of each) with SGD (lr 0.1,
momentum 0.9, wd 1e-4) through ``kvstore='dist_sync'``: ``update`` sums
each gradient over the ranks through the store, as
``module/module.py``'s ``update`` does for a dist store also with one
context.  The reference is one ``Module`` in this process on the whole
batch of 8 (one context, no store): its gradient is the batch's sum, the
sum of the two ranks' halves.  The JAX ``Module`` cannot be the
reference (its one-context ranks never sync).  Tolerances (fp32, the
same sums in another order): parameters and momenta within 1e-5
relative + 1e-6; the two ranks bit-identical.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_ranks import WORLD, Launched, jax_free, rank_setup  # noqa: E402

GLOBAL, ROWS, EPOCHS = 8, 32, 2
OPT = (("learning_rate", 0.1), ("momentum", 0.9), ("wd", 1e-4))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mlp(s):
    data = s.var("data")
    fc1 = s.FullyConnected(data, num_hidden=16, name="fc1")
    act = s.Activation(fc1, act_type="relu", name="relu1")
    fc2 = s.FullyConnected(act, num_hidden=4, name="fc2")
    return s.SoftmaxOutput(fc2, name="softmax")


def _data():
    rs = np.random.RandomState(3)
    x = rs.randn(ROWS, 10).astype("f4")
    return x, rs.randint(0, 4, ROWS).astype("f4")


def _args(mx):
    rs = np.random.RandomState(5)
    with mx.name.NameManager():
        sym = _mlp(mx.sym)
    shapes, _, _ = sym.infer_shape(data=(GLOBAL, 10))
    return {n: (rs.randn(*s) / np.sqrt(np.prod(s[1:]))).astype("f4")
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


def _fit(mx, x, y, batch, kvstore):
    """(parameters, momenta, module) after EPOCHS epochs of ``x``."""
    with mx.name.NameManager():
        sym = _mlp(mx.sym)
    mod = mx.mod.Module(sym, context=mx.cpu())
    mod.fit(mx.io.NDArrayIter(x, y, batch_size=batch, shuffle=False),
            num_epoch=EPOCHS, kvstore=kvstore, optimizer="sgd",
            optimizer_params=OPT,
            arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in _args(mx).items()})
    args, _ = mod.get_params()
    states = {f"mom/{i}": s.asnumpy()
              for i, s in sorted(mod._updater.states.items())}
    return {k: v.asnumpy() for k, v in args.items()}, states, mod


def _rank_main():
    rank, out_dir = rank_setup()
    import mxnet_tpu_torch as mx

    x, y = _data()
    half = GLOBAL // WORLD
    mine = np.concatenate([np.arange(b + rank * half, b + (rank + 1) * half)
                           for b in range(0, ROWS, GLOBAL)])
    args, states, mod = _fit(mx, x[mine], y[mine], half, "dist_sync")
    res = {f"arg/{k}": v for k, v in args.items()}
    res.update(states)
    res["store"] = np.array([mod._kvstore.type,
                             str(mod._kvstore.num_workers)])
    res["jax_free"] = np.array(jax_free())
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)


def test_dist_sync_fit_is_the_summed_batch_step(tmp_path):
    import mxnet_tpu_torch as mx

    group = Launched(__file__, tmp_path)
    try:
        x, y = _data()
        args, states, _ = _fit(mx, x, y, GLOBAL, None)
        res = group.results()
    finally:
        group.stop()
    want = {f"arg/{k}": v for k, v in args.items()}
    want.update(states)
    for r, got in enumerate(res):
        assert list(got["store"]) == ["dist_sync", str(WORLD)]
        assert bool(got["jax_free"])
        assert sorted(k for k in got if k.startswith(("arg/", "mom/"))) \
            == sorted(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=f"rank {r}: {k}")
            np.testing.assert_array_equal(got[k], res[0][k])


if __name__ == "__main__":
    _rank_main()
