"""The port's dist KVStore over two gloo ranks against the JAX package's
``device`` store over ``[cpu(0), cpu(1)]``, which computes the same sums.

The ranks are two processes of this file, started once for the file by
the port's ``tools/launch.py`` (``tests/torch_ranks.py``); each rank
holds the values of one replica of the JAX store (made from a seed with
numpy), runs every case below on ``kv.create('dist_sync')`` and writes
what it pulled.  The JAX stores run in the pytest process.

* ``push``/``pull``/``pushpull`` of one value a rank, and of two local
  values a rank (the local sum, then the collective: the JAX store's
  pairwise order over four replicas); ``pushpull_fused`` over keys of
  two dtypes in buckets of 64 bytes, and the pulls after it (each bucket
  publishes its sums); ``rank``, ``num_workers``, ``barrier``.
  Two-operand fp32 sums: bit for bit.
* The store-side updater (``set_optimizer``, SGD with momentum): three
  pushes of a gradient per rank, the pulled weights, 1e-6 relative
  (the same update ops on the same sums).
* 2-bit compression: three pushes; each rank's codes are gathered and
  every rank sums what each decodes.  Held bit for bit against the JAX
  package's ``TwoBitCompressor`` run per rank (its residual carried) and
  the decoded values summed in rank order.
* A row-sparse push: the dense sum and the union of the ranks' rows,
  against the JAX store's merged row-sparse sum.
* ``parallel.dist.allgather_np``.
* In the pytest process: ``dist_async`` warns once, naming the port's
  collectives; ``nccl`` and its alias ``xla``; the refusals (compression
  on ``local``, an unknown type or kind, a sparse value under
  compression, a sparse ``out``); ``MXNET_KVSTORE_TIMEOUT`` as the
  process group's timeout.
"""
import os
import sys
import warnings

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_ranks import WORLD, Launched, jax_free, rank_setup  # noqa: E402

SHAPE = (4, 5)
FUSED = [(10, (3, 4), "float32"), (11, (7,), "float32"),
         (12, (2, 3), "float16"), (13, (5,), "float16"),
         (14, (6, 2), "float32")]
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
STEPS = 3
THRESHOLD = 0.5
SPARSE_ROWS = {0: [0, 3], 1: [3, 5]}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _val(key, rank, step=0, shape=SHAPE, dtype="float32", scale=1.0):
    rs = np.random.RandomState(1000 * key + 10 * rank + step)
    return (rs.randn(*shape) * scale).astype(dtype)


# ---------------------------------------------------------------------------
# the rank processes (port only)
# ---------------------------------------------------------------------------

def _rank_main():
    rank, out_dir = rank_setup()
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ndarray import sparse as tsp
    from mxnet_tpu_torch.parallel import dist

    cpu = mt.cpu()
    res = {}

    def nd(a):
        return mt.nd.array(a, ctx=cpu, dtype=a.dtype)

    kv = mt.kv.create("dist_sync")
    res["rank"] = np.array(kv.rank)
    res["num_workers"] = np.array(kv.num_workers)
    kv.barrier()
    # push / pull, one value and two local values a rank
    kv.init(3, mt.nd.zeros(SHAPE, ctx=cpu))
    kv.push(3, nd(_val(3, rank)))
    out = mt.nd.zeros(SHAPE, ctx=cpu)
    kv.pull(3, out=out)
    res["push1"] = out.asnumpy()
    kv.push(3, [nd(_val(4, 2 * rank)), nd(_val(4, 2 * rank + 1))])
    kv.pull(3, out=out)
    res["push2"] = out.asnumpy()
    kv.init(5, mt.nd.zeros(SHAPE, ctx=cpu))
    outs = [mt.nd.zeros(SHAPE, ctx=cpu) for _ in range(2)]
    kv.pushpull(5, nd(_val(5, rank)), out=outs)
    res["pushpull"] = np.stack([o.asnumpy() for o in outs])
    # pushpull_fused: buckets of 64 bytes over two dtypes
    vals = [nd(_val(k, rank, shape=s, dtype=d)) for k, s, d in FUSED]
    for (k, _, _), v in zip(FUSED, vals):
        kv.init(k, v)
    kv.pushpull_fused([k for k, _, _ in FUSED], vals, bucket_bytes=64)
    for (k, s, d), v in zip(FUSED, vals):
        res[f"fused/{k}"] = v.asnumpy()
        o = mt.nd.zeros(s, ctx=cpu, dtype=d)
        kv.pull(k, out=o)
        res[f"fused_pull/{k}"] = o.asnumpy()
    # the store-side updater
    ku = mt.kv.create("dist_sync")
    ku.set_optimizer(mt.optimizer.create("sgd", **OPT))
    w = mt.nd.array(_val(7, 0), ctx=cpu)
    ku.init(7, w)
    for step in range(STEPS):
        ku.push(7, nd(_val(8, rank, step)))
        ku.pull(7, out=w)
    res["updater"] = w.asnumpy()
    # 2-bit compression
    kc = mt.kv.create("dist_sync")
    kc.set_gradient_compression({"type": "2bit", "threshold": THRESHOLD})
    kc.init(9, mt.nd.zeros(SHAPE, ctx=cpu))
    for step in range(STEPS):
        kc.push(9, nd(_val(9, rank, step, scale=0.6)))
        kc.pull(9, out=out)
        res[f"2bit/{step}"] = out.asnumpy()
    try:
        kc.push(9, tsp.zeros("row_sparse", SHAPE, ctx=cpu))
        res["2bit_sparse_refused"] = np.array(False)
    except MXNetError as e:
        res["2bit_sparse_refused"] = np.array("sparse" in str(e))
    # row-sparse: the union of the ranks' rows
    rows = SPARSE_ROWS[rank]
    rsp = tsp.row_sparse_array((_val(11, rank, shape=(2, 5)), rows),
                               shape=(6, 5), ctx=cpu)
    kv.init(11, mt.nd.zeros((6, 5), ctx=cpu))
    kv.push(11, rsp)
    got = kv._store[11]
    res["sparse/dense"] = got.asnumpy()
    res["sparse/indices"] = got.indices.asnumpy()
    res["allgather"] = dist.allgather_np(np.arange(3) + 10 * rank)
    kv.barrier()
    dist.shutdown()
    res["jax_free"] = np.array(jax_free())
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)


# ---------------------------------------------------------------------------
# the pytest side
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    group = Launched(__file__, tmp_path_factory.mktemp("kvdist"))
    yield group
    group.stop()


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX device store's results for the same values, once."""
    import mxnet_tpu as mx
    from mxnet_tpu.ndarray import sparse as jsp

    ctx = [mx.cpu(r) for r in range(2 * WORLD)]
    res = {}

    def nd(a, r):
        return mx.nd.array(a, ctx=ctx[r], dtype=a.dtype)

    kv = mx.kv.create("device")
    kv.init(3, mx.nd.zeros(SHAPE))
    out = mx.nd.zeros(SHAPE)
    kv.push(3, [nd(_val(3, r), r) for r in range(WORLD)])
    kv.pull(3, out=out)
    res["push1"] = out.asnumpy()
    kv.push(3, [nd(_val(4, r), r) for r in range(2 * WORLD)])
    kv.pull(3, out=out)
    res["push2"] = out.asnumpy()
    kv.init(5, mx.nd.zeros(SHAPE))
    kv.pushpull(5, [nd(_val(5, r), r) for r in range(WORLD)], out=out)
    res["pushpull"] = out.asnumpy()
    vals = [[nd(_val(k, r, shape=s, dtype=d), r) for r in range(WORLD)]
            for k, s, d in FUSED]
    for (k, _, _), v in zip(FUSED, vals):
        kv.init(k, v[0])
    kv.pushpull_fused([k for k, _, _ in FUSED], vals, bucket_bytes=64)
    for (k, _, _), v in zip(FUSED, vals):
        res[f"fused/{k}"] = v[0].asnumpy()
    ku = mx.kv.create("device")
    ku.set_optimizer(mx.optimizer.create("sgd", **OPT))
    w = mx.nd.array(_val(7, 0))
    ku.init(7, w)
    for step in range(STEPS):
        ku.push(7, [nd(_val(8, r, step), r) for r in range(WORLD)])
        ku.pull(7, out=w)
    res["updater"] = w.asnumpy()
    rsps = [jsp.row_sparse_array((_val(11, r, shape=(2, 5)),
                                  SPARSE_ROWS[r]), shape=(6, 5), ctx=ctx[r])
            for r in range(WORLD)]
    kv.init(11, mx.nd.zeros((6, 5)))
    kv.push(11, rsps)
    res["sparse/dense"] = kv._store[11].asnumpy()
    res["sparse/indices"] = kv._store[11].indices.asnumpy()
    return res


def _two_bit_reference():
    """Each rank's 2-bit codes by the JAX package's compressor (its
    residual carried), decoded and summed in rank order."""
    from mxnet_tpu.kvstore_compression import TwoBitCompressor

    comps = [TwoBitCompressor(THRESHOLD) for _ in range(WORLD)]
    out = []
    for step in range(STEPS):
        total = 0
        for r, c in enumerate(comps):
            packed, shape = c.compress(9, _val(9, r, step, scale=0.6))
            total = total + c.decompress(packed, shape)
        out.append(total)
    return out


def test_ranks_identity_and_jax_free(ranks):
    for r, res in enumerate(ranks.results()):
        assert int(res["rank"]) == r
        assert int(res["num_workers"]) == WORLD
        assert bool(res["jax_free"])
        assert bool(res["2bit_sparse_refused"])


@pytest.mark.parametrize("case", ["push1", "push2", "pushpull"])
def test_push_pull_sums_bit_for_bit(ranks, jax_ref, case):
    for res in ranks.results():
        got = res[case]
        want = jax_ref[case]
        for g in (got if got.ndim == 3 else [got]):
            np.testing.assert_array_equal(g, want)


@pytest.mark.parametrize("key", [k for k, _, _ in FUSED])
def test_pushpull_fused_buckets(ranks, jax_ref, key):
    for res in ranks.results():
        np.testing.assert_array_equal(res[f"fused/{key}"],
                                      jax_ref[f"fused/{key}"])
        np.testing.assert_array_equal(res[f"fused_pull/{key}"],
                                      jax_ref[f"fused/{key}"])


def test_store_side_updater(ranks, jax_ref):
    for res in ranks.results():
        np.testing.assert_allclose(res["updater"], jax_ref["updater"],
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("step", range(STEPS))
def test_two_bit_compression_against_the_jax_quantizer(ranks, step):
    want = _two_bit_reference()[step]
    for res in ranks.results():
        np.testing.assert_array_equal(res[f"2bit/{step}"], want)


def test_row_sparse_union(ranks, jax_ref):
    for res in ranks.results():
        np.testing.assert_array_equal(res["sparse/dense"],
                                      jax_ref["sparse/dense"])
        np.testing.assert_array_equal(res["sparse/indices"],
                                      jax_ref["sparse/indices"])


def test_allgather_np(ranks):
    for res in ranks.results():
        np.testing.assert_array_equal(
            res["allgather"], np.stack([np.arange(3) + 10 * r
                                        for r in range(WORLD)]))


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------

def test_dist_async_warns_once_and_the_aliases(monkeypatch):
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import kvstore as tkv

    monkeypatch.setattr(tkv, "_ASYNC_WARNED", [False])
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        a = mt.kv.create("dist_async")
        mt.kv.create("dist_async")
    msgs = [str(w.message) for w in got if "dist_async" in str(w.message)]
    assert len(msgs) == 1
    assert "collective" in msgs[0] and "TPU" not in msgs[0]
    assert (a.type, a.rank, a.num_workers) == ("dist_async", 0, 1)
    for name in ("dist", "dist_sync", "dist_device_sync"):
        assert mt.kv.create(name).type == name
    assert mt.kv.create("nccl").type == mt.kv.create("xla").type == "nccl"


def test_refusals():
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ndarray import sparse as tsp

    cpu = mt.cpu()
    with pytest.raises(MXNetError, match="unknown kvstore type"):
        mt.kv.create("ps_lite")
    with pytest.raises(MXNetError, match="'local'"):
        mt.kv.create("local").set_gradient_compression({"type": "2bit"})
    kv = mt.kv.create("device")
    with pytest.raises(MXNetError, match="'1bit' is not implemented"):
        kv.set_gradient_compression({"type": "1bit"})
    with pytest.raises(MXNetError, match="unknown gradient compression"):
        kv.set_gradient_compression({"type": "3bit"})
    with pytest.raises(MXNetError, match="threshold must be > 0"):
        kv.set_gradient_compression({"type": "2bit", "threshold": 0})
    kv.set_gradient_compression({"type": "2bit"})
    kv.init(0, mt.nd.ones(SHAPE, ctx=cpu))
    with pytest.raises(MXNetError, match="sparse gradients"):
        kv.pushpull(0, [tsp.zeros("row_sparse", SHAPE, ctx=cpu)] * 2)
    with pytest.raises(MXNetError, match="row_sparse_pull"):
        kv.pull(0, out=tsp.zeros("row_sparse", SHAPE, ctx=cpu))
    with pytest.raises(MXNetError, match="not initialized"):
        kv.pull(1, out=mt.nd.zeros(SHAPE, ctx=cpu))


def test_compression_on_one_replica_skips_the_round_trip():
    """A device store with one replica sends nothing, so it sums without
    the lossy round trip; with two it quantizes the sum, as the JAX
    store does (one compressor, its residual per key)."""
    import mxnet_tpu as mx
    import mxnet_tpu_torch as mt

    g = [_val(20, r, scale=0.6) for r in range(2)]
    out = {}
    for pkg, ctx in ((mt, [mt.cpu(0), mt.cpu(1)]),
                     (mx, [mx.cpu(0), mx.cpu(1)])):
        kv = pkg.kv.create("device")
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        kv.init(0, pkg.nd.zeros(SHAPE, ctx=ctx[0]))
        o = pkg.nd.zeros(SHAPE, ctx=ctx[0])
        kv.pushpull(0, pkg.nd.array(g[0], ctx=ctx[0]), out=o)
        one = o.asnumpy()
        kv.pushpull(0, [pkg.nd.array(a, ctx=c) for a, c in zip(g, ctx)],
                    out=o)
        out[pkg] = (one, o.asnumpy())
    np.testing.assert_array_equal(out[mt][0], g[0])
    for a, b in zip(out[mt], out[mx]):
        np.testing.assert_array_equal(a, b)


def test_kvstore_timeout_is_the_group_timeout(monkeypatch):
    import datetime

    import torch.distributed as tdist

    from mxnet_tpu_torch.parallel import dist

    seen = {}
    monkeypatch.setattr(dist, "_INITIALIZED", False)
    monkeypatch.setattr(tdist, "init_process_group",
                        lambda *a, **kw: seen.update(kw))
    monkeypatch.setenv("MXNET_KVSTORE_TIMEOUT", "7.5")
    dist.init("tcp://127.0.0.1:1", 2, 0, backend="gloo")
    assert seen["timeout"] == datetime.timedelta(seconds=7.5)
    monkeypatch.setattr(dist, "_INITIALIZED", False)
    seen.clear()
    dist.init("tcp://127.0.0.1:1", 2, 0, backend="gloo", timeout=3)
    assert seen["timeout"] == datetime.timedelta(seconds=3)
    monkeypatch.setattr(dist, "_INITIALIZED", False)


if __name__ == "__main__":
    _rank_main()
