"""The port's sparse NDArrays (``mxnet_tpu_torch/ndarray/sparse.py``),
their ``.params`` records, the local KVStore's row-sparse path and the
optimizers' sparse branches against the JAX package on the CPU.

Every case of ``tests/test_sparse.py`` runs through both packages on the
same numpy inputs.  Tolerances:

* construction, casts, retain, copies, gathers and the stored indices:
  bit for bit (values, indices, indptr, dense views);
* ``dot`` and the elementwise ops (fp32 products and sums): within
  2^-22 · k relative to the sum of the k terms' magnitudes;
* the optimizer updates: each touched row within one fp32 ulp of the
  JAX update (XLA's CPU backend may contract a multiply-add into an
  FMA), the rows a lazy update does not touch bit for bit.

Where the JAX package's dense backing shows through (a row-sparse
``divide`` gives 0/0 in the rows neither side stores; a position given
twice to ``csr_matrix`` reads the value given last) the port returns
what the JAX package returns, and the cases below hold it.
"""
import numpy as np
import pytest
import scipy.sparse as sps

import mxnet_tpu as mx
from mxnet_tpu.ndarray import sparse as jsp

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ndarray import sparse as tsp

CPU = mt.cpu()
REL = 2.0 ** -22


def _same(port_nd, jax_nd):
    assert port_nd.stype == jax_nd.stype and port_nd.shape == jax_nd.shape
    np.testing.assert_array_equal(port_nd.asnumpy(), jax_nd.asnumpy())
    for aux in ("indices", "indptr"):
        if hasattr(jax_nd, aux):
            np.testing.assert_array_equal(
                getattr(port_nd, aux).asnumpy(),
                getattr(jax_nd, aux).asnumpy().astype(np.int64))
    if port_nd.stype != "default":
        np.testing.assert_array_equal(port_nd.data.asnumpy(),
                                      jax_nd.data.asnumpy())


def _close(got, want, terms, k):
    bound = REL * k * terms + 1e-30
    assert np.all(np.abs(got.astype(np.float64) - want) <= bound)


def test_row_sparse_creation():
    vals = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = tsp.row_sparse_array((vals, [4, 1]), shape=(6, 3), ctx=CPU)
    j = jsp.row_sparse_array((vals, [4, 1]), shape=(6, 3))
    _same(t, j)
    assert t.indices.asnumpy().dtype == np.int64
    _same(t.todense(), j.todense())
    # dense input, shape inferred from the indices
    _same(tsp.row_sparse_array(np.eye(3, dtype=np.float32), ctx=CPU),
          jsp.row_sparse_array(np.eye(3, dtype=np.float32)))
    _same(tsp.row_sparse_array((vals, [0, 2]), ctx=CPU),
          jsp.row_sparse_array((vals, [0, 2])))


def test_csr_creation_and_asscipy():
    m = sps.random(8, 5, density=0.4, format="csr", dtype=np.float32,
                   random_state=0)
    t, j = tsp.csr_matrix(m, ctx=CPU), jsp.csr_matrix(m)
    _same(t, j)
    back = t.asscipy()
    np.testing.assert_array_equal(back.toarray(), m.toarray())
    t2 = tsp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape,
                        ctx=CPU)
    _same(t2, jsp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape))
    # (data, (row, col)) sums repeated coordinates, as scipy's coo does
    coo = (np.array([1.0, 2.0, 4.0], np.float32), ([0, 0, 2], [1, 1, 3]))
    _same(tsp.csr_matrix(coo, shape=(3, 4), ctx=CPU),
          jsp.csr_matrix(coo, shape=(3, 4)))
    # a dense source and float64 narrowing to float32
    d = np.arange(12, dtype=np.float64).reshape(3, 4) % 3
    _same(tsp.csr_matrix(d, ctx=CPU), jsp.csr_matrix(d))
    assert tsp.csr_matrix((m.data.astype(np.float64), m.indices, m.indptr),
                          shape=m.shape, ctx=CPU).dtype == np.float32


def test_csr_keeps_compact_storage():
    """The port's CSR holds the compact triple only: its device bytes
    are those of data, indices and indptr."""
    m = sps.random(64, 100000, density=1e-4, format="csr",
                   dtype=np.float32, random_state=3)
    t = tsp.csr_matrix(m, ctx=CPU)
    assert t.nbytes_compact() == m.nnz * (4 + 8) + 65 * 8
    assert t.shape == (64, 100000) and t.ndim == 2 and t.size == 6400000


def test_csr_repeated_position_reads_the_value_given_last():
    """Reference behaviour the port copies: a position given twice keeps
    both entries, each reading the value written last into the JAX
    package's dense backing; it counts once in the dense view and in
    dot."""
    args = (np.array([1.0, 2.0, 3.0, 5.0], np.float32),
            np.array([1, 1, 0, 2]), np.array([0, 2, 4]))
    t = tsp.csr_matrix(args, shape=(2, 3), ctx=CPU)
    j = jsp.csr_matrix(args, shape=(2, 3))
    _same(t, j)
    rhs = np.arange(6, dtype=np.float32).reshape(3, 2) + 1
    np.testing.assert_array_equal(
        tsp.dot(t, mt.nd.array(rhs, ctx=CPU)).asnumpy(),
        jsp.dot(j, mx.nd.array(rhs)).asnumpy())
    np.testing.assert_array_equal(
        tsp.dot(t, mt.nd.array(rhs[:2], ctx=CPU), transpose_a=True)
        .asnumpy(), jsp.dot(j, mx.nd.array(rhs[:2]), transpose_a=True)
        .asnumpy())


def test_cast_storage_round_trip():
    rng = np.random.RandomState(0)
    dense = rng.rand(6, 4).astype(np.float32)
    dense[[1, 3]] = 0
    dense[0, 1] = 0
    tx, jx = mt.nd.array(dense, ctx=CPU), mx.nd.array(dense)
    _same(mt.nd.cast_storage(tx, "row_sparse"),
          mx.nd.cast_storage(jx, "row_sparse"))
    _same(tx.tostype("csr"), jx.tostype("csr"))
    _same(mt.nd.cast_storage(tx.tostype("csr"), "default"),
          mx.nd.cast_storage(jx.tostype("csr"), "default"))
    _same(tx.tostype("csr").tostype("row_sparse"),
          jx.tostype("csr").tostype("row_sparse"))
    _same(tx.tostype("row_sparse").tostype("csr"),
          jx.tostype("row_sparse").tostype("csr"))
    with pytest.raises(MXNetError, match="2-D"):
        mt.nd.array(np.ones((2, 2, 2), np.float32), ctx=CPU).tostype("csr")


@pytest.mark.parametrize("stype", ["row_sparse", "csr", "default"])
def test_sparse_zeros(stype):
    t = tsp.zeros(stype, (4, 3), ctx=CPU)
    j = jsp.zeros(stype, (4, 3))
    _same(t, j)
    assert tsp.empty(stype, (4, 3), ctx=CPU).stype == stype


def test_retain():
    vals = np.arange(6, dtype=np.float32).reshape(3, 2) + 1
    t = tsp.row_sparse_array((vals, [0, 2, 4]), shape=(6, 2), ctx=CPU)
    j = jsp.row_sparse_array((vals, [0, 2, 4]), shape=(6, 2))
    for keep in ([2, 4, 5], [5, 0], [], [2, 2, 4]):
        _same(tsp.retain(t, keep), jsp.retain(j, keep))
    _same(t.retain(mt.nd.array([4], ctx=CPU)), j.retain(mx.nd.array([4])))


@pytest.mark.parametrize("op", ["add", "subtract", "multiply", "divide"])
def test_sparse_elemwise_keeps_stype(op):
    """Row-sparse with row-sparse keeps the stype and merges indices
    (``divide`` gives 0/0 in the rows neither stores, as the JAX
    package's dense backing does); csr with csr recompresses; with a
    dense array or a number the result is dense."""
    rng = np.random.RandomState(1)
    av, bv = rng.rand(2, 3).astype(np.float32) + 1, \
        rng.rand(2, 3).astype(np.float32) + 1
    ta = tsp.row_sparse_array((av, [0, 2]), shape=(5, 3), ctx=CPU)
    tb = tsp.row_sparse_array((bv, [2, 4]), shape=(5, 3), ctx=CPU)
    ja = jsp.row_sparse_array((av, [0, 2]), shape=(5, 3))
    jb = jsp.row_sparse_array((bv, [2, 4]), shape=(5, 3))
    t, j = getattr(tsp, op)(ta, tb), getattr(jsp, op)(ja, jb)
    assert t.stype == j.stype == "row_sparse"
    np.testing.assert_array_equal(t.indices.asnumpy(), j.indices.asnumpy())
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    if op == "divide":
        assert np.isnan(t.asnumpy()[[1, 3]]).all()
    m1 = sps.random(4, 5, density=0.5, format="csr", dtype=np.float32,
                    random_state=2)
    m2 = sps.random(4, 5, density=0.5, format="csr", dtype=np.float32,
                    random_state=4)
    if op != "divide":
        t = getattr(tsp, op)(tsp.csr_matrix(m1, ctx=CPU),
                             tsp.csr_matrix(m2, ctx=CPU))
        _same(t, getattr(jsp, op)(jsp.csr_matrix(m1), jsp.csr_matrix(m2)))
    d = rng.rand(5, 3).astype(np.float32) + 0.5
    for rhs_t, rhs_j in ((mt.nd.array(d, ctx=CPU), mx.nd.array(d)),
                         (2.5, 2.5)):
        t, j = getattr(tsp, op)(ta, rhs_t), getattr(jsp, op)(ja, rhs_j)
        assert t.stype == j.stype == "default"
        np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


def test_add_n():
    vs = [np.full((1, 2), v, np.float32) for v in (1.0, 2.0, 4.0)]
    t = tsp.add_n(*[tsp.row_sparse_array((v, [i]), shape=(4, 2), ctx=CPU)
                    for i, v in enumerate(vs)])
    j = jsp.add_n(*[jsp.row_sparse_array((v, [i]), shape=(4, 2))
                    for i, v in enumerate(vs)])
    _same(t, j)


@pytest.mark.parametrize("transpose_a", [False, True])
def test_sparse_dot(transpose_a):
    rng = np.random.RandomState(0)
    m = sps.random(60, 40, density=0.1, format="csr", dtype=np.float32,
                   random_state=1)
    rhs = rng.standard_normal((60 if transpose_a else 40, 3)).astype(
        np.float32)
    t = tsp.dot(tsp.csr_matrix(m, ctx=CPU), mt.nd.array(rhs, ctx=CPU),
                transpose_a=transpose_a)
    j = jsp.dot(jsp.csr_matrix(m), mx.nd.array(rhs),
                transpose_a=transpose_a)
    a = np.abs(m.toarray().T if transpose_a else m.toarray())
    k = int((a != 0).sum(1).max())
    _close(t.asnumpy(), j.asnumpy(), a @ np.abs(rhs), k)
    # a row-sparse right-hand side is read through its dense backing,
    # and transpose_b transposes it
    r = tsp.row_sparse_array((rhs[:, :2].T.copy(), [0, 2]),
                             shape=(3, rhs.shape[0]), ctx=CPU)
    jr = jsp.row_sparse_array((rhs[:, :2].T.copy(), [0, 2]),
                              shape=(3, rhs.shape[0]))
    t = tsp.dot(tsp.csr_matrix(m, ctx=CPU), r, transpose_a=transpose_a,
                transpose_b=True)
    j = jsp.dot(jsp.csr_matrix(m), jr, transpose_a=transpose_a,
                transpose_b=True)
    _close(t.asnumpy(), j.asnumpy(), a @ np.abs(jr.asnumpy().T), k)


def test_csr_row_slicing():
    m = sps.random(6, 5, density=0.5, format="csr", dtype=np.float32,
                   random_state=5)
    t, j = tsp.csr_matrix(m, ctx=CPU), jsp.csr_matrix(m)
    for key in (2, slice(1, 4), slice(0, 6, 2), slice(None)):
        _same(t[key], j[key])
    with pytest.raises(MXNetError, match="int/slice"):
        t[[1, 2]]


def test_sparse_save_load_both_ways(tmp_path):
    """A ``.params`` file with sparse records written by either package
    loads in the other, bit for bit."""
    vals = np.arange(8, dtype=np.float32).reshape(2, 4)
    m = sps.random(4, 6, density=0.4, format="csr", dtype=np.float32,
                   random_state=0)
    dense = np.arange(3, dtype=np.float32)
    t = {"rsp": tsp.row_sparse_array((vals, [1, 3]), shape=(5, 4),
                                     ctx=CPU),
         "csr": tsp.csr_matrix(m, ctx=CPU),
         "dense": mt.nd.array(dense, ctx=CPU)}
    j = {"rsp": jsp.row_sparse_array((vals, [1, 3]), shape=(5, 4)),
         "csr": jsp.csr_matrix(m), "dense": mx.nd.array(dense)}
    fj, ft = str(tmp_path / "jax.params"), str(tmp_path / "port.params")
    mx.nd.save(fj, j)
    mt.nd.save(ft, t)
    assert open(fj, "rb").read() == open(ft, "rb").read()
    port_of_jax, jax_of_port = mt.nd.load(fj), mx.nd.load(ft)
    for k in j:
        _same(port_of_jax[k], j[k])
        _same(t[k], jax_of_port[k])
    lst = str(tmp_path / "list.params")
    mt.nd.save(lst, [t["csr"], t["rsp"]])
    back = mx.nd.load(lst)
    _same(t["csr"], back[0])
    _same(t["rsp"], back[1])


def test_kvstore_row_sparse_pull():
    w = np.random.RandomState(0).rand(8, 3).astype(np.float32)
    tk, jk = mt.kv.create("local"), mx.kv.create("local")
    tk.init("emb", mt.nd.array(w, ctx=CPU))
    jk.init("emb", mx.nd.array(w))
    to, jo = tsp.zeros("row_sparse", (8, 3), ctx=CPU), \
        jsp.zeros("row_sparse", (8, 3))
    tk.row_sparse_pull("emb", out=to,
                       row_ids=mt.nd.array([5, 1, 5], dtype="int32",
                                           ctx=CPU))
    jk.row_sparse_pull("emb", out=jo,
                       row_ids=mx.nd.array([5, 1, 5], dtype="int32"))
    _same(to, jo)
    # a dense out gets the dense rows; no row_ids is a pull
    td, jd = mt.nd.zeros((8, 3), ctx=CPU), mx.nd.zeros((8, 3))
    tk.row_sparse_pull("emb", out=td, row_ids=mt.nd.array([2], ctx=CPU))
    jk.row_sparse_pull("emb", out=jd, row_ids=mx.nd.array([2]))
    np.testing.assert_array_equal(td.asnumpy(), jd.asnumpy())
    tk.row_sparse_pull("emb", out=td)
    np.testing.assert_array_equal(td.asnumpy(), w)


def test_kvstore_push_row_sparse_reduce():
    def run(m, sp, ctx):
        kv = m.kv.create("local")
        kv.init("w", m.nd.zeros((6, 2), **ctx))
        g1 = sp.row_sparse_array((np.ones((1, 2), np.float32), [1]),
                                 shape=(6, 2), **ctx)
        g2 = sp.row_sparse_array((np.ones((2, 2), np.float32), [1, 4]),
                                 shape=(6, 2), **ctx)
        kv.push("w", [g1, g2])
        out = m.nd.zeros((6, 2), **ctx)
        kv.pull("w", out=out)
        return kv._store["w"], out

    (ts, to), (js, jo) = run(mt, tsp, {"ctx": CPU}), run(mx, jsp, {})
    _same(ts, js)
    np.testing.assert_array_equal(to.asnumpy(), jo.asnumpy())


def test_row_sparse_pull_from_sparse_store_and_multi_key():
    def run(m, sp, ctx):
        kv = m.kv.create("local")
        kv.init("a", m.nd.array(np.arange(12, dtype=np.float32)
                                .reshape(6, 2), **ctx))
        kv.init("b", m.nd.array(-np.arange(12, dtype=np.float32)
                                .reshape(6, 2), **ctx))
        kv.init("c", m.nd.zeros((6, 2), **ctx))
        kv.push("c", sp.row_sparse_array(
            (np.ones((1, 2), np.float32), [3]), shape=(6, 2), **ctx))
        oa, ob = m.nd.zeros((6, 2), **ctx), m.nd.zeros((6, 2), **ctx)
        kv.row_sparse_pull(["a", "b"], out=[oa, ob],
                           row_ids=[m.nd.array([1], dtype="int32", **ctx),
                                    m.nd.array([4], dtype="int32", **ctx)])
        oc = sp.zeros("row_sparse", (6, 2), **ctx)
        kv.row_sparse_pull("c", out=oc,
                           row_ids=m.nd.array([3], dtype="int32", **ctx))
        return oa, ob, oc

    for t, j in zip(run(mt, tsp, {"ctx": CPU}), run(mx, jsp, {})):
        _same(t, j)


def test_pull_sparse_out_and_compression_refuse():
    kv = mt.kv.create("local")
    kv.init("w", mt.nd.ones((4, 2), ctx=CPU))
    with pytest.raises(MXNetError, match="row_sparse_pull"):
        kv.pull("w", out=tsp.zeros("row_sparse", (4, 2), ctx=CPU))
    with pytest.raises(MXNetError, match="row_sparse_pull"):
        kv.pushpull("w", mt.nd.ones((4, 2), ctx=CPU),
                    out=tsp.zeros("row_sparse", (4, 2), ctx=CPU))
    with pytest.raises(MXNetError, match="'local'"):
        kv.set_gradient_compression({"type": "2bit"})
    # a device store takes 2-bit compression, and refuses it on sparse
    # values, for one replica too (ref: GradientCompression)
    kd = mt.kv.create("device")
    kd.set_gradient_compression({"type": "2bit"})
    kd.init("w", mt.nd.ones((4, 2), ctx=CPU))
    with pytest.raises(MXNetError, match="sparse"):
        kd.push("w", tsp.zeros("row_sparse", (4, 2), ctx=CPU))


def test_kvstore_optimizer_and_its_states(tmp_path):
    """``set_optimizer`` runs the update on push (lazy SGD on a
    row-sparse gradient); the states saved by one store load into the
    other package's."""
    w0 = np.random.RandomState(2).rand(6, 3).astype(np.float32)
    g = np.ones((2, 3), np.float32)

    def run(m, sp, ctx, fname):
        kv = m.kv.create("local")
        kv.set_optimizer(m.optimizer.SGD(learning_rate=0.1, momentum=0.9,
                                         wd=0.01))
        kv.init(0, m.nd.array(w0, **ctx))
        for _ in range(2):
            kv.push(0, sp.row_sparse_array((g, [1, 4]), shape=(6, 3),
                                           **ctx))
        out = m.nd.zeros((6, 3), **ctx)
        kv.pull(0, out=out)
        kv.save_optimizer_states(fname)
        return out.asnumpy(), kv

    tw, tk = run(mt, tsp, {"ctx": CPU}, str(tmp_path / "t.states"))
    jw, jk = run(mx, jsp, {}, str(tmp_path / "j.states"))
    _one_ulp(tw, jw, [1, 4])
    tk.load_optimizer_states(str(tmp_path / "j.states"))
    jk.load_optimizer_states(str(tmp_path / "t.states"))
    np.testing.assert_array_equal(tk._updater.states[0].asnumpy(),
                                  np.asarray(jk._updater.states[0]
                                             .asnumpy()))
    with pytest.raises(MXNetError, match="no optimizer"):
        mt.kv.create("local").save_optimizer_states(str(tmp_path / "x"))


def _one_ulp(got, want, touched):
    """Touched rows within one fp32 ulp; the others bit for bit."""
    rows = np.zeros(got.shape[0], bool)
    rows[touched] = True
    np.testing.assert_array_equal(got[~rows], want[~rows])
    ulp = np.spacing(np.abs(want[rows]).astype(np.float32))
    assert np.all(np.abs(got[rows] - want[rows]) <= ulp)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("lazy", [True, False])
def test_sgd_on_a_row_sparse_gradient(momentum, lazy):
    """Lazy: only the gradient's rows move, two steps with momentum;
    lazy_update=False: the dense update on the dense view (wd decays
    every row)."""
    w0 = np.random.RandomState(0).rand(6, 3).astype(np.float32)
    gv = np.random.RandomState(1).rand(2, 3).astype(np.float32)

    def run(m, sp, ctx):
        opt = m.optimizer.SGD(learning_rate=0.1, momentum=momentum,
                              wd=0.01, rescale_grad=0.5, clip_gradient=0.4,
                              lazy_update=lazy)
        w = m.nd.array(w0, **ctx)
        st = opt.create_state(0, w)
        out = []
        for _ in range(2):
            opt.update(0, w, sp.row_sparse_array((gv, [1, 4]), shape=(6, 3),
                                                 **ctx), st)
            out.append(w.asnumpy().copy())
        return out, st

    (tw, ts), (jw, js) = run(mt, tsp, {"ctx": CPU}), run(mx, jsp, {})
    touched = [1, 4] if lazy else list(range(6))
    for a, b in zip(tw, jw):
        _one_ulp(a, b, touched)
    if lazy:
        np.testing.assert_array_equal(tw[1][[0, 2, 3, 5]], w0[[0, 2, 3, 5]])
    if momentum:
        _one_ulp(ts.asnumpy(), js.asnumpy(), touched)


@pytest.mark.parametrize("name", ["nag", "adam"])
def test_nag_and_adam_take_a_row_sparse_gradient(name):
    """NAG has no lazy form and densifies; Adam takes ``lazy_update``
    and ignores it, updating every row from the dense view (reference
    behaviour the port copies)."""
    w0 = np.random.RandomState(3).rand(4, 2).astype(np.float32)

    def run(m, sp, ctx):
        opt = m.optimizer.create(name, learning_rate=0.1, wd=0.01,
                                 lazy_update=True)
        if name == "nag":
            opt.momentum = 0.9
        w = m.nd.array(w0, **ctx)
        st = opt.create_state(0, w)
        for _ in range(2):
            opt.update(0, w, sp.row_sparse_array(
                (np.ones((1, 2), np.float32), [2]), shape=(4, 2), **ctx), st)
        return w.asnumpy()

    t, j = run(mt, tsp, {"ctx": CPU}), run(mx, jsp, {})
    _one_ulp(t, j, list(range(4)))
    assert not np.array_equal(t[0], w0[0])  # every row moved


def test_sparse_setitem_copy_and_refusals():
    rsp = tsp.zeros("row_sparse", (4, 2), ctx=CPU)
    src = tsp.row_sparse_array((np.ones((1, 2), np.float32), [3]),
                               shape=(4, 2), ctx=CPU)
    rsp[:] = src
    np.testing.assert_array_equal(rsp.indices.asnumpy(), [3])
    cp = rsp.copy()
    assert cp.stype == "row_sparse" and cp._data is not rsp._data
    rsp[:] = mt.nd.array(np.eye(4, 2, dtype=np.float32), ctx=CPU)
    np.testing.assert_array_equal(rsp.indices.asnumpy(), [0, 1])
    csr = tsp.zeros("csr", (2, 3), ctx=CPU)
    csr[:] = np.array([[0, 1, 0], [2, 0, 0]], np.float32)
    np.testing.assert_array_equal(csr.indptr.asnumpy(), [0, 1, 2])
    dense = mt.nd.zeros((2, 3), ctx=CPU)
    csr.copyto(dense)
    np.testing.assert_array_equal(dense.asnumpy(), csr.asnumpy())
    with pytest.raises(MXNetError, match="sliced assignment"):
        rsp[1] = 5.0
    with pytest.raises(MXNetError, match="inplace"):
        rsp += 1
    assert tsp.array(src).stype == "row_sparse"
    assert tsp.array(sps.eye(3, format="csr"), ctx=CPU).stype == "csr"
    with pytest.raises(MXNetError, match="sparse input"):
        tsp.array(np.ones(3))
    assert repr(src).strip() == "<RowSparseNDArray 4x2 @cpu(0)>"


def test_cast_storage_bf16_csr_and_astype():
    x = mt.nd.array(np.eye(3, dtype=np.float32), ctx=CPU).astype("bfloat16")
    jx = mx.nd.array(np.eye(3, dtype=np.float32)).astype("bfloat16")
    t, j = x.tostype("csr"), jx.tostype("csr")
    np.testing.assert_array_equal(t.indices.asnumpy(), j.indices.asnumpy())
    np.testing.assert_array_equal(
        t.todense().asnumpy().astype(np.float32),
        j.todense().asnumpy().astype(np.float32))
    assert t.astype("float32").dtype == np.float32
    assert t.as_in_context(CPU) is t


def test_ops_without_a_csr_form_see_the_dense_view():
    m = sps.random(3, 4, density=0.5, format="csr", dtype=np.float32,
                   random_state=7)
    t = tsp.csr_matrix(m, ctx=CPU)
    np.testing.assert_array_equal((t * 2).asnumpy(), m.toarray() * 2)
    np.testing.assert_array_equal(mt.nd.sum(t).asnumpy(),
                                  mx.nd.sum(jsp.csr_matrix(m)).asnumpy())
