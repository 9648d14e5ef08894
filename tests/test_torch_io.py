"""mxnet_tpu_torch's data iterators, learning-rate schedules and
initializers against the JAX package's, on the CPU.

Iterators must hand out the same batches (values exactly, pads and
counts equal), seeded shuffles included: both draw from numpy's global
generator.  Schedules are pure Python in both packages, so their rates
over 200 updates must be equal exactly.  Initializers draw from a
``torch.Generator`` in the port and from numpy in the JAX package, so
the deterministic ones (constant, bilinear, LSTM bias, the name
dispatch, ``Mixed``'s routing) must match exactly and the random ones
match in law: shape, bounds, mean and spread within 5 standard errors,
orthogonality to 1e-5.
"""
import gzip
import math
import struct

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError


def _batches(it):
    return [([d.asnumpy() for d in b.data], [x.asnumpy() for x in b.label],
             b.pad) for b in it]


def _same_batches(tb, jb):
    assert len(tb) == len(jb)
    for (td, tl, tp), (jd, jl, jp) in zip(tb, jb):
        assert tp == jp
        for a, b in zip(td + tl, jd + jl):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _both(make):
    return make(tmx.io), make(jmx.io)


DATA = np.arange(42, dtype="float32").reshape(21, 2)
LABEL = np.arange(21, dtype="float32")


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarrayiter_matches_over_epochs(handle, shuffle):
    np.random.seed(7)
    t = tmx.io.NDArrayIter(DATA, LABEL, batch_size=4, shuffle=shuffle,
                           last_batch_handle=handle)
    np.random.seed(7)
    j = jmx.io.NDArrayIter(DATA, LABEL, batch_size=4, shuffle=shuffle,
                           last_batch_handle=handle)
    for _ in range(3):
        # each reset reshuffles from the global generator: same seed state
        state = np.random.get_state()
        tb = _batches(t)
        t.reset()
        np.random.set_state(state)
        jb = _batches(j)
        j.reset()
        _same_batches(tb, jb)
    assert t.provide_data == j.provide_data
    assert t.provide_label == j.provide_label


def test_ndarrayiter_inputs_and_descs():
    t, j = _both(lambda io: io.NDArrayIter(
        {"a": np.zeros((6, 2)), "b": np.ones((6, 3), "f4")}, None,
        batch_size=3))
    assert [d.name for d in t.provide_data] == ["a", "b"]
    assert t.provide_data == j.provide_data
    _same_batches(_batches(t), _batches(j))
    t, j = _both(lambda io: io.NDArrayIter(
        [DATA, DATA * 2], [LABEL], batch_size=5, label_name="lbl"))
    assert [d.name for d in t.provide_data] == ["_0_data", "_1_data"]
    assert t.provide_label[0].name == "lbl"
    _same_batches(_batches(t), _batches(j))
    d = t.provide_data[0]
    assert isinstance(d, tmx.io.DataDesc) and d.layout == "NCHW"
    assert tmx.io.DataDesc.get_batch_axis("NHWC") == 0
    with pytest.raises(MXNetError, match="larger than"):
        tmx.io.NDArrayIter(DATA[:2], batch_size=4)
    # the piecewise interface
    it = tmx.io.NDArrayIter(DATA, LABEL, batch_size=8)
    assert it.iter_next() and it.getpad() == 0
    np.testing.assert_array_equal(it.getdata()[0].asnumpy(), DATA[:8])


def test_csviter_matches(tmp_path):
    data = np.random.RandomState(0).rand(10, 6).astype("float32")
    np.savetxt(tmp_path / "d.csv", data, delimiter=",")
    np.savetxt(tmp_path / "l.csv", np.arange(10, dtype="f4"), delimiter=",")
    for round_batch in (True, False):
        t, j = _both(lambda io: io.CSVIter(
            data_csv=str(tmp_path / "d.csv"), data_shape=(2, 3),
            label_csv=str(tmp_path / "l.csv"), batch_size=4,
            round_batch=round_batch))
        tb = _batches(t)
        assert len(tb) == (3 if round_batch else 2)
        _same_batches(tb, _batches(j))
        assert tb[0][0][0].shape == (4, 2, 3)


def _write_mnist(path, n=10, gz=False):
    rs = np.random.RandomState(1)
    imgs = rs.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    lbls = rs.randint(0, 10, n).astype(np.uint8)
    op = gzip.open if gz else open
    ext = ".gz" if gz else ""
    with op(f"{path}-images{ext}", "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    with op(f"{path}-labels{ext}", "wb") as f:
        f.write(struct.pack(">II", 2049, n) + lbls.tobytes())
    return f"{path}-images{ext}", f"{path}-labels{ext}", imgs, lbls


@pytest.mark.parametrize("gz,flat", [(False, False), (True, True)])
def test_mnistiter_reads_the_idx_files(tmp_path, gz, flat):
    img, lbl, imgs, lbls = _write_mnist(str(tmp_path / "m"), gz=gz)
    t, j = _both(lambda io: io.MNISTIter(image=img, label=lbl,
                                         batch_size=4, shuffle=False,
                                         flat=flat))
    tb = _batches(t)
    _same_batches(tb, _batches(j))
    first = imgs[:4].astype("f4") / 255.0
    np.testing.assert_array_equal(
        tb[0][0][0], first.reshape(4, -1) if flat else first[:, None])
    np.testing.assert_array_equal(tb[0][1][0], lbls[:4].astype("f4"))
    with open(tmp_path / "bad", "wb") as f:
        f.write(struct.pack(">IIII", 1234, 1, 28, 28))
    with pytest.raises(MXNetError, match="magic"):
        tmx.io.MNISTIter(image=str(tmp_path / "bad"), label=lbl)


def test_resize_and_prefetching_iters():
    t, j = _both(lambda io: io.ResizeIter(
        io.NDArrayIter(DATA[:8], LABEL[:8], batch_size=4), size=5))
    for _ in range(2):
        _same_batches(_batches(t), _batches(j))
        t.reset()
        j.reset()
    t, j = _both(lambda io: io.PrefetchingIter(
        io.NDArrayIter(DATA[:12], None, batch_size=4)))
    for _ in range(2):
        tb = _batches(t)
        assert len(tb) == 3
        _same_batches(tb, _batches(j))
        t.reset()
        j.reset()
    assert t.provide_data == j.provide_data


# ---------------------------------------------------------------------------
# learning-rate schedules
# ---------------------------------------------------------------------------

SCHEDULES = {
    "factor": lambda m: m.FactorScheduler(step=7, factor=0.7,
                                          stop_factor_lr=1e-3, base_lr=0.5),
    "factor_warmup": lambda m: m.FactorScheduler(
        step=10, factor=0.5, base_lr=0.1, warmup_steps=20,
        warmup_begin_lr=0.01),
    "multifactor": lambda m: m.MultiFactorScheduler(
        step=[15, 60, 120], factor=0.3, base_lr=0.2, warmup_steps=5,
        warmup_mode="constant", warmup_begin_lr=0.05),
    "poly": lambda m: m.PolyScheduler(max_update=150, base_lr=0.3, pwr=2,
                                      final_lr=1e-3, warmup_steps=10),
    "cosine": lambda m: m.CosineScheduler(max_update=170, base_lr=0.1,
                                          final_lr=1e-4, warmup_steps=12,
                                          warmup_begin_lr=1e-3),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedule_sequences_equal(name):
    t = SCHEDULES[name](tmx.lr_scheduler)
    j = SCHEDULES[name](jmx.lr_scheduler)
    tl = [t(i) for i in range(200)]
    jl = [j(i) for i in range(200)]
    assert tl == jl
    assert len(set(tl)) > 3


def test_lr_schedule_errors_and_the_optimizer():
    with pytest.raises(MXNetError, match="step must be"):
        tmx.lr_scheduler.FactorScheduler(step=0)
    with pytest.raises(MXNetError, match="increasing"):
        tmx.lr_scheduler.MultiFactorScheduler(step=[5, 3])
    with pytest.raises(MXNetError, match="warmup_mode"):
        tmx.lr_scheduler.LRScheduler(warmup_mode="cubic")
    sched = tmx.lr_scheduler.PolyScheduler(max_update=10, base_lr=1.0)
    opt = tmx.optimizer.create("sgd", learning_rate=0.5, lr_scheduler=sched)
    assert sched.base_lr == 0.5
    opt.num_update = 5
    assert opt.learning_rate == sched(5)


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def _port_init(init, name, shape, seed=0):
    arr = torch.zeros(shape)
    if not isinstance(name, tmx.init.InitDesc):
        name = tmx.init.InitDesc(name)
    init(name, arr, torch.Generator().manual_seed(seed))
    return arr.numpy()


def _jax_init(init, name, shape):
    arr = jmx.nd.zeros(shape)
    init(jmx.initializer.InitDesc(name), arr)
    return arr.asnumpy()


@pytest.mark.parametrize("name,expect", [
    ("fc_bias", 0.0), ("bn_beta", 0.0), ("bn_moving_mean", 0.0),
    ("q_min", 0.0), ("q_max", 0.0), ("bn_gamma", 1.0),
    ("bn_moving_var", 1.0), ("bn_running_var", 1.0)])
def test_name_dispatch_matches(name, expect):
    for init_t, init_j in ((tmx.init.Xavier(), jmx.initializer.Xavier()),
                           (tmx.init.Normal(3.0),
                            jmx.initializer.Normal(3.0))):
        t = _port_init(init_t, name, (5,))
        np.testing.assert_array_equal(t, _jax_init(init_j, name, (5,)))
        assert (t == expect).all()


@pytest.mark.parametrize("make,shape", [
    (lambda m: m.Constant(0.25), (3, 4)),
    (lambda m: m.Zero(), (3, 4)),
    (lambda m: m.One(), (3, 4)),
    (lambda m: m.Bilinear(), (2, 3, 4, 4)),
    (lambda m: m.Bilinear(), (1, 1, 3, 5)),
], ids=["constant", "zero", "one", "bilinear4", "bilinear3x5"])
def test_deterministic_initializers_match(make, shape):
    t = make(tmx.init)
    t.init_array("w", arr := torch.zeros(shape), torch.Generator())
    j = jmx.nd.zeros(shape)
    make(jmx.initializer).init_array("w", j)
    np.testing.assert_allclose(arr.numpy(), j.asnumpy(), rtol=0,
                               atol=1e-7)


def test_lstm_bias_and_attr_init():
    t = torch.zeros(8)
    tmx.init.LSTMBias(2.0).init_array("l_bias", t, torch.Generator())
    j = jmx.nd.zeros((8,))
    jmx.initializer.LSTMBias(2.0).init_array("l_bias", j)
    np.testing.assert_array_equal(t.numpy(), j.asnumpy())
    # an InitDesc's __init__ attribute names the initializer to use
    desc = tmx.init.InitDesc("x_weight", attrs={
        "__init__": tmx.init.Constant(0.5).dumps()})
    assert (_port_init(tmx.init.Xavier(), desc, (3,)) == 0.5).all()
    assert tmx.init.create("xavier", magnitude=2.0).magnitude == 2.0
    assert isinstance(tmx.init.create(None), tmx.init.Uniform)
    with pytest.raises(MXNetError, match="cannot create"):
        tmx.init.create("bogus")


def test_mixed_routes_by_pattern():
    def route(m, init_mod):
        return init_mod.Mixed([".*_weight", ".*"],
                              [init_mod.Constant(2.0), init_mod.One()])
    for name in ("fc_weight", "fc_scale", "fc_bias"):
        t = _port_init(route(None, tmx.init), name, (4,))
        np.testing.assert_array_equal(
            t, _jax_init(route(None, jmx.initializer), name, (4,)))
    with pytest.raises(MXNetError, match="did not match"):
        _port_init(tmx.init.Mixed(["a"], [tmx.init.One()]), "b", (1,))


def _moments(a, mean, std, n_sigma=5):
    n = a.size
    assert abs(a.mean() - mean) <= n_sigma * std / math.sqrt(n)
    assert abs(a.std() - std) <= n_sigma * std / math.sqrt(2 * n)


@pytest.mark.parametrize("name", ["uniform", "normal", "xavier_uniform",
                                  "xavier_gaussian_in", "msraprelu"])
def test_random_initializers_match_in_law(name):
    shape = (64, 32, 3, 3)
    fan_in, fan_out = 32 * 9, 64 * 9
    make, std = {
        "uniform": (lambda m: m.Uniform(0.3), 0.3 / math.sqrt(3)),
        "normal": (lambda m: m.Normal(0.2), 0.2),
        "xavier_uniform": (lambda m: m.Xavier(), math.sqrt(
            3 / ((fan_in + fan_out) / 2)) / math.sqrt(3)),
        "xavier_gaussian_in": (lambda m: m.Xavier(
            rnd_type="gaussian", factor_type="in", magnitude=2),
            math.sqrt(2 / fan_in)),
        "msraprelu": (lambda m: m.MSRAPrelu(slope=0.1),
                      math.sqrt(2 / 1.01 / ((fan_in + fan_out) / 2))),
    }[name]
    t = _port_init(make(tmx.init), "conv_weight", shape)
    j = _jax_init(make(jmx.initializer), "conv_weight", shape)
    for a in (t, j):
        _moments(a, 0.0, std)
    assert np.abs(t).max() <= np.abs(j).max() * 1.5
    # a seeded port draw repeats
    np.testing.assert_array_equal(
        t, _port_init(make(tmx.init), "conv_weight", shape))


@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
def test_orthogonal(rand_type):
    for shape in ((6, 4), (4, 2, 3)):
        t = _port_init(tmx.init.Orthogonal(scale=1.5, rand_type=rand_type),
                       "w", shape).reshape(shape[0], -1)
        j = _jax_init(jmx.initializer.Orthogonal(scale=1.5,
                                                 rand_type=rand_type),
                      "w", shape).reshape(shape[0], -1)
        for a in (t, j):
            gram = a.T @ a if a.shape[0] >= a.shape[1] else a @ a.T
            np.testing.assert_allclose(gram, 2.25 * np.eye(len(gram)),
                                       atol=1e-5)


# ---------------------------------------------------------------------------
# LibSVMIter: the same CSR batches as the JAX package's from one file
# ---------------------------------------------------------------------------

def _libsvm_file(tmp_path, rows=11, feats=30, multi_label=False):
    """A libsvm file with rows of 0-4 nonzeros (an empty row included),
    unsorted and repeated column ids, and one or two labels a row."""
    rng = np.random.RandomState(17)
    lines = []
    for r in range(rows):
        k = 0 if r == 3 else rng.randint(1, 5)
        cols = rng.randint(0, feats, k)
        if r == 5:
            cols = np.array([7, 2, 7])
        labs = [f"{rng.randint(0, 2)}"] + ([f"{rng.rand():.3f}"]
                                           if multi_label else [])
        toks = [f"{c}:{rng.standard_normal():.6g}" for c in cols]
        lines.append(" ".join(labs + toks))
    path = tmp_path / "data.libsvm"
    path.write_text("\n".join(lines) + "\n\n")
    return str(path)


def _csr_batches(it):
    out = []
    for b in it:
        d = b.data[0]
        assert d.stype == "csr"
        out.append((d.data.asnumpy(), d.indices.asnumpy().astype(np.int64),
                    d.indptr.asnumpy().astype(np.int64), d.shape,
                    d.asnumpy(), b.label[0].asnumpy(), b.pad,
                    np.asarray(b.index)))
    return out


@pytest.mark.parametrize("round_batch", [True, False])
@pytest.mark.parametrize("multi_label", [False, True])
def test_libsvm_iter_matches_jax(tmp_path, round_batch, multi_label):
    """Values, column ids, row pointers, dense views, labels, pads and
    row indices bit for bit, over two epochs (``reset``); the port's
    batches are compact CSR on the CPU."""
    path = _libsvm_file(tmp_path, multi_label=multi_label)
    kw = dict(data_libsvm=path, data_shape=(30,), batch_size=4,
              round_batch=round_batch)
    t, j = tmx.io.LibSVMIter(**kw), jmx.io.LibSVMIter(**kw)
    assert t.provide_data == j.provide_data
    assert t.provide_label == j.provide_label
    for _ in range(2):
        tb, jb = _csr_batches(t), _csr_batches(j)
        assert len(tb) == len(jb) == (3 if round_batch else 2)
        for a, b in zip(tb, jb):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        t.reset()
        j.reset()
    first = tmx.io.LibSVMIter(**kw).next().data[0]
    assert first.ctx == tmx.cpu() and first.nbytes_compact() == \
        first.data.size * 12 + 5 * 8


def test_libsvm_iter_label_file(tmp_path):
    path = _libsvm_file(tmp_path)
    lab = tmp_path / "labels.txt"
    lab.write_text("\n".join(f"{i % 3} {i}" for i in range(11)) + "\n")
    kw = dict(data_libsvm=path, data_shape=30, label_libsvm=str(lab),
              label_shape=(2,), batch_size=5)
    t, j = tmx.io.LibSVMIter(**kw), jmx.io.LibSVMIter(**kw)
    assert t.provide_label == j.provide_label
    for a, b in zip(_csr_batches(t), _csr_batches(j)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
