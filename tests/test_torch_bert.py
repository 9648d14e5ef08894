"""mxnet_tpu_torch's BERT serving slice against the JAX package.

A tiny BERT (2 layers, 32 units, 4 heads, vocab 100, max_length 32) is
built in the JAX package with random weights from a numpy seed (biases,
LayerNorm gammas and betas included), and the same values are carried
into the port by ``load_numpy_params`` under the structural names.  The
forward (sequence and pooled outputs) and the MLM/NSP heads agree to
1e-5 in fp32, eager and hybridized.  Then the tie of the MLM decoder to
the word embedding, BERT's ops in fp32 and bf16, and the serving path
(export -> import_model -> InferenceServer on the CPU) are checked.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu.gluon.model_zoo.bert import get_bert_model as jax_bert
from mxnet_tpu.ops import nn as jnn

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import ops, serving
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib import deploy
from mxnet_tpu_torch.gluon import load_numpy_params, model_zoo
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert

TINY = dict(vocab_size=100, num_layers=2, units=32, hidden_size=64,
            num_heads=4, max_length=32, dropout=0.1)
B, S = 3, 12


def _batch(seed=0, lengths=(12, 7, 1)):
    rs = np.random.RandomState(seed)
    tok = rs.randint(0, 100, (B, S)).astype(np.int32)
    seg = rs.randint(0, 2, (B, S)).astype(np.int32)
    return tok, seg, np.array(lengths, np.float32)


def _random_values(params, seed=1):
    """One value per parameter (the tied one once, under both names)."""
    rs = np.random.RandomState(seed)
    by_id, vals = {}, {}
    for name, p in params.items():
        if id(p) not in by_id:
            shape = tuple(p.shape)
            if name.endswith("gamma"):
                v = 1.0 + 0.1 * rs.randn(*shape)
            elif name.endswith(("beta", "bias")):
                v = 0.1 * rs.randn(*shape)
            else:
                v = 0.05 * rs.randn(*shape)
            by_id[id(p)] = v.astype(np.float32)
        vals[name] = by_id[id(p)]
    return vals


def _jax_outputs(net, tok, seg, vl, heads=True):
    seq, pooled = net(nd.array(tok, dtype="int32"),
                      nd.array(seg, dtype="int32"), nd.array(vl))
    outs = [seq, pooled]
    if heads:
        outs += [net.decode_mlm(seq), net.classify_nsp(pooled)]
    return [a.asnumpy() for a in outs]


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX network with random weights, its eager and hybridized
    outputs on one batch, and the weights by structural name."""
    net = jax_bert("bert_12_768_12", **TINY)
    net.initialize(mx.initializer.Normal(0.02), ctx=mx.cpu())
    tok, seg, vl = _batch()
    _jax_outputs(net, tok, seg, vl)  # resolve the heads' deferred shapes
    params = net._collect_params_with_prefix()
    values = _random_values(params)
    for k, p in params.items():
        p.set_data(mx.nd.array(values[k]))
    eager = _jax_outputs(net, tok, seg, vl)
    # the JAX package's hybridized forward (its heads run eagerly)
    net.hybridize()
    hybrid = _jax_outputs(net, tok, seg, vl, heads=False)
    return net, values, eager, hybrid


def _port_net(values, hybridize=True):
    net = tbert.get_bert_model("bert_12_768_12", **TINY)
    net.initialize(ctx=mt.cpu())
    load_numpy_params(net, values)
    if hybridize:
        net.hybridize()
    net.eval()
    return net


def _port_outputs(net, tok, seg, vl):
    with torch.no_grad():
        seq, pooled = net(torch.from_numpy(tok), torch.from_numpy(seg),
                          torch.from_numpy(vl))
        return [t.numpy() for t in (seq, pooled, net.decode_mlm(seq),
                                    net.classify_nsp(pooled))]


@pytest.mark.parametrize("hybridize", [False, True])
def test_bert_matches_jax_fp32(jax_ref, hybridize):
    _, values, eager, hybrid = jax_ref
    got = _port_outputs(_port_net(values, hybridize), *_batch())
    shapes = [(B, S, 32), (B, 32), (B, S, 100), (B, 2)]
    for g, e, shape, what in zip(got, eager, shapes,
                                 ("seq", "pooled", "mlm", "nsp")):
        assert g.shape == shape, what
        np.testing.assert_allclose(g, e, rtol=1e-5, atol=1e-5, err_msg=what)
    for g, h in zip(got, hybrid):
        np.testing.assert_allclose(g, h, rtol=1e-5, atol=1e-5)


def test_padding_positions_do_not_change_valid_ones(jax_ref):
    net = _port_net(jax_ref[1])
    tok, seg, vl = _batch()
    tok2, seg2 = tok.copy(), seg.copy()
    for i, n in enumerate(vl.astype(int)):
        tok2[i, n:] = 99
        seg2[i, n:] = 1 - seg2[i, n:]
    a = _port_outputs(net, tok, seg, vl)[0]
    b = _port_outputs(net, tok2, seg2, vl)[0]
    for i, n in enumerate(vl.astype(int)):
        np.testing.assert_allclose(a[i, :n], b[i, :n], rtol=1e-5, atol=1e-5)


def test_jax_saved_parameters_load_in_the_port(jax_ref, tmp_path):
    jnet, values, eager, _ = jax_ref
    f = str(tmp_path / "bert.params")
    jnet.save_parameters(f)
    net = tbert.get_bert_model("bert_12_768_12", **TINY)
    net.initialize(ctx=mt.cpu())
    net.load_parameters(f)
    got = {k: v.detach().numpy()
           for k, v in net.state_dict(keep_vars=True).items()}
    assert set(got) == set(values)
    assert "mlm_decoder.embed_weight" in got and "position_weight" in got
    for k in values:
        np.testing.assert_array_equal(got[k], values[k], err_msg=k)
    net.eval()
    np.testing.assert_allclose(_port_outputs(net, *_batch())[0], eager[0],
                               rtol=1e-5, atol=1e-5)


def test_the_tie_survives_initialize_load_and_cast(jax_ref, tmp_path):
    net = tbert.get_bert_model("bert_12_768_12", **TINY)
    net.initialize(mt.init.Normal(0.02), ctx=mt.cpu(), seed=3)
    params = net.state_dict(keep_vars=True)
    word, tied = "word_embed.weight", "mlm_decoder.embed_weight"
    assert params[tied] is params[word]
    assert torch.equal(params[tied], params[word])
    values = jax_ref[1]
    for name in (word, tied):  # a load through either name changes both
        new = 0.5 * values[word] + float(name == tied)
        one = {k: v for k, v in values.items() if k not in (word, tied)}
        one[name] = new
        load_numpy_params(net, one)
        p = net.state_dict(keep_vars=True)
        assert p[tied] is p[word] is net.word_embed.weight
        np.testing.assert_array_equal(p[word].detach().numpy(), new)
    clash = dict(values, **{tied: values[word] + 1.0})
    with pytest.raises(MXNetError, match="tied"):
        load_numpy_params(net, clash)
    missing = {k: v for k, v in values.items() if k not in (word, tied)}
    with pytest.raises(MXNetError, match="missing"):
        load_numpy_params(net, missing)
    net.cast("bfloat16")
    p = net.state_dict(keep_vars=True)
    assert p[tied] is p[word] and p[word].dtype == torch.bfloat16
    f = str(tmp_path / "tied.params")
    net.save_parameters(f)
    net2 = tbert.get_bert_model("bert_12_768_12", **TINY)
    net2.initialize(ctx=mt.cpu())
    net2.load_parameters(f)
    p2 = net2.state_dict(keep_vars=True)
    assert p2[tied] is p2[word] and p2[word].dtype == torch.bfloat16
    assert torch.equal(p2[word], p[word])


def _bf16_close(got, want, ulps, mag=None):
    """|got - want| <= `ulps` bf16 ulps of `mag` (default |want|), taken
    no smaller than the ulp of max|want| times 2^-8."""
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    mag = np.abs(w) if mag is None else mag
    mag = np.maximum(mag, np.abs(w).max() * 2.0 ** -8)
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    err = np.abs(g - w)
    assert (err <= ulps * ulp).all(), float((err / ulp).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bert_ops_match_the_jax_ops(dtype):
    """fp32 to 1e-6; bf16 exactly (embedding) or within 1 bf16 ulp (tanh
    rounds one fp32 value; gelu runs the same bf16 ops on both sides, and
    erfc may land one ulp apart).  layer_norm in bf16 runs
    the same chain of bf16 ops on both sides, but XLA's bf16 rsqrt can
    land one ulp from PyTorch's correctly rounded one, and that ulp
    scales (x - mean) * gamma: bound 2 ulps of |x_hat * gamma| + |beta|."""
    rs = np.random.RandomState(4)
    x = (rs.randn(3, 5, 32) * 2 + 0.5).astype(np.float32)
    gamma = (1 + 0.1 * rs.randn(32)).astype(np.float32)
    beta = (0.1 * rs.randn(32)).astype(np.float32)
    table = rs.randn(10, 8).astype(np.float32)
    ids = np.array([[0, 3, 9, 10, 250], [-1, -7, 4, 2, 1]], np.int32)
    bf16 = dtype == "bfloat16"
    npdt = ml_dtypes.bfloat16 if bf16 else np.float32
    tdt = torch.bfloat16 if bf16 else torch.float32

    def j(a):
        return jnp.asarray(np.asarray(a).astype(npdt))

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(tdt)
    xq = x.astype(npdt).astype(np.float32)
    x_hat = (xq - xq.mean(-1, keepdims=True)) / xq.std(-1, keepdims=True)
    ln_mag = np.abs(x_hat * gamma) + np.abs(beta)
    cases = [
        ("layer_norm", ops.layer_norm(t(x), t(gamma), t(beta), eps=1e-12),
         jnn._layer_norm(j(x), j(gamma), j(beta), eps=1e-12), 2, ln_mag),
        ("gelu", ops.activation(t(x), "gelu"),
         jnn._activation(j(x), act_type="gelu"), 1, None),
        ("tanh", ops.activation(t(x), "tanh"),
         jnn._activation(j(x), act_type="tanh"), 1, None),
        ("embedding", ops.embedding(torch.from_numpy(ids), t(table)),
         jnn._embedding(jnp.asarray(ids), j(table)), 0, None),
    ]
    for name, got, want, ulps, mag in cases:
        assert got.dtype == tdt, name
        want = np.asarray(want).astype(np.float32)
        assert got.shape == want.shape, name
        if bf16:
            _bf16_close(got, want, ulps, mag)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6, err_msg=name)
    # out-of-range ids clamp into the table, never raise
    emb = ops.embedding(torch.from_numpy(ids), torch.from_numpy(table))
    np.testing.assert_array_equal(emb[0, 4].numpy(), table[9])
    np.testing.assert_array_equal(emb[1, 1].numpy(), table[0])
    with pytest.raises(MXNetError, match="relu"):
        ops.activation(t(x), "bogus")


def test_served_bert_equals_a_direct_forward(jax_ref, tmp_path):
    """export -> import_model -> InferenceServer on the CPU, requests of
    mixed valid lengths: every answer is the (seq, pooled) pair of a
    direct forward, including the batch padded with zero rows (valid
    length 0, every key masked)."""
    net = _port_net(jax_ref[1])
    tok, seg, vl = _batch(seed=2, lengths=(12, 5, 1))
    with torch.no_grad():
        direct = net(torch.from_numpy(tok), torch.from_numpy(seg),
                     torch.from_numpy(vl))
        pad = net(torch.zeros(1, S, dtype=torch.int32),
                  torch.zeros(1, S, dtype=torch.int32), torch.zeros(1))
    assert all(bool(torch.isfinite(t).all()) for t in pad)
    ex = [torch.from_numpy(a[:1]) for a in (tok, seg, vl)]
    path = deploy.export_model(net, str(tmp_path / "bert"), ex,
                               dynamic_batch=True)
    served = deploy.import_model(path, ctx=mt.cpu())
    assert served.meta["inputs"] == [
        {"shape": [None, S], "dtype": "int32"},
        {"shape": [None, S], "dtype": "int32"},
        {"shape": [None], "dtype": "float32"}]
    assert served.meta["n_outputs"] == 2
    assert type(served.net) is tbert.BERTModel
    repo = serving.ModelRepository(ctx=mt.cpu())
    repo.add("bert", path)
    server = serving.InferenceServer(
        repo, serving.ServingConfig(max_batch_size=4, batch_timeout_ms=500))
    try:
        futs = [server.submit("bert", [torch.from_numpy(a[i:i + 1])
                                       for a in (tok, seg, vl)])
                for i in range(B)]
        answers = [f.result(timeout=60) for f in futs]
    finally:
        server.shutdown(drain=True)
    snap = repo.get("bert").metrics.snapshot()
    assert snap["padded_rows"] > snap["batched_rows"] == B
    for i, (seq, pooled) in enumerate(answers):
        assert seq.shape == (1, S, 32) and pooled.shape == (1, 32)
        torch.testing.assert_close(seq[0], direct[0][i], rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(pooled[0], direct[1][i], rtol=1e-5,
                                   atol=1e-5)
    assert model_zoo.get_model("bert_12_768_12", **TINY)._arch["name"] \
        == "BERTModel"


def test_training_mode_dropout_draws_from_the_trace_generator(jax_ref):
    """In a train-mode trace scope every Dropout and the attention's
    probability dropout draw from the scope's generator; eval is the
    identity and a train scope without a generator raises."""
    net = _port_net(jax_ref[1], hybridize=False)
    xs = [torch.from_numpy(a) for a in _batch()]

    def run(train, seed=None):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad(), mt.gluon.ActiveTrace(train, generator=gen):
            return net(*xs)[0]
    eval_out = run(False)
    torch.testing.assert_close(run(True, 5), run(True, 5), rtol=0, atol=0)
    assert not torch.equal(run(True, 5), run(True, 6))
    assert not torch.equal(run(True, 5), eval_out)
    with pytest.raises(MXNetError, match="Generator"):
        run(True)


def test_entry_points_raise_without_cuda(jax_ref, tmp_path, monkeypatch):
    net = _port_net(jax_ref[1])
    tok, seg, vl = _batch()
    path = deploy.export_model(net, str(tmp_path / "bert"),
                               [torch.from_numpy(a[:1])
                                for a in (tok, seg, vl)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        deploy.import_model(path)
    with pytest.raises(MXNetError, match="no CUDA device"):
        serving.ModelRepository()
    with pytest.raises(MXNetError, match="no CUDA device"):
        tbert.get_bert_model("bert_12_768_12", **TINY).initialize()
