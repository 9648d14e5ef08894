"""mxnet_tpu_torch's Transformer against the JAX package's
(``bench_all.py``'s config 5 at its ``--cpu-smoke`` size: 2 layers, 64
units, 4 heads, vocab 1000, batch 2 x 16).

A tiny ``transformer_base`` is built in the JAX package with random
weights from a numpy seed (biases and LayerNorm parameters included,
the sinusoidal ``pos_table`` as the JAX package builds it), and the
values are carried into the port under the structural names.  Held
(fp32): the logits within 1e-5 of their largest element, with valid
lengths below the bucket on both sides; ``encode`` + ``decode_logits``
equal to the forward; ``greedy_decode``'s tokens identical; the
label-smoothed loss within 1e-6 relative; two Adam steps of
``bench_all.py``'s config-5 step through both ``SPMDTrainer``s (losses
1e-5 relative; each tensor's update w2 - w0 within 1e-3 relative plus
1e-3 * lr on 99.9% of its elements and within 1e-2 * lr on all: Adam
divides by each element's root mean square, so where two steps'
gradients nearly cancel in the first moment their fp32 rounding moves
the update by a share of lr, measured 3.1e-3 * lr on 1 of 64000 in the
shared embedding; moments within 1e-3 relative plus 1e-3 of the largest
moment); a ``.params``
file written by the JAX package loads in the port, ``pos_table`` and the
three names of the shared embedding included, and the port's file loads
back; ``nd.concatenate`` against the JAX package's.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import nd as jnd
from mxnet_tpu import parallel as jpar
from mxnet_tpu.gluon.block import HybridBlock as JHybridBlock
from mxnet_tpu.gluon.model_zoo import transformer as jtr

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.examples import bench_steps as bs
from mxnet_tpu_torch.gluon import load_numpy_params, model_zoo
from mxnet_tpu_torch.gluon.model_zoo import transformer as ttr

SIZE = "cpu_smoke"
CFG = bs.TRANSFORMER_SIZES[SIZE]
TINY = dict(src_vocab_size=CFG["vocab"], tgt_vocab_size=CFG["vocab"],
            dropout=0.0, **CFG["model"])
B, S = CFG["batch"], CFG["seq"]
TIE = ("src_embed.weight", "tgt_embed.weight", "tied_weight")
OPT = {"learning_rate": 1e-3, "wd": 1e-2}


def _random_values(params, seed=1):
    """One value per parameter (a tied one once, under each name); the
    position table stays the JAX package's."""
    rs = np.random.RandomState(seed)
    by_id, vals = {}, {}
    for name, p in params.items():
        if id(p) not in by_id:
            v = p.data().asnumpy()
            if name != "pos_table":
                v = float(name.endswith("gamma")) + 0.1 * rs.randn(*v.shape)
            by_id[id(p)] = np.asarray(v, np.float32)
        vals[name] = by_id[id(p)]
    return vals


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    src = rs.randint(4, CFG["vocab"], (B, S)).astype(np.int32)
    tgt = rs.randint(4, CFG["vocab"], (B, S)).astype(np.int32)
    return src, tgt, np.array([S, 9], np.float32), np.array([S, 11],
                                                            np.float32)


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX network with random weights, its logits on one batch, and
    the weights by structural name."""
    np.random.seed(0)
    mx.random.seed(0)
    net = jtr.get_transformer_model("transformer_base", **TINY)
    net.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    src, tgt, sv, tv = _batch()
    args = [jnd.array(src, dtype="int32"), jnd.array(tgt, dtype="int32"),
            jnd.array(sv), jnd.array(tv)]
    net(*args)
    params = net._collect_params_with_prefix()
    values = _random_values(params)
    for k, p in params.items():
        p.set_data(mx.nd.array(values[k]))
    return net, values, net(*args).asnumpy()


def _port_net(values):
    net = ttr.get_transformer_model("transformer_base", **TINY)
    net.initialize(ctx=mt.cpu())
    load_numpy_params(net, values)
    return net.eval()


def _logits(net, src, tgt, sv, tv):
    with torch.no_grad():
        return net(*map(torch.from_numpy, (src, tgt, sv, tv))).numpy()


def test_logits_match_jax_fp32(jax_ref):
    _, values, want = jax_ref
    got = _logits(_port_net(values), *_batch())
    assert got.shape == (B, S, CFG["vocab"])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_structure_names_and_the_three_way_tie(jax_ref):
    _, values, _ = jax_ref
    net = _port_net(values)
    params = net.state_dict(keep_vars=True)
    assert set(params) == set(values)
    assert params[TIE[0]] is params[TIE[1]] is params[TIE[2]]
    assert isinstance(params[TIE[0]], torch.nn.Parameter)
    # the position table is a constant: a buffer, never trained
    assert "pos_table" in dict(net.named_buffers())
    np.testing.assert_array_equal(params["pos_table"].numpy(),
                                  jtr._sinusoid_table(512, 64))
    np.testing.assert_array_equal(ttr._sinusoid_table(40, 64),
                                  jtr._sinusoid_table(40, 64))
    tr = tpar.SPMDTrainer(net, bs.Identity(), "adam", {},
                          mesh=tpar.make_mesh(dp=1, devices=[mt.cpu()]),
                          n_labels=0)
    assert "pos_table" not in tr._trainable
    assert [n for n in TIE if n in tr._trainable] == ["tied_weight"]
    # initialize refills the table; cast carries it, as the JAX Constant
    net.initialize(mt.init.Xavier(), ctx=mt.cpu(), seed=4)
    np.testing.assert_array_equal(net.pos_table.data().asnumpy(),
                                  values["pos_table"])
    net.cast("bfloat16")
    assert net.pos_table.data()._data.dtype == torch.bfloat16
    assert net.src_embed.weight._tensor is net.tied_weight._tensor
    assert net.tied_weight._tensor.dtype == torch.bfloat16
    with pytest.raises(MXNetError, match="share_embed"):
        ttr.Transformer(100, 200)


def test_encode_and_decode_logits_equal_the_forward(jax_ref):
    _, values, want = jax_ref
    net = _port_net(values)
    src, tgt, sv, tv = (mt.nd.array(a, ctx=mt.cpu()) for a in _batch())
    mem, mask = net.encode(src, sv)
    assert isinstance(mem, mt.nd.NDArray) and mem.shape == (B, S, 64)
    got = net.decode_logits(tgt, tv, mem, mask).asnumpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # the JAX package's own inference stages agree with its forward
    jnet = jax_ref[0]
    jsrc, jtgt, jsv, jtv = (jnd.array(a) for a in _batch())
    jmem, jmask = jnet.encode(jsrc, jsv)
    np.testing.assert_allclose(mem.asnumpy(), jmem.asnumpy(), rtol=0,
                               atol=1e-5 * np.abs(jmem.asnumpy()).max())


def test_greedy_decode_tokens_equal_jax(jax_ref):
    jnet, values, _ = jax_ref
    net = _port_net(values)
    rs = np.random.RandomState(5)
    src = rs.randint(4, CFG["vocab"], (4, S)).astype(np.float32)
    sv = np.array([16, 5, 1, 12], np.float32)
    want = jnet.greedy_decode(jnd.array(src), jnd.array(sv),
                              max_len=10).asnumpy()
    got = net.greedy_decode(mt.nd.array(src, ctx=mt.cpu()),
                            mt.nd.array(sv, ctx=mt.cpu()), max_len=10)
    assert isinstance(got, mt.nd.NDArray)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.asnumpy(), want)
    assert (want[:, 0] == 1).all() and want.shape[1] <= 10


def test_greedy_decode_freezes_finished_rows(jax_ref):
    """eos_id set to the token the first row emits first: that row keeps
    emitting it, in both packages."""
    jnet, values, _ = jax_ref
    net = _port_net(values)
    src = np.random.RandomState(6).randint(4, CFG["vocab"], (3, 8)).astype(
        np.float32)
    sv = np.array([8, 8, 3], np.float32)
    first = net.greedy_decode(mt.nd.array(src, ctx=mt.cpu()),
                              mt.nd.array(sv, ctx=mt.cpu()),
                              max_len=3).asnumpy()
    eos = int(first[0, 1])
    want = jnet.greedy_decode(jnd.array(src), jnd.array(sv), max_len=6,
                              eos_id=eos).asnumpy()
    got = net.greedy_decode(mt.nd.array(src, ctx=mt.cpu()),
                            mt.nd.array(sv, ctx=mt.cpu()), max_len=6,
                            eos_id=eos).asnumpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, 1:] == eos).all()


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_label_smoothed_loss_matches_jax(smoothing):
    rs = np.random.RandomState(2)
    pred = rs.randn(3, 5, 17).astype(np.float32)
    label = rs.randint(0, 17, (3, 5)).astype(np.float32)
    weight = rs.rand(3, 5).astype(np.float32)
    jl = jtr.LabelSmoothedCELoss(smoothing=smoothing)
    tl = ttr.LabelSmoothedCELoss(smoothing=smoothing)
    for extra in ((), (weight,)):
        want = jl(jnd.array(pred), jnd.array(label),
                  *map(jnd.array, extra)).asnumpy()
        got = tl(*map(torch.from_numpy, (pred, label) + extra)).numpy()
        assert got.shape == (3, 5)
        np.testing.assert_allclose(got, want, rtol=1e-6)


class _Identity:
    def __call__(self, out, *labels):
        return out


class JaxNMTStep(JHybridBlock):
    """``bench_all.py``'s config-5 step (bench_all.py:268-290)."""

    def __init__(self):
        super().__init__()
        with self.name_scope():
            self.net = jtr.get_transformer_model("transformer_base", **TINY)

    def hybrid_forward(self, F, src, tgt_in, src_valid, tgt_valid,
                       tgt_out):
        logits = self.net(src, tgt_in, src_valid, tgt_valid)
        lsm = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
        eps = 0.1
        nll = -jnp.take_along_axis(
            lsm, tgt_out[..., None].astype(jnp.int32), -1)[..., 0]
        smooth = -lsm.mean(-1)
        steps_ = jax.lax.broadcasted_iota(
            jnp.int32, nll.shape, 1).astype(jnp.float32)
        mask = (steps_ < tgt_valid[:, None].astype(jnp.float32))
        per_tok = ((1 - eps) * nll + eps * smooth) * mask
        return per_tok.sum() / jnp.maximum(mask.sum(), 1.0)


def _train_batch():
    src, tgt_in, sv, tv, tgt_out = bs.transformer_batch(SIZE)
    return src, tgt_in, sv, np.array([S, 10], np.float32), tgt_out


def test_nmt_training_two_adam_steps_match_jax(jax_ref):
    values = {"net." + k: v for k, v in jax_ref[1].items()}
    batch = _train_batch()
    jstep = JaxNMTStep()
    jstep.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    jstep.net(*(jnd.array(a) for a in batch[:4]))
    params = jstep._collect_params_with_prefix()
    for k, p in params.items():
        p.set_data(mx.nd.array(values[k]))
    with jpar.make_mesh(dp=1):
        jt = jpar.SPMDTrainer(jstep, _Identity(), "adam", dict(OPT),
                              n_labels=0)
        jl = [float(jt.step(*batch).asnumpy()) for _ in range(2)]
    step = bs.transformer_step(SIZE, dropout=0.0)
    step.initialize(ctx=mt.cpu())
    load_numpy_params(step, values)
    tt = bs.spmd_trainer(step, OPT["learning_rate"],
                         mesh=tpar.make_mesh(dp=1, devices=[mt.cpu()]),
                         wd=OPT["wd"])
    tl = [float(tt.step(*(torch.from_numpy(a) for a in batch)))
          for _ in range(2)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[1] < tl[0]
    got = step.state_dict(keep_vars=True)
    # the shared embedding: one state, trained once a step
    tie = ["net." + n for n in TIE]
    assert [n for n in tie if n in tt.opt_state] == ["net.tied_weight"]
    assert got[tie[0]] is got[tie[2]]
    jstate = {k: jt.opt_state[p.name] for k, p in params.items()
              if p.name in jt.opt_state}
    floors = [1e-3 * max(float(np.abs(np.asarray(s[i])).max())
                         for s in jstate.values()) for i in (0, 1)]
    for k, p in params.items():
        want = np.asarray(jt.params[p.name])
        d_want = want - values[k]
        d_got = got[k].detach().numpy() - values[k]
        err = np.abs(d_got - d_want)
        lr = OPT["learning_rate"]
        assert (err <= 1e-3 * np.abs(d_want) + 1e-3 * lr).mean() >= 0.999, k
        assert err.max() <= 1e-2 * lr, k
        if k in tt.opt_state:
            for i in (0, 1):
                np.testing.assert_allclose(
                    tt.opt_state[k][i].numpy(), np.asarray(jstate[k][i]),
                    rtol=1e-3, atol=floors[i], err_msg=f"state {i} {k}")


def test_jax_saved_parameters_load_in_the_port(jax_ref, tmp_path):
    jnet, values, want = jax_ref
    f = str(tmp_path / "transformer.params")
    jnet.save_parameters(f)
    net = ttr.get_transformer_model("transformer_base", **TINY)
    net.initialize(ctx=mt.cpu())
    net.load_parameters(f)
    params = net.state_dict(keep_vars=True)
    for k in values:
        np.testing.assert_array_equal(params[k].detach().numpy(), values[k],
                                      err_msg=k)
    assert params[TIE[0]] is params[TIE[1]] is params[TIE[2]]
    np.testing.assert_allclose(_logits(net.eval(), *_batch()), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # and the port's file back into the JAX package
    f2 = str(tmp_path / "port.params")
    net.save_parameters(f2)
    jnet2 = jtr.get_transformer_model("transformer_base", **TINY)
    jnet2.load_parameters(f2, ctx=mx.cpu())
    for k, p in jnet2._collect_params_with_prefix().items():
        np.testing.assert_array_equal(p.data().asnumpy(), values[k],
                                      err_msg=k)


def test_transformer_models_in_the_zoo():
    net = model_zoo.get_model("transformer_base", src_vocab_size=100)
    assert isinstance(net, ttr.Transformer)
    assert net.encoder.layers[5].attention.query.weight.shape == (512, 512)
    assert net.decoder.layers[0].self_attention._causal
    assert not net.decoder.layers[0].cross_attention._causal
    big = model_zoo.get_model("transformer_big", src_vocab_size=10,
                              num_layers=1)
    assert big.pos_table.shape == (512, 1024)
    with pytest.raises(MXNetError, match="unknown transformer"):
        ttr.get_transformer_model("transformer_huge")


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_nd_concatenate_matches_jax(axis):
    rs = np.random.RandomState(axis + 3)
    parts = [rs.randn(2, 3, 4).astype(np.float32) for _ in range(3)]
    want = jnd.concatenate([jnd.array(p) for p in parts], axis=axis)
    got = tnd.concatenate([tnd.array(p, ctx=mt.cpu()) for p in parts],
                          axis=axis)
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    mixed = tnd.concatenate([tnd.array(parts[0], ctx=mt.cpu()),
                             tnd.full((2, 3, 4), 2, ctx=mt.cpu())], axis=0)
    assert mixed.shape == (4, 3, 4) and mixed.dtype == np.float32
    assert tnd.Concat(tnd.array(parts[0], ctx=mt.cpu()),
                      tnd.array(parts[1], ctx=mt.cpu()),
                      dim=1).shape == (2, 6, 4)
