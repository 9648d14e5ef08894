"""BERT MLM+NSP pretraining through the port's SPMDTrainer with Adam,
against the JAX package's (``bench_all.py``'s config 3 at its
``--cpu-smoke`` size: 2 layers, 64 units, 4 heads, vocab 1000, batch 2
x 32 tokens).

The JAX step block is ``bench_all.py``'s own ``Step`` (copied here: the
benchmark defines it inside a function); the port's is
``examples.bench_steps.BertPretrainStep``.  Both start from the JAX
block's ``Normal(0.02)`` weights, carried across by structural name, and
train two Adam steps (lr 1e-3, wd 1e-2) at dropout 0 on
``bench_all.py``'s synthetic batch.  Tolerances (fp32): each loss within
1e-5 relative (measured 1.3e-7); each parameter's update w2 - w0 within
1e-3 relative plus 1e-3 * lr (measured: at most 7.3e-4 * lr; Adam
divides each element's gradient by its own root mean square, so where
a gradient is small its fp32 rounding moves the update by a share of
lr); each Adam moment within 1e-3 relative plus 1e-3 of the largest
moment over all tensors (measured: 4.2e-7 of it; the attention key
biases' gradients are analytically 0, rounding noise in both packages).

The tied word embedding (the MLM decoder's weight) is updated once a
step under one name, as the JAX package updates it: its update equals
one functional Adam step on the gradient summed over both uses.  Then
the dropout checks at dropout 0.1, which need none of JAX's random
bits: the step draws from the device's generator (the state moves each
step), every dropout mask has the rate 0.1 and scales the kept values by
1/0.9, the same seed gives the same losses, and another seed others.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import parallel as jpar
from mxnet_tpu.gluon.block import HybridBlock as JHybridBlock
from mxnet_tpu.gluon.model_zoo.bert import get_bert_model as jax_bert

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import ops as tops
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.examples import bench_steps as bs
from mxnet_tpu_torch.gluon import load_numpy_params

SIZE = "cpu_smoke"
OPT = {"learning_rate": 1e-3, "wd": 1e-2}
STEPS = 2
TIED = ("bert.word_embed.weight", "bert.mlm_decoder.embed_weight")


class _Identity:
    def __call__(self, out, *labels):
        return out


class JaxBertStep(JHybridBlock):
    """``bench_all.py``'s config-3 step (bench_all.py:157-171)."""

    def __init__(self, vocab, **kw):
        super().__init__()
        with self.name_scope():
            self.bert = jax_bert("bert_12_768_12", vocab_size=vocab, **kw)

    def hybrid_forward(self, F, tokens, segments, vlen, mlm_labels,
                       mlm_weight, nsp_labels):
        seq_out, pooled = self.bert(tokens, segments, vlen)
        mlm_scores = self.bert.decode_mlm(seq_out)
        nsp_scores = self.bert.classify_nsp(pooled)
        lsm = jax.nn.log_softmax(mlm_scores.astype(jnp.float32), -1)
        nll = -jnp.take_along_axis(
            lsm, mlm_labels[..., None].astype(jnp.int32), -1)[..., 0]
        mlm_l = ((nll * mlm_weight).sum()
                 / jnp.maximum(mlm_weight.sum(), 1.0))
        nsp_lsm = jax.nn.log_softmax(nsp_scores.astype(jnp.float32), -1)
        nsp_l = -jnp.take_along_axis(
            nsp_lsm, nsp_labels[:, None].astype(jnp.int32), -1)[:, 0]
        return mlm_l + nsp_l.mean()


@pytest.fixture(scope="module")
def jax_run():
    """The JAX step's initial weights by structural name, its losses, and
    its parameters and Adam moments after STEPS steps."""
    cfg = bs.BERT_SIZES[SIZE]
    batch = bs.bert_batch(SIZE)
    np.random.seed(0)
    mx.random.seed(0)
    net = JaxBertStep(cfg["vocab"], dropout=0.0, **cfg["model"])
    net.initialize(mx.initializer.Normal(0.02), ctx=mx.cpu())
    with mx.autograd.pause():
        seq, pooled = net.bert(*(mx.nd.array(a, ctx=mx.cpu())
                                 for a in batch[:3]))
        net.bert.decode_mlm(seq)
        net.bert.classify_nsp(pooled)
    params = net._collect_params_with_prefix()
    w0 = {k: p.data().asnumpy().copy() for k, p in params.items()}
    with jpar.make_mesh(dp=1):
        tr = jpar.SPMDTrainer(net, _Identity(), "adam", dict(OPT),
                              n_labels=0)
        losses = [float(tr.step(*batch).asnumpy()) for _ in range(STEPS)]
    w = {k: np.asarray(tr.params[p.name]) for k, p in params.items()}
    mom = {k: tuple(np.asarray(s) for s in tr.opt_state[p.name])
           for k, p in params.items() if p.name in tr.opt_state}
    return w0, losses, w, mom


def _port_step(w0, dropout=0.0):
    step = bs.bert_step(SIZE, dropout=dropout)
    step.initialize(ctx=mt.cpu())
    load_numpy_params(step, w0)
    trainer = bs.spmd_trainer(step, OPT["learning_rate"],
                              mesh=tpar.make_mesh(dp=1, devices=[mt.cpu()]),
                              wd=OPT["wd"])
    return step, trainer


def _batch():
    return bs.bert_batch(SIZE, ctx=mt.cpu())


def test_two_adam_steps_match_jax(jax_run):
    w0, jl, jw, jm = jax_run
    step, tr = _port_step(w0)
    batch = _batch()
    tl = [float(tr.step(*batch)) for _ in range(STEPS)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    got = {k: v.detach().numpy() for k, v in
           step.state_dict(keep_vars=True).items()}
    assert set(got) == set(jw)
    for k in jw:
        d_want, d_got = jw[k] - w0[k], got[k] - w0[k]
        np.testing.assert_allclose(d_got, d_want, rtol=1e-3,
                                   atol=1e-3 * OPT["learning_rate"],
                                   err_msg=k)
    # one state per tensor, under the first name of a tied one
    assert set(tr.opt_state) == set(jm) - {TIED[1]}
    for i, what in enumerate(("mean", "var")):
        floor = 1e-3 * max(np.abs(s[i]).max() for s in jm.values())
        for k, want in jm.items():
            if k != TIED[1]:
                np.testing.assert_allclose(
                    tr.opt_state[k][i].numpy(), want[i], rtol=1e-3,
                    atol=floor, err_msg=f"{what} {k}")


def test_tied_embedding_is_updated_once_a_step(jax_run):
    """The tied word embedding gets one Adam step on the gradient summed
    over its two uses (the embedding lookup and the MLM projection)."""
    w0 = jax_run[0]
    step, tr = _port_step(w0)
    params = step.state_dict(keep_vars=True)
    assert params[TIED[0]] is params[TIED[1]]
    assert TIED[0] in tr._trainable and TIED[1] not in tr._trainable
    assert len(tr._trainable) == len({id(params[n]) for n in tr._trainable})
    tied = params[TIED[0]]
    batch = _batch()
    with mt.gluon.ActiveTrace(train=True):
        g = torch.autograd.grad(step(*batch), tied)[0]
    fo = tpar.functional_optimizer(
        mt.optimizer.create("adam", **OPT))
    with torch.no_grad():
        want, _ = fo.apply(tied.detach().clone(), g, fo.init(tied),
                           OPT["learning_rate"], 1)
    tr.step(*batch)
    np.testing.assert_allclose(tied.detach().numpy(), want.numpy(),
                               rtol=0, atol=1e-7)
    assert not np.allclose(tied.detach().numpy(), w0[TIED[0]])


def test_dropout_draws_from_the_device_generator(jax_run, monkeypatch):
    w0 = jax_run[0]
    calls = []
    real = tops.dropout

    def spy(data, p=0.5, mode="training", train=False, generator=None):
        out = real(data, p=p, mode=mode, train=train, generator=generator)
        calls.append((p, train, generator, data.detach(), out.detach()))
        return out
    monkeypatch.setattr(tops, "dropout", spy)
    step, tr = _port_step(w0, dropout=0.1)
    gen = trandom.generator(mt.cpu())
    trandom.seed(11)
    batch = _batch()
    states = [gen.get_state()]
    losses = []
    for _ in range(STEPS):
        losses.append(float(tr.step(*batch)))
        states.append(gen.get_state())
    assert all(not torch.equal(a, b) for a, b in zip(states, states[1:]))
    # the embedding, each layer's attention output and FFN: 1 + 2 * 2
    assert len(calls) == STEPS * 5
    zeros = kept = 0
    for p, train, g, x, y in calls:
        assert p == 0.1 and train and g is gen
        drop = (y == 0) & (x != 0)
        zeros += int(drop.sum())
        kept += int((~drop).sum())
        np.testing.assert_allclose(y[~drop].numpy(),
                                   (x[~drop] / 0.9).numpy(), rtol=1e-6)
    n = zeros + kept
    rate = zeros / n
    assert abs(rate - 0.1) <= 5 * np.sqrt(0.1 * 0.9 / n), rate
    # the same seed and weights: the same losses; another seed: others
    step2, tr2 = _port_step(w0, dropout=0.1)
    trandom.seed(11)
    assert [float(tr2.step(*batch)) for _ in range(STEPS)] == losses
    step3, tr3 = _port_step(w0, dropout=0.1)
    trandom.seed(12)
    assert float(tr3.step(*batch)) != losses[0]


def test_attention_probability_dropout_rate_and_scale():
    """The attention's own dropout (on the probabilities, the plain path
    the JAX package also takes in training), from the generator passed
    in: with v the identity the output is the dropped P itself, 0 at the
    rate 0.1 and P / 0.9 elsewhere."""
    rs = np.random.RandomState(0)
    b, h, s, d = 4, 4, 64, 32
    q, k = (torch.from_numpy(rs.randn(b, h, s, d).astype(np.float32))
            for _ in range(2))
    v = torch.eye(d).expand(b, h, d, d)
    k = k[:, :, :d]
    gen = torch.Generator().manual_seed(3)
    out = tops.dot_product_attention(q, k, v, None, dropout=0.1, train=True,
                                     generator=gen)
    p = tops.dot_product_attention(q, k, v, None)
    drop = out == 0
    rate = float(drop.float().mean())
    assert abs(rate - 0.1) <= 5 * np.sqrt(0.1 * 0.9 / out.numel()), rate
    np.testing.assert_allclose(out[~drop].numpy(), (p[~drop] / 0.9).numpy(),
                               rtol=1e-6)
