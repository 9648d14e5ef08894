"""The port's BERT pretraining and Transformer NMT example scripts
(``mxnet_tpu_torch/examples/bert_pretrain.py``, ``transformer_nmt.py``)
against the JAX package's ``examples/bert_pretrain.py`` and
``examples/transformer_nmt.py`` on the CPU.

``_CorpusSampler``'s batches equal the JAX sampler's bit for bit on the
same corpus and seed (the JAX class is loaded from its file).  The
scripts' ``--small`` nets start from the JAX nets' weights, carried
across by structural name, at dropout 0, and two steps of the port's
``train_step`` give the losses of the JAX script's loop (its body is
copied here: the script defines it inside ``main``) within 1e-5
relative, on the port's synthetic batch, whose draws equal the JAX
script's.  Then both scripts run in-process with ``--cpu --small``
(BERT 2 steps, also from a corpus; NMT 1 epoch, also from a parallel
corpus) with finite losses.
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.examples import bert_pretrain as tbert
from mxnet_tpu_torch.examples import transformer_nmt as tnmt
from mxnet_tpu_torch.gluon import load_numpy_params

REPO = pathlib.Path(__file__).resolve().parent.parent
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    rng = np.random.RandomState(0)
    words = [f"w{i}" for i in range(150)]
    path = tmp_path_factory.mktemp("corpus") / "corpus.txt"
    with open(path, "w") as f:
        for _ in range(40):
            sents = [" ".join(rng.choice(words, rng.randint(4, 9)))
                     for _ in range(rng.randint(2, 4))]
            f.write(". ".join(sents) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def parallel_corpus(tmp_path_factory):
    rng = np.random.RandomState(1)
    d = tmp_path_factory.mktemp("nmt")
    src, tgt = d / "train.src", d / "train.tgt"
    with open(src, "w") as fs, open(tgt, "w") as ft:
        for _ in range(80):
            n = rng.randint(3, 12)
            toks = [f"s{rng.randint(60)}" for _ in range(n)]
            fs.write(" ".join(toks) + "\n")
            ft.write(" ".join(t.replace("s", "t")
                              for t in reversed(toks)) + "\n")
    return str(src), str(tgt)


def test_corpus_sampler_batches_are_bit_for_bit(corpus):
    jsampler = _jax_example("bert_pretrain")._CorpusSampler(
        [corpus], 1000, 32, np.random.RandomState(0))
    tsampler = tbert._CorpusSampler([corpus], 1000, 32,
                                    np.random.RandomState(0))
    assert tsampler.vocab_size == jsampler.vocab_size
    assert tsampler.w2i == jsampler.w2i
    for _ in range(2):
        jb = jsampler.batch(4, mx.cpu())
        tb = tsampler.batch(4, mt.cpu())
        for j, t in zip(jb, tb):
            assert np.array_equal(t.asnumpy(), j.asnumpy())


def _carry(jnet, tnet):
    """The JAX net's weights into the port's, by structural name."""
    w = {k: p.data().asnumpy()
         for k, p in jnet._collect_params_with_prefix().items()}
    load_numpy_params(tnet, w)


def _jax_bert_step(net, trainer, loss_fn, batch, ctx):
    """The JAX script's loop body (examples/bert_pretrain.py, main)."""
    from mxnet_tpu import autograd, nd

    tokens, segments, vlen, mlm_labels, mlm_weight, nsp_labels = batch
    b, s = tokens.shape
    with autograd.record():
        seq, pooled = net(tokens, segments, vlen)
        mlm_scores = net.decode_mlm(seq)
        nsp_scores = net.classify_nsp(pooled)
        per_sample = loss_fn(mlm_scores, mlm_labels,
                             mlm_weight.expand_dims(-1))
        denom = nd.maximum(mlm_weight.sum(), nd.ones((1,), ctx=ctx))
        mlm_l = per_sample.sum() * float(s) / denom
        loss = mlm_l + loss_fn(nsp_scores, nsp_labels).mean()
    loss.backward()
    trainer.step(b)
    return loss.asnumpy().item()


def test_bert_steps_match_the_jax_script():
    from mxnet_tpu.gluon import Trainer as JTrainer
    from mxnet_tpu.gluon.loss import SoftmaxCrossEntropyLoss as JLoss
    from mxnet_tpu.gluon.model_zoo.bert import get_bert_model

    args = tbert.parse_args(["--cpu", "--small"])
    ctx = mt.cpu()
    batch = tbert.synthetic_batch(args, np.random.RandomState(0), ctx)
    # the JAX script's draws, in its order
    rng = np.random.RandomState(0)
    b, s = args.batch_size, args.seq_len
    want = [rng.randint(0, args.vocab, (b, s)), np.zeros((b, s)),
            np.full(b, s), rng.randint(0, args.vocab, (b, s)),
            np.ones((b, s)), rng.randint(0, 2, (b,))]
    for t, w in zip(batch, want):
        assert np.array_equal(t.asnumpy(), w.astype(np.float32))

    mx.random.seed(0)
    jnet = get_bert_model("bert_12_768_12", vocab_size=args.vocab,
                          dropout=0.0, num_layers=2, units=64,
                          hidden_size=128, num_heads=4,
                          max_length=args.seq_len)
    jnet.initialize(mx.initializer.Normal(0.02), ctx=mx.cpu())
    jbatch = [mx.nd.array(t.asnumpy(), ctx=mx.cpu()) for t in batch]
    with mx.autograd.pause():
        seq, pooled = jnet(*jbatch[:3])
        jnet.decode_mlm(seq)
        jnet.classify_nsp(pooled)
    tnet = tbert.build_net(args, ctx, dropout=0.0)
    _carry(jnet, tnet)
    jtr = JTrainer(jnet.collect_params(), "adam", {"learning_rate": 1e-4})
    ttr = mt.gluon.Trainer(tnet.collect_params(), "adam",
                           {"learning_rate": 1e-4})
    jloss, tloss = JLoss(), mt.gluon.loss.SoftmaxCrossEntropyLoss()
    for _ in range(2):
        want = _jax_bert_step(jnet, jtr, jloss, jbatch, mx.cpu())
        got = tbert.train_step(tnet, ttr, tloss, batch,
                               ctx).asnumpy().item()
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def _jax_nmt_step(net, trainer, loss_fn, batch, batch_size):
    """The JAX script's loop body (examples/transformer_nmt.py, main)."""
    from mxnet_tpu import autograd, nd

    src, tgt_in, tgt_out, slen, tlen, mask = batch
    with autograd.record():
        logits = net(src, tgt_in, slen, tlen)
        per = loss_fn(logits, tgt_out, mask)
        loss = per.sum() / nd.maximum(mask.sum(), 1.0)
    loss.backward()
    trainer.step(batch_size)
    return loss.asnumpy().item()


def test_nmt_steps_match_the_jax_script():
    from mxnet_tpu.gluon import Trainer as JTrainer
    from mxnet_tpu.gluon.model_zoo.transformer import (
        LabelSmoothedCELoss, get_transformer_model)

    args = tnmt.parse_args(["--cpu", "--small"])
    ctx = mt.cpu()
    batch = tnmt.synthetic_batch(args, np.random.RandomState(0), 12, ctx)
    # the JAX script's make_batch draws
    rng = np.random.RandomState(0)
    src = rng.randint(3, args.vocab, (args.batch_size, 12)).astype("f4")
    assert np.array_equal(batch[0].asnumpy(), src)
    assert np.array_equal(batch[2].asnumpy(), src[:, ::-1])
    assert batch[-1] == args.batch_size * 12

    mx.random.seed(0)
    jnet = get_transformer_model("transformer_base",
                                 src_vocab_size=args.vocab, units=32,
                                 hidden_size=64, num_layers=2, num_heads=4,
                                 max_length=32, dropout=0.0)
    jnet.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    jbatch = [mx.nd.array(t.asnumpy(), ctx=mx.cpu()) for t in batch[:-1]]
    with mx.autograd.pause():
        jnet(*jbatch[:2], *jbatch[3:5])
    tnet, buckets = tnmt.build_net(args, ctx)
    assert buckets == [8, 12, 16]
    _carry(jnet, tnet)
    jtr = JTrainer(jnet.collect_params(), "adam", {"learning_rate": 1e-3})
    ttr = mt.gluon.Trainer(tnet.collect_params(), "adam",
                           {"learning_rate": 1e-3})
    jloss = LabelSmoothedCELoss(smoothing=0.1)
    tloss = mt.gluon.model_zoo.transformer.LabelSmoothedCELoss(
        smoothing=0.1)
    for _ in range(2):
        want = _jax_nmt_step(jnet, jtr, jloss, jbatch, args.batch_size)
        got = tnmt.train_step(tnet, ttr, tloss, batch,
                              args.batch_size).asnumpy().item()
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_scripts_run_in_process(corpus, parallel_corpus):
    for argv in (["--cpu", "--small", "--steps", "2"],
                 ["--cpu", "--small", "--steps", "2", "--corpus", corpus]):
        res = tbert.main(argv)
        assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
        assert res["tokens_per_s"] > 0
    src, tgt = parallel_corpus
    for argv in (["--cpu", "--small", "--epochs", "1"],
                 ["--cpu", "--small", "--epochs", "1", "--src", src,
                  "--tgt", tgt]):
        res = tnmt.main(argv)
        assert res["losses"] and np.isfinite(res["losses"]).all()
        assert len(res["tokens_per_s"]) == 1
    with pytest.raises(SystemExit):
        tnmt.parse_args(["--src", src])
