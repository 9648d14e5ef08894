"""BERT pretraining example on the port (counterpart of
examples/bert_pretrain.py; BASELINE config 3: BERT-base).

Synthetic-corpus MLM + NSP pretraining loop over the BERT stack through
``gluon.Trainer`` (Adam): the attention kernel of ``csrc/attention.cu``
on the card, tied MLM decoder, NSP classifier.  The reference-era
equivalent is GluonNLP's scripts/bert/run_pretraining.py.

Usage:
  python -m mxnet_tpu_torch.examples.bert_pretrain              # gpu(0)
  python -m mxnet_tpu_torch.examples.bert_pretrain --cpu --small
  python -m mxnet_tpu_torch.examples.bert_pretrain --corpus wiki.txt \\
      --steps 10000
      # REAL-DATA path: any plain-text file(s), one document per line;
      # a whitespace vocab is built, sentence pairs sampled for NSP and
      # 15% of tokens masked for MLM (BERT paper recipe)

It runs on gpu(0) and raises without a CUDA device unless --cpu is
given.  ``main(argv)`` returns the losses, each step's ms and the last
step's tokens/s.
"""
from __future__ import annotations

import argparse
import time


class _CorpusSampler:
    """Real-data MLM+NSP batches from plain text (the BERT paper recipe
    over a whitespace vocabulary — the wordpiece step of GluonNLP's
    run_pretraining.py data pipeline is out of scope, everything else is
    the same: sentence-pair NSP sampling, 15% masking with 80/10/10)."""

    PAD, UNK, CLS, SEP, MASK = 0, 1, 2, 3, 4

    def __init__(self, paths, max_vocab, seq_len, rng):
        from collections import Counter

        self.seq_len = seq_len
        self.rng = rng
        docs = []
        counts = Counter()
        for p in paths:
            with open(p) as f:
                for line in f:
                    sents = [s.split() for s in line.strip().split(". ")
                             if s.split()]
                    if len(sents) >= 2:
                        docs.append(sents)
                        for s in sents:
                            counts.update(s)
        if not docs:
            raise SystemExit("corpus: need lines with >=2 sentences")
        vocab = [w for w, _ in counts.most_common(max_vocab - 5)]
        self.w2i = {w: i + 5 for i, w in enumerate(vocab)}
        self.vocab_size = len(self.w2i) + 5
        self.docs = docs

    def _ids(self, sent):
        return [self.w2i.get(w, self.UNK) for w in sent]

    def _pair(self):
        rng = self.rng
        d = self.docs[rng.randint(len(self.docs))]
        i = rng.randint(len(d) - 1)
        a = self._ids(d[i])
        if rng.rand() < 0.5 or len(self.docs) < 2:
            b, is_next = self._ids(d[i + 1]), 1
        else:
            # negative: a sentence from a DIFFERENT document (the BERT
            # recipe — sampling the same doc could yield a true
            # next-sentence pair mislabeled 0)
            while True:
                j = rng.randint(len(self.docs))
                if self.docs[j] is not d:
                    break
            rd = self.docs[j]
            b, is_next = self._ids(rd[rng.randint(len(rd))]), 0
        budget = self.seq_len - 3
        a = a[: budget // 2]
        b = b[: budget - len(a)]
        toks = [self.CLS] + a + [self.SEP] + b + [self.SEP]
        segs = [0] * (len(a) + 2) + [1] * (len(b) + 1)
        return toks, segs, is_next

    def batch(self, b, ctx):
        import numpy as np

        from mxnet_tpu_torch import nd

        s = self.seq_len
        toks = np.zeros((b, s), np.int64)
        segs = np.zeros((b, s), np.int64)
        vlen = np.zeros((b,), np.float32)
        labels = np.zeros((b, s), np.int64)
        weight = np.zeros((b, s), np.float32)
        nsp = np.zeros((b,), np.float32)
        for k in range(b):
            t, g, is_next = self._pair()
            n = len(t)
            vlen[k] = n
            nsp[k] = is_next
            t = np.asarray(t + [self.PAD] * (s - n))
            segs[k, :n] = g
            labels[k] = t
            # mask 15% of real (non-special) positions: 80% [MASK],
            # 10% random, 10% kept
            cand = [i for i in range(n)
                    if t[i] not in (self.CLS, self.SEP, self.PAD)]
            self.rng.shuffle(cand)
            n_mask = max(1, int(0.15 * len(cand)))
            for i in cand[:n_mask]:
                weight[k, i] = 1.0
                r = self.rng.rand()
                if r < 0.8:
                    t[i] = self.MASK
                elif r < 0.9:
                    t[i] = self.rng.randint(5, self.vocab_size)
            toks[k] = t
        f = np.float32
        return (nd.array(toks.astype(f), ctx=ctx),
                nd.array(segs.astype(f), ctx=ctx),
                nd.array(vlen, ctx=ctx),
                nd.array(labels.astype(f), ctx=ctx),
                nd.array(weight, ctx=ctx),
                nd.array(nsp, ctx=ctx))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=30522)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--corpus", default=None,
                    help="comma-separated text files (one document per "
                         "line) for real-data MLM+NSP pretraining")
    args = ap.parse_args(argv)
    if args.small:
        args.vocab, args.seq_len, args.batch_size = 1000, 32, 4
    return args


def build_net(args, ctx, dropout=0.1):
    """The script's BERT (2 layers of 64 units with --small, BERT-base
    otherwise) initialised with Normal(0.02) on ctx, cast to --dtype."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.bert import get_bert_model

    if args.small:
        net = get_bert_model("bert_12_768_12", vocab_size=args.vocab,
                             dropout=dropout, num_layers=2, units=64,
                             hidden_size=128, num_heads=4,
                             max_length=args.seq_len)
    else:
        net = get_bert_model("bert_12_768_12", vocab_size=args.vocab,
                             dropout=dropout,
                             max_length=max(512, args.seq_len))
    net.initialize(mx.initializer.Normal(0.02), ctx=ctx)
    if args.dtype != "float32":
        net.cast(args.dtype)
    return net


def synthetic_batch(args, rng, ctx):
    """One fixed batch of random tokens and labels, all positions
    predicted, drawn from rng in the JAX script's order."""
    import numpy as np

    from mxnet_tpu_torch import nd

    b, s = args.batch_size, args.seq_len
    tokens = nd.array(
        rng.randint(0, args.vocab, (b, s)).astype("float32"), ctx=ctx)
    segments = nd.zeros((b, s), ctx=ctx)
    vlen = nd.array(np.full(b, s, "float32"), ctx=ctx)
    mlm_labels = nd.array(
        rng.randint(0, args.vocab, (b, s)).astype("float32"), ctx=ctx)
    mlm_weight = nd.array(np.ones((b, s), "float32"), ctx=ctx)
    nsp_labels = nd.array(rng.randint(0, 2, (b,)).astype("float32"),
                          ctx=ctx)
    return tokens, segments, vlen, mlm_labels, mlm_weight, nsp_labels


def train_step(net, trainer, loss_fn, batch, ctx):
    """One MLM + NSP step and its Adam update; returns the loss (an
    NDArray)."""
    from mxnet_tpu_torch import autograd, nd

    tokens, segments, vlen, mlm_labels, mlm_weight, nsp_labels = batch
    b, s = tokens.shape
    with autograd.record():
        seq, pooled = net(tokens, segments, vlen)
        mlm_scores = net.decode_mlm(seq)
        nsp_scores = net.classify_nsp(pooled)
        # masked mean over the predicted positions: gluon losses apply
        # sample_weight per token, then mean over the seq axis
        per_sample = loss_fn(mlm_scores, mlm_labels,
                             mlm_weight.expand_dims(-1))
        denom = nd.maximum(mlm_weight.sum(), nd.ones((1,), ctx=ctx))
        mlm_l = per_sample.sum() * float(s) / denom
        loss = mlm_l + loss_fn(nsp_scores, nsp_labels).mean()
    loss.backward()
    trainer.step(b)
    return loss


def main(argv=None):
    """Pretrain for --steps; returns a dict of the losses, each step's ms,
    the last step's tokens/s, the net and the trainer."""
    args = parse_args(argv)
    import numpy as np

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    ctx = mx.cpu() if args.cpu else mx.gpu(0)
    rng = np.random.RandomState(0)
    b, s = args.batch_size, args.seq_len

    # the sampler is built FIRST so the model's embedding + MLM decoder
    # are sized to the corpus's actual vocabulary
    sampler = None
    if args.corpus:
        sampler = _CorpusSampler(args.corpus.split(","), args.vocab, s,
                                 rng)
        args.vocab = sampler.vocab_size

    net = build_net(args, ctx)
    loss_fn = SoftmaxCrossEntropyLoss()
    trainer = Trainer(net.collect_params(), "adam",
                      {"learning_rate": 1e-4})

    if sampler is not None:
        def next_batch():
            return sampler.batch(b, ctx)
    else:
        fixed = synthetic_batch(args, rng, ctx)

        def next_batch():
            return fixed

    losses, step_ms = [], []
    for step in range(args.steps):
        tic = time.perf_counter()
        loss = train_step(net, trainer, loss_fn, next_batch(), ctx)
        lval = loss.asnumpy().item()  # sync point ends the step timing
        step_ms.append((time.perf_counter() - tic) * 1e3)
        losses.append(lval)
        print(f"step {step}: loss={lval:.4f} ({step_ms[-1] / 1e3:.2f}s)")
    tokens_per_s = b * s / step_ms[-1] * 1e3 if step_ms else None
    if step_ms:
        print(f"last-step throughput: {tokens_per_s:.0f} tokens/s")
    return dict(losses=losses, step_ms=step_ms, tokens_per_s=tokens_per_s,
                net=net, trainer=trainer)


if __name__ == "__main__":
    main()
