"""A bucketed LSTM language model through the symbolic Module path
(counterpart of examples/rnn_bucketing.py, line for line in the port's
names; ref: example/rnn/bucketing/lstm_bucketing.py).

A char-level LM: sentences are bucketed by length and every bucket is a
symbol of its own, bound as one executor per bucket over shared
parameters (``mod.BucketingModule``), trained with ``Module.fit`` and
Adam over the fused ``RNN`` op, or with ``--cells`` over the legacy
``rnn.LSTMCell`` stack unrolled per bucket.  On the card each bucket's
step is captured once and replayed.

Usage:
  python -m mxnet_tpu_torch.examples.rnn_bucketing            # gpu(0)
  python -m mxnet_tpu_torch.examples.rnn_bucketing --cpu --small
  python -m mxnet_tpu_torch.examples.rnn_bucketing --text corpus.txt
      # any plain-text file, one sentence per line

It trains on gpu(0) and raises without a CUDA device unless --cpu is
given.  The synthetic corpus, the initial weights and the bucket
shuffles are drawn from --seed.
"""
from __future__ import annotations

import argparse
import logging

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.io import DataBatch, DataDesc


class BucketSentenceIter:
    """Sentences of encoded ids in the smallest bucket that holds them,
    batches padded to the bucket's length; the label is the data moved
    one step left (ref: BucketSentenceIter in example/rnn/bucketing).
    Batches are CPU NDArrays."""

    def __init__(self, sentences, batch_size, buckets, vocab_size,
                 invalid_label=0):
        self.batch_size = batch_size
        self.buckets = sorted(buckets)
        self.vocab_size = vocab_size
        self.data = {b: [] for b in self.buckets}
        for s in sentences:
            if len(s) < 2:
                continue
            bk = next((b for b in self.buckets if len(s) <= b + 1), None)
            if bk is None:
                continue
            row = np.full(bk + 1, invalid_label, np.float32)
            row[:len(s)] = s
            self.data[bk].append(row)
        self.default_bucket_key = self.buckets[-1]
        self.provide_data = [DataDesc(
            "data", (batch_size, self.default_bucket_key))]
        self.provide_label = [DataDesc(
            "softmax_label", (batch_size, self.default_bucket_key))]
        self.reset()

    def reset(self):
        self._plan = []
        for bk, rows in self.data.items():
            np.random.shuffle(rows)
            for i in range(0, len(rows) - self.batch_size + 1,
                           self.batch_size):
                self._plan.append((bk, i))
        np.random.shuffle(self._plan)
        self._cursor = 0

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def next(self):
        if self._cursor >= len(self._plan):
            raise StopIteration
        bk, i = self._plan[self._cursor]
        self._cursor += 1
        rows = np.stack(self.data[bk][i:i + self.batch_size])
        data, label = rows[:, :-1], rows[:, 1:]
        return DataBatch(
            data=[mx.nd.array(data, ctx=mx.cpu())],
            label=[mx.nd.array(label, ctx=mx.cpu())], bucket_key=bk,
            provide_data=[DataDesc("data", data.shape)],
            provide_label=[DataDesc("softmax_label", label.shape)])


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--text", default=None,
                    help="plain-text file, one sentence per line")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--num-hidden", type=int, default=200)
    ap.add_argument("--num-layers", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--cells", action="store_true",
                    help="build the graph with the legacy mx.rnn cell API "
                         "(an unrolled LSTMCell stack, the reference "
                         "lstm_bucketing.py design) instead of the fused "
                         "RNN op")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def corpus(args, buckets):
    """The lines of --text, else the synthetic corpus: runs of a
    ten-letter alphabet from a random start, 4 to the largest bucket's
    length."""
    if args.text:
        with open(args.text) as f:
            return [line.strip() for line in f if line.strip()]
    rng = np.random.RandomState(0)
    alpha = "abcdefghij"
    lines = []
    for _ in range(300 if args.small else 2000):
        start = rng.randint(len(alpha))
        n = rng.randint(4, (buckets[-1] - 1))
        lines.append("".join(alpha[(start + k) % len(alpha)]
                             for k in range(n)))
    return lines


def make_sym_gen(args, vocab_size):
    """One graph per bucket length: Embedding, the LSTM (the fused op, or
    with ``--cells`` the legacy cells unrolled), the output layer and
    SoftmaxOutput over every position."""
    def sym_gen(seq_len):
        data = mx.sym.var("data")
        label = mx.sym.var("softmax_label")
        embed = mx.sym.Embedding(data, input_dim=vocab_size,
                                 output_dim=args.num_hidden, name="embed")
        if args.cells:
            stack = mx.rnn.SequentialRNNCell()
            for i in range(args.num_layers):
                stack.add(mx.rnn.LSTMCell(args.num_hidden,
                                          prefix=f"lstm_l{i}_"))
            out, _states = stack.unroll(seq_len, embed, layout="NTC")
        else:
            rnn_in = mx.sym.transpose(embed, axes=(1, 0, 2))  # (T, N, H)
            out = mx.sym.RNN(rnn_in, state_size=args.num_hidden,
                             num_layers=args.num_layers, mode="lstm",
                             state_outputs=False, name="lstm")
            out = mx.sym.transpose(out, axes=(1, 0, 2))       # (N, T, H)
        out = mx.sym.reshape(out, shape=(-1, args.num_hidden))
        pred = mx.sym.FullyConnected(out, num_hidden=vocab_size,
                                     name="pred")
        label_f = mx.sym.reshape(label, shape=(-1,))
        sm = mx.sym.SoftmaxOutput(pred, label_f, name="softmax")
        return sm, ("data",), ("softmax_label",)
    return sym_gen


def main(argv=None):
    """Train and score; returns the model, the iterator and the final
    perplexity."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    np.random.seed(args.seed)
    mx.random.seed(args.seed)
    if args.small:
        args.batch_size, args.num_hidden, args.num_layers = 8, 32, 1
        buckets = [8, 16]
    else:
        buckets = [10, 20, 30, 40, 60]

    lines = corpus(args, buckets)
    chars = sorted(set("".join(lines)))
    vocab = {c: i + 1 for i, c in enumerate(chars)}  # 0 = pad
    vocab_size = len(vocab) + 1
    sentences = [[vocab[c] for c in line] for line in lines]
    train_iter = BucketSentenceIter(sentences, args.batch_size, buckets,
                                    vocab_size)

    ctx = mx.cpu() if args.cpu else mx.gpu(0)
    model = mx.mod.BucketingModule(
        sym_gen=make_sym_gen(args, vocab_size),
        default_bucket_key=train_iter.default_bucket_key, context=ctx)
    metric = mx.metric.Perplexity(ignore_label=0)
    model.fit(train_iter, eval_metric=metric, optimizer="adam",
              optimizer_params={"learning_rate": args.lr},
              initializer=mx.initializer.Xavier(), num_epoch=args.epochs,
              batch_end_callback=mx.callback.Speedometer(args.batch_size,
                                                         10))
    train_iter.reset()
    final = model.score(train_iter, mx.metric.Perplexity(ignore_label=0))
    print(f"final {final[0][0]}={final[0][1]:.3f}", flush=True)
    return dict(model=model, iter=train_iter, perplexity=final[0][1],
                args=args)


if __name__ == "__main__":
    main()
