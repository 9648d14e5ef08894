"""Transformer NMT training example on the port (counterpart of
examples/transformer_nmt.py; BASELINE config 5).

Synthetic sequence-to-sequence task (reverse-copy) with BUCKETED batches
through ``gluon.Trainer`` (Adam): each (src_len, tgt_len) bucket is one
batch shape, reused across epochs.  The attention kernel of
``csrc/attention.cu`` runs on the card.  The reference-era equivalent is
Sockeye's train.py / example/rnn/bucketing.

Usage:
  python -m mxnet_tpu_torch.examples.transformer_nmt            # gpu(0)
  python -m mxnet_tpu_torch.examples.transformer_nmt --cpu --small
  python -m mxnet_tpu_torch.examples.transformer_nmt --src train.de \\
      --tgt train.en
      # REAL-DATA path: parallel corpus, one sentence per line; vocabs
      # built from the data, batches bucketed by source length

It runs on gpu(0) and raises without a CUDA device unless --cpu is
given.  ``main(argv)`` returns each step's loss and ms and each epoch's
tokens/s.
"""
from __future__ import annotations

import argparse
import time

PAD, BOS, UNK = 0, 1, 2


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--src", default=None,
                    help="source-language text file (one sentence/line)")
    ap.add_argument("--tgt", default=None,
                    help="target-language text file, parallel to --src")
    args = ap.parse_args(argv)
    if bool(args.src) != bool(args.tgt):
        ap.error("--src and --tgt must be given together")
    if args.small:
        args.vocab, args.batch_size = 100, 8
    return args


def build_net(args, ctx):
    """The script's Transformer (2 layers of 32 units with --small,
    Transformer-base otherwise) initialised with Xavier on ctx, and its
    buckets."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.transformer import \
        get_transformer_model

    if args.small:
        net = get_transformer_model("transformer_base",
                                    src_vocab_size=args.vocab, units=32,
                                    hidden_size=64, num_layers=2,
                                    num_heads=4, max_length=32, dropout=0.0)
        buckets = [8, 12, 16]
    else:
        net = get_transformer_model("transformer_base",
                                    src_vocab_size=args.vocab,
                                    max_length=256)
        buckets = [16, 32, 64, 128]
    net.initialize(mx.initializer.Xavier(), ctx=ctx)
    return net, buckets


def synthetic_batch(args, rng, seq_len, ctx):
    """One reverse-copy batch of seq_len tokens, drawn from rng as the JAX
    script draws it: (src, tgt_in, tgt_out, src_len, tgt_len, mask,
    tokens)."""
    import numpy as np

    from mxnet_tpu_torch import nd

    b = args.batch_size
    src = rng.randint(3, args.vocab, (b, seq_len)).astype("float32")
    tgt_out = src[:, ::-1].copy()
    tgt_in = np.concatenate([np.full((b, 1), BOS), tgt_out[:, :-1]],
                            axis=1).astype("float32")
    vlen = np.full(b, seq_len, "float32")
    mask = nd.array(np.ones((b, seq_len), "float32"), ctx=ctx)
    return (nd.array(src, ctx=ctx), nd.array(tgt_in, ctx=ctx),
            nd.array(tgt_out, ctx=ctx), nd.array(vlen, ctx=ctx),
            nd.array(vlen, ctx=ctx), mask, b * seq_len)


def corpus_batches(args, rng, buckets, ctx):
    """A generator function over the parallel corpus --src/--tgt: length-
    bucketed batches, each bucket shuffled by rng every pass."""
    import numpy as np

    from mxnet_tpu_torch import nd

    def read_vocab(path):
        from collections import Counter

        counts = Counter()
        lines = []
        with open(path) as f:
            for line in f:
                toks = line.split()
                lines.append(toks)
                counts.update(toks)
        vocab = {w: i + 3 for i, (w, _) in enumerate(
            counts.most_common(args.vocab - 3))}
        return lines, vocab

    src_lines, src_vocab = read_vocab(args.src)
    tgt_lines, tgt_vocab = read_vocab(args.tgt)
    if len(src_lines) != len(tgt_lines):
        raise SystemExit("--src/--tgt line counts differ")
    by_bucket = {bk: [] for bk in buckets}
    for s_toks, t_toks in zip(src_lines, tgt_lines):
        s = [src_vocab.get(w, UNK) for w in s_toks]
        t = [tgt_vocab.get(w, UNK) for w in t_toks]
        if s and t and len(s) <= buckets[-1] and len(t) <= buckets[-1]:
            bk = next(bk for bk in buckets if len(s) <= bk and len(t) <= bk)
            by_bucket[bk].append((s, t))

    def batches():
        for bk, items in by_bucket.items():
            rng.shuffle(items)
            for i in range(0, len(items) - args.batch_size + 1,
                           args.batch_size):
                chunk = items[i:i + args.batch_size]
                b = len(chunk)
                src = np.full((b, bk), PAD, "float32")
                tgt_out = np.full((b, bk), PAD, "float32")
                tgt_in = np.full((b, bk), PAD, "float32")
                slen = np.zeros(b, "float32")
                tlen = np.zeros(b, "float32")
                for j, (s, t) in enumerate(chunk):
                    src[j, :len(s)] = s
                    tgt_out[j, :len(t)] = t
                    tgt_in[j, 0] = BOS
                    tgt_in[j, 1:len(t)] = t[:-1]
                    slen[j], tlen[j] = len(s), len(t)
                # loss mask: only real target positions count (PAD would
                # otherwise dominate long buckets)
                mask = (np.arange(bk)[None, :]
                        < tlen[:, None]).astype("float32")
                yield (nd.array(src, ctx=ctx), nd.array(tgt_in, ctx=ctx),
                       nd.array(tgt_out, ctx=ctx), nd.array(slen, ctx=ctx),
                       nd.array(tlen, ctx=ctx), nd.array(mask, ctx=ctx),
                       int(tlen.sum()))
    return batches


def train_step(net, trainer, loss_fn, batch, batch_size):
    """One step on a batch of synthetic_batch's form and its Adam update;
    returns the loss (an NDArray)."""
    from mxnet_tpu_torch import autograd, nd

    src, tgt_in, tgt_out, slen, tlen, mask, _ = batch
    with autograd.record():
        logits = net(src, tgt_in, slen, tlen)
        per = loss_fn(logits, tgt_out, mask)  # per-token (b, s)
        loss = per.sum() / nd.maximum(mask.sum(), 1.0)
    loss.backward()
    trainer.step(batch_size)
    return loss


def main(argv=None):
    """Train for --epochs; returns a dict of each step's loss and ms, each
    epoch's tokens/s, the net and the trainer."""
    args = parse_args(argv)
    import numpy as np

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.model_zoo.transformer import \
        LabelSmoothedCELoss

    ctx = mx.cpu() if args.cpu else mx.gpu(0)
    net, buckets = build_net(args, ctx)
    loss_fn = LabelSmoothedCELoss(smoothing=0.1)
    trainer = Trainer(net.collect_params(), "adam", {"learning_rate": 1e-3})
    rng = np.random.RandomState(0)

    if args.src:
        batches = corpus_batches(args, rng, buckets, ctx)
    else:
        def batches():
            for it in range(6):
                yield synthetic_batch(args, rng, buckets[it % len(buckets)],
                                      ctx)

    losses, step_ms, tok_s = [], [], []
    for epoch in range(args.epochs):
        total, tokens, steps, tic = 0.0, 0, 0, time.perf_counter()
        for batch in batches():
            t0 = time.perf_counter()
            lval = train_step(net, trainer, loss_fn, batch,
                              args.batch_size).asnumpy().item()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(lval)
            total += lval
            tokens += batch[-1]
            steps += 1
        tok_s.append(tokens / (time.perf_counter() - tic))
        print(f"epoch {epoch}: avg-loss={total / max(steps, 1):.4f} "
              f"{tok_s[-1]:.0f} tok/s (buckets {buckets})")
    return dict(losses=losses, step_ms=step_ms, tokens_per_s=tok_s,
                net=net, trainer=trainer)


if __name__ == "__main__":
    main()
