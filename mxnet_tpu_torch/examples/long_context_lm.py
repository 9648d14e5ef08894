"""Long-context causal LM with sequence-parallel attention, on the port
(counterpart of examples/long_context_lm.py).

A small transformer LM whose attention runs RING (K/V rotation, O(L/n)
memory a rank) or ULYSSES (all-to-all head re-sharding) sequence
parallelism over the 'sp' mesh axis, trained through
``parallel.SPMDTrainer`` (Adam, lr 3e-3) on a dp x sp mesh: one process
a mesh position.  The same ``SPBlock``/``LM`` and the same synthetic
next-token task from ``RandomState(1)`` as the JAX script; the tokens are
placed with the batch spec only, so outside attention the ranks of 'sp'
hold the same activations and the ring takes each rank's block of q, k
and v.  The loss must fall.

Usage (one process a mesh position, under the port's launcher):
  python mxnet_tpu_torch/tools/launch.py -n 4 --launcher local \\
      python -m mxnet_tpu_torch.examples.long_context_lm --cpu --dp 2 --sp 2
  python mxnet_tpu_torch/tools/launch.py -n 2 --launcher local \\
      python -m mxnet_tpu_torch.examples.long_context_lm --dp 1 --sp 2 \\
      --method ulysses --seq-len 8192        # CUDA, one rank a card

With ``--cpu`` the ranks run on gloo over CPU tensors; otherwise on
cuda:(rank mod cards), over NCCL when every rank has its own card and
over gloo when ranks share one.  A single process runs dp = sp = 1.
``main(argv)`` returns the losses and each step's ms.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import parallel
from ..gluon import nn
from ..gluon.block import HybridBlock
from ..parallel import ring, ulysses

__all__ = ["SPBlock", "LM", "build_lm", "lm_data", "main"]


class SPBlock(HybridBlock):
    """Pre-LN transformer block; attention is sequence-parallel."""

    def __init__(self, method, units, heads):
        super().__init__()
        self._method, self._units, self._heads = method, units, heads
        u = units
        with self.name_scope():
            self.ln1 = nn.LayerNorm(in_channels=u)
            self.qkv = nn.Dense(3 * u, flatten=False, in_units=u)
            self.proj = nn.Dense(u, flatten=False, in_units=u)
            self.ln2 = nn.LayerNorm(in_channels=u)
            self.fc1 = nn.Dense(4 * u, flatten=False, in_units=u,
                                activation="relu")
            self.fc2 = nn.Dense(u, flatten=False, in_units=4 * u)

    def hybrid_forward(self, F, x):
        u, h = self._units, self._heads
        y = self.ln1(x)
        qkv = self.qkv(y)                           # [B, L, 3U]
        b, l = qkv.shape[0], qkv.shape[1]
        q, k, v = torch.split(qkv, u, dim=-1)

        def heads(t):                               # [B,L,U] -> [B,H,L,D]
            return t.reshape(b, l, h, u // h).permute(0, 2, 1, 3)

        att = (ring.ring_attention_sharded if self._method == "ring"
               else ulysses.ulysses_attention_sharded)
        o = att(heads(q), heads(k), heads(v), causal=True)
        o = o.permute(0, 2, 1, 3).reshape(b, l, u)
        x = x + self.proj(o)
        return x + self.fc2(self.fc1(self.ln2(x)))


class LM(HybridBlock):
    """Embedding, ``layers`` SPBlocks, LayerNorm and the vocabulary head;
    the forward returns the mean next-token loss (fp32 log-softmax)."""

    def __init__(self, method, units=64, heads=4, vocab=512, layers=2):
        super().__init__()
        with self.name_scope():
            self.embed = nn.Embedding(vocab, units)
            self.blocks = nn.HybridSequential(prefix="")
            for _ in range(layers):
                self.blocks.add(SPBlock(method, units, heads))
            self.ln = nn.LayerNorm(in_channels=units)
            self.head = nn.Dense(vocab, flatten=False, in_units=units)

    def hybrid_forward(self, F, tokens, labels):
        x = self.blocks(self.embed(tokens))
        logits = self.head(self.ln(x))
        lsm = torch.log_softmax(logits.float(), -1)
        nll = -lsm.gather(-1, labels.long()[..., None])[..., 0]
        return nll.mean()


class _Id:
    def __call__(self, out, *labels):
        return out


def build_lm(method="ring", units=64, heads=4, vocab=512, layers=2,
             ctx=None, seed=0):
    """The LM with Xavier weights from ``seed`` on ``ctx``."""
    from ..initializer import Xavier

    net = LM(method, units, heads, vocab, layers)
    net.initialize(Xavier(), ctx=ctx, seed=seed)
    return net


def lm_data(batch_size=4, seq_len=256, vocab=512):
    """(tokens, labels), [B, L] int32: the JAX script's synthetic
    next-token task with local structure, from ``RandomState(1)``."""
    rng = np.random.RandomState(1)
    toks = rng.randint(4, vocab, (batch_size, seq_len + 2)).astype(np.int32)
    toks[:, 1::2] = (toks[:, 0::2][:, :toks[:, 1::2].shape[1]] + 1) % vocab
    toks = toks[:, :seq_len + 1]
    return toks[:, :-1], toks[:, 1:]


def trainer_for(net, mesh):
    """The JAX script's trainer: Adam at lr 3e-3, the loss the net's."""
    return parallel.SPMDTrainer(net, _Id(), "adam", {"learning_rate": 3e-3},
                                mesh=mesh, n_labels=0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--method", default="ring", choices=["ring", "ulysses"])
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--sp", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--units", type=int, default=64)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)

    from .. import cpu
    from ..parallel import dist

    world = int(__import__("os").environ.get("DMLC_NUM_WORKER", "1"))
    share = not args.cpu and torch.cuda.device_count() < world
    dist.init(backend="gloo" if args.cpu or share else "nccl")
    world = dist.num_workers()
    # clamp the mesh to the ranks that exist, as the JAX script clamps it
    # to the devices
    while args.dp * args.sp > world and args.sp > 1:
        args.sp //= 2
    while args.dp * args.sp > world and args.dp > 1:
        args.dp //= 2
    if args.dp * args.sp != world:
        raise SystemExit(f"dp={args.dp} x sp={args.sp} does not fill the "
                         f"{world} ranks")
    devices = [cpu()] * world if args.cpu else None
    mesh = parallel.make_mesh(dp=args.dp, sp=args.sp, devices=devices)
    if not args.cpu:
        torch.cuda.set_device(mesh.local_device)
    torch.manual_seed(0)
    net = build_lm(args.method, args.units, args.heads, args.vocab,
                   args.layers, ctx=mesh.local_device)
    tokens, labels = lm_data(args.batch_size, args.seq_len, args.vocab)
    losses, ms = [], []
    with mesh:
        trainer = trainer_for(net, mesh)
        for step in range(args.steps):
            tic = time.perf_counter()
            lval = float(trainer.step(tokens, labels))
            ms.append((time.perf_counter() - tic) * 1e3)
            losses.append(lval)
            if dist.rank() == 0:
                print(f"step {step}: loss={lval:.4f} ({ms[-1]:.1f} ms, "
                      f"{args.method}, dp={args.dp} sp={args.sp}, "
                      f"L={args.seq_len})", flush=True)
    if dist.rank() == 0:
        print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
    assert losses[-1] < losses[0], "no learning progress"
    return dict(losses=losses, ms=ms, dp=args.dp, sp=args.sp)


if __name__ == "__main__":
    main()
