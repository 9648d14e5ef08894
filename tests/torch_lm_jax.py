"""The JAX package's long-context LM, for the port's parity tests.

``examples/long_context_lm.py`` defines ``SPBlock`` and ``LM`` inside its
``main``; :func:`jax_lm` builds the same blocks (copied from it) at the
widths given.  Imports jax and mxnet_tpu when called, so that rank
processes may import a test file that uses it.
"""


def jax_lm(method="ring", units=64, heads=4, vocab=512, layers=2):
    import jax
    import jax.numpy as jnp

    from mxnet_tpu.gluon import nn
    from mxnet_tpu.gluon.block import HybridBlock

    U, H, V = units, heads, vocab

    class SPBlock(HybridBlock):
        def __init__(self, method):
            super().__init__()
            self._method = method
            with self.name_scope():
                self.ln1 = nn.LayerNorm(in_channels=U)
                self.qkv = nn.Dense(3 * U, flatten=False, in_units=U)
                self.proj = nn.Dense(U, flatten=False, in_units=U)
                self.ln2 = nn.LayerNorm(in_channels=U)
                self.fc1 = nn.Dense(4 * U, flatten=False, in_units=U,
                                    activation="relu")
                self.fc2 = nn.Dense(U, flatten=False, in_units=4 * U)

        def hybrid_forward(self, F, x):
            from mxnet_tpu.parallel import ring, ulysses

            h = self.ln1(x)
            qkv = self.qkv(h)
            b, l = qkv.shape[0], qkv.shape[1]
            q, k, v = jnp.split(qkv, 3, axis=-1)

            def heads_(t):
                return jnp.transpose(
                    t.reshape(b, l, H, U // H), (0, 2, 1, 3))

            att_fn = (ring.ring_attention_sharded if self._method == "ring"
                      else ulysses.ulysses_attention_sharded)
            o = att_fn(heads_(q), heads_(k), heads_(v), causal=True)
            o = jnp.transpose(o, (0, 2, 1, 3)).reshape(b, l, U)
            x = x + self.proj(o)
            return x + self.fc2(self.fc1(self.ln2(x)))

    class LM(HybridBlock):
        def __init__(self, method):
            super().__init__()
            with self.name_scope():
                self.embed = nn.Embedding(V, U)
                self.blocks = nn.HybridSequential(prefix="")
                for _ in range(layers):
                    self.blocks.add(SPBlock(method))
                self.ln = nn.LayerNorm(in_channels=U)
                self.head = nn.Dense(V, flatten=False, in_units=U)

        def hybrid_forward(self, F, tokens, labels):
            x = self.blocks(self.embed(tokens))
            logits = self.head(self.ln(x))
            lsm = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
            nll = -jnp.take_along_axis(
                lsm, labels[..., None].astype(jnp.int32), -1)[..., 0]
            return nll.mean()

    return LM(method)


class Identity:
    def __call__(self, out, *labels):
        return out
