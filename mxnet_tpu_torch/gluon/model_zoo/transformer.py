"""Transformer NMT encoder-decoder of the port (counterpart of
``mxnet_tpu/gluon/model_zoo/transformer.py``, BASELINE config 5).

The same blocks, structural parameter names and forward: sinusoidal
position table (a constant, saved and loaded as ``pos_table``), post-LN
encoder and decoder cells over BERT's ``MultiHeadAttention`` and
``BERTPositionwiseFFN`` (ReLU), a causal self-attention and a
cross-attention in each decoder cell, and the output projection tied to
the target embedding.  With ``share_embed`` the source embedding, the
target embedding and the projection are one ``nn.Parameter`` under three
names (``src_embed.weight``, ``tgt_embed.weight``, ``tied_weight``),
trained once.  Attention runs ``dot_product_attention``: the CUDA kernel
on the card, causal in the decoder's self-attention.

``encode``, ``decode_logits`` and ``greedy_decode`` are the inference
stages; they take NDArrays as the JAX package's do (``encode`` and
``decode_logits`` also tensors).  ``greedy_decode`` encodes the source
once and reruns the decoder over the whole prefix each step, freezing a
row on ``eos_id`` on the host, as the JAX package does.
"""
from __future__ import annotations

import numpy as np

from ... import ops as _ops
from ...base import MXNetError
from ...ops.tensor import _scalar_as
from .. import nn
from ..block import HybridBlock, _call_on_ndarrays
from ..loss import Loss
from .bert import BERTPositionwiseFFN, MultiHeadAttention

__all__ = ["Transformer", "TransformerEncoder", "TransformerDecoder",
           "TransformerEncoderCell", "TransformerDecoderCell",
           "LabelSmoothedCELoss", "transformer_base", "transformer_big",
           "get_transformer_model"]


def _sinusoid_table(max_len: int, units: int) -> np.ndarray:
    """Vaswani et al.'s sinusoidal position table, in float64 then fp32."""
    pos = np.arange(max_len)[:, None].astype(np.float64)
    dim = np.arange(units)[None, :].astype(np.float64)
    angle = pos / np.power(10000.0, 2 * (dim // 2) / units)
    table = np.where(dim % 2 == 0, np.sin(angle), np.cos(angle))
    return table.astype(np.float32)


def _any_ndarray(*args) -> bool:
    from ...ndarray.ndarray import NDArray

    return any(isinstance(a, NDArray) for a in args)


class TransformerEncoderCell(HybridBlock):
    """Post-LN encoder layer: self-attention, then the ReLU FFN."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 prefix=None, params=None):
        super().__init__(prefix, params)
        self.attention = MultiHeadAttention(units, num_heads, dropout)
        self.ln1 = nn.LayerNorm(in_channels=units)
        self.ffn = BERTPositionwiseFFN(units, hidden_size, dropout,
                                       activation="relu")
        self.ln2 = nn.LayerNorm(in_channels=units)
        self.dropout = nn.Dropout(dropout) if dropout else None

    def hybrid_forward(self, F, x, mask):
        att = self.attention(x, x, mask)
        if self.dropout is not None:
            att = self.dropout(att)
        x = self.ln1(x + att)
        return self.ln2(x + self.ffn(x))


class TransformerDecoderCell(HybridBlock):
    """Post-LN decoder layer: causal self-attention, cross-attention over
    the encoder's memory, then the ReLU FFN."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 prefix=None, params=None):
        super().__init__(prefix, params)
        self.self_attention = MultiHeadAttention(units, num_heads, dropout,
                                                 causal=True)
        self.ln1 = nn.LayerNorm(in_channels=units)
        self.cross_attention = MultiHeadAttention(units, num_heads, dropout)
        self.ln2 = nn.LayerNorm(in_channels=units)
        self.ffn = BERTPositionwiseFFN(units, hidden_size, dropout,
                                       activation="relu")
        self.ln3 = nn.LayerNorm(in_channels=units)
        self.dropout = nn.Dropout(dropout) if dropout else None

    def hybrid_forward(self, F, x, tgt_mask, mem, mem_mask):
        att = self.self_attention(x, x, tgt_mask)
        if self.dropout is not None:
            att = self.dropout(att)
        x = self.ln1(x + att)
        cross = self.cross_attention(x, mem, mem_mask)
        if self.dropout is not None:
            cross = self.dropout(cross)
        x = self.ln2(x + cross)
        return self.ln3(x + self.ffn(x))


class TransformerEncoder(HybridBlock):
    def __init__(self, num_layers=6, units=512, hidden_size=2048,
                 num_heads=8, dropout=0.1, prefix=None, params=None):
        super().__init__(prefix, params)
        self.layers = nn.HybridSequential()
        for _ in range(num_layers):
            self.layers.add(TransformerEncoderCell(units, hidden_size,
                                                   num_heads, dropout))

    def hybrid_forward(self, F, x, mask):
        for cell in self.layers._modules.values():
            x = cell(x, mask)
        return x


class TransformerDecoder(HybridBlock):
    def __init__(self, num_layers=6, units=512, hidden_size=2048,
                 num_heads=8, dropout=0.1, prefix=None, params=None):
        super().__init__(prefix, params)
        self.layers = nn.HybridSequential()
        for _ in range(num_layers):
            self.layers.add(TransformerDecoderCell(units, hidden_size,
                                                   num_heads, dropout))

    def hybrid_forward(self, F, x, tgt_mask, mem, mem_mask):
        for cell in self.layers._modules.values():
            x = cell(x, tgt_mask, mem, mem_mask)
        return x


class Transformer(HybridBlock):
    """Encoder-decoder transformer for NMT.

    forward(src, tgt, src_valid, tgt_valid) -> logits (B, S_tgt, vocab).
    With ``share_embed`` the source and target embeddings and the output
    projection are one parameter (transformer-base's joint vocabulary).
    """

    def __init__(self, src_vocab_size, tgt_vocab_size=None, units=512,
                 hidden_size=2048, num_layers=6, num_heads=8, dropout=0.1,
                 max_length=512, share_embed=True, prefix=None, params=None):
        super().__init__(prefix, params)
        tgt_vocab_size = tgt_vocab_size or src_vocab_size
        if share_embed and tgt_vocab_size != src_vocab_size:
            raise MXNetError("share_embed requires equal vocab sizes")
        self._units = units
        self._tgt_vocab_size = tgt_vocab_size
        self._scale = float(np.sqrt(units))
        self.src_embed = nn.Embedding(src_vocab_size, units)
        self.tgt_embed = self.src_embed if share_embed \
            else nn.Embedding(tgt_vocab_size, units)
        self._constant("pos_table", _sinusoid_table(max_length, units))
        self.encoder = TransformerEncoder(num_layers, units, hidden_size,
                                          num_heads, dropout)
        self.decoder = TransformerDecoder(num_layers, units, hidden_size,
                                          num_heads, dropout)
        self.dropout = nn.Dropout(dropout) if dropout else None
        self.out_proj_bias = self._param("out_proj_bias", (tgt_vocab_size,),
                                         "zeros")
        # tied: registered here, initialised and cast by its owner only
        self.tied_weight = self.tgt_embed.weight

    def _embed(self, F, embed, tokens):
        x = embed(tokens)
        x = x * _scalar_as(self._scale, x.dtype)  # a weak scalar, as in JAX
        pos = F.slice_axis(self.pos_table, axis=0, begin=0,
                           end=tokens.shape[1])
        x = F.broadcast_add(x, F.expand_dims(pos, axis=0))
        if self.dropout is not None:
            x = self.dropout(x)
        return x

    @staticmethod
    def _valid_mask(F, tokens, valid_length):
        steps = F.arange_like(tokens, axis=1)
        return F.cast(F.broadcast_lesser(
            F.expand_dims(steps, axis=0),
            F.expand_dims(valid_length, axis=-1)), dtype="float32")

    def _project(self, F, dec):
        return F.fully_connected(dec, self.tied_weight, self.out_proj_bias,
                                 num_hidden=self._tgt_vocab_size,
                                 flatten=False)

    def hybrid_forward(self, F, src, tgt, src_valid, tgt_valid):
        src_mask = self._valid_mask(F, src, src_valid)
        tgt_mask = self._valid_mask(F, tgt, tgt_valid)
        enc = self.encoder(self._embed(F, self.src_embed, src), src_mask)
        dec = self.decoder(self._embed(F, self.tgt_embed, tgt), tgt_mask,
                           enc, src_mask)
        return self._project(F, dec)

    # ---- inference stages ------------------------------------------------
    def encode(self, src, src_valid):
        """Run the encoder once; returns (memory, src_mask) for
        decoding."""
        if _any_ndarray(src, src_valid):
            return _call_on_ndarrays(self, (src, src_valid), {}, self.encode)
        src_mask = self._valid_mask(_ops, src, src_valid)
        mem = self.encoder(self._embed(_ops, self.src_embed, src), src_mask)
        return mem, src_mask

    def decode_logits(self, tgt, tgt_valid, mem, src_mask):
        """Decoder + tied projection over an already-encoded source."""
        if _any_ndarray(tgt, tgt_valid, mem, src_mask):
            return _call_on_ndarrays(self, (tgt, tgt_valid, mem, src_mask),
                                     {}, self.decode_logits)
        tgt_mask = self._valid_mask(_ops, tgt, tgt_valid)
        dec = self.decoder(self._embed(_ops, self.tgt_embed, tgt), tgt_mask,
                           mem, src_mask)
        return self._project(_ops, dec)

    def greedy_decode(self, src, src_valid, max_len=32, bos_id=1, eos_id=2):
        """Greedy autoregressive decoding of NDArrays ``src`` (B, S) and
        ``src_valid`` (B,).  The source is encoded once; each step reruns
        the decoder over the prefix.  A row that emitted ``eos_id`` keeps
        emitting it (frozen on the host).  Returns the (B, <= max_len)
        float32 tokens, ``bos_id`` first."""
        from ... import nd

        b = src.shape[0]
        mem, src_mask = self.encode(src, src_valid)
        tgt = nd.full((b, 1), bos_id, ctx=src.ctx)
        finished = np.zeros(b, bool)
        for _ in range(max_len - 1):
            tgt_valid = nd.full((b,), tgt.shape[1], ctx=src.ctx)
            logits = self.decode_logits(tgt, tgt_valid, mem, src_mask)
            nxt = logits[:, -1, :].argmax(axis=-1).asnumpy().astype(
                "float32")
            nxt = np.where(finished, float(eos_id), nxt)
            finished |= nxt == eos_id
            tgt = nd.concatenate(
                [tgt, nd.array(nxt[:, None], ctx=src.ctx)], axis=1)
            if finished.all():
                break
        return tgt


class LabelSmoothedCELoss(Loss):
    """Cross entropy with label smoothing, one value per token:
    (1 - smoothing) * nll + smoothing * mean(-log p)."""

    def __init__(self, smoothing=0.1, axis=-1, weight=None, batch_axis=0,
                 prefix=None, params=None):
        super().__init__(weight, batch_axis, prefix, params)
        self._smoothing = smoothing
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        logp = F.log_softmax(pred, axis=self._axis)
        nll = -F.pick(logp, label, axis=self._axis)
        smooth = -F.mean(logp, axis=self._axis)
        loss = nll * _scalar_as(1.0 - self._smoothing, nll.dtype) \
            + smooth * _scalar_as(self._smoothing, smooth.dtype)
        if sample_weight is not None:
            loss = loss * sample_weight
        return loss


_TRANSFORMER_SPECS = {
    "transformer_base": dict(units=512, hidden_size=2048, num_layers=6,
                             num_heads=8),
    "transformer_big": dict(units=1024, hidden_size=4096, num_layers=6,
                            num_heads=16),
}


def get_transformer_model(model_name="transformer_base", src_vocab_size=32000,
                          **kwargs):
    if model_name not in _TRANSFORMER_SPECS:
        raise MXNetError(f"unknown transformer {model_name}; have "
                         f"{sorted(_TRANSFORMER_SPECS)}")
    spec = dict(_TRANSFORMER_SPECS[model_name])
    spec.update(kwargs)
    return Transformer(src_vocab_size, **spec)


def transformer_base(**kwargs):
    """Vaswani et al.'s base configuration."""
    return get_transformer_model("transformer_base", **kwargs)


def transformer_big(**kwargs):
    return get_transformer_model("transformer_big", **kwargs)
