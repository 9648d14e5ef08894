"""BERT models of the port (counterpart of
``mxnet_tpu/gluon/model_zoo/bert.py``).

The same blocks, structural parameter names and forward: word, token
type and position embeddings, LayerNorm, a post-LN encoder whose
attention runs ``dot_product_attention`` (the CUDA kernel on the card),
the pooler, the MLM decoder tied to the word-embedding matrix and the
NSP classifier.  Every layer is built with its
``in_units``/``in_channels``, so no parameter is deferred.  Dropout
and the attention's probability dropout follow the trace's train flag
inside a trace scope, else the module's mode, and draw from the trace
scope's generator.  ``BERTModel`` keeps an ``_arch`` record for
``contrib.deploy``.
"""
from __future__ import annotations

from ...base import MXNetError
from .. import nn
from ..block import HybridBlock, trace_generator, train_mode

__all__ = ["BERTModel", "BERTEncoder", "BERTEncoderCell",
           "MultiHeadAttention", "bert_12_768_12", "bert_24_1024_16",
           "get_bert_model"]


class MultiHeadAttention(HybridBlock):
    """Multi-head attention over ``dot_product_attention``; query and
    key/value sources may differ (both ``units`` wide)."""

    def __init__(self, units, num_heads, dropout=0.0, causal=False,
                 out_dropout=0.0, prefix=None, params=None):
        super().__init__(prefix, params)
        if units % num_heads:
            raise MXNetError(f"units {units} not divisible by heads "
                             f"{num_heads}")
        self._num_heads = num_heads
        self._dropout = dropout
        self._causal = causal
        self.query = nn.Dense(units, flatten=False, in_units=units)
        self.key = nn.Dense(units, flatten=False, in_units=units)
        self.value = nn.Dense(units, flatten=False, in_units=units)
        self.proj = nn.Dense(units, flatten=False, in_units=units)
        self.dropout = nn.Dropout(out_dropout) if out_dropout else None

    def hybrid_forward(self, F, x, mem, mem_mask):
        out = F.dot_product_attention(
            self.query(x), self.key(mem), self.value(mem), mem_mask,
            num_heads=self._num_heads, dropout=self._dropout,
            causal=self._causal, train=train_mode(self),
            generator=trace_generator())
        out = self.proj(out)
        if self.dropout is not None:
            out = self.dropout(out)
        return out


class BERTSelfAttention(MultiHeadAttention):
    """Self-attention with BERT's output dropout."""

    def __init__(self, units, num_heads, dropout=0.0, prefix=None,
                 params=None):
        super().__init__(units, num_heads, dropout=dropout,
                         out_dropout=dropout, prefix=prefix, params=params)

    def hybrid_forward(self, F, x, mask):
        return super().hybrid_forward(F, x, x, mask)


class BERTPositionwiseFFN(HybridBlock):
    def __init__(self, units, hidden_size, dropout=0.0, activation="gelu",
                 prefix=None, params=None):
        super().__init__(prefix, params)
        self.ffn_1 = nn.Dense(hidden_size, flatten=False,
                              activation=activation, in_units=units)
        self.ffn_2 = nn.Dense(units, flatten=False, in_units=hidden_size)
        self.dropout = nn.Dropout(dropout) if dropout else None

    def hybrid_forward(self, F, x):
        out = self.ffn_2(self.ffn_1(x))
        if self.dropout is not None:
            out = self.dropout(out)
        return out


class BERTEncoderCell(HybridBlock):
    """Post-LN transformer encoder layer (BERT convention)."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 prefix=None, params=None):
        super().__init__(prefix, params)
        self.attention = BERTSelfAttention(units, num_heads, dropout)
        self.ln1 = nn.LayerNorm(epsilon=1e-12, in_channels=units)
        self.ffn = BERTPositionwiseFFN(units, hidden_size, dropout)
        self.ln2 = nn.LayerNorm(epsilon=1e-12, in_channels=units)

    def hybrid_forward(self, F, x, mask):
        x = self.ln1(x + self.attention(x, mask))
        return self.ln2(x + self.ffn(x))


class BERTEncoder(HybridBlock):
    """N-layer transformer encoder."""

    def __init__(self, num_layers=12, units=768, hidden_size=3072,
                 num_heads=12, dropout=0.1, prefix=None, params=None):
        super().__init__(prefix, params)
        self.layers = nn.HybridSequential()
        for _ in range(num_layers):
            self.layers.add(BERTEncoderCell(units, hidden_size, num_heads,
                                            dropout))

    def hybrid_forward(self, F, x, mask):
        for cell in self.layers._modules.values():
            x = cell(x, mask)
        return x


class _MLMDecoder(HybridBlock):
    """MLM head: transform + LN + vocab projection with the TIED
    word-embedding matrix (the same ``nn.Parameter``)."""

    def __init__(self, units, vocab_size, embed_weight, prefix=None,
                 params=None):
        super().__init__(prefix, params)
        self._vocab_size = vocab_size
        self.transform = nn.Dense(units, flatten=False, activation="gelu",
                                  in_units=units)
        self.ln = nn.LayerNorm(epsilon=1e-12, in_channels=units)
        self.bias = self._param("bias", (vocab_size,), "zeros")
        # tied: registered here, initialised and cast by its owner only
        self.embed_weight = embed_weight

    def hybrid_forward(self, F, x):
        h = self.ln(self.transform(x))
        return F.fully_connected(h, self._value("embed_weight"),
                                 self._value("bias"),
                                 num_hidden=self._vocab_size, flatten=False)


class BERTModel(HybridBlock):
    """BERT with pooler, tied MLM decoder, and NSP classifier.

    forward(inputs, token_types, valid_length) ->
        (sequence_output (B, S, U), pooled_output (B, U))
    ``decode_mlm(sequence_output)`` -> (B, S, vocab) scores (tied
    weights); ``classify_nsp(pooled_output)`` -> (B, 2).
    """

    def __init__(self, vocab_size=30522, token_type_vocab_size=2,
                 units=768, hidden_size=3072, max_length=512,
                 num_layers=12, num_heads=12, dropout=0.1,
                 use_pooler=True, use_decoder=True, use_classifier=True,
                 prefix=None, params=None):
        super().__init__(prefix, params)
        self._arch = {"name": "BERTModel", "kwargs": dict(
            vocab_size=vocab_size,
            token_type_vocab_size=token_type_vocab_size, units=units,
            hidden_size=hidden_size, max_length=max_length,
            num_layers=num_layers, num_heads=num_heads, dropout=dropout,
            use_pooler=use_pooler, use_decoder=use_decoder,
            use_classifier=use_classifier)}
        self._use_pooler = use_pooler
        self._use_decoder = use_decoder
        self._use_classifier = use_classifier
        self.position_weight = self._param("position_weight",
                                           (max_length, units), "normal")
        self.word_embed = nn.Embedding(vocab_size, units)
        self.token_type_embed = nn.Embedding(token_type_vocab_size, units)
        self.embed_ln = nn.LayerNorm(epsilon=1e-12, in_channels=units)
        self.embed_dropout = nn.Dropout(dropout) if dropout else None
        self.encoder = BERTEncoder(num_layers, units, hidden_size,
                                   num_heads, dropout)
        if use_pooler:
            self.pooler = nn.Dense(units, flatten=False, activation="tanh",
                                   in_units=units)
        if use_decoder:
            self.mlm_decoder = _MLMDecoder(units, vocab_size,
                                           self.word_embed.weight)
        if use_classifier:
            self.classifier = nn.Dense(2, flatten=False, in_units=units)

    def hybrid_forward(self, F, inputs, token_types, valid_length):
        x = self.word_embed(inputs) + self.token_type_embed(token_types)
        seq_len = inputs.shape[1]
        pos = F.slice_axis(self._value("position_weight"), axis=0, begin=0,
                           end=seq_len)
        x = F.broadcast_add(x, F.expand_dims(pos, axis=0))
        x = self.embed_ln(x)
        if self.embed_dropout is not None:
            x = self.embed_dropout(x)
        # key-validity mask (B, S) from valid_length
        steps = F.arange_like(inputs, axis=1)
        mask = F.cast(F.broadcast_lesser(
            F.expand_dims(steps, axis=0),
            F.expand_dims(valid_length, axis=-1)), dtype="float32")
        seq = self.encoder(x, mask)
        if not self._use_pooler:
            return seq
        cls_tok = F.squeeze(F.slice_axis(seq, axis=1, begin=0, end=1),
                            axis=1)
        return seq, self.pooler(cls_tok)

    def decode_mlm(self, sequence_output):
        """MLM scores over every position with tied embedding weights."""
        if not self._use_decoder:
            raise MXNetError("model built with use_decoder=False")
        return self.mlm_decoder(sequence_output)

    def classify_nsp(self, pooled_output):
        if not self._use_classifier:
            raise MXNetError("model built with use_classifier=False")
        return self.classifier(pooled_output)


_BERT_SPECS = {
    "bert_12_768_12": dict(num_layers=12, units=768, hidden_size=3072,
                           num_heads=12),
    "bert_24_1024_16": dict(num_layers=24, units=1024, hidden_size=4096,
                            num_heads=16),
}


def get_bert_model(model_name="bert_12_768_12", vocab_size=30522,
                   dropout=0.1, max_length=512, **kwargs):
    if model_name not in _BERT_SPECS:
        raise MXNetError(f"unknown BERT model {model_name}; have "
                         f"{sorted(_BERT_SPECS)}")
    spec = dict(_BERT_SPECS[model_name])
    spec.update(kwargs)
    return BERTModel(vocab_size=vocab_size, dropout=dropout,
                     max_length=max_length, **spec)


def bert_12_768_12(**kwargs):
    """BERT-base."""
    return get_bert_model("bert_12_768_12", **kwargs)


def bert_24_1024_16(**kwargs):
    """BERT-large."""
    return get_bert_model("bert_24_1024_16", **kwargs)
