"""Legacy RNN data helpers (counterpart of ``mxnet_tpu/rnn/io.py``):
``encode_sentences`` and ``BucketSentenceIter``, the input side of the
bucketing language-model recipe.  Batches are NDArrays on the CPU, as
every iterator of the port gives them; the executor copies them to its
device.  The shuffles draw from numpy's ``RandomState(1)``, as in the
JAX package, so both packages give the same batches in the same
order."""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..base import MXNetError
from ..context import cpu
from ..io.io import DataBatch, DataDesc, DataIter
from ..ndarray import array as _array


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0, unknown_token=None):
    """Encode tokenized sentences into id lists, building/extending the
    vocab (ref: io.py::encode_sentences)."""
    idx = start_label
    if vocab is None:
        vocab = {invalid_key: invalid_label}
        new_vocab = True
    else:
        new_vocab = False
        idx = max(vocab.values()) + 1
    res = []
    for sent in sentences:
        coded = []
        for word in sent:
            if word not in vocab:
                if not new_vocab:
                    if unknown_token is None:
                        raise MXNetError(f"unknown token {word!r} with a "
                                         "frozen vocab and no unknown_token")
                    word = unknown_token
                    if word not in vocab:
                        # a frozen vocab must already contain its
                        # unknown_token; inserting it would silently
                        # mutate a vocab the caller declared fixed
                        raise MXNetError(
                            f"unknown_token {unknown_token!r} is not in "
                            "the provided (frozen) vocab")
                else:
                    if idx == invalid_label:
                        idx += 1
                    vocab[word] = idx
                    idx += 1
            coded.append(vocab[word])
        res.append(coded)
    return res, vocab


class BucketSentenceIter(DataIter):
    """Pads encoded sentences into per-bucket batches
    (ref: io.py::BucketSentenceIter).  provide_data/label follow the
    current bucket; `bucket_key` of each batch selects the
    BucketingModule executor."""

    def __init__(self, sentences: List[List[int]], batch_size: int,
                 buckets: Optional[List[int]] = None, invalid_label=-1,
                 data_name="data", label_name="softmax_label",
                 dtype="float32", layout="NT"):
        super().__init__(batch_size)
        if buckets is None:
            lens = np.bincount([len(s) for s in sentences])
            buckets = [i for i, n in enumerate(lens)
                       if n >= batch_size] or [max(len(s)
                                                   for s in sentences)]
        buckets = sorted(buckets)
        self.data = [[] for _ in buckets]
        ndiscard = 0
        for sent in sentences:
            buck = next((i for i, b in enumerate(buckets)
                         if b >= len(sent)), None)
            if buck is None:
                ndiscard += 1
                continue
            buf = np.full((buckets[buck],), invalid_label, dtype=dtype)
            buf[:len(sent)] = sent
            self.data[buck].append(buf)
        self.data = [np.asarray(x, dtype=dtype) for x in self.data]
        if ndiscard:
            import logging

            logging.info("BucketSentenceIter: discarded %d sentences "
                         "longer than the largest bucket", ndiscard)
        self.batch_size = batch_size
        self.buckets = buckets
        self.invalid_label = invalid_label
        self.dtype = dtype
        self.data_name, self.label_name = data_name, label_name
        self.major_axis = 0 if layout.find("N") == 0 else 1
        self.default_bucket_key = max(buckets)
        self._rng = np.random.RandomState(1)
        self.reset()

    @property
    def provide_data(self):
        shape = ((self.batch_size, self.default_bucket_key)
                 if self.major_axis == 0
                 else (self.default_bucket_key, self.batch_size))
        return [DataDesc(self.data_name, shape, self.dtype)]

    @property
    def provide_label(self):
        shape = ((self.batch_size, self.default_bucket_key)
                 if self.major_axis == 0
                 else (self.default_bucket_key, self.batch_size))
        return [DataDesc(self.label_name, shape, self.dtype)]

    def reset(self):
        self.curr_idx = 0
        self.idx = []
        for i, buck in enumerate(self.data):
            self._rng.shuffle(buck)
            for j in range(0, len(buck) - self.batch_size + 1,
                           self.batch_size):
                self.idx.append((i, j))
        self._rng.shuffle(self.idx)

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        buck = self.data[i][j:j + self.batch_size]
        label = np.full_like(buck, self.invalid_label)
        label[:, :-1] = buck[:, 1:]
        if self.major_axis == 1:
            buck, label = buck.T, label.T
        shape = buck.shape
        return DataBatch(
            data=[_array(buck, ctx=cpu())],
            label=[_array(label, ctx=cpu())],
            bucket_key=self.buckets[i],
            provide_data=[DataDesc(self.data_name, shape, self.dtype)],
            provide_label=[DataDesc(self.label_name, shape, self.dtype)])
