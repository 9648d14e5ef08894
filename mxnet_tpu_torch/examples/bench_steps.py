"""The training steps of ``bench_all.py``'s configurations 3 to 5 on the
port: config 3 (BERT-base MLM+NSP pretraining), config 4 (SSD-300 with a
ResNet-50 v1 backbone and ``SSDMultiBoxLoss`` on precomputed targets)
and config 5 (Transformer-base NMT with the label-smoothed cross
entropy), each a ``HybridBlock`` whose forward returns the loss, trained
through ``parallel.SPMDTrainer`` with an identity loss and
``n_labels=0``, as ``bench_all.py`` trains them.  Inputs are synthetic
and drawn as ``bench_all.py`` draws them.  No feature of its own: the
tests and ``chip_smoke.py`` use these blocks so that the port has one
copy of each step.

Usage::

    step = bert_step("full", dropout=0.1)
    init_step(step, init.Normal(0.02), ctx=gpu(0), dtype="bfloat16")
    trainer = spmd_trainer(step, 1e-4)
    loss = trainer.step(*bert_batch("full", ctx=gpu(0)))

    step = init_step(ssd_step("full"), init.Xavier(), ctx=gpu(0),
                     dtype="bfloat16")
    trainer = spmd_trainer(step, **SSD_OPT)
    loss = trainer.step(*ssd_batch("full", ctx=gpu(0), dtype="bfloat16"))
"""
from __future__ import annotations

import numpy as np
import torch

from .. import parallel
from ..base import dtype_of
from ..context import resolve
from ..gluon.block import ActiveTrace, HybridBlock
from ..gluon.model_zoo.bert import get_bert_model
from ..gluon.model_zoo.detection import SSDMultiBoxLoss, ssd_300_resnet50_v1
from ..gluon.model_zoo.transformer import get_transformer_model

__all__ = ["Identity", "BertPretrainStep", "SSDTrainStep",
           "TransformerNMTStep", "BERT_SIZES", "SSD_SIZES", "SSD_OPT",
           "TRANSFORMER_SIZES", "bert_step", "ssd_step", "transformer_step",
           "bert_batch", "ssd_batch", "transformer_batch", "init_step",
           "spmd_trainer"]

# bench_all.py's sizes: "cpu_smoke" (--cpu-smoke) and "full"
BERT_SIZES = {
    "cpu_smoke": dict(batch=2, seq=32, vocab=1000,
                      model=dict(num_layers=2, units=64, hidden_size=128,
                                 num_heads=4, max_length=32)),
    "full": dict(batch=32, seq=128, vocab=30522,
                 model=dict(max_length=512)),
}
# config 4 at 300x300, the input its anchor spec is keyed to: 2078
# anchors (19², 10² maps x 4, then 5², 3², 2², 1² x 6)
SSD_SIZES = {
    "cpu_smoke": dict(batch=1, size=300, classes=20, anchors=2078),
    "full": dict(batch=32, size=300, classes=20, anchors=2078),
}
SSD_OPT = dict(optimizer="sgd", lr=0.01, momentum=0.9, wd=5e-4)
TRANSFORMER_SIZES = {
    "cpu_smoke": dict(batch=2, seq=16, vocab=1000,
                      model=dict(num_layers=2, units=64, hidden_size=128,
                                 num_heads=4)),
    "full": dict(batch=64, seq=64, vocab=32000, model={}),
}


class Identity:
    """The loss of a step whose forward already returns the loss."""

    def __call__(self, out, *labels):
        return out


class BertPretrainStep(HybridBlock):
    """Config 3: the MLM loss weighted by ``mlm_weight`` over
    max(sum(mlm_weight), 1), plus the mean NSP loss; both log-softmaxes
    in fp32.  Under a mesh that splits the batch, sum(mlm_weight) is the
    global batch's (summed over the batch axes) and the MLM term is
    scaled so that the trainer's mean of the ranks' shares is the global
    loss, as the JAX package's step computes it on the global batch."""

    def __init__(self, vocab, dropout=0.1, **model):
        super().__init__()
        self.bert = get_bert_model("bert_12_768_12", vocab_size=vocab,
                                   dropout=dropout, **model)

    def hybrid_forward(self, F, tokens, segments, vlen, mlm_labels,
                       mlm_weight, nsp_labels):
        seq_out, pooled = self.bert(tokens, segments, vlen)
        mlm_scores = self.bert.decode_mlm(seq_out)
        nsp_scores = self.bert.classify_nsp(pooled)
        lsm = F.log_softmax(mlm_scores.float(), axis=-1)
        nll = -F.pick(lsm, mlm_labels, axis=-1)
        den, shards = mlm_weight.sum(), parallel.batch_shards()
        if shards > 1:
            den = parallel.dist.all_reduce_sum(
                den, parallel.mesh.batch_group())
        mlm_l = (nll * mlm_weight).sum() * shards / den.clamp_min(1.0)
        nsp_lsm = F.log_softmax(nsp_scores.float(), axis=-1)
        nsp_l = -F.pick(nsp_lsm, nsp_labels, axis=-1)
        return mlm_l + nsp_l.mean()


class SSDTrainStep(HybridBlock):
    """Config 4: ``ssd_300_resnet50_v1`` and ``SSDMultiBoxLoss`` on
    targets given with the batch; returns the loss per image."""

    def __init__(self, classes=20):
        super().__init__()
        self.ssd = ssd_300_resnet50_v1(classes=classes)
        self.loss = SSDMultiBoxLoss()

    def hybrid_forward(self, F, x, cls_t, box_t):
        cls_p, box_p, _anchors = self.ssd(x)
        return self.loss(cls_p, box_p, cls_t, box_t)


class TransformerNMTStep(HybridBlock):
    """Config 5: the label-smoothed (eps 0.1) cross entropy in fp32,
    masked by ``tgt_valid`` and averaged over the valid tokens.  Under a
    mesh that splits the batch the valid-token count is the global
    batch's (summed over the batch axes) and the sum is scaled as
    BERT's MLM term is, so that the step's loss is the JAX package's
    global token mean."""

    EPS = 0.1

    def __init__(self, vocab, dropout=0.1, **model):
        super().__init__()
        self.net = get_transformer_model(
            "transformer_base", src_vocab_size=vocab, tgt_vocab_size=vocab,
            dropout=dropout, **model)

    def hybrid_forward(self, F, src, tgt_in, src_valid, tgt_valid, tgt_out):
        logits = self.net(src, tgt_in, src_valid, tgt_valid)
        lsm = F.log_softmax(logits.float(), axis=-1)
        nll = -F.pick(lsm, tgt_out, axis=-1)
        smooth = -lsm.mean(-1)
        steps = torch.arange(nll.shape[1], device=nll.device,
                             dtype=torch.float32)
        mask = steps[None, :] < tgt_valid[:, None].float()
        per_tok = ((1 - self.EPS) * nll + self.EPS * smooth) * mask
        den, shards = mask.sum().float(), parallel.batch_shards()
        if shards > 1:
            den = parallel.dist.all_reduce_sum(
                den, parallel.mesh.batch_group())
        return per_tok.sum() * shards / den.clamp_min(1.0)


def bert_step(size="full", dropout=0.1) -> BertPretrainStep:
    cfg = BERT_SIZES[size]
    return BertPretrainStep(cfg["vocab"], dropout=dropout, **cfg["model"])


def ssd_step(size="full") -> SSDTrainStep:
    return SSDTrainStep(SSD_SIZES[size]["classes"])


def transformer_step(size="full", dropout=0.1) -> TransformerNMTStep:
    cfg = TRANSFORMER_SIZES[size]
    return TransformerNMTStep(cfg["vocab"], dropout=dropout, **cfg["model"])


def _on(arrays, ctx):
    if ctx is None:
        return arrays
    dev = resolve(ctx)
    return tuple(torch.from_numpy(a).to(dev) for a in arrays)


def bert_batch(size="full", seed=0, ctx=None):
    """(tokens, segments, vlen, mlm_labels, mlm_weight, nsp_labels) from
    ``RandomState(seed)`` as ``bench_all.py`` draws them: numpy arrays,
    or tensors on ``ctx``."""
    cfg = BERT_SIZES[size]
    bs, seq, vocab = cfg["batch"], cfg["seq"], cfg["vocab"]
    rng = np.random.RandomState(seed)
    tokens = rng.randint(5, vocab, (bs, seq)).astype(np.int32)
    segments = np.zeros((bs, seq), np.int32)
    vlen = np.full((bs,), seq, np.float32)
    mlm_labels = rng.randint(5, vocab, (bs, seq)).astype(np.int32)
    mlm_weight = (rng.rand(bs, seq) < 0.15).astype(np.float32)
    nsp_labels = rng.randint(0, 2, (bs,)).astype(np.int32)
    return _on((tokens, segments, vlen, mlm_labels, mlm_weight, nsp_labels),
               ctx)


def ssd_batch(size="full", seed=0, ctx=None, dtype=None):
    """(x, cls_t, box_t) from ``RandomState(seed)`` as ``bench_all.py``
    draws them: images from ``rand``, class targets in [-1, classes]
    (-1 ignored, 0 background), box targets ``randn * 0.1``; numpy arrays,
    or tensors on ``ctx``.  ``dtype`` casts the images (the targets stay
    float32): a bf16 net needs bf16 images, since a convolution takes one
    dtype (the JAX package's ``lax.conv_general_dilated`` refuses a
    float32 batch for bf16 weights too)."""
    cfg = SSD_SIZES[size]
    bs, s, n = cfg["batch"], cfg["size"], cfg["anchors"]
    rng = np.random.RandomState(seed)
    x = rng.rand(bs, 3, s, s).astype(np.float32)
    cls_t = rng.randint(-1, cfg["classes"] + 1, (bs, n)).astype(np.float32)
    box_t = (rng.randn(bs, n, 4) * 0.1).astype(np.float32)
    out = _on((x, cls_t, box_t), ctx)
    if dtype is not None and ctx is not None:
        out = (out[0].to(dtype_of(dtype)),) + out[1:]
    return out


def transformer_batch(size="full", seed=0, ctx=None):
    """(src, tgt_in, src_valid, tgt_valid, tgt_out) from
    ``RandomState(seed)`` as ``bench_all.py`` draws them: one (seq, seq)
    bucket, every token valid."""
    cfg = TRANSFORMER_SIZES[size]
    bs, slen, vocab = cfg["batch"], cfg["seq"], cfg["vocab"]
    rng = np.random.RandomState(seed)
    src = rng.randint(4, vocab, (bs, slen)).astype(np.int32)
    tgt_in = rng.randint(4, vocab, (bs, slen)).astype(np.int32)
    tgt_out = rng.randint(4, vocab, (bs, slen)).astype(np.int32)
    sv = np.full((bs,), slen, np.float32)
    tv = np.full((bs,), slen, np.float32)
    return _on((src, tgt_in, sv, tv, tgt_out), ctx)


def init_step(step, init, ctx=None, seed=0, dtype=None, warm=None):
    """``initialize(init)`` on ``ctx`` from ``seed``, one inference
    forward of the model on ``warm`` (its model inputs, as
    ``bench_all.py`` warms the JAX blocks), then ``cast(dtype)``."""
    step.initialize(init, ctx=ctx, seed=seed)
    if warm is not None:
        model = step.bert if isinstance(step, BertPretrainStep) else step.net
        with torch.no_grad(), ActiveTrace(train=False):
            model(*warm)
    if dtype is not None:
        step.cast(dtype)
    return step


def spmd_trainer(step, lr, mesh=None, optimizer="adam", **optimizer_params):
    """``SPMDTrainer(step, Identity(), optimizer, {"learning_rate": lr,
    **optimizer_params}, n_labels=0)`` on ``mesh`` (default: one device,
    gpu(0))."""
    return parallel.SPMDTrainer(step, Identity(), optimizer,
                                dict(optimizer_params, learning_rate=lr),
                                mesh=mesh or parallel.make_mesh(dp=1),
                                n_labels=0)
