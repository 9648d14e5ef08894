"""SSD detection models (counterpart of
``mxnet_tpu/gluon/model_zoo/detection.py``; BASELINE config 4:
SSD-300-ResNet50).

The GluonCV contract: ``SSD.forward(x)`` returns (cls_preds (B, N, C+1),
box_preds (B, N, 4), anchors (1, N, 4)).  The child names equal the JAX
package's (the backbone is re-parented under ``stages``: ``stages.0.4.0
.body.0.weight``), so weights carry across through ``.params`` files in
both directions.  The port has no deferred shapes: each head and extra
layer is given its input channels, read from the last convolution of
the feature block before it.

The backbones run in NCHW, the zoo's default layout, so the fused
Conv+BN unit (NHWC only) never engages: SSD runs op-granular, through
cuDNN, as the JAX package runs it through XLA.  Anchors come from
``MultiBoxPrior`` inside the forward (a function of the feature maps'
static shapes), and the loss mines hard negatives with two sorts on the
device, so a training step and a hybridized forward have no host sync
and are captured by ``_graphs`` like any other.
"""
from __future__ import annotations

from typing import List, Sequence

from ...base import MXNetError
from .. import nn
from ..block import HybridBlock
from ..loss import Loss
from . import vision

__all__ = ["SSD", "SSDMultiBoxLoss", "SSDTargetGenerator",
           "ssd_300_resnet50_v1", "ssd_512_resnet50_v1",
           "ssd_300_mobilenet1_0", "get_detection_model"]


def _out_channels(block) -> int:
    """Output channels of a feature block: its last convolution's."""
    convs = [m for m in block.modules() if isinstance(m, nn.Conv2D)]
    return int(convs[-1].weight.shape[0])


class ConvPredictor(HybridBlock):
    """3x3 conv head for class or box predictions."""

    def __init__(self, num_channels, in_channels, **kwargs):
        super().__init__(**kwargs)
        self.predictor = nn.Conv2D(num_channels, 3, 1, 1,
                                   in_channels=in_channels)

    def hybrid_forward(self, F, x):
        return self.predictor(x)


class _ExtraLayer(HybridBlock):
    """1x1 reduce + 3x3 stride-2 downsample (SSD's extra feature
    layers)."""

    def __init__(self, reduce_ch, out_ch, in_channels, **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.Conv2D(reduce_ch, 1, in_channels=in_channels))
        self.body.add(nn.BatchNorm(in_channels=reduce_ch))
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(out_ch, 3, strides=2, padding=1,
                                in_channels=reduce_ch))
        self.body.add(nn.BatchNorm(in_channels=out_ch))
        self.body.add(nn.Activation("relu"))

    def hybrid_forward(self, F, x):
        return self.body(x)


class SSD(HybridBlock):
    """Single-shot detector over a truncated backbone: the backbone's
    feature blocks, ``num_extras`` extra layers, and one class and one box
    predictor per scale.

    forward(x) -> (cls_preds (B, N, classes+1), box_preds (B, N, 4),
    anchors (1, N, 4)).
    """

    def __init__(self, backbone_features: List[HybridBlock],
                 num_extras: int, sizes: Sequence[Sequence[float]],
                 ratios: Sequence[Sequence[float]], classes: int,
                 extra_channels=(512, 256, 256, 128), **kwargs):
        super().__init__(**kwargs)
        if len(sizes) != len(ratios):
            raise MXNetError("sizes and ratios must have same length")
        self._num_scales = len(sizes)
        self._classes = classes
        self._sizes = [tuple(s) for s in sizes]
        self._ratios = [tuple(r) for r in ratios]
        num_anchors = [len(s) + len(r) - 1
                       for s, r in zip(self._sizes, self._ratios)]
        self.stages = nn.HybridSequential(prefix="stages_")
        feat_channels = []
        for blk in backbone_features:
            self.stages.add(blk)
            feat_channels.append(_out_channels(blk))
        self.extras = nn.HybridSequential(prefix="extras_")
        for i in range(num_extras):
            out = extra_channels[min(i, len(extra_channels) - 1)]
            self.extras.add(_ExtraLayer(out // 2, out, feat_channels[-1],
                                        prefix=f"extra{i}_"))
            feat_channels.append(out)
        self.class_predictors = nn.HybridSequential(prefix="cls_")
        self.box_predictors = nn.HybridSequential(prefix="box_")
        for i, (na, ch) in enumerate(zip(num_anchors, feat_channels)):
            self.class_predictors.add(
                ConvPredictor(na * (classes + 1), ch, prefix=f"cls{i}_"))
            self.box_predictors.add(ConvPredictor(na * 4, ch,
                                                  prefix=f"box{i}_"))

    def hybrid_forward(self, F, x):
        feats = []
        for stage in self.stages._modules.values():
            x = stage(x)
            feats.append(x)
        for extra in self.extras._modules.values():
            x = extra(x)
            feats.append(x)
        if len(feats) != self._num_scales:
            raise MXNetError(f"got {len(feats)} feature scales, expected "
                             f"{self._num_scales}")
        cls_preds, box_preds, anchors = [], [], []
        for i, feat in enumerate(feats):
            cp = self.class_predictors[i](feat)
            bp = self.box_predictors[i](feat)
            # (B, A*(C+1), H, W) -> (B, H*W*A, C+1)
            cp = F.reshape(F.transpose(cp, axes=(0, 2, 3, 1)),
                           shape=(0, -1, self._classes + 1))
            bp = F.reshape(F.transpose(bp, axes=(0, 2, 3, 1)),
                           shape=(0, -1, 4))
            cls_preds.append(cp)
            box_preds.append(bp)
            anchors.append(F.MultiBoxPrior(feat, sizes=self._sizes[i],
                                           ratios=self._ratios[i], clip=True))
        return (F.concat(*cls_preds, dim=1), F.concat(*box_preds, dim=1),
                F.concat(*anchors, dim=1))


class SSDTargetGenerator(HybridBlock):
    """MultiBoxTarget: (anchors, labels, cls_preds) -> (box_target,
    box_mask, cls_target)."""

    def __init__(self, overlap_threshold=0.5, negative_mining_ratio=-1.0,
                 variances=(0.1, 0.1, 0.2, 0.2), **kwargs):
        super().__init__(**kwargs)
        self._kwargs = dict(overlap_threshold=overlap_threshold,
                            negative_mining_ratio=negative_mining_ratio,
                            variances=tuple(variances))

    def hybrid_forward(self, F, anchors, labels, cls_preds):
        # MultiBoxTarget takes cls_preds as (B, C+1, N)
        cp = F.transpose(cls_preds, axes=(0, 2, 1))
        return F.MultiBoxTarget(anchors, labels, cp, **self._kwargs)


class SSDMultiBoxLoss(Loss):
    """Softmax cross entropy with hard-negative mining on the device, plus
    smooth L1 on the positives' boxes, over max(positives, 1) per sample
    (GluonCV's SSDMultiBoxLoss surface)."""

    def __init__(self, negative_mining_ratio=3.0, rho=1.0, lambd=1.0,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._ratio = negative_mining_ratio
        self._rho = rho
        self._lambd = lambd

    def mine(self, F, cls_pred, cls_target):
        """(cls_loss (B, N), keep (B, N), pos (B, N), num_pos (B,)): the
        cross entropy of every valid anchor, and the anchors it is summed
        over, the positives and the hard negatives (1.0, else 0.0)."""
        pred = F.log_softmax(cls_pred, axis=-1)
        pos = F.cast(F.broadcast_greater(
            cls_target, F.zeros_like(cls_target)), dtype="float32")
        # anchors the target generator marked ignore (-1) train nothing
        valid = F.cast(F.broadcast_greater_equal(
            cls_target, F.zeros_like(cls_target)), dtype="float32")
        cls_loss = F.pick(pred, cls_target, axis=-1) * -1.0 * valid
        # rank the valid negatives by their loss, the rest pushed last;
        # argsort(is_ascend=False) puts the later of two tied anchors
        # first, as the JAX package's does
        neg_mask = (1.0 - pos) * valid
        rank_score = cls_loss * neg_mask - (1.0 - neg_mask) * 1e6
        rank = F.argsort(F.argsort(rank_score, axis=1, is_ascend=False),
                         axis=1, is_ascend=True)
        num_pos = F.sum(pos, axis=1)
        max_neg = F.expand_dims(num_pos * self._ratio, axis=-1)
        hard_neg = F.cast(F.broadcast_lesser(rank, max_neg),
                          dtype="float32") * neg_mask
        return cls_loss, pos + hard_neg, pos, num_pos

    def hybrid_forward(self, F, cls_pred, box_pred, cls_target, box_target):
        """cls_pred (B, N, C+1); box_pred (B, N, 4); cls_target (B, N);
        box_target (B, N*4) or (B, N, 4).  Returns the loss per sample
        (B,)."""
        cls_loss, keep, pos, num_pos = self.mine(F, cls_pred, cls_target)
        cls_loss = F.sum(cls_loss * keep, axis=1)
        diff = F.reshape(box_pred, shape=(0, -1, 4)) - \
            F.reshape(box_target, shape=(0, -1, 4))
        sl1 = F.smooth_l1(diff, scalar=self._rho)
        box_loss = F.sum(sl1 * F.expand_dims(pos, axis=-1), axis=(1, 2))
        denom = F.broadcast_maximum(num_pos, F.ones_like(num_pos))
        return (cls_loss + self._lambd * box_loss) / denom


def _resnet_feature_stages(depth_fn, **kwargs) -> List[HybridBlock]:
    """A ResNet V1's features split into SSD's two backbone stages:
    [through stage 3] and [stage 4] (output strides 16 and 32)."""
    net = depth_fn(**kwargs)
    feats = list(net.features._modules.values())
    # conv, bn, relu, pool, stage1..4, gap
    head = nn.HybridSequential(prefix="backbone_")
    head.add(*feats[:7])
    tail = nn.HybridSequential(prefix="backbone_s4_")
    tail.add(feats[7])
    return [head, tail]


_SSD_SPECS = {
    300: dict(num_scales=6,
              sizes=[[0.1, 0.141], [0.2, 0.272], [0.37, 0.447],
                     [0.54, 0.619], [0.71, 0.79], [0.88, 0.961]],
              ratios=[[1, 2, 0.5]] * 2 + [[1, 2, 0.5, 3, 1.0 / 3]] * 4),
    512: dict(num_scales=7,
              sizes=[[0.07, 0.1025], [0.15, 0.2121], [0.3, 0.3674],
                     [0.45, 0.5196], [0.6, 0.6708], [0.75, 0.8216],
                     [0.9, 0.9721]],
              ratios=[[1, 2, 0.5]] * 2 + [[1, 2, 0.5, 3, 1.0 / 3]] * 5),
}


def _build_ssd(backbone_stages, input_size, classes, **kwargs):
    spec = _SSD_SPECS[input_size]
    num_extras = spec["num_scales"] - len(backbone_stages)
    return SSD(backbone_stages, num_extras, spec["sizes"], spec["ratios"],
               classes, **kwargs)


def ssd_300_resnet50_v1(classes=20, **kwargs):
    """SSD-300 with a ResNet-50 v1 backbone (BASELINE config 4)."""
    return _build_ssd(_resnet_feature_stages(vision.resnet50_v1), 300,
                      classes, **kwargs)


def ssd_512_resnet50_v1(classes=20, **kwargs):
    return _build_ssd(_resnet_feature_stages(vision.resnet50_v1), 512,
                      classes, **kwargs)


def ssd_300_mobilenet1_0(classes=20, **kwargs):
    net = vision.mobilenet1_0()
    feats = list(net.features._modules.values())
    cut = max(len(feats) - 10, 1)
    head = nn.HybridSequential(prefix="backbone_")
    head.add(*feats[:cut])
    tail = nn.HybridSequential(prefix="backbone_tail_")
    tail.add(*feats[cut:-2])  # without the pooling and the flatten
    return _build_ssd([head, tail], 300, classes, **kwargs)


_DETECTION_MODELS = {
    "ssd_300_resnet50_v1": ssd_300_resnet50_v1,
    "ssd_512_resnet50_v1": ssd_512_resnet50_v1,
    "ssd_300_mobilenet1.0": ssd_300_mobilenet1_0,
}


def get_detection_model(name, **kwargs):
    name = name.lower()
    if name not in _DETECTION_MODELS:
        raise MXNetError(
            f"unknown detection model {name}; have "
            f"{sorted(_DETECTION_MODELS)}")
    return _DETECTION_MODELS[name](**kwargs)
