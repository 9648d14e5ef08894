"""AlexNet (counterpart of ``mxnet_tpu/gluon/model_zoo/vision/alexnet.py``,
ref: python/mxnet/gluon/model_zoo/vision/alexnet.py).  Child and
parameter names equal the JAX package's; the input widths are deferred
to the first forward, as there."""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn

__all__ = ["AlexNet", "alexnet"]


class AlexNet(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        self._arch = {"name": "AlexNet", "kwargs": {"classes": classes}}
        self.features = nn.HybridSequential(prefix="")
        self.features.add(nn.Conv2D(64, kernel_size=11, strides=4, padding=2,
                                    activation="relu"))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
        self.features.add(nn.Conv2D(192, kernel_size=5, padding=2,
                                    activation="relu"))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
        self.features.add(nn.Conv2D(384, kernel_size=3, padding=1,
                                    activation="relu"))
        self.features.add(nn.Conv2D(256, kernel_size=3, padding=1,
                                    activation="relu"))
        self.features.add(nn.Conv2D(256, kernel_size=3, padding=1,
                                    activation="relu"))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
        self.features.add(nn.Flatten())
        self.features.add(nn.Dense(4096, activation="relu"))
        self.features.add(nn.Dropout(0.5))
        self.features.add(nn.Dense(4096, activation="relu"))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def alexnet(pretrained=False, ctx=None, root=None, **kwargs):
    return AlexNet(**kwargs)
