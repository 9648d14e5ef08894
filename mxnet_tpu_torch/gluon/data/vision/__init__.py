"""Vision datasets of the port (counterpart of
``mxnet_tpu/gluon/data/vision``): MNIST and FashionMNIST."""
from .datasets import MNIST, FashionMNIST

__all__ = ["MNIST", "FashionMNIST"]
