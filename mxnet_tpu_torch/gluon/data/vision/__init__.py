"""Vision datasets and transforms of the port (counterpart of
``mxnet_tpu/gluon/data/vision``): MNIST, FashionMNIST, CIFAR10/100,
ImageRecordDataset, ImageFolderDataset and ``transforms``."""
from .datasets import (CIFAR10, CIFAR100, MNIST, FashionMNIST,
                       ImageFolderDataset, ImageRecordDataset)
from . import transforms

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset", "transforms"]
