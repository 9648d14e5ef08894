"""Vision datasets (counterpart of
``mxnet_tpu/gluon/data/vision/datasets.py``): MNIST and FashionMNIST.

They read the idx files (optionally gzipped) in ``root`` when present;
otherwise they generate the JAX package's deterministic synthetic set,
bit for bit (the port keeps its own copy of ``_synthetic_images``),
flagged by ``.synthetic``.  Nothing is ever downloaded.  A sample is an
NDArray on the CPU and its label.  CIFAR and the image-file datasets
wait (ROADMAP queue A item 8).
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ....ndarray.ndarray import _cpu_array
from ..dataset import Dataset

__all__ = ["MNIST", "FashionMNIST"]


def _synthetic_images(n, shape, num_classes, template_seed, sample_seed):
    """Deterministic class-separable synthetic data: each class gets a
    fixed random template (shared by train AND test via template_seed);
    samples are noisy templates (sample_seed differs per split)."""
    t_rng = np.random.RandomState(template_seed)
    templates = t_rng.uniform(0, 255, (num_classes,) + shape).astype("float32")
    s_rng = np.random.RandomState(sample_seed)
    labels = s_rng.randint(0, num_classes, n).astype("int32")
    noise = s_rng.normal(0, 32, (n,) + shape).astype("float32")
    images = np.clip(templates[labels] + noise, 0, 255).astype("uint8")
    return images, labels


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self.synthetic = False
        self._data = None
        self._label = None
        self._get_data()

    def __getitem__(self, idx):
        img = _cpu_array(self._data[idx])
        label = self._label[idx]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self._label)


class MNIST(_DownloadedDataset):
    """idx-format files in ``root``, else the synthetic set (8192 train,
    2048 test images of 28x28x1)."""

    _files = {
        True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
        False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
    }
    _shape = (28, 28, 1)
    _classes = 10
    _seed = 42

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)

    def _read_idx(self, img_path, lbl_path):
        def opener(p):
            return gzip.open(p, "rb") if p.endswith(".gz") else open(p, "rb")

        with opener(lbl_path) as f:
            struct.unpack(">II", f.read(8))
            labels = np.frombuffer(f.read(), dtype=np.uint8).astype(np.int32)
        with opener(img_path) as f:
            _, n, rows, cols = struct.unpack(">IIII", f.read(16))
            images = np.frombuffer(f.read(), dtype=np.uint8).reshape(
                n, rows, cols, 1)
        return images, labels

    def _get_data(self):
        img_name, lbl_name = self._files[self._train]
        for suffix in ("", ".gz"):
            ip = os.path.join(self._root, img_name + suffix)
            lp = os.path.join(self._root, lbl_name + suffix)
            if os.path.exists(ip) and os.path.exists(lp):
                self._data, self._label = self._read_idx(ip, lp)
                return
        self.synthetic = True
        n = 8192 if self._train else 2048
        self._data, self._label = _synthetic_images(
            n, self._shape, self._classes, self._seed,
            self._seed + 1000 + int(self._train))


class FashionMNIST(MNIST):
    _seed = 43

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)
