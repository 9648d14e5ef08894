"""Vision datasets (counterpart of
``mxnet_tpu/gluon/data/vision/datasets.py``): MNIST, FashionMNIST,
CIFAR10, CIFAR100, ImageRecordDataset and ImageFolderDataset.

They read the standard files in ``root`` when present (MNIST's idx files,
optionally gzipped; CIFAR's binary batches); otherwise they generate the
JAX package's deterministic synthetic set, bit for bit (the port keeps
its own copy of ``_synthetic_images``), flagged by ``.synthetic``.
Nothing is ever downloaded.  A sample is an HWC uint8 NDArray on the CPU
and its int32 label.  ``ImageRecordDataset`` (a ``.rec`` with its
``.idx``) and ``ImageFolderDataset`` (a folder a class) decode with
``cv2`` into HWC uint8 NDArrays on the CPU; both pickle for the
DataLoader's spawned workers.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ....ndarray.ndarray import _cpu_array
from ..dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset"]


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


class CIFAR10(_DownloadedDataset):
    """``data_batch_1..5.bin`` / ``test_batch.bin`` in ``root``, else the
    synthetic set (4096 train, 1024 test images of 32x32x3)."""

    _shape = (32, 32, 3)
    _classes = 10
    _seed = 44

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar10"),
                 train=True, transform=None):
        super().__init__(root, train, transform)

    @staticmethod
    def _read_batch(filename):
        with open(filename, "rb") as f:
            raw = np.frombuffer(f.read(), dtype=np.uint8)
        rec = raw.reshape(-1, 3072 + 1)
        return rec[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), \
            rec[:, 0].astype(np.int32)

    def _synthesize(self):
        self.synthetic = True
        n = 4096 if self._train else 1024
        self._data, self._label = _synthetic_images(
            n, self._shape, self._classes, self._seed,
            self._seed + 1000 + int(self._train))

    def _get_data(self):
        names = [f"data_batch_{i}.bin" for i in range(1, 6)] \
            if self._train else ["test_batch.bin"]
        paths = [os.path.join(self._root, n) for n in names]
        if all(os.path.exists(p) for p in paths):
            data, labels = zip(*[self._read_batch(p) for p in paths])
            self._data = np.concatenate(data)
            self._label = np.concatenate(labels)
            return
        self._synthesize()


class CIFAR100(CIFAR10):
    """``train.bin`` / ``test.bin`` in ``root`` (coarse labels, or fine
    with ``fine_label=True``), else the synthetic set of 100 classes."""

    _classes = 100
    _seed = 45

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"),
                 fine_label=False, train=True, transform=None):
        self._fine = fine_label
        _DownloadedDataset.__init__(self, root, train, transform)

    def _get_data(self):
        p = os.path.join(self._root, "train.bin" if self._train
                         else "test.bin")
        if os.path.exists(p):
            with open(p, "rb") as f:
                raw = np.frombuffer(f.read(), dtype=np.uint8)
            rec = raw.reshape(-1, 3072 + 2)
            self._data = rec[:, 2:].reshape(-1, 3, 32, 32).transpose(
                0, 2, 3, 1)
            self._label = rec[:, 1 if self._fine else 0].astype(np.int32)
            return
        self._synthesize()


class ImageRecordDataset(Dataset):
    """The images of a RecordIO file and its ``.idx``: (HWC uint8 image,
    label), the label a float when the record holds one value."""

    def __init__(self, filename, flag=1, transform=None):
        from ....recordio import MXIndexedRecordIO

        idx_file = filename[:filename.rfind(".")] + ".idx"
        self._record = MXIndexedRecordIO(idx_file, filename, "r")
        self._flag = flag
        self._transform = transform

    def __len__(self):
        return len(self._record.keys)

    def __getitem__(self, idx):
        from ....recordio import unpack_img

        record = self._record.read_idx(self._record.keys[idx])
        header, img = unpack_img(record, self._flag)
        label = header.label
        if hasattr(label, "__len__") and len(label) == 1:
            label = float(label[0])
        img = _cpu_array(img)
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class ImageFolderDataset(Dataset):
    """``root/<class>/<image>``: classes are the sorted sub-folders, their
    index the label; ``.jpg``, ``.jpeg``, ``.png`` and ``.npy`` files."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for fname in sorted(os.listdir(path)):
                if fname.lower().endswith((".jpg", ".jpeg", ".png", ".npy")):
                    self.items.append((os.path.join(path, fname), label))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        from ....image import imread

        path, label = self.items[idx]
        if path.endswith(".npy"):
            img = _cpu_array(np.load(path))
        else:
            img = imread(path, self._flag)
        if self._transform is not None:
            return self._transform(img, label)
        return img, label
