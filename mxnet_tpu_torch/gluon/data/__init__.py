"""Gluon data API of the port (counterpart of ``mxnet_tpu/gluon/data``):
datasets, samplers and the single-process DataLoader."""
from .dataset import ArrayDataset, Dataset, SimpleDataset
from .sampler import BatchSampler, RandomSampler, Sampler, SequentialSampler
from .dataloader import DataLoader
from . import vision

__all__ = ["Dataset", "ArrayDataset", "SimpleDataset", "Sampler",
           "SequentialSampler", "RandomSampler", "BatchSampler",
           "DataLoader", "vision"]
