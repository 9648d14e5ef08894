"""Gluon data API of the port (counterpart of ``mxnet_tpu/gluon/data``):
datasets, samplers, the DataLoader with its thread and process worker
pools, and the vision datasets and transforms."""
from .dataset import ArrayDataset, Dataset, RecordFileDataset, SimpleDataset
from .sampler import BatchSampler, RandomSampler, Sampler, SequentialSampler
from .dataloader import DataLoader, WorkerDied
from . import vision

__all__ = ["Dataset", "ArrayDataset", "SimpleDataset", "RecordFileDataset",
           "Sampler", "SequentialSampler", "RandomSampler", "BatchSampler",
           "DataLoader", "WorkerDied", "vision"]
