"""The legacy data-iterator API (counterpart of ``mxnet_tpu/io``):
``DataDesc``, ``DataBatch``, ``DataIter`` and the iterators
``NDArrayIter``, ``CSVIter``, ``MNISTIter``, ``ResizeIter``,
``PrefetchingIter`` and ``LibSVMIter`` (CSR batches).  Batches are
NDArrays on the CPU; the executor copies them to its device.
``ImageRecordIter`` is not ported and raises."""
from .io import (CSVIter, DataBatch, DataDesc, DataIter, ImageRecordIter,
                 LibSVMIter, MNISTIter, NDArrayIter, PrefetchingIter,
                 ResizeIter)

__all__ = ["DataBatch", "DataDesc", "DataIter", "NDArrayIter", "CSVIter",
           "MNISTIter", "ImageRecordIter", "ResizeIter", "PrefetchingIter",
           "LibSVMIter"]
