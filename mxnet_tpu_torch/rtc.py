"""mx.rtc: CUDA runtime compilation (counterpart of ``mxnet_tpu/rtc.py``;
ref: python/mxnet/rtc.py).

The JAX package keeps the reference's ``CudaModule``/``CudaKernel`` as
names that raise, and so does the port.  Its route for a kernel of your
own is a CUDA source under ``mxnet_tpu_torch/csrc/``, compiled by nvcc at
first use and bound through ctypes by ``_kernels.py`` (the port's
kernels are built that way), or an operator written in Python with
``mx.operator.CustomOp``.  The names stay so that code importing
``mx.rtc`` fails where it is used, with this message, not at import.
"""
from __future__ import annotations

from .base import MXNetError

__all__ = ["CudaModule", "CudaKernel"]

_MSG = ("mx.rtc (NVRTC runtime compilation) is not provided by "
        "mxnet_tpu_torch: write the kernel as a CUDA source under "
        "mxnet_tpu_torch/csrc/, built by nvcc at first use and bound by "
        "mxnet_tpu_torch/_kernels.py, or write the operator in Python with "
        "mx.operator.CustomOp")


class CudaModule:
    def __init__(self, *args, **kwargs):
        raise MXNetError(_MSG)


class CudaKernel:
    def __init__(self, *args, **kwargs):
        raise MXNetError(_MSG)
