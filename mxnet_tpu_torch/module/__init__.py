"""The Module API (counterpart of ``mxnet_tpu/module``): ``BaseModule``'s
``fit``/``score``/``predict`` loop over ``Module``, which trains a symbol
through one ``GraphExecutor`` (``DataParallelExecutorGroup`` over one
context), and ``BucketingModule``, one ``Module`` per bucket over shared
parameters."""
from .base_module import BaseModule
from .bucketing_module import BucketingModule
from .executor_group import DataParallelExecutorGroup
from .module import Module

__all__ = ["BaseModule", "Module", "BucketingModule",
           "DataParallelExecutorGroup"]
