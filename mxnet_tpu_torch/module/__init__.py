"""The Module API (counterpart of ``mxnet_tpu/module``): ``BaseModule``'s
``fit``/``score``/``predict`` loop over ``Module``, which trains a symbol
through one ``GraphExecutor`` (``DataParallelExecutorGroup`` over one
context).  ``BucketingModule`` is not ported (ROADMAP queue A item 6)."""
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup
from .module import Module

__all__ = ["BaseModule", "Module", "DataParallelExecutorGroup"]
