"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu.

A second package beside the JAX one, with its module names and
structure, in PyTorch's idiom: blocks are ``nn.Module``s, ops are plain
functions on tensors, devices are explicit and random draws take an
explicit ``torch.Generator``.  Every Pallas kernel of the JAX package
on a ported path is a hand-written CUDA kernel for Hopper (``csrc/``),
built with nvcc at first use.  The port imports neither jax nor
anything of ``mxnet_tpu``.

Slice 1 serves ResNet V1 (``gluon.model_zoo.vision``) through
``contrib.deploy`` and ``serving``; slice 2 trains it through
``parallel.SPMDTrainer``; slice 3 serves BERT-base; slice 4 trains
ResNet V1 data parallel over a process group (``dist``); slice 9 adds
MXNet's imperative surface: ``nd`` (NDArray and the op registry),
``autograd`` over ``torch.autograd``, ``gluon.Trainer`` with
``Parameter``/``ParameterDict``, the local ``kvstore``, ``metric`` and
``gluon.data`` (see ``examples/mnist.py``); slice 13 adds MXNet's
symbolic half: ``sym`` (Symbol and its executor), ``mod`` (Module),
``io``, ``lr_scheduler``, ``callback``, ``model`` and
``gluon.SymbolBlock``; slice 17 adds MXNet's imperative op surface: the
rest of the tensor, unary and nn ops, the NDArray methods, ``nd.random``
and ``mx.random``'s samplers, and ``autograd.Function``; slice 18 adds
the recurrent path: the ``RNN`` and ``CTCLoss`` ops, ``gluon.rnn``, the
legacy ``rnn`` cells and ``BucketSentenceIter``, ``mod.BucketingModule``
and ``contrib.amp`` (see ``examples/rnn_bucketing.py``); slice 19 adds
MXNet's core runtime: ``Context`` with its ``with ctx:`` scope, the
linalg ops, sparse NDArrays (``nd.sparse``) with lazy updates,
``kv.row_sparse_pull``, ``io.LibSVMIter``, ``util.env``, ``engine``
and ``resource``; slice 21 adds the image data path: ``recordio``, ``image``
(``ImageIter``, ``ImageDetIter``), ``nd.image``, ``io.ImageRecordIter``
over the native decode pipeline (``lib``, built from ``native/`` with
g++), the record and folder datasets and ``tools/im2rec.py`` (see
``examples/imagenet_train.py``); slice 23 adds user-defined operators
(``operator``, the ``Custom`` op), ``contrib.foreach``/``while_loop``/
``cond`` and ``contrib.onnx``; slice 24 adds ``profiler`` (op records
and a CUDA device trace), ``monitor`` (``Module.install_monitor``),
``visualization``, ``test_utils``, ``runtime``, ``storage``,
``initialize`` and ``rtc`` (see ``examples/bert_pretrain.py`` and
``examples/transformer_nmt.py``); slice 25 adds MXNet's data-parallel
API: parameters replicated over several contexts, the ``device`` and
dist ``kvstore``s (``kvstore_compression``, ``kvstore_server``), the
``spmd=True`` step's ``optimizer.SpmdUpdater`` and ``optimizer.comm``,
``Module`` over several contexts and ``tools/launch.py``; slice 28 adds
serving's production front end: ``serving.serve_http``, the circuit
breaker, retry and chaos (``resilience``), rollover and drain, over the
metrics, tracing and alert core of ``telemetry``.
"""
from __future__ import annotations

import os as _os

from .base import MXNetError

__version__ = "0.1.0"
from . import context, util
from .context import (Context, cpu, cpu_pinned, cpu_shared, current_context,
                      gpu, num_gpus, tpu)
from . import initializer
from . import initializer as init
from . import ops, serialization
from . import parallel
from .parallel import dist
from . import autograd, kvstore, metric, ndarray, optimizer, random
from . import kvstore as kv
from . import engine, resource
from . import ndarray as nd
from .ndarray import NDArray
from . import gluon
from . import attribute, callback, io, lr_scheduler, model, name
from . import symbol
from . import symbol as sym
from . import module
from . import module as mod
from . import contrib, rnn
from . import image, lib, recordio
from . import operator
from . import profiler, storage
from . import resilience, telemetry
from . import monitor, rtc, runtime, test_utils, visualization
from . import monitor as mon
from . import visualization as viz
from . import initialize as _initialize
from .attribute import AttrScope
from .ndarray import waitall

_initialize.initialize()

if _os.environ.get("DMLC_ROLE") == "server":
    # a server-role process parks here until its launcher ends the job
    # (kvstore_server): it must not run the training script as a worker
    from . import kvstore_server as _kvstore_server

    _kvstore_server._init_kvstore_server_module()

__all__ = ["MXNetError", "Context", "context", "cpu", "gpu", "tpu",
           "cpu_pinned", "cpu_shared", "num_gpus", "current_context",
           "util", "kv", "engine", "resource",
           "initializer", "init", "ops", "serialization", "parallel", "dist",
           "autograd", "kvstore", "metric", "ndarray", "nd", "NDArray",
           "optimizer", "random", "gluon", "attribute", "AttrScope",
           "callback", "io", "lr_scheduler", "model", "name", "symbol",
           "sym", "module", "mod", "contrib", "rnn", "image", "lib",
           "recordio", "operator", "profiler", "storage", "monitor", "mon",
           "rtc", "runtime", "test_utils", "visualization", "viz",
           "waitall", "resilience", "telemetry", "__version__"]
