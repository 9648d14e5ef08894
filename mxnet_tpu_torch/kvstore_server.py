"""The KVStore server role (counterpart of ``mxnet_tpu/kvstore_server.py``;
ref: python/mxnet/kvstore_server.py).

MXNet's parameter servers (``DMLC_ROLE=server``) sum the workers'
gradients and may run the update.  In the port the workers sum through
the collectives of their process group (``parallel.dist``) and each
updates itself, so a server has nothing to serve.  A launcher that still
starts server roles (``tools/launch.py -s N`` of the reference's
cluster scripts) lands in :func:`_init_kvstore_server_module` when the
script imports ``mxnet_tpu_torch``: the process parks there until the
launcher ends it, instead of running the training script as an extra
worker.
"""
from __future__ import annotations

import os
import time

__all__ = ["KVStoreServer", "_init_kvstore_server_module"]


class KVStoreServer:
    """``run()`` parks for the job's life; the launcher that started the
    server ends it (a server does not decide when the job ends)."""

    def __init__(self, kvstore=None):
        self.kvstore = kvstore

    def run(self):  # pragma: no cover - parks until killed
        from .parallel import dist

        dist.init()  # joins nothing for the server role
        while True:
            time.sleep(60)


def _init_kvstore_server_module():
    """Park a ``DMLC_ROLE=server`` process (run at the package's import
    in such a process)."""
    if os.environ.get("DMLC_ROLE") == "server":
        KVStoreServer().run()
