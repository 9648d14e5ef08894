"""Library initialization: crash signal handlers and fork safety
(counterpart of ``mxnet_tpu/initialize.py``; ref: src/initialize.cc).

The reference installs SIGSEGV/SIGBUS handlers that print a C++ stack
trace (gated by ``MXNET_USE_SIGNAL_HANDLER``) and ``pthread_atfork``
handlers that stop the engine before a fork.  Here the crash trace is
:mod:`faulthandler`'s (every Python thread's stack on SIGSEGV, SIGFPE,
SIGABRT, SIGBUS and SIGILL: the useful trace of a crash in a ctypes
kernel call is the Python side that issued it), and fork safety is
:func:`lib.install_fork_handlers`, which registers ``os.register_at_fork``
hooks and builds nothing.

Runs once at package import (``mxnet_tpu_torch/__init__.py``).
"""
from __future__ import annotations

import faulthandler
import io

from . import lib
from .util import env

__all__ = ["initialize", "signal_handlers_enabled"]

_DONE = False
_FAULTHANDLER_ENABLED = False


def signal_handlers_enabled() -> bool:
    """Whether :func:`initialize` installed the crash handlers."""
    return _FAULTHANDLER_ENABLED


def initialize() -> None:
    """Idempotent library init (signal handlers and fork hooks).  Without
    a usable ``sys.stderr`` (no file descriptor) the handlers stay off
    and :func:`signal_handlers_enabled` says so."""
    global _DONE, _FAULTHANDLER_ENABLED
    if _DONE:
        return
    _DONE = True
    if env.get_bool("MXNET_USE_SIGNAL_HANDLER"):
        try:
            if not faulthandler.is_enabled():
                faulthandler.enable(all_threads=True)
            _FAULTHANDLER_ENABLED = True
        except (AttributeError, ValueError, RuntimeError,
                io.UnsupportedOperation):
            _FAULTHANDLER_ENABLED = False
    lib.install_fork_handlers()
