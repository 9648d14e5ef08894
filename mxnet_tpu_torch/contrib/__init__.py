"""Contrib of the port: ``deploy`` (artifacts for serving) and ``amp``
(mixed precision in bfloat16)."""
from . import amp, deploy

__all__ = ["amp", "deploy"]
