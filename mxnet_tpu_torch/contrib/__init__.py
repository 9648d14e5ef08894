"""Contrib of the port: ``deploy`` (artifacts for serving)."""
from . import deploy

__all__ = ["deploy"]
