"""Framework-internal utilities (the knob registry)."""
from . import env

__all__ = ["env"]
