"""Shared helpers: environment reads and device selection."""

from .device import resolve_device
from .retry import env_float, env_int

__all__ = ["env_float", "env_int", "resolve_device"]
