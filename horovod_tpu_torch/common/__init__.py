"""Shared helpers: environment reads, device selection, the process
lifecycle (``basics``) and the framework exceptions."""

from .device import resolve_device
from .retry import env_float, env_int

__all__ = ["env_float", "env_int", "resolve_device"]
