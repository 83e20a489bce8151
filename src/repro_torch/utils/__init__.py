"""Shared utilities: logging, timing, registries, LRU caches, devices."""
from repro_torch.utils.device import resolve_device
from repro_torch.utils.logging import get_logger
from repro_torch.utils.registry import Registry
from repro_torch.utils.timing import time_callable

__all__ = ["get_logger", "Registry", "resolve_device", "time_callable"]
