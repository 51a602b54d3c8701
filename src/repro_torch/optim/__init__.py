"""Optimizers on PyTorch, ported from ``repro.optim``."""
from . import adamw

__all__ = ["adamw"]
