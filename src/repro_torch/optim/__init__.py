"""Optimizers on PyTorch, ported from ``repro.optim``: AdamW and the local
half of gradient compression."""
from . import adamw, compress

__all__ = ["adamw", "compress"]
