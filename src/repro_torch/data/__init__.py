"""Synthetic data sources (numpy only), copied from ``repro.data``."""
from .pipeline import DataConfig, SyntheticLM

__all__ = ["DataConfig", "SyntheticLM"]
