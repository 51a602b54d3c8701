"""Synthetic data sources and the MoLe provider stage (numpy only), copied
from ``repro.data``."""
from .pipeline import DataConfig, Pipeline, ProviderStage, SyntheticLM

__all__ = ["DataConfig", "Pipeline", "ProviderStage", "SyntheticLM"]
