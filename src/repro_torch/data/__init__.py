"""Deterministic synthetic data: a pure function of (seed, step)."""
from .pipeline import DataConfig, SyntheticStream
__all__ = ["DataConfig", "SyntheticStream"]
