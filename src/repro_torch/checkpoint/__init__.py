"""Checkpointing: atomic, async."""
from .store import AsyncCheckpointer, latest_step, restore, save
__all__ = ["AsyncCheckpointer", "latest_step", "restore", "save"]
