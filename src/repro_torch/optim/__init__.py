"""Optimizers: AdamW and the warmup-cosine schedule (the JAX package's
``repro.optim``).  Adafactor and error-feedback gradient compression are
not on the one-card training path yet (ROADMAP A9)."""

import math

from .adamw import AdamWConfig, adamw_init, adamw_update, global_norm


def warmup_cosine(peak: float, warmup: int, total: int, floor: float = 0.1):
    """Standard warmup + cosine decay schedule: ``lr(step) -> float``."""
    def lr(step) -> float:
        s = float(step)
        if s < warmup:
            return peak * s / max(warmup, 1)
        frac = min(max((s - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return peak * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi
                                                                  * frac)))
    return lr


__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "warmup_cosine"]
