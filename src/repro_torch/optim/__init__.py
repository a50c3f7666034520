"""Optimizers and gradient compression (the JAX package's
``repro.optim``): AdamW, Adafactor, error-feedback int8 compression and
the warmup-cosine schedule."""

import math

from .adafactor import AdafactorConfig, adafactor_init, adafactor_update
from .adamw import AdamWConfig, adamw_init, adamw_update, global_norm
from .compress import ef_compress, ef_decompress, ef_init


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
           "AdafactorConfig", "adafactor_init", "adafactor_update",
           "ef_compress", "ef_decompress", "ef_init", "warmup_cosine"]
