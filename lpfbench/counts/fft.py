"""Least times of complex64 FFTs (copied from the port's chip script's
``fft_bound_ms``): read and write every value once at the memory rate,
or do 5 n log2 n float32 operations per row at the float32 peak,
whichever is longer."""

from __future__ import annotations

import math

from .peaks import FP32_FLOPS, HBM_BYTES_PER_S

ITEMSIZE = 8        # complex64


def fft_bound_ms(batch: int, n: int) -> tuple:
    """(least ms, "bytes" or "operations") of ``batch`` n-point
    transforms."""
    t_bytes = 2 * batch * n * ITEMSIZE / HBM_BYTES_PER_S
    t_ops = batch * 5.0 * n * math.log2(n) / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def transform_bound_ms(n: int) -> float:
    """Least ms of one whole n-point transform, whatever computes it."""
    return fft_bound_ms(1, n)[0]
