"""The plain PyTorch version of ``fft_stage``: a radix-2 Stockham FFT (no
bit reversal) in torch ops on complex tensors — the stage algebra of the
TPU kernel's ``_fft_body``.  It runs on any device; :mod:`.ops` takes it
only for CPU tensors, and ``chip_smoke.py`` holds the CUDA kernel against
it on the card.

Stage invariant: after the stage that reaches sub-transform length ``L``
the row viewed as ``[n/L, L]`` holds, in row ``r``, the L-point DFT of
the stride-``n/L`` subsequence ``x[r::n/L]``.  Twiddles are computed in
float64 and rounded to the input's precision.
"""

from __future__ import annotations

import math

import torch

__all__ = ["fft_ref", "ifft_ref", "stockham"]


def stockham(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """FFT along the last axis (power-of-two length); the inverse scales
    by 1/n."""
    shape = x.shape
    n = shape[-1]
    if n < 1 or n & (n - 1):
        raise ValueError(f"radix-2 FFT needs a power-of-two n, got {n}")
    sign = 1.0 if inverse else -1.0
    y = x.reshape(-1, n, 1)
    L = 1
    while L < n:
        d = n // (2 * L)
        v = y.reshape(-1, 2, d, L)
        a, b = v[:, 0], v[:, 1]                       # [rows, d, L]
        ang = torch.arange(L, dtype=torch.float64, device=x.device) \
            * (sign * math.pi / L)
        w = torch.polar(torch.ones_like(ang), ang).to(x.dtype)
        tb = b * w
        y = torch.cat([a + tb, a - tb], dim=2)        # [rows, d, 2L]
        L *= 2
    y = y.reshape(shape)
    return y / n if inverse else y


def fft_ref(x: torch.Tensor) -> torch.Tensor:
    return stockham(x, inverse=False)


def ifft_ref(x: torch.Tensor) -> torch.Tensor:
    return stockham(x, inverse=True)
