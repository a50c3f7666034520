"""The plain PyTorch version of ``fft_stage``: a radix-2 Stockham FFT (no
bit reversal) in torch ops on complex tensors — the stage algebra of the
TPU kernel's ``_fft_body``.  It runs on any device; :mod:`.ops` takes it
only for CPU tensors, and ``chip_smoke.py`` holds the CUDA kernel against
it on the card.

Stage invariant: after the stage that reaches sub-transform length ``L``
the row viewed as ``[n/L, L]`` holds, in row ``r``, the L-point DFT of
the stride-``n/L`` subsequence ``x[r::n/L]``.  Twiddles are computed in
float64 and rounded to the input's precision.

:func:`four_step` is the CUDA kernel's decomposition in plain torch ops,
pass by pass as ``kernel.pass_plan`` gives it; the tests hold it against
the JAX kernel and ``np.fft`` (the port's ``ops`` never calls it).
"""

from __future__ import annotations

import math

import torch

__all__ = ["fft_ref", "four_step", "ifft_ref", "stockham"]


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


def _dft(v: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Unscaled DFT along the last axis (``stockham``'s 1/t undone: a
    power of two, so exactly)."""
    y = stockham(v, inverse=inverse)
    return y * v.shape[-1] if inverse else y


def four_step(x: torch.Tensor, plan, inverse: bool = False) -> torch.Tensor:
    """FFT along the last axis through the passes of ``plan`` (a list of
    ``kernel.FFTPass``), as the CUDA kernel computes it: sub-transforms by
    :func:`stockham`, a col pass's twiddles w_{t a}^{i k} from the exact
    integer i * k in float64, the row pass's output order
    ``d1 + r1 * dm + s * k``, and the inverse's 1/n in the last store."""
    shape = x.shape
    n = shape[-1]
    y = x.reshape(-1, n)
    rows = y.shape[0]
    sign = 1.0 if inverse else -1.0
    for i, p in enumerate(plan):
        if p.kind == "col":
            v = y.reshape(rows * p.s, p.t, p.a).transpose(1, 2)  # [., a, j]
            f = _dft(v, inverse)                                 # [., a, k]
            e = torch.outer(torch.arange(p.a, dtype=torch.int64),
                            torch.arange(p.t, dtype=torch.int64))
            ang = e.to(torch.float64) * (sign * 2.0 * math.pi / (p.t * p.a))
            w = torch.polar(torch.ones_like(ang), ang).to(x.dtype)
            y = (f * w.to(x.device)).transpose(1, 2).reshape(rows, n)
        else:
            f = _dft(y.reshape(rows, p.r1, p.m, p.t), inverse)
            # [row, d1, dm, k] to d1 + r1 * dm + s * k
            y = f.permute(0, 3, 2, 1).reshape(rows, n)
            if inverse and i == len(plan) - 1:
                y = y / n
    return y.reshape(shape)


def fft_ref(x: torch.Tensor) -> torch.Tensor:
    return stockham(x, inverse=False)


def ifft_ref(x: torch.Tensor) -> torch.Tensor:
    return stockham(x, inverse=True)
