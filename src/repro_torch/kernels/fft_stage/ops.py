"""Complex-tensor wrapper for the local FFT kernel.

A CUDA tensor goes to the CUDA kernel (:func:`.kernel.fft_planes`) — it
launches or raises, never falls back.  A CPU tensor goes to the plain
version (:func:`.ref.stockham`).  The kernel computes in complex64:
complex128 input raises instead of losing precision silently (use
``torch.fft`` for full precision).
"""

from __future__ import annotations

import torch

from . import kernel as _k
from . import ref as _ref

__all__ = ["fft", "ifft"]


def _run(x, inverse: bool) -> torch.Tensor:
    x = torch.as_tensor(x)
    if not x.is_complex():
        x = x.to(torch.complex64)
    if x.dtype != torch.complex64:
        raise TypeError(
            f"fft_stage computes in complex64; got {x.dtype} (a cast would "
            f"lose precision silently — use torch.fft for complex128)")
    shape = x.shape
    rows = x.reshape(-1, shape[-1])
    if x.device.type == "cuda":
        # a lazy conjugate/negative view (torch.conj) is not in memory yet:
        # materialise it before the kernel reads the raw pointer
        rows = rows.resolve_conj().resolve_neg().contiguous()
        y = _k.fft_planes(rows, inverse=inverse)
    elif x.device.type == "cpu":
        y = _ref.stockham(rows, inverse=inverse)
    else:
        raise TypeError(f"fft_stage runs on CUDA or CPU tensors, not "
                        f"{x.device}")
    return y.reshape(shape)


def fft(x) -> torch.Tensor:
    """FFT along the last axis (power-of-two length)."""
    return _run(x, inverse=False)


def ifft(x) -> torch.Tensor:
    """Inverse FFT along the last axis, scaled by 1/n."""
    return _run(x, inverse=True)
