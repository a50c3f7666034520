"""ctypes wrapper of the CUDA kernel ``csrc/fft_stage.cu`` — the Hopper
port of the TPU kernel ``fft_planes`` (``repro/kernels/fft_stage/kernel.py``).

:func:`fft_planes` transforms ``[batch, n]`` complex64 rows on a CUDA
device.  Where the TPU kernel took separate re/im f32 planes, this one
reads and writes interleaved complex64 (``float2``) directly; the name is
kept so each counterpart is found.  The rows go through
``len(pass_radices(n))`` Stockham passes of radix up to 16, ping-ponging
between the output and one scratch buffer allocated here.

``fft_planes.launches`` counts the calls that launched the kernel;
``fft_planes.cuda_launches`` counts the CUDA kernel launches they made.
"""

from __future__ import annotations

import ctypes
from typing import List

import torch

from ...core.errors import LPFFatalError
from .. import build

__all__ = ["fft_planes", "pass_radices"]

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_void_p]


def pass_radices(n: int) -> List[int]:
    """The radices of the passes for an ``n``-point row: the remainder
    of log2(n) mod 4 first, then radix-16 passes."""
    bits = n.bit_length() - 1
    return ([1 << (bits % 4)] if bits % 4 else []) + [16] * (bits // 4)


def _lib() -> ctypes.CDLL:
    lib = build.load("fft_stage")
    fn = lib.fft_stage_pass
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return lib


def fft_planes(x: torch.Tensor, *, inverse: bool = False) -> torch.Tensor:
    """Batched FFT of the rows of a contiguous complex64 CUDA tensor
    ``[batch, n]``, n a power of two >= 2; the inverse scales by 1/n.
    Returns a new tensor; ``x`` is not modified."""
    if x.device.type != "cuda":
        raise LPFFatalError(f"fft_planes needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.complex64 or x.ndim != 2 or not x.is_contiguous() \
            or x.is_conj() or x.is_neg():
        raise LPFFatalError(
            f"fft_planes takes a contiguous, materialised complex64 "
            f"[batch, n] tensor, got {x.dtype} {tuple(x.shape)} "
            f"contiguous={x.is_contiguous()} lazy conj/neg="
            f"{x.is_conj() or x.is_neg()}")
    batch, n = x.shape
    if n < 2 or n & (n - 1):
        raise LPFFatalError(f"fft_planes needs a power-of-two n >= 2, got {n}")
    fn = _lib().fft_stage_pass
    radices = pass_radices(n)
    out = torch.empty_like(x)
    tmp = torch.empty_like(x) if len(radices) > 1 else out
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        src, L = x, 1
        for i, radix in enumerate(radices):
            last = i == len(radices) - 1
            # the last pass writes ``out``: count back from it
            dst = out if (len(radices) - 1 - i) % 2 == 0 else tmp
            scale = 1.0 / n if inverse and last else 1.0
            rc = fn(ctypes.c_void_p(src.data_ptr()),
                    ctypes.c_void_p(dst.data_ptr()), batch, n, L, radix,
                    int(inverse), scale, stream)
            if rc != 0:
                raise LPFFatalError(
                    f"fft_stage pass {i} (radix {radix}, n={n}, "
                    f"batch={batch}) failed to launch: CUDA error {rc}")
            fft_planes.cuda_launches += 1
            src, L = dst, L * radix
    fft_planes.launches += 1
    return out


fft_planes.launches = 0
fft_planes.cuda_launches = 0
