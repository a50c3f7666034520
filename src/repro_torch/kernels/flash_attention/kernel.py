"""ctypes wrapper of the CUDA kernel ``csrc/flash_attention_fwd.cu`` — the
Hopper port of the TPU kernel ``flash_attention_fwd``
(``repro/kernels/flash_attention/kernel.py:90``).

:func:`flash_attention_fwd` takes q ``[B,H,S,D]`` and k, v
``[B,Hkv,S,D]`` (f32 or bf16, contiguous CUDA tensors, D in 32/64/128)
and returns ``(o, lse)``: o in q's dtype and lse ``[B,H,S,1]`` in f32,
the residual the backward kernels read.  It launches on PyTorch's current
stream and never falls back to the plain version: anything the kernel
does not take raises :class:`~repro_torch.core.errors.LPFFatalError`.

``flash_attention_fwd.launches`` counts the calls that launched the
kernel (one CUDA launch each).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ...core.errors import LPFFatalError
from .. import build

__all__ = ["flash_attention_fwd", "HEAD_DIMS"]

#: head dims the kernel is instantiated for
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention_fwd")
    fn = lib.flash_attention_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, window):
    """Raise on anything the kernel does not take (the device last, so
    every other refusal can be shown without a card)."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            # a strided view ([B,S,H,D] swapped to [B,H,S,D]) is not laid
            # out as the kernel reads it: the caller makes it contiguous
            raise LPFFatalError(
                f"flash_attention_fwd takes contiguous tensors; {name} has "
                f"strides {x.stride()}")
        if x.data_ptr() % 16:
            raise LPFFatalError(
                f"flash_attention_fwd needs 16-byte aligned tensors; {name} "
                f"starts at {x.data_ptr():#x}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise LPFFatalError(
            f"flash_attention_fwd takes float32 or bfloat16 q, k, v of one "
            f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise LPFFatalError(
            f"flash_attention_fwd takes q [B,H,S,D] and k, v [B,Hkv,S,D], "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, D = q.shape
    if k.shape[0] != B or k.shape[2] != S or k.shape[3] != D \
            or H % k.shape[1]:
        raise LPFFatalError(
            f"flash_attention_fwd: k/v {tuple(k.shape)} do not match q "
            f"{tuple(q.shape)} (same B, S, D; Hkv dividing H)")
    if D not in HEAD_DIMS:
        raise LPFFatalError(
            f"flash_attention_fwd is built for head dims {HEAD_DIMS}, got "
            f"D={D}")
    if window is not None and window < 1:
        raise LPFFatalError(f"flash_attention_fwd: window must be >= 1, "
                            f"got {window}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda":
            raise LPFFatalError(
                f"flash_attention_fwd needs CUDA tensors, got {name} on "
                f"{x.device}")
    if q.device != k.device or q.device != v.device:
        raise LPFFatalError("flash_attention_fwd: q, k, v on different "
                            "devices")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B,H,S,D], k/v [B,Hkv,S,D] -> (o [B,H,S,D], lse [B,H,S,1] f32)."""
    _check(q, k, v, window)
    B, H, S, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    fn = _lib().flash_attention_fwd
    o = torch.empty_like(q)
    lse = torch.empty(B, H, S, 1, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = fn(ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
                ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(o.data_ptr()),
                ctypes.c_void_p(lse.data_ptr()), _DTYPES[q.dtype], B, H,
                k.shape[1], S, D, int(bool(causal)),
                int(window) if window is not None else 0,
                float(softcap) if softcap is not None else 0.0,
                float(scale), stream)
    if rc != 0:
        raise LPFFatalError(
            f"flash_attention_fwd failed to launch on {tuple(q.shape)} "
            f"{q.dtype}: CUDA error {rc}")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0
