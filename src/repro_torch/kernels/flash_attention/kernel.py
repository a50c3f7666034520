"""ctypes wrappers of the CUDA kernels ``csrc/flash_attention_fwd.cu`` and
``csrc/flash_attention_bwd.cu`` — the Hopper ports of the TPU kernels
``flash_attention_fwd`` and ``flash_attention_bwd``
(``repro/kernels/flash_attention/kernel.py:90`` and ``:250``).

* :func:`flash_attention_fwd` takes q ``[B,H,S,D]`` and k, v
  ``[B,Hkv,S,D]`` (f32 or bf16, contiguous CUDA tensors, D in
  :data:`HEAD_DIMS`)
  and returns ``(o, lse)``: o in q's dtype and lse ``[B,H,S,1]`` in f32,
  the residual the backward kernels read;
* :func:`flash_attention_bwd` takes the same q, k, v, the forward's o and
  lse and the output gradient dO (like o) and returns ``(dq, dk, dv)`` in
  q's, k's and v's dtype.  It computes ``delta = rowsum(dO * o)`` with
  torch (as the JAX package computes it outside its two pallas_calls),
  then launches :func:`flash_attention_bwd_dkv` (dK and dV, summed over
  each GQA group inside the kernel) and :func:`flash_attention_bwd_dq`.

Each launches on PyTorch's current stream and never falls back to the
plain version: anything a kernel does not take raises
:class:`~repro_torch.core.errors.LPFFatalError`.  ``<wrapper>.launches``
counts the calls that launched that wrapper's kernel (one CUDA launch
each).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ...core.errors import LPFFatalError
from .. import build

__all__ = ["flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dq", "HEAD_DIMS"]

#: head dims the kernels are instantiated for, forward and backward
HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
# q, k, v, dO, lse, delta, outputs..., dtype, B, H, Hkv, S, D, causal,
# window, softcap, scale, stream
_BWD_ARGTYPES = {
    "flash_attention_bwd_dkv": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                                + [ctypes.c_float] * 2 + [ctypes.c_void_p]),
    "flash_attention_bwd_dq": ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                               + [ctypes.c_float] * 2 + [ctypes.c_void_p]),
}


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention_fwd")
    fn = lib.flash_attention_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return lib


def _check(fn, window, q, k, v, **extra):
    """Raise on anything kernel ``fn`` does not take (the device last, so
    every other refusal can be shown without a card).  ``extra``: the
    backward's o, dO (shaped like q, in q's dtype), lse ``[B,H,S,1]`` and
    delta ``[B,H,S]`` (f32)."""
    tensors = dict(q=q, k=k, v=v, **extra)
    stats = ("lse", "delta")
    for name, x in tensors.items():
        if not x.is_contiguous():
            # a strided view ([B,S,H,D] swapped to [B,H,S,D]) is not laid
            # out as the kernel reads it: the caller makes it contiguous
            raise LPFFatalError(
                f"{fn} takes contiguous tensors; {name} has strides "
                f"{x.stride()}")
        if x.data_ptr() % 16:
            raise LPFFatalError(
                f"{fn} needs 16-byte aligned tensors; {name} starts at "
                f"{x.data_ptr():#x}")
    io = {n: x for n, x in tensors.items() if n not in stats}
    if q.dtype not in _DTYPES or any(x.dtype != q.dtype for x in io.values()):
        raise LPFFatalError(
            f"{fn} takes float32 or bfloat16 {', '.join(io)} of one dtype, "
            f"got {', '.join(str(x.dtype) for x in io.values())}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise LPFFatalError(
            f"{fn} takes q [B,H,S,D] and k, v [B,Hkv,S,D], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, D = q.shape
    if k.shape[0] != B or k.shape[2] != S or k.shape[3] != D \
            or H % k.shape[1]:
        raise LPFFatalError(
            f"{fn}: k/v {tuple(k.shape)} do not match q {tuple(q.shape)} "
            f"(same B, S, D; Hkv dividing H)")
    for name in ("o", "do"):
        if name in extra and extra[name].shape != q.shape:
            raise LPFFatalError(f"{fn}: {name} {tuple(extra[name].shape)} "
                                f"is not shaped like q {tuple(q.shape)}")
    for name, shape in (("lse", (B, H, S, 1)), ("delta", (B, H, S))):
        x = extra.get(name)
        if x is not None and (x.dtype != torch.float32 or x.shape != shape):
            raise LPFFatalError(
                f"{fn}: {name} must be float32 {shape}, got {x.dtype} "
                f"{tuple(x.shape)}")
    if D not in HEAD_DIMS:
        raise LPFFatalError(
            f"{fn} is built for head dims {HEAD_DIMS}, got D={D}")
    if window is not None and window < 1:
        raise LPFFatalError(f"{fn}: window must be >= 1, got {window}")
    for name, x in tensors.items():
        if x.device.type != "cuda":
            raise LPFFatalError(
                f"{fn} needs CUDA tensors, got {name} on {x.device}")
    if any(x.device != q.device for x in tensors.values()):
        raise LPFFatalError(f"{fn}: {', '.join(tensors)} on different "
                            f"devices")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B,H,S,D], k/v [B,Hkv,S,D] -> (o [B,H,S,D], lse [B,H,S,1] f32)."""
    _check("flash_attention_fwd", window, q, k, v)
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


def _bwd_lib(name: str) -> ctypes.CDLL:
    lib = build.load("flash_attention_bwd")
    fn = getattr(lib, name)
    fn.argtypes = _BWD_ARGTYPES[name]
    fn.restype = ctypes.c_int
    return lib


def _bwd_launch(name: str, q, k, v, do, lse, delta, outs, causal, window,
                softcap, scale) -> None:
    """Launch backward kernel ``name`` writing ``outs`` on q's device."""
    B, H, S, D = q.shape
    fn = getattr(_bwd_lib(name), name)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    with torch.cuda.device(q.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = fn(ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta),
                *map(ptr, outs), _DTYPES[q.dtype], B, H, k.shape[1], S, D,
                int(bool(causal)), int(window) if window is not None else 0,
                float(softcap) if softcap is not None else 0.0,
                float(scale), stream)
    if rc != 0:
        raise LPFFatalError(f"{name} failed to launch on {tuple(q.shape)} "
                            f"{q.dtype}: CUDA error {rc}")


def flash_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, do: torch.Tensor,
                            lse: torch.Tensor, delta: torch.Tensor, *,
                            causal: bool = True,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B,Hkv,S,D] in k's dtype, summed over each GQA group."""
    _check("flash_attention_bwd_dkv", window, q, k, v, do=do, lse=lse,
           delta=delta)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch("flash_attention_bwd_dkv", q, k, v, do, lse, delta,
                (dk, dv), causal, window, softcap, scale)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, do: torch.Tensor,
                           lse: torch.Tensor, delta: torch.Tensor, *,
                           causal: bool = True,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """dq [B,H,S,D] in q's dtype."""
    _check("flash_attention_bwd_dq", window, q, k, v, do=do, lse=lse,
           delta=delta)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    dq = torch.empty_like(q)
    _bwd_launch("flash_attention_bwd_dq", q, k, v, do, lse, delta, (dq,),
                causal, window, softcap, scale)
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, o, dO [B,H,S,D], k/v [B,Hkv,S,D], lse [B,H,S,1] -> (dq, dk,
    dv): both backward kernels, on the forward's residuals."""
    _check("flash_attention_bwd", window, q, k, v, o=o, do=do, lse=lse)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    delta = (do.float() * o.float()).sum(dim=-1)     # [B,H,S] f32
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dq.launches = 0
