"""Public wrapper of flash attention (forward only).

A CUDA tensor goes to the CUDA kernel (:func:`.kernel.flash_attention_fwd`)
— it launches or raises, never falls back.  A CPU tensor goes to the plain
version (:func:`.ref.flash_attention_fwd_ref`).  Inputs that require a
gradient raise: the backward kernels are ROADMAP B3, and the plain version
is never differentiated in their place.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...core.errors import LPFFatalError
from . import kernel as _k
from . import ref as _ref

__all__ = ["flash_attention"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention: q [B,H,S,D], k/v [B,Hkv,S,D] -> [B,H,S,D]."""
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise LPFFatalError(
            "flash_attention is forward-only in the port: its backward "
            "kernels (flash_attention_bwd) are ROADMAP B3")
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if q.device.type == "cuda":
        o, _lse = _k.flash_attention_fwd(q.contiguous(), k.contiguous(),
                                         v.contiguous(), **kw)
    elif q.device.type == "cpu":
        o, _lse = _ref.flash_attention_fwd_ref(q, k, v, **kw)
    else:
        raise LPFFatalError(f"flash_attention runs on CUDA or CPU tensors, "
                            f"not {q.device}")
    return o
