"""Public wrapper of flash attention, differentiable.

:func:`flash_attention` is a :class:`torch.autograd.Function`, the
counterpart of the JAX package's ``custom_vjp`` (``repro/kernels/
flash_attention/ops.py:26-53``).  Its forward saves q, k, v, o and the
log-sum-exp ``lse``; its backward computes (dq, dk, dv) from them.

Either route first refuses, by name, shapes that neither the CUDA kernel
nor the TPU kernel it replaces computes right: keys of another length
than the queries (the TPU kernel sizes its key blocks from the query
length, so at one query it reads one key only) and values of another
width than the keys (MLA's; the TPU kernel's output takes q's shape).

A CUDA tensor goes to the CUDA kernels (:func:`.kernel.flash_attention_fwd`
forward, :func:`.kernel.flash_attention_bwd` backward) — they launch or
raise, never fall back.  A CPU tensor goes to the plain versions
(:func:`.ref.flash_attention_fwd_ref`, :func:`.ref.flash_attention_bwd_ref`)
and launches nothing.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...core.errors import LPFFatalError
from . import kernel as _k
from . import ref as _ref

__all__ = ["flash_attention"]


def _impl(device: torch.device, cuda_fn, cpu_fn):
    if device.type == "cuda":
        return cuda_fn
    if device.type == "cpu":
        return cpu_fn
    raise LPFFatalError(f"flash_attention runs on CUDA or CPU tensors, not "
                        f"{device}")


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
        # the kernels read [B,H,S,D] row-major: the model's swapped
        # [B,S,H,D] views are made contiguous here
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        fwd = _impl(q.device, _k.flash_attention_fwd,
                    _ref.flash_attention_fwd_ref)
        o, lse = fwd(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = _impl(q.device, _k.flash_attention_bwd,
                    _ref.flash_attention_bwd_ref)
        dq, dk, dv = bwd(q, k, v, o, do.contiguous(), lse, **ctx.kw)
        return dq, dk, dv, None, None, None, None


def _check_shapes(q, k, v) -> None:
    S, D = q.shape[-2], q.shape[-1]
    if k.shape[-2] != S or v.shape[-2] != S:
        raise LPFFatalError(
            f"flash_attention takes keys as long as the queries (the TPU "
            f"kernel sizes its key blocks from the query length and at "
            f"one query reads one key only): S={S}, keys {k.shape[-2]}, "
            f"values {v.shape[-2]}; run attn_impl='blocked'")
    if k.shape[-1] != D or v.shape[-1] != D:
        raise LPFFatalError(
            f"flash_attention takes q, k and v of one head dim (the TPU "
            f"kernel's output takes q's shape): q {D}, k {k.shape[-1]}, "
            f"v {v.shape[-1]}; MLA runs attn_impl='blocked'")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention: q [B,H,S,D], k/v [B,Hkv,S,D] -> [B,H,S,D]."""
    _check_shapes(q, k, v)
    return _FlashAttention.apply(q, k, v, causal, window, softcap, scale)
