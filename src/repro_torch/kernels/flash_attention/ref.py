"""The plain PyTorch versions of flash attention, in f32 math.

* :func:`attention_ref` — the port of the JAX oracle
  (``repro/kernels/flash_attention/ref.py``), the model's
  ``attn_impl="reference"`` path;
* :func:`flash_attention_fwd_ref` — the same function as the CUDA kernel
  ``csrc/flash_attention_fwd.cu`` and the TPU kernel it replaces: the
  output in q's dtype and the log-sum-exp residual ``lse [B,H,S,1]`` in
  f32, with the TPU kernel's finite mask value and ``max(l, 1e-30)``
  guards.  P stays in f32 for P·V, as in the TPU kernel; ``round_p=True``
  rounds it to q's dtype first, as the CUDA kernel does for bf16 inputs
  (``l`` still sums the unrounded P in both), so ``chip_smoke.py`` can
  show that rounding's share of the kernel's error.

Both run on any device.  :mod:`.ops` takes :func:`flash_attention_fwd_ref`
only for CPU tensors; ``chip_smoke.py`` holds the CUDA kernel against it
on the card.  They materialise the full ``[B, H, S, S]`` score matrix.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["NEG_INF", "attention_ref", "flash_attention_fwd_ref"]

#: the finite mask value of the TPU kernel (``kernel.py:24``)
NEG_INF = -1e30


def _scores(q, k, causal, window, softcap, scale):
    """f32 masked scores ``[B, H, S, S]``; K repeated over each GQA group."""
    B, H, S, D = q.shape
    group = H // k.shape[1]
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(S, device=q.device)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= (pos[:, None] - pos[None, :]) < window
    return s.masked_fill(~mask, NEG_INF)


def _repeat_kv(v, group):
    return v.repeat_interleave(group, dim=1) if group > 1 else v


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, H, S, D]; k, v: [B, Hkv, S, D] -> [B, H, S, D].  f32 math."""
    s = _scores(q, k, causal, window, softcap, scale)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    v = _repeat_kv(v, q.shape[1] // v.shape[1])
    return torch.matmul(p, v.float()).to(q.dtype)


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None,
                            scale: Optional[float] = None,
                            round_p: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function: q [B,H,S,D], k/v [B,Hkv,S,D] -> (o
    [B,H,S,D] in q's dtype, lse [B,H,S,1] f32)."""
    s = _scores(q, k, causal, window, softcap, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if round_p:
        p = p.to(q.dtype).float()
    v = _repeat_kv(v, q.shape[1] // v.shape[1])
    o = torch.matmul(p, v.float()) / l
    return o.to(q.dtype), m + torch.log(l)
