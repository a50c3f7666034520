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
  show that rounding's share of the kernel's error;
* :func:`flash_attention_bwd_ref` — the same function as the CUDA
  kernels ``csrc/flash_attention_bwd.cu`` and the two TPU backward
  kernels they replace: ``(dq, dk, dv)`` from q, k, v, o, dO and ``lse``,
  with dK/dV computed per query head and summed over each GQA group in
  f32.  ``round_p=True`` rounds P and dS to q's dtype before their
  products, as the CUDA kernels do for bf16 inputs.

All run on any device.  :mod:`.ops` takes the plain versions only for CPU
tensors; ``chip_smoke.py`` holds the CUDA kernels against them on the
card.  They materialise the full ``[B, H, S, S]`` score matrix.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["NEG_INF", "attention_ref", "flash_attention_fwd_ref",
           "flash_attention_bwd_ref"]

#: the finite mask value of the TPU kernel (``kernel.py:24``)
NEG_INF = -1e30


def _mask(S, causal, window, device):
    """The kept (query, key) pairs ``[S, S]``."""
    pos = torch.arange(S, device=device)
    mask = torch.ones(S, S, dtype=torch.bool, device=device)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= (pos[:, None] - pos[None, :]) < window
    return mask


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
    return s.masked_fill(~_mask(S, causal, window, q.device), NEG_INF)


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


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, lse: torch.Tensor, *,
                            causal: bool = True,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None,
                            scale: Optional[float] = None,
                            round_p: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The backward kernels' function (``repro/kernels/flash_attention/
    kernel.py:250``): from q [B,H,S,D], k/v [B,Hkv,S,D], the forward's o
    and lse [B,H,S,1] and the output gradient dO, return (dq in q's dtype,
    dk in k's, dv in v's).  f32 math::

        delta = rowsum(dO * o);  P = where(mask, exp(s - lse), 0)
        dV = P^T dO;  dP = dO V^T;  dS = P (dP - delta) [(1 - t^2) soft-cap]
        dK = dS^T (Q scale);  dQ = dS K scale
    """
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    group = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qs = q.float() * scale
    kf = _repeat_kv(k, group).float()
    vf = _repeat_kv(v, group).float()
    dof = do.float()
    s = torch.matmul(qs, kf.transpose(-1, -2))
    dcap = None
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = softcap * t
        dcap = 1.0 - t * t
    mask = _mask(S, causal, window, q.device)
    p = torch.where(mask, torch.exp(s - lse), 0.0)
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)

    def mm(x):
        # the CUDA kernels feed P and dS to bf16 tensor cores
        return x.to(q.dtype).float() if round_p else x

    dv_h = torch.matmul(mm(p).transpose(-1, -2), dof)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)
    if dcap is not None:
        ds = ds * dcap
    ds = mm(ds)
    dk_h = torch.matmul(ds.transpose(-1, -2), qs)
    dq = torch.matmul(ds, kf) * scale
    dk = dk_h.reshape(B, Hkv, group, S, D).sum(dim=2)
    dv = dv_h.reshape(B, Hkv, group, S, D).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
