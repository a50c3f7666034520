"""Attention for prefill and single-token decode on one device.

* :func:`blocked_attention` — online softmax over query chunks in plain
  PyTorch (never the full ``[S, S]`` scores at once): bf16 operands,
  f32 scores and softmax, ``p`` cast to v's dtype before ``p @ v`` — the
  JAX package's default ``attn_impl``;
* ``attn_impl="flash"`` — :func:`repro_torch.kernels.flash_attention.ops
  .flash_attention`, the hand-written CUDA kernel on a CUDA tensor;
* ``attn_impl="reference"`` — the f32 oracle
  :func:`~repro_torch.kernels.flash_attention.ref.attention_ref`;
* :func:`_partial_softmax` / :func:`merge_partials` — the (m, l, o)
  partials the decode step merges (cache, then the new token).

The JAX package's :func:`decode_attention` shards the KV cache over a
mesh's data and model axes; one card has none, and it raises (ROADMAP
A10, its multi-GPU part).

Two limits of the JAX package's attention hold here too, each refused by
name where the JAX package fails or goes silently wrong:

* :func:`blocked_attention` builds its mask from the query length, so
  keys as many as the queries, or a single query (a decode step's
  cross-attention, whose one-row mask broadcasts over every key); other
  key lengths fail in the JAX package and raise here;
* the flash kernel sizes its key blocks from the query length: the JAX
  kernel at one query reads one key only, the CUDA kernel takes only
  ``Skv == S``, and ``attn_impl="flash"`` refuses every other key length
  (and values narrower or wider than the keys, MLA's) on both devices.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.errors import LPFFatalError
from ..kernels.flash_attention import ops as _flash_ops
from ..kernels.flash_attention import ref as _flash_ref

__all__ = ["blocked_attention", "decode_attention", "attention",
           "merge_partials"]

NEG_INF = _flash_ref.NEG_INF


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      softcap: Optional[float] = None,
                      scale: Optional[float] = None,
                      q_chunk: int = 512) -> torch.Tensor:
    """q [B, S, H, D]; k [B, S, Hkv, D], v [B, S, Hkv, Dv] -> [B, S, H,
    Dv].  A single query (S = 1) takes keys of any length, all of them
    unmasked.

    Loops over query chunks; scores per chunk are [B, Hkv, g, qc, S].
    GQA folds the head groups instead of repeating K/V."""
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if Skv != S and S != 1:
        raise LPFFatalError(
            f"blocked_attention builds its mask from the query length, as "
            f"the JAX package's does: {S} queries take {S} keys (or one "
            f"query any number), got {Skv}")
    group = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qc = min(q_chunk, S)
    nq = -(-S // qc)
    pad = nq * qc - S
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
    q5 = q.reshape(B, nq, qc, Hkv, group, D)
    # bf16 products are exact in f32: f32 operands give the f32 scores
    # that the JAX package asks of its bf16 einsum
    kf, vf = k.float(), v.float()
    # the JAX package's mask, [qc, S]: at S = 1 it broadcasts over the keys
    k_pos = torch.arange(S, device=q.device)
    outs = []
    for i in range(nq):
        s = torch.einsum("bqhgd,bkhd->bhgqk", q5[:, i].float(), kf) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        q_pos = i * qc + torch.arange(qc, device=q.device)
        mask = torch.ones(qc, S, dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            mask &= (q_pos[:, None] - k_pos[None, :]) < window
        s = s.masked_fill(~mask, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        p = (p / l.clamp_min(1e-30)).to(v.dtype)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p.float(), vf)
        outs.append(o.to(v.dtype))
    out = torch.stack(outs, dim=1).reshape(B, nq * qc, H, v.shape[-1])
    if pad:
        out = out[:, :S]
    return out.to(q.dtype)


def _partial_softmax(q, k, v, scale, softcap, valid=None):
    """Partial attention stats over a cache chunk.
    q [B, H, D]; k/v [B, Sc, Hkv, D] -> (m, l, o) with o unnormalised.
    ``valid`` [Sc] bool masks cache slots not yet written."""
    B, H, D = q.shape
    Hkv = k.shape[2]
    group = H // Hkv
    qg = q.reshape(B, Hkv, group, D).float() * scale
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    if valid is not None:
        s = s.masked_fill(~valid[None, None, None, :], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)                         # [B,Hkv,g,1]
    p = torch.exp(s - m)
    if valid is not None:
        p = p.masked_fill(~valid[None, None, None, :], 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    return m, l, o


def merge_partials(m1, l1, o1, m2, l2, o2):
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    return m, a1 * l1 + a2 * l2, a1 * o1 + a2 * o2


def decode_attention(*args, **kwargs):
    """The JAX package's decode against a sequence-sharded cache
    (``shard_map`` over a mesh).  One card has no mesh: the single-device
    decode is :func:`repro_torch.models.blocks._attn_decode`."""
    raise LPFFatalError(
        "decode_attention shards the KV cache over a device mesh's data and "
        "model axes; one card holds only pods, as virtual processes "
        "(ROADMAP A10, its multi-GPU part)")


def attention(q, k, v, *, impl: str = "blocked", causal=True, window=None,
              softcap=None, scale=None, q_chunk: int = 512):
    """Dispatch prefill attention by implementation name; q [B,S,H,D],
    k [B,Skv,Hkv,D], v [B,Skv,Hkv,Dv] -> [B,S,H,Dv]."""
    if impl in ("flash", "reference"):
        # kernel layout is [B, H, S, D]
        fn = _flash_ops.flash_attention if impl == "flash" \
            else _flash_ref.attention_ref
        o = fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
               causal=causal, window=window, softcap=softcap, scale=scale)
        return o.transpose(1, 2)
    return blocked_attention(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale, q_chunk=q_chunk)
