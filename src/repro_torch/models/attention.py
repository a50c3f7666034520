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
  partials the decode step merges (cache, then the new token);
  :func:`sharded_decode` merges them over ``n`` cache shards, one shard
  on a single device;
* :func:`decode_attention` — one token against a KV cache sharded over a
  mesh's sequence axes (and its batch over the batch axes), the JAX
  package's ``shard_map`` body over virtual shards
  (:mod:`repro_torch.core.mesh`): each shard of the cache takes its
  partial softmax over the slots it holds (global slot ``shard * Sc +
  i`` valid below ``pos``), the partials merge (``pmax``, then the
  rescaled ``psum`` in shard order), then the new token is folded in.

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
from typing import Optional, Tuple

import torch

from ..core.errors import LPFFatalError
from ..core.mesh import merge, mesh_shards, split
from ..kernels.flash_attention import ops as _flash_ops
from ..kernels.flash_attention import ref as _flash_ref

__all__ = ["blocked_attention", "decode_attention", "sharded_decode",
           "attention", "merge_partials", "shard_slots"]

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
    ``valid`` [Sc] (or [B, Sc], a row's own; [1, Sc] broadcasts) bool
    masks cache slots not yet written."""
    B, H, D = q.shape
    Hkv = k.shape[2]
    group = H // Hkv
    qg = q.reshape(B, Hkv, group, D).float() * scale
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    if valid is not None:
        invalid = ~(valid[None, None, None, :] if valid.dim() == 1
                    else valid[:, None, None, :])
        s = s.masked_fill(invalid, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)                         # [B,Hkv,g,1]
    p = torch.exp(s - m)
    if valid is not None:
        p = p.masked_fill(invalid, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    return m, l, o


def merge_partials(m1, l1, o1, m2, l2, o2):
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    return m, a1 * l1 + a2 * l2, a1 * o1 + a2 * o2


def shard_slots(n: int, Sc: int, device) -> torch.Tensor:
    """The global slot index ``[n, Sc]`` of each of ``n`` cache shards'
    ``Sc`` slots: ``shard * Sc + i``."""
    return torch.arange(n * Sc, device=device).reshape(n, Sc)


def sharded_decode(q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, k_new: torch.Tensor,
                   v_new: torch.Tensor, n: int, *, scale: float,
                   softcap: Optional[float], pos=None) -> torch.Tensor:
    """One-token decode against a cache split into ``n`` sequence shards
    (``n = 1``: the single-device decode).  q [B, H, D]; {k,v}_cache [B,
    S, Hkv, D]; {k,v}_new [B, 1, Hkv, D] -> [B, H, Dv].  The shards fold
    into the batch (row ``b * n + s``), so every shard's partial is one
    call of :func:`_partial_softmax`; they merge (``pmax``, then the
    rescaled ``psum`` in shard order), then the new token is folded in.
    ``pos`` (an int or a 0-d device tensor) masks the slots not yet
    written."""
    B, H, D = q.shape
    Hkv, Dv = k_cache.shape[2], v_cache.shape[-1]
    kc = split(k_cache, 1, n, "decode_attention's cache length")
    vc = split(v_cache, 1, n, "decode_attention's cache length")
    Sc = kc.shape[2]
    valid = None
    if pos is not None:
        # a row's own mask; one shard's [1, Sc] broadcasts over the rows
        valid = shard_slots(n, Sc, q.device) < pos
        if n > 1:
            valid = merge(valid.expand(B, n, Sc), 0)
    m, l, o = _partial_softmax(
        merge(q[:, None].expand(B, n, H, D), 0), merge(kc, 0),
        merge(vc, 0), scale, softcap, valid)
    m, l, o = (split(t, 0, B) for t in (m, l, o))
    mg, lg, og = m[:, 0], l[:, 0], o[:, 0]
    if n > 1:
        mg = m.amax(dim=1)
        corr = torch.exp(m - mg[:, None])
        lg, og = lg * corr[:, 0], og * corr[:, 0]
        for i in range(1, n):
            lg = lg + l[:, i] * corr[:, i]
            og = og + o[:, i] * corr[:, i]
    m2, l2, o2 = _partial_softmax(q, k_new, v_new, scale, softcap)
    _m, lf, of = merge_partials(mg, lg, og, m2, l2, o2)
    return (of / lf.clamp_min(1e-30)).reshape(B, H, Dv).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, *, mesh,
                     seq_axes: Tuple[str, ...] = ("model",),
                     batch_axes: Tuple[str, ...] = ("data",),
                     softcap: Optional[float] = None,
                     scale: Optional[float] = None,
                     pos=None) -> torch.Tensor:
    """One-token decode against a sequence-sharded cache with the
    shards' partials merged (:func:`sharded_decode`).  q [B, H, D];
    {k,v}_cache [B, S, Hkv, D], the batch over ``batch_axes`` and S over
    ``seq_axes`` of ``mesh``; {k,v}_new [B, 1, Hkv, D].  Returns [B, H,
    D].  Sliding-window caches are pre-rolled, so no window masks here.
    A batch or cache length that its shards do not divide raises."""
    if mesh is None:
        raise LPFFatalError("decode_attention shards the KV cache over a "
                            "mesh's axes, and got mesh=None; without a "
                            "mesh the decode is blocks._attn_decode's")
    batch_axes, seq_axes = tuple(batch_axes), tuple(seq_axes)
    if set(batch_axes) & set(seq_axes):
        raise LPFFatalError(f"decode_attention: batch axes {batch_axes} "
                            f"and sequence axes {seq_axes} overlap")
    split(q, 0, mesh_shards(mesh, batch_axes), "decode_attention's batch")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return sharded_decode(q, k_cache, v_cache, k_new, v_new,
                          mesh_shards(mesh, seq_axes), scale=scale,
                          softcap=softcap, pos=pos)


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
