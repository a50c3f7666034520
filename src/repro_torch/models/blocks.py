"""Transformer blocks on one device: init, prefill apply, decode step.

All blocks are pre-norm residual (``post_norms`` adds gemma-2's sandwich
norms).  A block's parameters are a plain dict of tensors named as in the
JAX tree (``attn.wq``, ``mlp.w_gate``, ``ln1.w``, ...), weight matrices
in the ``[in, out]`` layout (``x @ w``).  The port runs the dense
attention block (``mixer="attn"``, ``ffn="dense"``) with GQA, qk-norm,
QKV bias, RoPE, sliding windows and soft-capping, and the Mamba-2 block
(``mixer="mamba"``).  MLA, MoE and cross-attention blocks raise
:class:`LPFFatalError` naming the ROADMAP item that ports them.

One deliberate departure from the JAX package: a Mamba block calls
``mamba_apply(..., impl="kernel")``, where the JAX block takes the
default chunked path.  On the card that is the CUDA ``ssd_scan`` kernel;
on the CPU, ``ops.ssd`` takes the kernel's plain version, which computes
the same function as the JAX block's chunked path.

Decode writes the new token's K/V (or the Mamba state and convolution
window) into the cache in place (for attention at slot ``pos % cache_len``,
after attention has read the cache: a slice copy for an int ``pos``, an
``index_copy_`` for a position held in a device tensor); the JAX package
returns an updated copy.  The values are the same.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from ..core.context import resolve_device
from ..core.errors import LPFFatalError
from .attention import _partial_softmax, attention, merge_partials
from .common import apply_rope, dense_init, layer_norm, rms_norm
from .config import BlockCfg, ModelConfig
from .mamba import (mamba_apply, mamba_decode_step, mamba_init_cache,
                    mamba_params)

__all__ = ["block_params", "block_apply", "block_decode",
           "block_init_cache", "Runtime"]

Tree = Dict[str, Any]


class Runtime:
    """Execution context handed down from the launcher: the device.

    The JAX package's runtime carries a mesh and its axis roles; the port
    runs on one device, so :attr:`distributed` is always False.  A CUDA
    device (the default) is refused, never replaced by the CPU, when no
    card is present."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    @property
    def distributed(self) -> bool:
        return False


def _unported(bcfg: BlockCfg) -> None:
    """Raise for the block kinds this slice does not port."""
    if bcfg.mixer == "mla":
        raise LPFFatalError("mixer='mla' blocks are not ported yet "
                            "(ROADMAP A8)")
    if bcfg.ffn == "moe":
        raise LPFFatalError("ffn='moe' blocks are not ported yet "
                            "(ROADMAP A8)")
    if bcfg.cross_attn:
        raise LPFFatalError("cross-attention blocks (encoder-decoder) are "
                            "not ported yet (ROADMAP A8)")


def _norm(x, p, kind: str, plus_one: bool = False):
    if kind == "layer":
        return layer_norm(x, p["w"], p["b"])
    return rms_norm(x, p["w"], plus_one=plus_one)


def _norm_params(d: int, kind: str, device) -> Tree:
    if kind == "layer":
        return {"w": torch.ones(d, device=device),
                "b": torch.zeros(d, device=device)}
    return {"w": torch.zeros(d, device=device)}   # rms stored as (1+w) style


# --------------------------------------------------------------------------
# parameter init
# --------------------------------------------------------------------------

def _attn_params(gen, cfg: ModelConfig, dtype, device) -> Tree:
    hd = cfg.hd
    init = lambda shape: dense_init(gen, shape, dtype=dtype, device=device)
    p = {"wq": init((cfg.d_model, cfg.n_heads * hd)),
         "wk": init((cfg.d_model, cfg.n_kv * hd)),
         "wv": init((cfg.d_model, cfg.n_kv * hd)),
         "wo": init((cfg.n_heads * hd, cfg.d_model))}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(cfg.n_heads * hd, dtype=dtype, device=device)
        p["bk"] = torch.zeros(cfg.n_kv * hd, dtype=dtype, device=device)
        p["bv"] = torch.zeros(cfg.n_kv * hd, dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, device=device)
        p["k_norm"] = torch.ones(hd, device=device)
    return p


def _mlp_params(gen, cfg: ModelConfig, dtype, device) -> Tree:
    init = lambda shape: dense_init(gen, shape, dtype=dtype, device=device)
    return {"w_gate": init((cfg.d_model, cfg.d_ff)),
            "w_up": init((cfg.d_model, cfg.d_ff)),
            "w_down": init((cfg.d_ff, cfg.d_model))}


def block_params(gen: torch.Generator, bcfg: BlockCfg, cfg: ModelConfig,
                 dtype, device) -> Tree:
    """One block's parameters, drawn from ``gen`` (on ``device``)."""
    _unported(bcfg)
    p: Tree = {}
    if bcfg.mixer == "attn":
        p["attn"] = _attn_params(gen, cfg, dtype, device)
        p["ln1"] = _norm_params(cfg.d_model, cfg.norm, device)
    elif bcfg.mixer == "mamba":
        p["mamba"] = mamba_params(gen, cfg.mamba, dtype, device)
        p["ln1"] = _norm_params(cfg.d_model, cfg.norm, device)
    if cfg.post_norms and bcfg.mixer != "none":
        p["post_ln1"] = _norm_params(cfg.d_model, cfg.norm, device)
    if bcfg.ffn == "dense":
        p["mlp"] = _mlp_params(gen, cfg, dtype, device)
        p["ln2"] = _norm_params(cfg.d_model, cfg.norm, device)
    if cfg.post_norms and bcfg.ffn != "none":
        p["post_ln2"] = _norm_params(cfg.d_model, cfg.norm, device)
    return p


# --------------------------------------------------------------------------
# apply (prefill)
# --------------------------------------------------------------------------

def _mlp(p, x):
    return (torch.nn.functional.silu(x @ p["w_gate"]) * (x @ p["w_up"])) \
        @ p["w_down"]


def _attn_fwd(p, h, cfg: ModelConfig, bcfg: BlockCfg, positions):
    B, S, _ = h.shape
    hd = cfg.hd
    q = h @ p["wq"]
    k = h @ p["wk"]
    v = h @ p["wv"]
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, S, cfg.n_kv, hd)
    v = v.reshape(B, S, cfg.n_kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if cfg.pos_embed == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    o = attention(q, k, v, impl=cfg.attn_impl, causal=bcfg.causal,
                  window=bcfg.window, softcap=cfg.attn_softcap,
                  q_chunk=cfg.q_chunk)
    return o.reshape(B, S, cfg.n_heads * hd) @ p["wo"], (k, v)


def block_apply(p: Tree, x: torch.Tensor, bcfg: BlockCfg, cfg: ModelConfig,
                rt: Runtime, positions: torch.Tensor) -> torch.Tensor:
    """One block over a whole sequence; x [B, S, D]."""
    _unported(bcfg)
    plus_one = cfg.norm == "rms"
    if bcfg.mixer == "attn":
        h = _norm(x, p["ln1"], cfg.norm, plus_one)
        o, _ = _attn_fwd(p["attn"], h, cfg, bcfg, positions)
        if cfg.post_norms:
            o = _norm(o, p["post_ln1"], cfg.norm, plus_one)
        x = x + o
    elif bcfg.mixer == "mamba":
        h = _norm(x, p["ln1"], cfg.norm, plus_one)
        x = x + mamba_apply(p["mamba"], h, cfg.mamba, impl="kernel")
    if bcfg.ffn != "none":
        h = _norm(x, p["ln2"], cfg.norm, plus_one)
        o = _mlp(p["mlp"], h)
        if cfg.post_norms:
            o = _norm(o, p["post_ln2"], cfg.norm, plus_one)
        x = x + o
    return x


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def block_init_cache(bcfg: BlockCfg, cfg: ModelConfig, batch: int,
                     cache_len: int, dtype, device) -> Tree:
    _unported(bcfg)
    c: Tree = {}
    if bcfg.mixer == "attn":
        S = min(bcfg.window, cache_len) if bcfg.window else cache_len
        c["k"] = torch.zeros(batch, S, cfg.n_kv, cfg.hd, dtype=dtype,
                             device=device)
        c["v"] = torch.zeros(batch, S, cfg.n_kv, cfg.hd, dtype=dtype,
                             device=device)
    elif bcfg.mixer == "mamba":
        c.update(mamba_init_cache(batch, cfg.mamba, dtype, device))
    return c


def _attn_decode(p, h, cache, cfg: ModelConfig, bcfg: BlockCfg, pos):
    """One token of attention against the cache, then the rolling write
    of its K/V at slot ``pos % cache_len`` (in place).  ``pos`` is an int
    or a 0-d long tensor on ``h``'s device (see :func:`block_decode`)."""
    B, _ = h.shape
    hd = cfg.hd
    q = h @ p["wq"]
    k = h @ p["wk"]
    v = h @ p["wv"]
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = q.reshape(B, cfg.n_heads, hd)
    k = k.reshape(B, 1, cfg.n_kv, hd)
    v = v.reshape(B, 1, cfg.n_kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    on_device = isinstance(pos, torch.Tensor)
    if cfg.pos_embed == "rope":
        posb = pos.reshape(1, 1).expand(B, 1) if on_device else \
            torch.full((B, 1), pos, dtype=torch.long, device=h.device)
        q = apply_rope(q[:, None], posb, cfg.rope_theta)[:, 0]
        k = apply_rope(k, posb, cfg.rope_theta)
    scale = 1.0 / math.sqrt(hd)
    C = cache["k"].shape[1]
    valid = torch.arange(C, device=h.device) < pos
    m1, l1, o1 = _partial_softmax(q, cache["k"], cache["v"], scale,
                                  cfg.attn_softcap, valid)
    m2, l2, o2 = _partial_softmax(q, k, v, scale, cfg.attn_softcap)
    _m, l, o = merge_partials(m1, l1, o1, m2, l2, o2)
    o = (o / l.clamp_min(1e-30)).reshape(B, cfg.n_heads, hd).to(h.dtype)
    out = o.reshape(B, cfg.n_heads * hd) @ p["wo"]
    if on_device:
        # the slot computed on the device, where the position lives
        slot = (pos % C).reshape(1)
        cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
    else:
        # a slice with a host-side index: no index tensor to copy to the
        # device, so no wait for the device per layer
        slot = pos % C
        cache["k"][:, slot:slot + 1].copy_(k)
        cache["v"][:, slot:slot + 1].copy_(v)
    return out


def block_decode(p: Tree, x: torch.Tensor, cache: Tree, bcfg: BlockCfg,
                 cfg: ModelConfig, rt: Runtime, pos
                 ) -> Tuple[torch.Tensor, Tree]:
    """One-token decode.  x [B, D]; ``cache`` is updated in place and
    returned.  ``pos`` is an int, or a 0-d long tensor on the device that
    no step reads on the host (a CUDA graph replays it at whatever
    position the tensor holds)."""
    _unported(bcfg)
    plus_one = cfg.norm == "rms"
    if bcfg.mixer == "attn":
        h = _norm(x, p["ln1"], cfg.norm, plus_one)
        o = _attn_decode(p["attn"], h, cache, cfg, bcfg, pos)
        if cfg.post_norms:
            o = _norm(o, p["post_ln1"], cfg.norm, plus_one)
        x = x + o
    elif bcfg.mixer == "mamba":
        h = _norm(x, p["ln1"], cfg.norm, plus_one)
        o, _ = mamba_decode_step(p["mamba"], h, cache, cfg.mamba)
        x = x + o
    if bcfg.ffn != "none":
        h = _norm(x, p["ln2"], cfg.norm, plus_one)
        o = _mlp(p["mlp"], h)
        if cfg.post_norms:
            o = _norm(o, p["post_ln2"], cfg.norm, plus_one)
        x = x + o
    return x, cache
