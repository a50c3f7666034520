"""Transformer blocks on one device: init, prefill apply, decode step.

All blocks are pre-norm residual (``post_norms`` adds gemma-2's sandwich
norms).  A block's parameters are a plain dict of tensors named as in the
JAX tree (``attn.wq``, ``mlp.w_gate``, ``ln1.w``, ...), weight matrices
in the ``[in, out]`` layout (``x @ w``).  The mixers: attention
(``mixer="attn"``) with GQA, qk-norm, QKV bias, RoPE, sliding windows and
soft-capping; MLA (``mixer="mla"``, deepseek-v3's compressed-KV
attention: decompressed K/V at prefill, the absorbed product against the
compressed cache ``ckv``/``krope`` at decode); the Mamba-2 mixer
(``mixer="mamba"``).  A decoder block of an encoder-decoder model adds
cross-attention (``cross_attn=True``: K/V from the encoder's output, no
RoPE, not causal; a decode step recomputes them from ``enc_out`` every
step, as the JAX package does).  The feed-forward blocks: dense and MoE
(``ffn="dense"``, ``ffn="moe"`` with an optional shared expert), and a
vision tower's MLP (``ffn="gelu"`` or ``"quick_gelu"``: two matrices
with biases around that activation, :func:`fc_mlp`).  An attention
block's output projection adds the bias ``attn.bo`` where the tree holds
one (a CLIP tower's, :mod:`.vision`).

A :class:`Runtime` with a mesh and a model axis (``distributed``, as in
the JAX package) runs the two blocks whose ``shard_map`` bodies change
values over the mesh's virtual shards: the MoE block is
:func:`~.moe.moe_apply` (capacity per batch shard) and the decode's
attention :func:`~.attention.decode_attention` (a partial softmax per
cache shard).  Without one they are :func:`~.moe.moe_single` and the
single-device decode.

MLA's query/key width (``dh_nope + dh_rope``) differs from its value
width ``dh_v``: ``attn_impl="flash"`` refuses it by name, as the JAX
package's kernel cannot take it either, so MLA runs blocked.

One deliberate departure from the JAX package: a Mamba block calls
``mamba_apply(..., impl="kernel")``, where the JAX block takes the
default chunked path.  On the card that is the CUDA ``ssd_scan`` kernel;
on the CPU, ``ops.ssd`` takes the kernel's plain version, which computes
the same function as the JAX block's chunked path.

Decode writes the new token's K/V (MLA's ``ckv``/``krope``, or the Mamba
state and convolution window) into the cache in place (for attention at
slot ``pos % cache_len``,
after attention has read the cache: a slice copy for an int ``pos``, an
``index_copy_`` for a position held in a device tensor); the JAX package
returns an updated copy.  The values are the same.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..core.context import resolve_device
from .attention import (NEG_INF, attention, decode_attention,
                        sharded_decode)
from .common import apply_rope, dense_init, layer_norm, rms_norm
from .config import BlockCfg, ModelConfig
from .mamba import (mamba_apply, mamba_decode_step, mamba_init_cache,
                    mamba_params)
from .moe import moe_apply, moe_params, moe_single

__all__ = ["block_params", "block_apply", "block_decode",
           "block_init_cache", "Runtime", "fc_params", "fc_mlp", "FC_ACTS"]

Tree = Dict[str, Any]


class Runtime:
    """Execution context handed down from the launcher: the device, and
    the JAX package's mesh and axis roles.

    ``dp_axes``: batch-sharding axes (also the MoE token axes).
    ``seq_axes``: KV-cache sequence-sharding axes for decode (defaults to
    the model axis; long-context cells widen it to (data, model)).
    The mesh's shards are virtual (:mod:`repro_torch.core.mesh`).  A CUDA
    device (the default) is refused, never replaced by the CPU, when no
    card is present."""

    def __init__(self, device="cuda", mesh=None,
                 dp_axes: Tuple[str, ...] = (),
                 model_axis: Optional[str] = None,
                 seq_axes: Optional[Tuple[str, ...]] = None):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.dp_axes = tuple(dp_axes)
        self.model_axis = model_axis
        self.seq_axes = tuple(seq_axes) if seq_axes is not None \
            else ((model_axis,) if model_axis else ())

    @property
    def distributed(self) -> bool:
        return self.mesh is not None and self.model_axis is not None


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


def _mla_params(gen, cfg: ModelConfig, dtype, device) -> Tree:
    m = cfg.mla
    h = cfg.n_heads
    init = lambda shape: dense_init(gen, shape, dtype=dtype, device=device)
    return {"wq_a": init((cfg.d_model, m.q_lora)),
            "q_norm": torch.ones(m.q_lora, device=device),
            "wq_b": init((m.q_lora, h * (m.dh_nope + m.dh_rope))),
            "wkv_a": init((cfg.d_model, m.kv_lora + m.dh_rope)),
            "kv_norm": torch.ones(m.kv_lora, device=device),
            "wkv_b": init((m.kv_lora, h * (m.dh_nope + m.dh_v))),
            "wo": init((h * m.dh_v, cfg.d_model))}


def _mlp_params(gen, cfg: ModelConfig, dtype, device) -> Tree:
    init = lambda shape: dense_init(gen, shape, dtype=dtype, device=device)
    return {"w_gate": init((cfg.d_model, cfg.d_ff)),
            "w_up": init((cfg.d_model, cfg.d_ff)),
            "w_down": init((cfg.d_ff, cfg.d_model))}


#: the activations of :func:`fc_mlp`, by ``BlockCfg.ffn`` name: exact
#: GELU, and CLIP's ``quick_gelu`` x * sigmoid(1.702 x)
FC_ACTS = {"gelu": torch.nn.functional.gelu,
           "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x)}


def fc_params(gen, d_in: int, d_hidden: int, d_out: int, dtype,
              device) -> Tree:
    """A two-matrix MLP with biases (:func:`fc_mlp`); the biases start
    at 0."""
    init = lambda shape: dense_init(gen, shape, dtype=dtype, device=device)
    return {"w_in": init((d_in, d_hidden)),
            "b_in": torch.zeros(d_hidden, dtype=dtype, device=device),
            "w_out": init((d_hidden, d_out)),
            "b_out": torch.zeros(d_out, dtype=dtype, device=device)}


def block_params(gen: torch.Generator, bcfg: BlockCfg, cfg: ModelConfig,
                 dtype, device) -> Tree:
    """One block's parameters, drawn from ``gen`` (on ``device``)."""
    p: Tree = {}
    if bcfg.mixer == "attn":
        p["attn"] = _attn_params(gen, cfg, dtype, device)
        p["ln1"] = _norm_params(cfg.d_model, cfg.norm, device)
    elif bcfg.mixer == "mla":
        p["attn"] = _mla_params(gen, cfg, dtype, device)
        p["ln1"] = _norm_params(cfg.d_model, cfg.norm, device)
    elif bcfg.mixer == "mamba":
        p["mamba"] = mamba_params(gen, cfg.mamba, dtype, device)
        p["ln1"] = _norm_params(cfg.d_model, cfg.norm, device)
    if cfg.post_norms and bcfg.mixer != "none":
        p["post_ln1"] = _norm_params(cfg.d_model, cfg.norm, device)
    if bcfg.cross_attn:
        p["xattn"] = _attn_params(gen, cfg, dtype, device)
        p["ln_x"] = _norm_params(cfg.d_model, cfg.norm, device)
    if bcfg.ffn == "dense":
        p["mlp"] = _mlp_params(gen, cfg, dtype, device)
        p["ln2"] = _norm_params(cfg.d_model, cfg.norm, device)
    elif bcfg.ffn in FC_ACTS:
        p["mlp"] = fc_params(gen, cfg.d_model, cfg.d_ff, cfg.d_model, dtype,
                             device)
        p["ln2"] = _norm_params(cfg.d_model, cfg.norm, device)
    elif bcfg.ffn == "moe":
        p["moe"] = moe_params(gen, cfg.moe, dtype, device)
        p["ln2"] = _norm_params(cfg.d_model, cfg.norm, device)
        if cfg.shared_expert:
            # the shared expert is expert-sized (cfg.moe.d_ff), not d_ff
            p["shared_mlp"] = _mlp_params(
                gen, dataclasses.replace(cfg, d_ff=cfg.moe.d_ff), dtype,
                device)
    if cfg.post_norms and bcfg.ffn != "none":
        p["post_ln2"] = _norm_params(cfg.d_model, cfg.norm, device)
    return p


# --------------------------------------------------------------------------
# apply (prefill)
# --------------------------------------------------------------------------

def _mlp(p, x):
    return (torch.nn.functional.silu(x @ p["w_gate"]) * (x @ p["w_up"])) \
        @ p["w_down"]


def fc_mlp(p, x, act: str):
    """``act(x @ w_in + b_in) @ w_out + b_out``, the biases in x's
    dtype."""
    h = FC_ACTS[act](x @ p["w_in"] + p["b_in"].to(x.dtype))
    return h @ p["w_out"] + p["b_out"].to(x.dtype)


def _ffn_fwd(p, h, cfg: ModelConfig, bcfg: BlockCfg,
             rt: Runtime) -> torch.Tensor:
    """The feed-forward half of a block on h [B, S, D]: the dense MLP, a
    tower's biased MLP, or the MoE block (plus the shared expert where
    the config has one), over the runtime's mesh where it is
    ``distributed``."""
    if bcfg.ffn == "dense":
        return _mlp(p["mlp"], h)
    if bcfg.ffn in FC_ACTS:
        return fc_mlp(p["mlp"], h, bcfg.ffn)
    if rt.distributed:
        out = moe_apply(p["moe"], h, cfg.moe, mesh=rt.mesh,
                        model_axis=rt.model_axis, dp_axes=rt.dp_axes)
    else:
        out = moe_single(p["moe"], h, cfg.moe)
    if cfg.shared_expert:
        out = out + _mlp(p["shared_mlp"], h)
    return out


def _attn_fwd(p, h, cfg: ModelConfig, bcfg: BlockCfg, positions,
              kv_override=None):
    """Attention over h [B, S, D]; with ``kv_override`` [B, Skv, D]
    (cross-attention) K/V come from it, without RoPE and not causal.  The
    encoder states meet the projections in the promoted dtype, as JAX
    promotes a bf16 ``enc_out`` against f32 weights."""
    B, S, _ = h.shape
    hd = cfg.hd
    q = h @ p["wq"]
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
    q = q.reshape(B, S, cfg.n_heads, hd)
    if kv_override is None:
        src, wk, wv = h, p["wk"], p["wv"]
    else:
        dt = torch.promote_types(kv_override.dtype, p["wk"].dtype)
        src, wk, wv = kv_override.to(dt), p["wk"].to(dt), p["wv"].to(dt)
    Skv = src.shape[1]
    k = src @ wk
    v = src @ wv
    if "bk" in p:
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    k = k.reshape(B, Skv, cfg.n_kv, hd)
    v = v.reshape(B, Skv, cfg.n_kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if cfg.pos_embed == "rope" and kv_override is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    o = attention(q, k, v, impl=cfg.attn_impl,
                  causal=bcfg.causal and kv_override is None,
                  window=bcfg.window, softcap=cfg.attn_softcap,
                  q_chunk=cfg.q_chunk)
    out = o.reshape(B, S, cfg.n_heads * hd) @ p["wo"]
    if "bo" in p:
        out = out + p["bo"].to(out.dtype)
    return out, (k, v)


def _mla_fwd(p, h, cfg: ModelConfig, bcfg: BlockCfg, positions):
    """MLA prefill (decompressed K/V): queries and keys of width
    ``dh_nope + dh_rope`` (one RoPE key shared by every head), values of
    ``dh_v``, scale ``1/sqrt(dh_nope + dh_rope)``.  Returns the output and
    what a cache would hold (``c_kv`` [B, S, kv_lora], ``k_rope``
    [B, S, dh_rope])."""
    m = cfg.mla
    B, S, _ = h.shape
    H = cfg.n_heads
    q = rms_norm(h @ p["wq_a"], p["q_norm"]) @ p["wq_b"]
    q = q.reshape(B, S, H, m.dh_nope + m.dh_rope)
    q_nope, q_rope = q[..., :m.dh_nope], q[..., m.dh_nope:]
    kv = h @ p["wkv_a"]
    c_kv = rms_norm(kv[..., :m.kv_lora], p["kv_norm"])
    k_rope = kv[..., m.kv_lora:].reshape(B, S, 1, m.dh_rope)
    kvb = (c_kv @ p["wkv_b"]).reshape(B, S, H, m.dh_nope + m.dh_v)
    k_nope, v = kvb[..., :m.dh_nope], kvb[..., m.dh_nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, m.dh_rope)], dim=-1)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    scale = 1.0 / math.sqrt(m.dh_nope + m.dh_rope)
    o = attention(qf, k, v, impl=cfg.attn_impl, causal=bcfg.causal,
                  window=bcfg.window, softcap=cfg.attn_softcap,
                  scale=scale, q_chunk=cfg.q_chunk)
    out = o.reshape(B, S, H * m.dh_v) @ p["wo"]
    return out, (c_kv, k_rope.reshape(B, S, m.dh_rope))


def block_apply(p: Tree, x: torch.Tensor, bcfg: BlockCfg, cfg: ModelConfig,
                rt: Runtime, positions: torch.Tensor,
                enc_out=None) -> torch.Tensor:
    """One block over a whole sequence; x [B, S, D].  ``enc_out`` [B, Se,
    D]: the encoder's output, which a cross-attention block reads."""
    plus_one = cfg.norm == "rms"
    if bcfg.mixer in ("attn", "mla"):
        h = _norm(x, p["ln1"], cfg.norm, plus_one)
        fwd = _attn_fwd if bcfg.mixer == "attn" else _mla_fwd
        o, _ = fwd(p["attn"], h, cfg, bcfg, positions)
        if cfg.post_norms:
            o = _norm(o, p["post_ln1"], cfg.norm, plus_one)
        x = x + o
    elif bcfg.mixer == "mamba":
        h = _norm(x, p["ln1"], cfg.norm, plus_one)
        x = x + mamba_apply(p["mamba"], h, cfg.mamba, impl="kernel")
    if bcfg.cross_attn:
        h = _norm(x, p["ln_x"], cfg.norm, plus_one)
        o, _ = _attn_fwd(p["xattn"], h, cfg, bcfg, positions,
                         kv_override=enc_out)
        x = x + o
    if bcfg.ffn != "none":
        h = _norm(x, p["ln2"], cfg.norm, plus_one)
        o = _ffn_fwd(p, h, cfg, bcfg, rt)
        if cfg.post_norms:
            o = _norm(o, p["post_ln2"], cfg.norm, plus_one)
        x = x + o
    return x


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def block_init_cache(bcfg: BlockCfg, cfg: ModelConfig, batch: int,
                     cache_len: int, dtype, device) -> Tree:
    c: Tree = {}
    if bcfg.mixer == "attn":
        S = min(bcfg.window, cache_len) if bcfg.window else cache_len
        c["k"] = torch.zeros(batch, S, cfg.n_kv, cfg.hd, dtype=dtype,
                             device=device)
        c["v"] = torch.zeros(batch, S, cfg.n_kv, cfg.hd, dtype=dtype,
                             device=device)
    elif bcfg.mixer == "mla":
        m = cfg.mla
        c["ckv"] = torch.zeros(batch, cache_len, m.kv_lora, dtype=dtype,
                               device=device)
        c["krope"] = torch.zeros(batch, cache_len, m.dh_rope, dtype=dtype,
                                 device=device)
    elif bcfg.mixer == "mamba":
        c.update(mamba_init_cache(batch, cfg.mamba, dtype, device))
    return c


def _attn_decode(p, h, cache, cfg: ModelConfig, bcfg: BlockCfg,
                 rt: Runtime, pos):
    """One token of attention against the cache (over the runtime's
    mesh where it is ``distributed``), then the rolling write of its K/V
    at slot ``pos % cache_len`` (in place).  ``pos`` is an int or a 0-d
    long tensor on ``h``'s device (see :func:`block_decode`)."""
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
    if cfg.pos_embed == "rope":
        posb = _positions(pos, B, h.device)
        q = apply_rope(q[:, None], posb, cfg.rope_theta)[:, 0]
        k = apply_rope(k, posb, cfg.rope_theta)
    if rt.distributed:
        o = decode_attention(q, cache["k"], cache["v"], k, v, mesh=rt.mesh,
                             seq_axes=rt.seq_axes, batch_axes=rt.dp_axes,
                             softcap=cfg.attn_softcap, pos=pos)
    else:
        o = sharded_decode(q, cache["k"], cache["v"], k, v, 1,
                           scale=1.0 / math.sqrt(hd),
                           softcap=cfg.attn_softcap, pos=pos)
    out = o.reshape(B, cfg.n_heads * hd) @ p["wo"]
    _write_slot(cache, {"k": k, "v": v}, pos)
    return out


def _positions(pos, B: int, device) -> torch.Tensor:
    """``pos`` (an int or a 0-d device tensor) as [B, 1] positions."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(1, 1).expand(B, 1)
    return torch.full((B, 1), pos, dtype=torch.long, device=device)


def _write_slot(cache: Tree, new: Tree, pos) -> None:
    """The rolling write of each ``new[name]`` [B, 1, ...] into
    ``cache[name]`` [B, C, ...] at slot ``pos % C``, in place."""
    for name, val in new.items():
        c = cache[name]
        C = c.shape[1]
        if isinstance(pos, torch.Tensor):
            # the slot computed on the device, where the position lives
            c.index_copy_(1, (pos % C).reshape(1), val.to(c.dtype))
        else:
            # a slice with a host-side index: no index tensor to copy to
            # the device, so no wait for the device per layer
            slot = pos % C
            c[:, slot:slot + 1].copy_(val)


def _mla_decode(p, h, cache, cfg: ModelConfig, pos):
    """Absorbed MLA decode on the compressed cache (``ckv``, the shared
    ``krope``): ``W_uk`` folded into the query (``q_abs`` [B, H,
    kv_lora]), scores and the context in f32 as in the JAX package, then
    ``W_uv``; the new token's ``ckv``/``krope`` written at slot ``pos %
    cache_len`` after the cache is read."""
    m = cfg.mla
    B, _ = h.shape
    H = cfg.n_heads
    q = rms_norm(h @ p["wq_a"], p["q_norm"]) @ p["wq_b"]
    q = q.reshape(B, H, m.dh_nope + m.dh_rope)
    q_nope, q_rope = q[..., :m.dh_nope], q[..., m.dh_nope:]
    posb = _positions(pos, B, h.device)
    q_rope = apply_rope(q_rope[:, None], posb, cfg.rope_theta)[:, 0]
    kv = h @ p["wkv_a"]
    c_new = rms_norm(kv[..., :m.kv_lora], p["kv_norm"])          # [B, c]
    kr_new = apply_rope(kv[..., m.kv_lora:][:, None, None, :], posb,
                        cfg.rope_theta)[:, 0, 0]                  # [B, r]
    wkv_b = p["wkv_b"].reshape(m.kv_lora, H, m.dh_nope + m.dh_v)
    w_uk = wkv_b[..., :m.dh_nope]        # [kv_lora, H, dh_nope]
    w_uv = wkv_b[..., m.dh_nope:]        # [kv_lora, H, dh_v]
    q_abs = torch.einsum("bhd,chd->bhc", q_nope.float(), w_uk.float())
    qr = q_rope.float()
    scale = 1.0 / math.sqrt(m.dh_nope + m.dh_rope)
    ckv, krope = cache["ckv"], cache["krope"]
    ckv_f = ckv.float()
    s = (torch.einsum("bhc,bsc->bhs", q_abs, ckv_f)
         + torch.einsum("bhr,bsr->bhs", qr, krope.float())) * scale
    valid = torch.arange(ckv.shape[1], device=h.device) < pos
    s = s.masked_fill(~valid[None, None, :], NEG_INF)
    s_new = (torch.einsum("bhc,bc->bh", q_abs, c_new.float())
             + torch.einsum("bhr,br->bh", qr, kr_new.float())) * scale
    mmax = torch.maximum(s.amax(dim=-1), s_new)                  # [B, H]
    pcache = torch.exp(s - mmax[..., None])
    pnew = torch.exp(s_new - mmax)
    denom = pcache.sum(dim=-1) + pnew
    ctx = (torch.einsum("bhs,bsc->bhc", pcache, ckv_f)
           + pnew[..., None] * c_new.float()[:, None, :]) / denom[..., None]
    o = torch.einsum("bhc,chd->bhd", ctx, w_uv.float())
    out = o.reshape(B, H * m.dh_v).to(h.dtype) @ p["wo"]
    _write_slot(cache, {"ckv": c_new[:, None], "krope": kr_new[:, None]},
                pos)
    return out


def block_decode(p: Tree, x: torch.Tensor, cache: Tree, bcfg: BlockCfg,
                 cfg: ModelConfig, rt: Runtime, pos, enc_out=None
                 ) -> Tuple[torch.Tensor, Tree]:
    """One-token decode.  x [B, D]; ``cache`` is updated in place and
    returned.  ``pos`` is an int, or a 0-d long tensor on the device that
    no step reads on the host (a CUDA graph replays it at whatever
    position the tensor holds).  ``enc_out`` [B, Se, D]: the encoder's
    output, from which a cross-attention block recomputes its K/V."""
    plus_one = cfg.norm == "rms"
    if bcfg.mixer in ("attn", "mla"):
        h = _norm(x, p["ln1"], cfg.norm, plus_one)
        if bcfg.mixer == "attn":
            o = _attn_decode(p["attn"], h, cache, cfg, bcfg, rt, pos)
        else:
            o = _mla_decode(p["attn"], h, cache, cfg, pos)
        if cfg.post_norms:
            o = _norm(o, p["post_ln1"], cfg.norm, plus_one)
        x = x + o
    elif bcfg.mixer == "mamba":
        h = _norm(x, p["ln1"], cfg.norm, plus_one)
        o, _ = mamba_decode_step(p["mamba"], h, cache, cfg.mamba)
        x = x + o
    if bcfg.cross_attn:
        h = _norm(x, p["ln_x"], cfg.norm, plus_one)
        o, _ = _attn_fwd(p["xattn"], h[:, None], cfg, bcfg,
                         torch.zeros(x.shape[0], 1, dtype=torch.long,
                                     device=x.device),
                         kv_override=enc_out)
        x = x + o[:, 0]
    if bcfg.ffn != "none":
        h = _norm(x, p["ln2"], cfg.norm, plus_one)
        o = _ffn_fwd(p, h[:, None], cfg, bcfg, rt)[:, 0]
        if cfg.post_norms:
            o = _norm(o, p["post_ln2"], cfg.norm, plus_one)
        x = x + o
    return x, cache
