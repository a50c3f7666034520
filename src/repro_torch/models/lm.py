"""The language model on one device: embed -> block groups -> head, with
the training loss, prefill and single-token greedy decode, for
decoder-only, encoder-decoder (audio), stub-multimodal (vision) and
vision-tower (:class:`~.config.VLMConfig`, :mod:`.vision`) architectures:
attention, MLA and Mamba-2 mixers, cross-attention, dense and MoE
feed-forward blocks, and multi-token prediction (MTP).

Parameters live in a :class:`ParamTree`, an ``nn.Module`` whose
parameters are named as in the JAX tree (``embed``, ``final_norm.w``,
``dec_body.b0.attn.wq``, ...).  A group's leaves are stacked
``[repeats, ...]`` as the JAX package's ``vmap`` stacks them, and weight
matrices keep the ``[in, out]`` layout, so carrying a JAX tree across is a
copy (:func:`repro_torch.interop.params_from_jax`).

Batch conventions (as in ``repro.models.lm``)::

    train:    {"tokens" [B, S] int, "labels" [B, S] int (-1 = masked),
               optional "embeds" [B, P, D] (vision stub, prepended; the
               logits cover the S text positions only),
               or "pixels" [B, T, 3, s, s] (a VLMConfig's tiles: the
               tower's packed image positions, prepended likewise),
               optional "frames" [B, Se, D] (audio stub -> encoder)}
    prefill:  the same without "labels"
    decode:   decode_step(params, token [B] int, caches, pos, cfg, rt,
                          enc_out=None)
              (pos an int, or a 0-d long tensor on the device; enc_out
              [B, Se, D] the encoder's output, for an encoder-decoder)

With ``cfg.mtp`` :func:`forward` returns ``(logits, logits_mtp)``: the MTP
head predicts the token after next from the final hidden state and the
next token's embedding, and :func:`loss_fn` adds 0.3 times its
cross-entropy against the labels shifted by one.

Every entry point runs on ``rt.device`` (``Runtime()`` is the card) and
refuses parameters that live elsewhere.  :func:`loss_fn` runs with
autograd: each layer is checkpointed as ``cfg.remat`` says and casts its
weights to the compute dtype inside, so gradients reach the f32 masters of
a trainable tree (``init_params(..., trainable=True)``).  ``forward``,
``prefill`` and ``decode_step`` run without autograd.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Union

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from ..core.context import resolve_device
from ..core.errors import LPFFatalError
from ..core.trace import count, span, tracing
from . import vision
from .blocks import (Runtime, block_apply, block_decode, block_init_cache,
                     block_params)
from .common import (dense_init, dtype_of, layer_norm, rms_norm,
                     sinusoidal_positions)
from .config import Group, ModelConfig

__all__ = ["ParamTree", "init_params", "load_params", "cast_params",
           "forward", "prefill", "loss_fn", "init_caches", "decode_step",
           "count_params", "model_flops"]

Tree = Dict[str, Any]


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: each dict becomes a child
    module, each tensor a parameter.  ``trainable`` sets the parameters'
    ``requires_grad`` (off for serving, which has no backward)."""

    def __init__(self, tree: Tree, trainable: bool = False):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val, trainable))
            else:
                self.register_parameter(
                    key, nn.Parameter(val, requires_grad=trainable))

    def tree(self) -> Tree:
        """The parameters as a nested dict (the tensors themselves)."""
        out: Tree = dict(self.named_parameters(recurse=False))
        for key, mod in self.named_children():
            out[key] = mod.tree()
        return out


def _map(fn, tree: Tree) -> Tree:
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _stack_trees(trees: List[Tree]) -> Tree:
    """One tree whose leaves stack the given trees' leaves on a new
    leading axis (what ``jax.vmap`` makes of a per-layer init)."""
    first = trees[0]
    return {k: _stack_trees([t[k] for t in trees])
            if isinstance(first[k], dict) else torch.stack([t[k] for t in trees])
            for k in first}


def _group_params(gen, g: Group, cfg: ModelConfig, dtype, device,
                  cdt=None) -> Tree:
    """A group's leaves stacked ``[repeats, ...]``: each layer's blocks
    are drawn in order as a per-layer init draws them (what ``jax.vmap``
    stacks), each block copied into the stacked leaves and dropped, so
    the peak is the stacked tree plus one block (a jamba period is 8
    blocks, 13.3 B parameters; one of its MoE blocks 2.8 B).  ``cdt``
    casts each block's weight matrices as :func:`cast_params` does
    before they are stored."""
    out: Tree = {}
    for l in range(g.repeats):
        for i, b in enumerate(g.blocks):
            blk = block_params(gen, b, cfg, dtype, device)
            if cdt is not None:
                blk = _cast_params(blk, cdt)
            if l == 0:
                out[f"b{i}"] = _map(
                    lambda a: a.new_empty((g.repeats, *a.shape)), blk)
            _map2(lambda dst, src, l=l: dst[l].copy_(src), out[f"b{i}"],
                  blk)
            del blk
    return out


def _map2(fn, a: Tree, b: Tree) -> None:
    for k, v in a.items():
        if isinstance(v, dict):
            _map2(fn, v, b[k])
        else:
            fn(v, b[k])


def _init_tree(key: Union[int, torch.Generator], cfg: ModelConfig, dev,
               cdt=None) -> Tree:
    """The parameter tree of :func:`init_params`, each weight matrix cast
    to ``cdt`` as soon as it is drawn when ``cdt`` is given."""
    if isinstance(key, torch.Generator):
        gen = key
    elif dev.type == "meta":
        gen = None
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(key))
    dtype = dtype_of(cfg.param_dtype)

    def top(a):
        return a if cdt is None else _cast_params({"a": a}, cdt)["a"]
    p: Tree = {"embed": top(dense_init(gen, (cfg.vocab_padded, cfg.d_model),
                                       in_axis=1, dtype=dtype, device=dev))}
    p["final_norm"] = {"w": torch.ones(cfg.d_model, device=dev)}
    if cfg.norm != "rms":
        p["final_norm"]["b"] = torch.zeros(cfg.d_model, device=dev)
    if not cfg.tie_embeddings:
        p["head"] = top(dense_init(gen, (cfg.d_model, cfg.vocab_padded),
                                   dtype=dtype, device=dev))
    if cfg.pos_embed == "learned":
        p["pos_embed"] = top(dense_init(gen, (cfg.max_seq, cfg.d_model),
                                        in_axis=1, dtype=dtype, device=dev))
    for g in cfg.groups:
        p[f"dec_{g.name}"] = _group_params(gen, g, cfg, dtype, dev, cdt)
    for g in cfg.encoder_groups:
        p[f"enc_{g.name}"] = _group_params(gen, g, cfg, dtype, dev, cdt)
    if cfg.encoder_groups:
        p["enc_final_norm"] = {"w": torch.ones(cfg.d_model, device=dev)}
        if cfg.norm == "layer":
            p["enc_final_norm"]["b"] = torch.zeros(cfg.d_model, device=dev)
    if cfg.mtp:
        p["mtp_proj"] = top(dense_init(gen, (2 * cfg.d_model, cfg.d_model),
                                       dtype=dtype, device=dev))
        blk = block_params(gen, cfg.groups[-1].blocks[-1], cfg, dtype, dev)
        p["mtp_block"] = blk if cdt is None else _cast_params(blk, cdt)
    if cfg.vision is not None:
        vp = vision.frontend_params(gen, cfg, dtype, dev)
        if cdt is not None:
            vp = _cast_params(vp, cdt)
        tcfg = vision.tower_config(cfg)
        vp["layers"] = vision.output_bias(
            _group_params(gen, tcfg.groups[0], tcfg, dtype, dev, cdt), dtype)
        p["vision"] = vp
    return p


def init_params(key: Union[int, torch.Generator], cfg: ModelConfig, *,
                device="cuda", trainable: bool = False) -> ParamTree:
    """Random parameters in ``cfg.param_dtype`` on ``device``, drawn from
    ``key`` (a seed, or a ``torch.Generator`` on that device).  The JAX
    package's tree layout; not its random numbers.  ``device="meta"``
    gives the shapes alone; ``trainable`` makes the parameters require
    gradients."""
    return ParamTree(_init_tree(key, cfg, resolve_device(device)),
                     trainable)


def load_params(key: Union[int, torch.Generator], cfg: ModelConfig, *,
                device="cuda") -> ParamTree:
    """The serving load: the values of ``cast_params(init_params(key,
    cfg), cfg)``, with each weight matrix cast to ``cfg.compute_dtype`` as
    soon as it is drawn.  The peak is the cast tree plus one block in
    ``cfg.param_dtype``, where drawing the whole f32 tree first would need
    both trees at once (qwen3-14b: 59 GB in f32 and 29.5 GB in bf16, over
    one card's 80 GB)."""
    return ParamTree(_init_tree(key, cfg, resolve_device(device),
                                dtype_of(cfg.compute_dtype)))


def _cast_params(tree: Tree, cdt: torch.dtype, stacked: bool = False
                 ) -> Tree:
    """Cast weight matrices to the compute dtype; norms and scalars stay
    f32.  An int8 matrix is dequantised with the JAX package's folded
    per-tensor scale 0.01.  ``stacked``: the leaves carry a leading layer
    axis, so a matrix has three dims.  A tensor already in ``cdt`` is
    returned as is, so casting once at load (:func:`cast_params`) makes
    this free."""
    min_ndim = 3 if stacked else 2

    def one(a):
        if a.dtype == torch.int8 and a.ndim >= min_ndim:
            return a.to(cdt) * torch.tensor(0.01, dtype=cdt)
        if a.dtype in (torch.float32, torch.bfloat16) and a.ndim >= min_ndim:
            return a.to(cdt)
        return a
    return _map(one, tree)


def _cast_vision(vp: Tree, cdt) -> Tree:
    """The vision frontend's leaves cast as :func:`_cast_params` casts,
    its tower's ``layers`` as stacked leaves."""
    out = _cast_params({k: v for k, v in vp.items() if k != "layers"}, cdt)
    out["layers"] = _cast_params(vp["layers"], cdt, stacked=True)
    return out


def cast_params(params: ParamTree, cfg: ModelConfig) -> ParamTree:
    """The parameters with every weight matrix cast once to
    ``cfg.compute_dtype`` — the same values every call casts to."""
    cdt = dtype_of(cfg.compute_dtype)
    return ParamTree({k: _cast_vision(v, cdt) if k == "vision"
                      else _cast_params(v, cdt, stacked=k.startswith(
                          ("dec_", "enc_"))) if isinstance(v, dict)
                      else _cast_params({k: v}, cdt)[k]
                      for k, v in params.tree().items()})


# --------------------------------------------------------------------------
# execution
# --------------------------------------------------------------------------

def _runtime(params: ParamTree, rt: Optional[Runtime]) -> Runtime:
    rt = rt if rt is not None else Runtime()
    dev = params.embed.device
    if dev.type != rt.device.type or (
            rt.device.index is not None and dev != rt.device):
        raise LPFFatalError(f"parameters live on {dev}, the runtime is on "
                            f"{rt.device}; move one of them explicitly")
    return rt


def _layers(gp: Tree, repeats: int) -> List[Tree]:
    """Per-layer views of a group's stacked leaves: one ``unbind`` per
    leaf, so the backward stacks a leaf's per-layer gradients once (an
    index per layer would add a zero-filled full-size gradient per
    layer)."""
    split = _map(lambda a: a.unbind(0), gp)
    return [_map(lambda parts, l=l: parts[l], split) for l in range(repeats)]


def _top(params: ParamTree, cdt) -> Tree:
    return _cast_params({k: v for k, v in params.tree().items()
                         if not k.startswith(("dec_", "enc_", "vision"))},
                        cdt)


def _final_norm(x, p, cfg: ModelConfig):
    if cfg.norm == "layer":
        return layer_norm(x, p["w"], p["b"])
    return rms_norm(x, p["w"], plus_one=True)


def _embed_tokens(top: Tree, tokens, cfg: ModelConfig):
    x = top["embed"][tokens]
    if cfg.scale_embed:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def _head(top: Tree, x, cfg: ModelConfig):
    w = top["embed"].T if cfg.tie_embeddings else top["head"]
    logits = (x @ w).float()
    if cfg.logit_softcap is not None:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    if cfg.vocab_padded != cfg.vocab:
        # vocab-padding columns must never win softmax/argmax (out of
        # place: the loss differentiates through the logits)
        pad = torch.arange(cfg.vocab_padded, device=logits.device) \
            >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits


def _apply_layer(layer_p: Tree, x, enc_out, g: Group, cfg: ModelConfig,
                 rt: Runtime, positions, cdt) -> torch.Tensor:
    """One layer of group ``g``; its weights cast to ``cdt`` here, inside
    whatever checkpoint wraps the layer, as the JAX scan body does, one
    block at a time (the same values; a cast copy of one block at a time,
    where a jamba period's f32 copy would not fit the card).  ``enc_out``:
    the encoder's output for cross-attention blocks, or None."""
    for i, b in enumerate(g.blocks):
        x = block_apply(_cast_params(layer_p[f"b{i}"], cdt), x, b, cfg, rt,
                        positions, enc_out)
    return x


#: what ``remat="dots"`` saves: matrix products with no batch dimension
#: (the projections and the MLP), the JAX package's
#: ``dots_with_no_batch_dims_saveable``; everything else is recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, remat: str, layer_p: Tree, x, enc_out) -> torch.Tensor:
    """``fn(layer_p, x, enc_out)``, checkpointed per ``remat`` when
    autograd records: ``"full"`` saves only the layer's input and
    recomputes the layer in the backward, ``"dots"`` also saves its
    matrix products, ``"none"`` saves everything."""
    if not torch.is_grad_enabled() or remat == "none":
        return fn(layer_p, x, enc_out)
    if remat == "full":
        return _ckpt.checkpoint(fn, layer_p, x, enc_out, use_reentrant=False)
    if remat == "dots":
        return _ckpt.checkpoint(
            fn, layer_p, x, enc_out, use_reentrant=False,
            context_fn=functools.partial(
                _ckpt.create_selective_checkpoint_contexts, _dots_policy))
    raise LPFFatalError(f"remat={remat!r}: expected full, dots or none")


def _layer(layer_p: Tree, x, enc_out, g: Group, cfg: ModelConfig,
           rt: Runtime, positions, cdt) -> torch.Tensor:
    """One layer, checkpointed per ``cfg.remat`` (:func:`_remat`)."""
    fn = functools.partial(_apply_layer, g=g, cfg=cfg, rt=rt,
                           positions=positions, cdt=cdt)
    return _remat(fn, cfg.remat, layer_p, x, enc_out)


def _run_groups(tree: Tree, prefix: str, groups, x, enc_out,
                cfg: ModelConfig, rt: Runtime, positions, cdt):
    for g in groups:
        for layer_p in _layers(tree[f"{prefix}{g.name}"], g.repeats):
            x = _layer(layer_p, x, enc_out, g, cfg, rt, positions, cdt)
    return x


def _run_encoder(params: ParamTree, frames, cfg: ModelConfig,
                 rt: Runtime) -> torch.Tensor:
    """The encoder over ``frames`` [B, Se, D] (cast to the compute
    dtype, sinusoidal positions added, no causal mask), through
    ``enc_final_norm``: the ``enc_out`` a decoder's cross-attention
    reads, at prefill and at every decode step."""
    cdt = dtype_of(cfg.compute_dtype)
    tree = params.tree()
    x = torch.as_tensor(frames, device=rt.device).to(cdt)
    B, S, _ = x.shape
    x = x + sinusoidal_positions(S, cfg.d_model, rt.device)[None].to(cdt)
    positions = torch.arange(S, device=rt.device)[None].expand(B, S)
    x = _run_groups(tree, "enc_", cfg.encoder_groups, x, None, cfg, rt,
                    positions, cdt)
    return _final_norm(x, tree["enc_final_norm"], cfg)


@span(vision.VISION_RANGE)
def _image_prefix(vp: Tree, pixels, cfg: ModelConfig, rt: Runtime, cdt
                  ) -> torch.Tensor:
    """A VLMConfig's image positions [B, n_positions, D] in ``cdt`` from
    ``pixels`` [B, n_tiles, 3, s, s] (:mod:`.vision`): the tower's run
    layers, each checkpointed as the decoder's are and run inside its
    ``vision.layer`` span (entered again by the layer's remat
    recompute), the projector and anyres packing."""
    v = cfg.vision
    tcfg = vision.tower_config(cfg)
    (g,) = tcfg.groups
    apply = functools.partial(_apply_layer, g=g, cfg=tcfg, rt=rt,
                              positions=None, cdt=cdt)

    def layer(layer_p, x, enc_out):
        with span(vision.LAYER_RANGE):
            return apply(layer_p, x, enc_out)
    px = torch.as_tensor(pixels, device=rt.device)
    B, T = px.shape[:2]
    if tracing() and torch._C._current_graph_task_id() == -1:
        # once a forward (never in a backward's recompute)
        count("vision.tiles", B * T)
        count("vision.positions", B * v.n_positions)
    top = _cast_params({k: a for k, a in vp.items() if k != "layers"}, cdt)
    with span("vision.tower"):
        x = vision.embed_tiles(top, px.reshape(B * T, *px.shape[2:]), v, cdt)
        for layer_p in _layers(vp["layers"], g.repeats):
            x = _remat(layer, tcfg.remat, layer_p, x, None)
    with span("vision.project"):
        f = vision.project(top["proj"], x[:, 1:], v)
    with span("vision.pack"):
        return vision.pack(f.reshape(B, T, v.n_patches, -1), top["newline"],
                           v)


def _hidden(params: ParamTree, batch: dict, cfg: ModelConfig, rt: Runtime,
            top: Tree):
    """Embed (the image positions of a VLMConfig's ``pixels``, or the
    vision stub's ``embeds``, before the tokens), run the encoder on
    ``frames`` where the model has one, and every decoder group; returns
    the final hidden states [B, S, D] before the final norm, the
    positions [B, S] and the prefix length (0 without either)."""
    cdt = dtype_of(cfg.compute_dtype)
    tokens = torch.as_tensor(batch["tokens"], device=rt.device).long()
    x = _embed_tokens(top, tokens, cfg).to(cdt)
    emb = None
    if cfg.vision is not None and "pixels" in batch:
        emb = _image_prefix(params.tree()["vision"], batch["pixels"], cfg,
                            rt, cdt)
    elif cfg.modality == "vision" and "embeds" in batch:
        emb = torch.as_tensor(batch["embeds"], device=rt.device).to(cdt)
    n_prefix = 0
    if emb is not None:
        n_prefix = emb.shape[1]
        x = torch.cat([emb, x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, device=rt.device)[None].expand(B, S)
    if cfg.pos_embed == "learned":
        x = x + top["pos_embed"][:S][None].to(cdt)
    elif cfg.pos_embed == "sinusoidal":
        x = x + sinusoidal_positions(S, cfg.d_model, rt.device)[None].to(cdt)
    enc_out = None
    if cfg.encoder_groups:
        enc_out = _run_encoder(params, batch["frames"], cfg, rt)
    x = _run_groups(params.tree(), "dec_", cfg.groups, x, enc_out, cfg, rt,
                    positions, cdt)
    return x, positions, n_prefix


def _logits(top: Tree, x, batch: dict, positions, n_prefix: int,
            cfg: ModelConfig, rt: Runtime):
    """The final norm and head over the text positions; with MTP also the
    MTP head's logits (the final hidden state joined with the next
    token's embedding, one more block of the last group's kind)."""
    cdt = dtype_of(cfg.compute_dtype)
    x = _final_norm(x, top["final_norm"], cfg)[:, n_prefix:]
    logits = _head(top, x, cfg)
    if not cfg.mtp:
        return logits
    tokens = torch.as_tensor(batch["tokens"], device=rt.device).long()
    emb_next = torch.roll(_embed_tokens(top, tokens, cfg), -1, dims=1)
    h = torch.cat([x.to(cdt), emb_next.to(cdt)], dim=-1) @ top["mtp_proj"]
    h = block_apply(top["mtp_block"], h, cfg.groups[-1].blocks[-1], cfg, rt,
                    positions)
    return logits, _head(top, _final_norm(h, top["final_norm"], cfg), cfg)


@torch.no_grad()
def forward(params: ParamTree, batch: dict, cfg: ModelConfig,
            rt: Optional[Runtime] = None) -> torch.Tensor:
    """Prefill forward -> logits [B, S, V_padded] (f32) over the text
    positions; with MTP ``(logits, logits_mtp)``."""
    rt = _runtime(params, rt)
    top = _top(params, dtype_of(cfg.compute_dtype))
    x, positions, n_prefix = _hidden(params, batch, cfg, rt, top)
    return _logits(top, x, batch, positions, n_prefix, cfg, rt)


@torch.no_grad()
def prefill(params: ParamTree, batch: dict, cfg: ModelConfig,
            rt: Optional[Runtime] = None) -> torch.Tensor:
    """Last-position logits [B, V_padded] (f32).  The final norm and head
    are row-wise, so they run on the last position only: the same numbers
    as ``forward(...)[:, -1]`` (its first output with MTP, whose head a
    prefill does not need) without the [B, S, V] logits."""
    rt = _runtime(params, rt)
    top = _top(params, dtype_of(cfg.compute_dtype))
    x = _hidden(params, batch, cfg, rt, top)[0][:, -1]
    return _head(top, _final_norm(x, top["final_norm"], cfg), cfg)


def loss_fn(params: ParamTree, batch: dict, cfg: ModelConfig,
            rt: Optional[Runtime] = None) -> torch.Tensor:
    """Mean next-token cross-entropy over the labels that are not -1 (a
    0-d f32 tensor), with autograd; with MTP plus 0.3 times the MTP
    head's against the labels shifted by one.  The label's logit is
    gathered: the value the JAX package's one-hot einsum computes,
    without the ``[B, S, V]`` one-hot."""
    rt = _runtime(params, rt)
    top = _top(params, dtype_of(cfg.compute_dtype))
    x, positions, n_prefix = _hidden(params, batch, cfg, rt, top)
    out = _logits(top, x, batch, positions, n_prefix, cfg, rt)
    labels = torch.as_tensor(batch["labels"], device=rt.device).long()

    def xent(logits, labels):
        lse = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
        mask = (labels >= 0).float()
        return ((lse - picked) * mask).sum() / mask.sum().clamp_min(1.0)

    if not cfg.mtp:
        return xent(out, labels)
    logits, logits_mtp = out
    labels2 = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], -1)],
                        dim=1)
    return xent(logits, labels) + 0.3 * xent(logits_mtp, labels2)


def init_caches(cfg: ModelConfig, batch: int, cache_len: int, dtype=None,
                *, device="cuda") -> Tree:
    """Zeroed caches ``{group: {"b<i>": {...}}}`` in the JAX layout, each
    leaf ``[repeats, batch, ...]``: an attention block's ``k``, ``v``
    ``[.., cache_len, n_kv, hd]``; a Mamba block's ``ssm`` state
    ``[.., H, N, P]`` (f32) and ``conv`` window ``[.., 3, conv_dim]``; an
    MLA block's compressed ``ckv`` ``[.., cache_len, kv_lora]`` and
    ``krope`` ``[.., cache_len, dh_rope]``."""
    dev = resolve_device(device)
    dtype = dtype or dtype_of(cfg.compute_dtype)
    caches: Tree = {}
    for g in cfg.groups:
        caches[g.name] = _stack_trees([
            {f"b{i}": block_init_cache(b, cfg, batch, cache_len, dtype, dev)
             for i, b in enumerate(g.blocks)} for _ in range(g.repeats)])
    return caches


@torch.no_grad()
def decode_step(params: ParamTree, token, caches: Tree,
                pos: Union[int, torch.Tensor], cfg: ModelConfig,
                rt: Optional[Runtime] = None, enc_out=None):
    """One greedy decode step.  token [B] int; ``pos`` the absolute
    position of the new token (KV-cache writes roll modulo the cache
    length; every cache is updated in place).  ``pos`` is a Python int,
    or a 0-d long tensor on ``rt.device``: then no step reads it on the
    host, so the step can be captured as a CUDA graph and replayed at the
    position the tensor holds.  Both give the same values.  ``enc_out``
    [B, Se, D]: an encoder-decoder's encoder output, from which every
    cross-attention block recomputes its K/V.  Returns (next_token [B],
    logits [B, V_padded], caches)."""
    rt = _runtime(params, rt)
    cdt = dtype_of(cfg.compute_dtype)
    if not isinstance(pos, torch.Tensor):
        pos = int(pos)
    top = _top(params, cdt)
    token = torch.as_tensor(token, device=rt.device).long()
    x = _embed_tokens(top, token, cfg).to(cdt)
    if cfg.pos_embed == "learned":
        if isinstance(pos, torch.Tensor):
            row = top["pos_embed"].index_select(
                0, pos.clamp(max=cfg.max_seq - 1).reshape(1))
        else:
            row = top["pos_embed"][min(pos, cfg.max_seq - 1)][None]
        x = x + row.to(cdt)
    tree = params.tree()
    for g in cfg.groups:
        gc = caches[g.name]
        for l, layer_p in enumerate(_layers(tree[f"dec_{g.name}"],
                                            g.repeats)):
            for i, b in enumerate(g.blocks):
                cache_l = {k: c[l] for k, c in gc[f"b{i}"].items()}
                x, _ = block_decode(_cast_params(layer_p[f"b{i}"], cdt), x,
                                    cache_l, b, cfg, rt, pos, enc_out)
    x = _final_norm(x, top["final_norm"], cfg)
    logits = _head(top, x, cfg)
    # torch.argmax returns the first maximal index, as jnp.argmax does
    nxt = torch.argmax(logits, dim=-1)
    return nxt, logits, caches


# --------------------------------------------------------------------------
# accounting
# --------------------------------------------------------------------------

def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """The parameter count, from the tree's shapes (built on the meta
    device: nothing is allocated).  ``active_only``: the JAX package's
    rule, each leaf under ``moe`` whose name starts ``w_`` (the experts,
    padded ones included) counted at ``top_k / n_experts``."""
    params = init_params(0, cfg, device="meta")
    total = moe_total = 0
    for name, p in params.named_parameters():
        total += p.numel()
        keys = name.split(".")
        if "moe" in keys and any(k.startswith("w_") for k in keys):
            moe_total += p.numel()
    if not active_only or cfg.moe is None:
        return total
    frac = cfg.moe.top_k / cfg.moe.n_experts
    return int(total - moe_total + moe_total * frac)


def model_flops(cfg: ModelConfig, tokens: int) -> float:
    """6*N*D useful-training flops (6*N_active*D for MoE); for serve cells
    the caller divides by 3 (forward only)."""
    return 6.0 * count_params(cfg, active_only=True) * tokens
