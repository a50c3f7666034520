"""The language model on one device: embed -> block groups -> head, with
the training loss, prefill and single-token greedy decode (decoder-only:
dense attention blocks and Mamba-2 blocks).

Parameters live in a :class:`ParamTree`, an ``nn.Module`` whose
parameters are named as in the JAX tree (``embed``, ``final_norm.w``,
``dec_body.b0.attn.wq``, ...).  A group's leaves are stacked
``[repeats, ...]`` as the JAX package's ``vmap`` stacks them, and weight
matrices keep the ``[in, out]`` layout, so carrying a JAX tree across is a
copy (:func:`repro_torch.interop.params_from_jax`).

Batch conventions (as in ``repro.models.lm``)::

    train:    {"tokens" [B, S] int, "labels" [B, S] int (-1 = masked)}
    prefill:  {"tokens" [B, S] int}
    decode:   decode_step(params, token [B] int, caches, pos, cfg, rt)
              (pos an int, or a 0-d long tensor on the device)

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


def _check_blocks(cfg: ModelConfig) -> None:
    if cfg.encoder_groups or cfg.modality != "none" or cfg.mtp:
        raise LPFFatalError(
            f"{cfg.name}: encoder-decoder, modality-stub and multi-token-"
            f"prediction models are not ported yet (ROADMAP A8)")


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
    """A group's leaves stacked ``[repeats, ...]``: each layer is drawn
    as a per-layer init draws it (what ``jax.vmap`` stacks), copied into
    the stacked leaves and dropped, so the peak is the stacked tree plus
    one layer.  ``cdt`` casts each layer's weight matrices as
    :func:`cast_params` does before they are stored."""
    out: Optional[Tree] = None
    for l in range(g.repeats):
        layer = {f"b{i}": block_params(gen, b, cfg, dtype, device)
                 for i, b in enumerate(g.blocks)}
        if cdt is not None:
            layer = _cast_params(layer, cdt)
        if out is None:
            out = _map(lambda a: a.new_empty((g.repeats, *a.shape)), layer)
        _map2(lambda dst, src, l=l: dst[l].copy_(src), out, layer)
        del layer
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
    _check_blocks(cfg)
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
    soon as it is drawn.  The peak is the cast tree plus one layer in
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


def cast_params(params: ParamTree, cfg: ModelConfig) -> ParamTree:
    """The parameters with every weight matrix cast once to
    ``cfg.compute_dtype`` — the same values every call casts to."""
    cdt = dtype_of(cfg.compute_dtype)
    return ParamTree({k: _cast_params(v, cdt, stacked=k.startswith(
        ("dec_", "enc_"))) if isinstance(v, dict) else _cast_params(
        {k: v}, cdt)[k] for k, v in params.tree().items()})


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
                         if not k.startswith(("dec_", "enc_"))}, cdt)


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


def _apply_layer(layer_p: Tree, x, g: Group, cfg: ModelConfig, rt: Runtime,
                 positions, cdt) -> torch.Tensor:
    """One layer of group ``g``; its weights cast to ``cdt`` here, inside
    whatever checkpoint wraps the layer, as the JAX scan body does."""
    layer_p = _cast_params(layer_p, cdt)
    for i, b in enumerate(g.blocks):
        x = block_apply(layer_p[f"b{i}"], x, b, cfg, rt, positions)
    return x


#: what ``remat="dots"`` saves: matrix products with no batch dimension
#: (the projections and the MLP), the JAX package's
#: ``dots_with_no_batch_dims_saveable``; everything else is recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _layer(layer_p: Tree, x, g: Group, cfg: ModelConfig, rt: Runtime,
           positions, cdt) -> torch.Tensor:
    """One layer, checkpointed per ``cfg.remat`` when autograd records:
    ``"full"`` saves only the layer's input and recomputes the layer in
    the backward, ``"dots"`` also saves its matrix products, ``"none"``
    saves everything."""
    fn = functools.partial(_apply_layer, g=g, cfg=cfg, rt=rt,
                           positions=positions, cdt=cdt)
    if not torch.is_grad_enabled() or cfg.remat == "none":
        return fn(layer_p, x)
    if cfg.remat == "full":
        return _ckpt.checkpoint(fn, layer_p, x, use_reentrant=False)
    if cfg.remat == "dots":
        return _ckpt.checkpoint(
            fn, layer_p, x, use_reentrant=False,
            context_fn=functools.partial(
                _ckpt.create_selective_checkpoint_contexts, _dots_policy))
    raise LPFFatalError(f"remat={cfg.remat!r}: expected full, dots or none")


def _hidden(params: ParamTree, batch: dict, cfg: ModelConfig, rt: Runtime,
            top: Tree) -> torch.Tensor:
    """Embed and run every block group; the final hidden states [B, S, D]
    before the final norm."""
    _check_blocks(cfg)
    cdt = dtype_of(cfg.compute_dtype)
    tokens = torch.as_tensor(batch["tokens"], device=rt.device).long()
    x = _embed_tokens(top, tokens, cfg).to(cdt)
    B, S, _ = x.shape
    positions = torch.arange(S, device=rt.device)[None].expand(B, S)
    if cfg.pos_embed == "learned":
        x = x + top["pos_embed"][:S][None].to(cdt)
    elif cfg.pos_embed == "sinusoidal":
        x = x + sinusoidal_positions(S, cfg.d_model, rt.device)[None].to(cdt)
    tree = params.tree()
    for g in cfg.groups:
        for layer_p in _layers(tree[f"dec_{g.name}"], g.repeats):
            x = _layer(layer_p, x, g, cfg, rt, positions, cdt)
    return x


@torch.no_grad()
def forward(params: ParamTree, batch: dict, cfg: ModelConfig,
            rt: Optional[Runtime] = None) -> torch.Tensor:
    """Prefill forward -> logits [B, S, V_padded] (f32)."""
    rt = _runtime(params, rt)
    top = _top(params, dtype_of(cfg.compute_dtype))
    x = _hidden(params, batch, cfg, rt, top)
    return _head(top, _final_norm(x, top["final_norm"], cfg), cfg)


@torch.no_grad()
def prefill(params: ParamTree, batch: dict, cfg: ModelConfig,
            rt: Optional[Runtime] = None) -> torch.Tensor:
    """Last-position logits [B, V_padded] (f32).  The final norm and head
    are row-wise, so they run on the last position only: the same numbers
    as ``forward(...)[:, -1]`` without the [B, S, V] logits."""
    rt = _runtime(params, rt)
    top = _top(params, dtype_of(cfg.compute_dtype))
    x = _hidden(params, batch, cfg, rt, top)[:, -1]
    return _head(top, _final_norm(x, top["final_norm"], cfg), cfg)


def loss_fn(params: ParamTree, batch: dict, cfg: ModelConfig,
            rt: Optional[Runtime] = None) -> torch.Tensor:
    """Mean next-token cross-entropy over the labels that are not -1 (a
    0-d f32 tensor), with autograd.  The label's logit is gathered: the
    value the JAX package's one-hot einsum computes, without the
    ``[B, S, V]`` one-hot."""
    rt = _runtime(params, rt)
    top = _top(params, dtype_of(cfg.compute_dtype))
    x = _hidden(params, batch, cfg, rt, top)
    logits = _head(top, _final_norm(x, top["final_norm"], cfg), cfg)
    labels = torch.as_tensor(batch["labels"], device=rt.device).long()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((lse - picked) * mask).sum() / mask.sum().clamp_min(1.0)


def init_caches(cfg: ModelConfig, batch: int, cache_len: int, dtype=None,
                *, device="cuda") -> Tree:
    """Zeroed caches ``{group: {"b<i>": {...}}}`` in the JAX layout, each
    leaf ``[repeats, batch, ...]``: an attention block's ``k``, ``v``
    ``[.., cache_len, n_kv, hd]``; a Mamba block's ``ssm`` state
    ``[.., H, N, P]`` (f32) and ``conv`` window ``[.., 3, conv_dim]``."""
    _check_blocks(cfg)
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
                rt: Optional[Runtime] = None):
    """One greedy decode step.  token [B] int; ``pos`` the absolute
    position of the new token (KV-cache writes roll modulo the cache
    length; every cache is updated in place).  ``pos`` is a Python int,
    or a 0-d long tensor on ``rt.device``: then no step reads it on the
    host, so the step can be captured as a CUDA graph and replayed at the
    position the tensor holds.  Both give the same values.  Returns
    (next_token [B], logits [B, V_padded], caches)."""
    rt = _runtime(params, rt)
    _check_blocks(cfg)
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
            layer_p = _cast_params(layer_p, cdt)
            for i, b in enumerate(g.blocks):
                cache_l = {k: c[l] for k, c in gc[f"b{i}"].items()}
                x, _ = block_decode(layer_p[f"b{i}"], x, cache_l, b, cfg,
                                    rt, pos)
    x = _final_norm(x, top["final_norm"], cfg)
    logits = _head(top, x, cfg)
    # torch.argmax returns the first maximal index, as jnp.argmax does
    nxt = torch.argmax(logits, dim=-1)
    return nxt, logits, caches


# --------------------------------------------------------------------------
# accounting
# --------------------------------------------------------------------------

def count_params(cfg: ModelConfig) -> int:
    """The parameter count, from the tree's shapes (built on the meta
    device: nothing is allocated).  MoE blocks are not ported, so every
    parameter is active: the JAX package's ``active_only`` count is the
    same number."""
    params = init_params(0, cfg, device="meta")
    return sum(p.numel() for p in params.parameters())


def model_flops(cfg: ModelConfig, tokens: int) -> float:
    """6*N*D useful-training flops; for serve cells the caller divides by
    3 (forward only)."""
    return 6.0 * count_params(cfg) * tokens
