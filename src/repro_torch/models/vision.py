"""LLaVA-NeXT's vision frontend: a CLIP ViT tower over an image's tiles,
the projector and anyres packing (:class:`~.config.VisionCfg`), which
turn a batch's ``pixels`` [B, n_tiles, 3, image_size, image_size] into
each sample's image positions [B, n_positions, d_model] before its
tokens (:func:`repro_torch.models.lm._image_prefix` runs them).

* Patch embedding: CLIP's ``patch_size``-stride convolution (3 ->
  d_model, no bias) as one GEMM over the tiles' unfolded patches; the
  patch's values are ordered (channel, row, column), the convolution
  weight's ``[out, 3, p, p]`` flattened and transposed (``patch_embed``
  [3 p^2, d_model]).  Then the class token (``class_embed``), the
  learned positions (``pos_embed`` [1 + n_patches, d_model]) and CLIP's
  ``pre_layrnorm`` (``pre_norm``).
* The encoder: :func:`tower_config`'s ``run_layers`` pre-LayerNorm
  blocks of :mod:`.blocks` (non-causal attention with biases on q, k, v
  and, :func:`output_bias`, the output, ``ffn="quick_gelu"``), the
  stacked ``layers`` group, checkpointed as the language model's layers
  are.  The class position
  is dropped from their output.
* The projector (``proj``): Linear d_model -> D, exact GELU, Linear D ->
  D, with biases (:func:`~.blocks.fc_mlp`).
* :func:`pack`: the base tile's vectors, then the grid's as one map with
  ``newline`` [D] after each of its rows.

Weight matrices are ``[in, out]``; LayerNorm scales start at 1, biases
at 0, as the tower's blocks do.

Spans (:mod:`repro_torch.core.trace`): ``VISION_RANGE`` (``vision``)
encloses the frontend's forward, ``vision.tower`` (patch embedding
through the last run layer), ``vision.project`` and ``vision.pack``
inside it; each tower layer runs inside ``LAYER_RANGE``
(``vision.layer``), in the forward and in its remat recompute, so a
reader ties every forward, recompute and backward op of the frontend to
the two ranges.  Counters: ``vision.tiles`` (tiles encoded) and
``vision.positions`` (image positions packed), once a forward.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .blocks import fc_mlp, fc_params
from .common import dense_init, layer_norm
from .config import BlockCfg, Group, ModelConfig, VisionCfg

__all__ = ["VISION_RANGE", "LAYER_RANGE", "tower_config", "frontend_params",
           "output_bias", "patchify", "embed_tiles", "project", "pack"]

Tree = Dict[str, Any]

VISION_RANGE = "vision"
LAYER_RANGE = "vision.layer"


def tower_config(cfg: ModelConfig) -> ModelConfig:
    """The tower's encoder as a model config of one group, ``layers``:
    ``cfg.vision.run_layers`` CLIP blocks at the tower's widths, under
    ``cfg``'s attention implementation, remat and dtypes."""
    v = cfg.vision
    return ModelConfig(
        name=cfg.name + "-tower", d_model=v.d_model, vocab=0,
        groups=(Group("layers", (BlockCfg("attn", v.act, causal=False),),
                      v.run_layers),),
        n_heads=v.n_heads, n_kv=v.n_heads, head_dim=v.d_model // v.n_heads,
        d_ff=v.d_ff, qkv_bias=True, norm="layer", pos_embed="none",
        attn_impl=cfg.attn_impl, q_chunk=cfg.q_chunk, remat=cfg.remat,
        param_dtype=cfg.param_dtype, compute_dtype=cfg.compute_dtype)


def frontend_params(gen, cfg: ModelConfig, dtype, device) -> Tree:
    """The frontend's leaves but the tower's layers: patch embedding,
    class token, positions, ``pre_norm``, projector and newline."""
    v, D = cfg.vision, cfg.d_model
    init = lambda shape, in_axis=0: dense_init(
        gen, shape, in_axis=in_axis, dtype=dtype, device=device)
    return {
        "patch_embed": init((3 * v.patch_size ** 2, v.d_model)),
        "class_embed": init((v.d_model,)),
        "pos_embed": init((1 + v.n_patches, v.d_model), in_axis=1),
        "pre_norm": {"w": torch.ones(v.d_model, device=device),
                     "b": torch.zeros(v.d_model, device=device)},
        "proj": fc_params(gen, v.d_model, D, D, dtype, device),
        "newline": init((D,)),
    }


def output_bias(layers: Tree, dtype) -> Tree:
    """The tower's stacked ``layers`` with CLIP's output-projection bias
    ``attn.bo`` [repeats, d_model] added, at 0.  :mod:`.blocks` adds
    ``attn.bo`` where the tree holds one: a field for it would make
    ``BlockCfg`` and ``ModelConfig`` differ from the JAX package's."""
    wo = layers["b0"]["attn"]["wo"]
    layers["b0"]["attn"]["bo"] = torch.zeros(wo.shape[0], wo.shape[-1],
                                             dtype=dtype, device=wo.device)
    return layers


def patchify(pixels: torch.Tensor, patch: int) -> torch.Tensor:
    """[N, C, H, W] -> [N, (H/p)(W/p), C p p]: the patches row by row,
    each's values ordered (channel, row, column)."""
    N, C, H, W = pixels.shape
    x = pixels.reshape(N, C, H // patch, patch, W // patch, patch)
    return x.permute(0, 2, 4, 1, 3, 5).reshape(
        N, (H // patch) * (W // patch), C * patch * patch)


def embed_tiles(vp: Tree, pixels: torch.Tensor, v: VisionCfg,
                cdt) -> torch.Tensor:
    """Tiles [N, 3, s, s] -> the tower's input [N, 1 + n_patches,
    d_model] in ``cdt``: patch embedding, class token first, positions
    added, ``pre_norm``.  ``vp``'s matrices already in ``cdt``."""
    x = patchify(pixels.to(cdt), v.patch_size) @ vp["patch_embed"]
    cls = vp["class_embed"].to(cdt).expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], dim=1) + vp["pos_embed"][None]
    return layer_norm(x, vp["pre_norm"]["w"], vp["pre_norm"]["b"])


def project(p: Tree, x: torch.Tensor, v: VisionCfg) -> torch.Tensor:
    """The projector on the tower's features [..., d_model] -> [..., D]."""
    return fc_mlp(p, x, v.projector_act)


def pack(f: torch.Tensor, newline: torch.Tensor, v: VisionCfg
         ) -> torch.Tensor:
    """Projected tiles [B, n_tiles, n_patches, D] -> packed images [B,
    n_positions, D]: the base tile (tile 0) as is, then the grid's tiles
    (row by row) as one map of ``grid[0] * side`` rows and ``grid[1] *
    side`` columns, read row by row with ``newline`` after each row."""
    B, _, _, D = f.shape
    (gr, gc), s = v.grid, v.side
    grid = f[:, 1:].reshape(B, gr, gc, s, s, D).permute(0, 1, 3, 2, 4, 5) \
        .reshape(B, gr * s, gc * s, D)
    nl = newline.to(f.dtype).expand(B, gr * s, 1, D)
    rows = torch.cat([grid, nl], dim=2).reshape(B, gr * s * (gc * s + 1), D)
    return torch.cat([f[:, 0], rows], dim=1)
