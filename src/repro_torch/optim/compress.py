"""Gradient compression with error feedback — the JAX package's
``repro.optim.compress`` (the COMPRESSED sync attribute's
convergence-safe companion) over the port's name -> tensor trees.

``ef_compress``: quantise (grad + residual) to int8 per leaf, return the
quantised update, its scales and the *new* residual (what quantisation
lost).  The residual rides in the optimizer state, so information is
delayed, never destroyed.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .adamw import Tree, _map, _pick

__all__ = ["ef_init", "ef_compress", "ef_decompress"]


def ef_init(params: Tree) -> Tree:
    """A zero f32 residual for every leaf."""
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)


def _q(leaf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = leaf.abs().max() / 127.0 + 1e-30
    q = torch.clamp(torch.round(leaf / scale), -127, 127).to(torch.int8)
    return q, scale


def ef_compress(grads: Tree, residual: Tree) -> Tuple[Tree, Tree, Tree]:
    """Returns (int8 grads, f32 0-d scales, new residual)."""
    def one(g, r):
        x = g.detach().float() + r
        q, s = _q(x)
        return q, s, x - q.float() * s
    out = _map(one, grads, residual)
    return _pick(out, 0), _pick(out, 1), _pick(out, 2)


def ef_decompress(q_grads: Tree, scales: Tree,
                  dtype: torch.dtype = torch.float32) -> Tree:
    """Dequantise ``q * scale`` per leaf (f32, as in the JAX package)."""
    return _map(lambda q, s: q.float() * s, q_grads, scales)
