"""AdamW with decoupled weight decay and global-norm clipping — the JAX
package's ``repro.optim.adamw`` over the port's name -> tensor trees.

Functional, as in JAX: :func:`adamw_update` returns new parameters and a
new state and changes neither argument.  A tree is a nested dict of
tensors (``ParamTree.tree()``); the state is ``{"m": tree, "v": tree,
"step": int}`` with the moments in ``moment_dtype`` (f32) whatever the
parameters' dtype.

Weight decay follows the JAX rule as stored: a leaf with ``ndim > 1`` is
decayed.  A group's leaves are stacked ``[repeats, ...]``, so the block
norms (``dec_body.b0.ln1.w``, shape ``[repeats, d]``) are decayed, and
only unstacked vectors (``final_norm.w``) are spared; the port keeps that
so the two packages agree (ROADMAP C).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm"]

Tree = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Any = 3e-4                       # float or callable(step) -> float
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    moment_dtype: torch.dtype = torch.float32


def _map(fn, *trees: Tree) -> Tree:
    first = trees[0]
    return {k: _map(fn, *(t[k] for t in trees)) if isinstance(first[k], dict)
            else fn(*(t[k] for t in trees)) for k in first}


def _leaves(tree: Tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def adamw_init(params: Tree, cfg: AdamWConfig = AdamWConfig()) -> Tree:
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.moment_dtype,
                                  device=p.device)
    return {"m": _map(zeros, params), "v": _map(zeros, params), "step": 0}


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a 0-d tensor)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in _leaves(tree)))


def adamw_update(grads: Tree, state: Tree, params: Tree,
                 cfg: AdamWConfig = AdamWConfig(), *, donate: bool = False
                 ) -> Tuple[Tree, Tree, Dict[str, Any]]:
    """Returns (new_params, new_state, metrics) with metrics
    ``{"grad_norm": 0-d tensor, "lr": float}``.

    ``donate=True`` is the JAX package's buffer donation: the update
    consumes its arguments — ``params``, the moments and ``grads`` are
    written in place, slice by slice along each leaf's leading axis, and
    returned — so the step's peak holds one set of parameters and
    moments, not two (granite-moe-3b-a800m's 52.8 GB of f32 state fits
    one card only so)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    # clipped leaf by leaf inside ``upd``: a clipped copy of the whole tree
    # would be one more f32 tree at the update's peak
    scale = None if cfg.clip_norm is None else torch.clamp(
        cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = float(cfg.lr(step) if callable(cfg.lr) else cfg.lr)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - b1 ** step
    c2 = 1.0 - b2 ** step

    def upd(p, g, m, v):
        p = p.detach()
        if scale is not None:
            g = g * scale.to(g.dtype)
        gf = g.to(cfg.moment_dtype)
        m2 = b1 * m + (1 - b1) * gf
        v2 = b2 * v + (1 - b2) * gf * gf
        delta = (m2 / c1) / (torch.sqrt(v2 / c2) + cfg.eps)
        if p.ndim > 1:          # the JAX rule: stacked norms are decayed
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m2, v2

    def upd_inplace(p, g, m, v):
        # the same arithmetic on at most _DONATE_SLICE elements at a time:
        # the temporaries stay a slice's, whatever the leaf's size
        p, g = p.detach(), g.detach()
        rows = max(1, _DONATE_SLICE // max(1, p[0].numel())) \
            if p.ndim > 1 else p.shape[0] if p.ndim else 1
        for i in range(0, p.shape[0] if p.ndim else 1, rows):
            sl = (slice(i, i + rows),) if p.ndim else ()
            pp, gg, mm, vv = p[sl], g[sl], m[sl], v[sl]
            if scale is not None:
                gg.mul_(scale.to(gg.dtype))
            gf = gg.to(cfg.moment_dtype)
            mm.mul_(b1).add_(gf, alpha=1 - b1)
            vv.mul_(b2).addcmul_(gf, gf, value=1 - b2)
            delta = (mm / c1).div_((vv / c2).sqrt_().add_(cfg.eps))
            if p.ndim > 1:
                delta.add_(pp.float(), alpha=cfg.weight_decay)
            pp.copy_(pp.float() - lr * delta)
        return p, m, v

    out = _map(upd_inplace if donate else upd, params, grads, state["m"],
               state["v"])
    new_state = {"m": _pick(out, 1), "v": _pick(out, 2), "step": step}
    return _pick(out, 0), new_state, {"grad_norm": gnorm, "lr": lr}


#: elements of a leaf one in-place update slice covers (``donate=True``)
_DONATE_SLICE = 1 << 26


def _pick(tree: Tree, i: int) -> Tree:
    """Element ``i`` of every tuple leaf."""
    return {k: _pick(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}
