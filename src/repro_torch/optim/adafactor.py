"""Adafactor (factored second moments) — the JAX package's
``repro.optim.adafactor`` over the port's name -> tensor trees: the
memory-lean optimizer option, v stored as row/column statistics for
matrices, cutting optimizer memory from 2x to ~1x+eps of the parameter
count.

Functional, as in JAX: :func:`adafactor_update` returns new parameters
and a new state and changes neither argument.  The state is ``{"acc":
tree, "step": int}``, ``acc`` holding per leaf ``{"vr": ..., "vc": ...}``
(a factored matrix: both trailing dims at least ``min_dim_factored``) or
``{"v": ...}``, all f32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from .adamw import Tree, _pick

__all__ = ["AdafactorConfig", "adafactor_init", "adafactor_update"]


@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    lr: Any = 1e-3               # float or callable(step) -> float
    decay: float = 0.8           # t^-decay second-moment schedule
    eps: float = 1e-30
    clip_threshold: float = 1.0
    min_dim_factored: int = 128


def _factored(p: torch.Tensor, cfg: AdafactorConfig) -> bool:
    return p.ndim >= 2 and p.shape[-1] >= cfg.min_dim_factored \
        and p.shape[-2] >= cfg.min_dim_factored


def _over(fn, params: Tree, *trees: Tree) -> Tree:
    """``fn(leaf, *matching)`` over ``params``' leaves; the other trees
    follow params' structure (their own leaves may be dicts)."""
    return {k: _over(fn, v, *(t[k] for t in trees)) if isinstance(v, dict)
            else fn(v, *(t[k] for t in trees)) for k, v in params.items()}


def adafactor_init(params: Tree,
                   cfg: AdafactorConfig = AdafactorConfig()) -> Tree:
    def one(p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if _factored(p, cfg):
            return {"vr": torch.zeros(p.shape[:-1], **f32),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        return {"v": torch.zeros(p.shape, **f32)}
    return {"acc": _over(one, params), "step": 0}


def adafactor_update(grads: Tree, state: Tree, params: Tree,
                     cfg: AdafactorConfig = AdafactorConfig()
                     ) -> Tuple[Tree, Tree, Dict[str, Any]]:
    """Returns (new_params, new_state, metrics) with metrics
    ``{"lr": float}``."""
    step = state["step"] + 1
    # the JAX package computes the schedule in f32
    beta2 = float(1.0 - torch.tensor(float(step)) ** (-cfg.decay))
    lr = float(cfg.lr(step) if callable(cfg.lr) else cfg.lr)

    def upd(p, g, acc):
        gf = g.detach().float()
        g2 = gf * gf + cfg.eps
        if "vr" in acc:
            vr = beta2 * acc["vr"] + (1 - beta2) * g2.mean(dim=-1)
            vc = beta2 * acc["vc"] + (1 - beta2) * g2.mean(dim=-2)
            denom = torch.sqrt(
                vr[..., None] * vc[..., None, :]
                / torch.clamp(vr.mean(dim=-1, keepdim=True)[..., None],
                              min=cfg.eps))
            upd_v = gf / torch.clamp(denom, min=cfg.eps)
            new_acc = {"vr": vr, "vc": vc}
        else:
            v = beta2 * acc["v"] + (1 - beta2) * g2
            upd_v = gf / (torch.sqrt(v) + cfg.eps)
            new_acc = {"v": v}
        rms = torch.sqrt(torch.mean(torch.square(upd_v)) + 1e-30)
        upd_v = upd_v / torch.clamp(rms / cfg.clip_threshold, min=1.0)
        p = p.detach()
        return (p.float() - lr * upd_v).to(p.dtype), new_acc

    out = _over(upd, params, grads, state["acc"])
    return (_pick(out, 0), {"acc": _pick(out, 1), "step": step},
            {"lr": lr})
