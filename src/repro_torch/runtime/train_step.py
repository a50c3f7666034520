"""Train- and serve-step builders on one device — the JAX package's
``repro.runtime.train_step`` (``TrainStep``, ``build_train_step``,
``ServeStep``, ``build_serve_step``, ``build_serve_buckets``).

The JAX package jits its steps with parameter, optimizer and cache
shardings over a mesh.  On one card there are no shardings and nothing is
jitted: each step is eager PyTorch.

*Training.*  ``step_fn(params, opt, batch) -> (params, opt, metrics)`` is
the loss and its gradients (``torch.autograd.grad`` through
:func:`~repro_torch.models.lm.loss_fn`: the flash-attention kernels'
forward and backward on the card) followed by
:func:`~repro_torch.optim.adamw_update`, functional as in JAX: the
arguments are left as they were and new trees are returned.
``grad_accum`` loops over microbatches and averages their gradients in
f32; ``steps_per_call`` rolls K steps into one call over a batch with a
leading ``[K]`` axis and returns ``[K]`` metrics.  One card is one pod,
so ``grad_sync="lpf"`` is the plain step, as in JAX with one pod; what
needs pods (``pod_sync``, compressed or bucketed sync, local SGD) raises
(ROADMAP A10).

*Serving.*  ``step_fn`` is one eager decode step, and ``decode_fn(n)`` is
the greedy loop over it, so the two run the same calls.  They part when
the loop is captured as a CUDA graph (later work).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from ..core.errors import LPFFatalError
from ..models.blocks import Runtime
from ..models.config import ModelConfig
from ..models.lm import ParamTree, decode_step, init_params, loss_fn
from ..optim import AdamWConfig, adamw_init, adamw_update

__all__ = ["TrainStep", "build_train_step", "ServeStep", "build_serve_step",
           "build_serve_buckets"]

Tree = Dict[str, Any]


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

@dataclasses.dataclass
class TrainStep:
    #: (params, opt, batch) -> (params, opt, metrics)
    step_fn: Callable
    #: (seed) -> (params, opt): trainable f32 parameters and AdamW state
    init_fn: Callable
    #: () -> (params, opt) on the meta device: the structure, shapes and
    #: dtypes a checkpoint restores onto, with nothing allocated
    like_fn: Callable
    rt: Runtime


def _fill(tree: Tree, values) -> Tree:
    """``tree``'s structure with its leaves taken in order from the
    iterator ``values``."""
    return {k: _fill(v, values) if isinstance(v, dict) else next(values)
            for k, v in tree.items()}


def build_train_step(cfg: ModelConfig, *,
                     opt_cfg: AdamWConfig = AdamWConfig(),
                     grad_sync: str = "gspmd",
                     sync_attrs: Optional[Any] = None,
                     grad_accum: int = 1,
                     steps_per_call: int = 1,
                     device="cuda") -> TrainStep:
    """The training step of ``cfg`` on ``device`` (the card unless the
    caller asks for the CPU)."""
    if grad_sync not in ("gspmd", "lpf"):
        raise LPFFatalError(f"grad_sync={grad_sync!r}: expected gspmd or "
                            f"lpf")
    if sync_attrs is not None:
        raise LPFFatalError(
            "sync attributes (compressed or staled cross-pod gradient sync) "
            "need pods and bsp.pod_sync, which are not ported yet "
            "(ROADMAP A10)")
    if grad_accum < 1 or steps_per_call < 1:
        raise LPFFatalError(f"grad_accum={grad_accum} and steps_per_call="
                            f"{steps_per_call} must be >= 1")
    rt = Runtime(device)

    def loss_and_grads(params: ParamTree, batch: dict):
        """Microbatched (gradient-accumulated) loss and f32 gradients."""
        tree = params.tree()
        # parameters() walks the module in the order tree() nests it
        leaves = list(params.parameters())

        def one(mb):
            loss = loss_fn(params, mb, cfg, rt)
            return loss.detach(), torch.autograd.grad(loss, leaves)

        if grad_accum == 1:
            loss, grads = one(batch)
            return loss, _fill(tree, iter(grads))
        micro = {k: v.reshape((grad_accum, v.shape[0] // grad_accum)
                              + tuple(v.shape[1:])) for k, v in batch.items()}
        loss_sum = torch.zeros((), dtype=torch.float32, device=rt.device)
        g_sum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves]
        for i in range(grad_accum):
            loss, grads = one({k: v[i] for k, v in micro.items()})
            loss_sum += loss
            for a, g in zip(g_sum, grads):
                a += g.float()
        return loss_sum / grad_accum, _fill(tree, (g / grad_accum
                                                   for g in g_sum))

    def step(params: ParamTree, opt: Tree, batch: dict):
        loss, grads = loss_and_grads(params, batch)
        new, opt, metrics = adamw_update(grads, opt, params.tree(), opt_cfg)
        metrics["loss"] = loss
        return ParamTree(new, trainable=True), opt, metrics

    def multi(params: ParamTree, opt: Tree, batches: dict):
        """``steps_per_call`` steps over batches with a leading [K] axis;
        each metric stacked [K]."""
        history = []
        for i in range(steps_per_call):
            params, opt, m = step(params, opt,
                                  {k: v[i] for k, v in batches.items()})
            history.append(m)
        return params, opt, {k: torch.stack([torch.as_tensor(
            m[k], dtype=torch.float32, device=rt.device) for m in history])
            for k in history[0]}

    def init_fn(key):
        params = init_params(key, cfg, device=rt.device, trainable=True)
        return params, adamw_init(params.tree(), opt_cfg)

    def like_fn():
        params = init_params(0, cfg, device="meta", trainable=True)
        return params, adamw_init(params.tree(), opt_cfg)

    return TrainStep(step_fn=multi if steps_per_call > 1 else step,
                     init_fn=init_fn, like_fn=like_fn, rt=rt)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------


@dataclasses.dataclass
class ServeStep:
    #: (params, caches, token [B], pos) -> (next_token [B], caches)
    step_fn: Callable
    rt: Runtime
    #: (n_tokens) -> fn(params, caches, tok0 [B], pos0) ->
    #: (toks [n_tokens, B], caches): the greedy loop over ``step_fn``
    decode_fn: Callable


def build_serve_step(cfg: ModelConfig, *, device="cuda") -> ServeStep:
    """One decode bucket's step functions on ``device`` (the card unless
    the caller asks for the CPU).  Eager steps take any batch and cache
    length, so the JAX package's ``global_batch``/``cache_len`` shape
    arguments have no counterpart: the caller allocates the caches."""
    rt = Runtime(device)

    def serve(params, caches, token, pos):
        nxt, _logits, caches = decode_step(params, token, caches, pos, cfg,
                                           rt)
        return nxt, caches

    def decode_fn(n_tokens: int):
        """Greedy decode of ``n_tokens`` tokens from ``tok0`` at ``pos0``
        (caches written in place)."""
        def decode(params, caches, tok0, pos0):
            tok, toks = tok0, []
            for i in range(n_tokens):
                tok, caches = serve(params, caches, tok, int(pos0) + i)
                toks.append(tok)
            return torch.stack(toks), caches      # [n_tokens, B]

        return decode

    return ServeStep(step_fn=serve, rt=rt, decode_fn=decode_fn)


def build_serve_buckets(cfg: ModelConfig,
                        buckets: Sequence[Tuple[int, int]], *,
                        device="cuda") -> Dict[Tuple[int, int], ServeStep]:
    """The continuous-batching server's decode buckets: one
    :class:`ServeStep` per ``(global_batch, cache_len)`` shape.  Buckets
    never share KV buffers: each decode call allocates its own."""
    return {tuple(b): build_serve_step(cfg, device=device) for b in buckets}
