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

*Serving.*  ``step_fn`` is one eager decode step.  A bucket's
``decode_fn(n)`` is the counterpart of the JAX package's one-``While``
decode loop: on the card its step is captured once as a CUDA graph over
the bucket's own static caches, token, position and outputs
(:class:`CapturedDecode`), and an ``n``-token call replays it ``n`` times
with no host write between replays; the graph itself advances the
position.  On the CPU ``decode_fn(n)`` is the eager loop over
``step_fn``.  Both paths give the same tokens bit for bit: the captured
step runs the eager step's kernels on the same shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

from ..core.errors import LPFError, LPFFatalError, LPFTransientError
from ..models.blocks import Runtime
from ..models.config import ModelConfig
from ..models.lm import (ParamTree, decode_step, init_caches, init_params,
                         loss_fn)
from ..optim import AdamWConfig, adamw_init, adamw_update

__all__ = ["TrainStep", "build_train_step", "ServeStep", "CapturedDecode",
           "build_serve_step", "build_serve_buckets"]

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

class CapturedDecode:
    """One decode bucket's greedy step as a CUDA graph over static
    buffers: the caches, the token ``[B]``, the position (a 0-d long
    tensor) and the outputs ``[C, B]``, all owned by the bucket.  One
    replay decodes a token at the position the buffer holds, writes it to
    the outputs' next row, feeds it back as the next input and advances
    the position, so ``n`` replays decode ``n`` tokens with no host write
    between them.

    The graph is captured on the first call (and again for another
    parameter tree, whose addresses it reads): one eager warm-up step on
    a side stream, then the capture into the graph's own memory pool.  A
    capture that fails raises :class:`LPFTransientError`, which the serve
    ladder answers by moving the bucket to the per-token path; it never
    runs eagerly in its place."""

    def __init__(self, cfg: ModelConfig, rt: Runtime, batch: int,
                 cache_len: int):
        self.cfg, self.rt = cfg, rt
        self.batch, self.cache_len = batch, cache_len
        dev = rt.device
        self.caches = init_caches(cfg, batch, cache_len, device=dev)
        self.tok = torch.zeros(batch, dtype=torch.long, device=dev)
        self.pos = torch.zeros((), dtype=torch.long, device=dev)
        #: the outputs' next row (the replay count modulo ``cache_len``)
        self.row = torch.zeros((), dtype=torch.long, device=dev)
        self.out = torch.zeros(cache_len, batch, dtype=torch.long,
                               device=dev)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.params: Optional[ParamTree] = None
        #: graphs captured, and replays (tokens decoded through a graph)
        self.captures = 0
        self.replays = 0

    def _step(self) -> None:
        nxt, _logits, _ = decode_step(self.params, self.tok, self.caches,
                                      self.pos, self.cfg, self.rt)
        self.out.index_copy_(0, self.row.reshape(1), nxt[None])
        self.tok.copy_(nxt)
        self.pos.add_(1)
        self.row.copy_((self.row + 1) % self.cache_len)

    def _capture(self, params: ParamTree) -> None:
        self.graph = None             # the old graph and its pool go first
        self.params = params
        try:
            side = torch.cuda.Stream(self.rt.device)
            side.wait_stream(torch.cuda.current_stream(self.rt.device))
            with torch.cuda.stream(side):
                self._step()          # warm-up: handles, workspaces, pool
            torch.cuda.current_stream(self.rt.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self._step()
        except LPFError:
            self.params = None
            raise
        except Exception as e:
            self.params = None
            raise LPFTransientError(
                f"decode bucket ({self.batch}, {self.cache_len}) of "
                f"{self.cfg.name}: the CUDA-graph capture of its step "
                f"failed: {type(e).__name__}: {e}") from e
        self.graph = graph
        self.captures += 1

    def decode(self, params: ParamTree, tok0, pos0, n_tokens: int):
        """``n_tokens`` greedy tokens from ``tok0`` [B] at position
        ``pos0``, from zeroed caches.  Returns (toks [n_tokens, B], the
        bucket's caches, valid until its next call)."""
        if self.graph is None or params is not self.params:
            self._capture(params)
        for c in pytree.tree_leaves(self.caches):
            c.zero_()
        self.tok.copy_(torch.as_tensor(tok0))
        self.pos.copy_(torch.as_tensor(pos0))
        self.row.zero_()
        C, toks = self.cache_len, []
        for k in range(1, n_tokens + 1):
            self.graph.replay()
            self.replays += 1
            if k % C == 0 or k == n_tokens:
                # the rows written since the last read
                toks.append(self.out[:(k - 1) % C + 1].clone())
        out = torch.cat(toks) if toks else self.out[:0].clone()
        return out, self.caches


@dataclasses.dataclass
class ServeStep:
    #: (params, caches, token [B], pos) -> (next_token [B], caches): one
    #: eager step
    step_fn: Callable
    rt: Runtime
    #: (n_tokens) -> fn(params, tok0 [B], pos0) -> (toks [n_tokens, B],
    #: caches): the greedy loop from zeroed caches of the bucket's shape,
    #: on the card the bucket's captured step replayed (the JAX package's
    #: takes the caller's caches and donates them; no caller here has any)
    decode_fn: Callable
    #: the bucket's captured step on the card, None on the CPU
    graph: Optional[CapturedDecode] = None


def build_serve_step(cfg: ModelConfig, *, global_batch: int,
                     cache_len: int, device="cuda") -> ServeStep:
    """One ``(global_batch, cache_len)`` decode bucket's step functions on
    ``device`` (the card unless the caller asks for the CPU).  On the card
    ``decode_fn`` replays the bucket's captured step
    (:class:`CapturedDecode`); on the CPU it is the eager loop over
    ``step_fn``."""
    rt = Runtime(device)
    graph = None
    if rt.device.type == "cuda":
        graph = CapturedDecode(cfg, rt, global_batch, cache_len)

    def serve(params, caches, token, pos):
        nxt, _logits, caches = decode_step(params, token, caches, pos, cfg,
                                           rt)
        return nxt, caches

    def decode_fn(n_tokens: int):
        """Greedy decode of ``n_tokens`` tokens from ``tok0`` at ``pos0``,
        from zeroed caches."""
        def eager(params, tok0, pos0):
            caches = init_caches(cfg, global_batch, cache_len,
                                 device=rt.device)
            tok, toks = tok0, []
            for i in range(n_tokens):
                tok, caches = serve(params, caches, tok, int(pos0) + i)
                toks.append(tok)
            return torch.stack(toks), caches      # [n_tokens, B]

        def captured(params, tok0, pos0):
            return graph.decode(params, tok0, pos0, n_tokens)

        return eager if graph is None else captured

    return ServeStep(step_fn=serve, rt=rt, decode_fn=decode_fn, graph=graph)


def build_serve_buckets(cfg: ModelConfig,
                        buckets: Sequence[Tuple[int, int]], *,
                        device="cuda") -> Dict[Tuple[int, int], ServeStep]:
    """The continuous-batching server's decode buckets: one
    :class:`ServeStep` per ``(global_batch, cache_len)`` shape, each with
    its own captured step on the card.  Buckets never share buffers: each
    owns its caches, token, position, outputs, graph and memory pool, so
    quarantining one bucket's captured path cannot corrupt another's."""
    return {(b, c): build_serve_step(cfg, device=device, global_batch=b,
                                     cache_len=c) for b, c in buckets}
