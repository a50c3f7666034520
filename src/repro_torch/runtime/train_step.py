"""Serve-step builders on one device — the serving half of the JAX
package's ``repro.runtime.train_step`` (``ServeStep``,
``build_serve_step``, ``build_serve_buckets``).

The JAX package jits a per-token step and one whole-loop XLA ``While``
per decode length, with parameter and cache shardings over a mesh.  On one
card there are no shardings and nothing is jitted: ``step_fn`` is one
eager decode step, and ``decode_fn(n)`` is the greedy loop over it, so
the two run the same calls.  They part when the loop is captured as a
CUDA graph (later work).  The training half comes with the training
slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence, Tuple

import torch

from ..models.blocks import Runtime
from ..models.config import ModelConfig
from ..models.lm import decode_step

__all__ = ["ServeStep", "build_serve_step", "build_serve_buckets"]


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
