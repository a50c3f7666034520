"""Mixture-of-Experts block on one device.

The port of ``repro.models.moe`` and of the JAX package's single-device
path ``_moe_single`` (``repro/models/blocks.py``).  A token's router
logits (f32) pick its ``top_k`` experts, whose softmax-normalised gates
weigh their outputs.  Each expert takes at most ``cap`` tokens
(:func:`moe_capacity`): the ``cap`` largest of its gate weights, tokens
not routed to it weighing 0.  Beyond ``cap`` a routed token is dropped
for that expert, so a token's output depends on the other tokens of the
call (the reference's semantics).  The expert count is padded up to a
multiple of ``ep_degree``; the padded experts' logits are -1e30, so
routing never picks them.

Where the JAX package loops over experts, the port selects, gathers and
runs every expert's SwiGLU FFN at once (one ``topk`` over ``[E, T]``, one
gather, batched ``torch.matmul`` over ``[E, cap, D]``): per expert the
same tokens and products.  The weighted outputs are then summed into the
f32 output one expert at a time, in expert order, with one ``index_add_``
each: indices are unique within an expert, so the sum is deterministic
and in the reference's order (one scatter over all experts would add
duplicate indices with atomics, in no fixed order).  Every shape is fixed
by the call's shapes and nothing is read on the host, so a decode step
through this block can be captured as a CUDA graph.

Expert parallelism (:func:`moe_apply`, the JAX ``shard_map`` path over the
model axis) needs a device mesh and raises (ROADMAP A10, its multi-GPU
part).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..core.errors import LPFFatalError
from .common import dense_init

__all__ = ["MoEConfig", "moe_params", "moe_capacity", "moe_single",
           "moe_apply", "expert_load", "MOE_RANGE"]

#: the ``torch.profiler`` range around :func:`moe_single` (free without a
#: profiler): the block's share of a prefill's or a decode step's device
#: time
MOE_RANGE = "moe_single"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                 # per-expert hidden
    n_experts: int            # logical experts (pre-padding)
    top_k: int
    capacity_factor: float = 1.25
    ep_degree: int = 1        # model-axis size at runtime
    router_dtype: str = "float32"

    @property
    def padded_experts(self) -> int:
        e = self.n_experts
        d = max(self.ep_degree, 1)
        return -(-e // d) * d


def moe_params(gen, cfg: MoEConfig, dtype, device) -> Dict[str, torch.Tensor]:
    """The router ``[D, E]`` (f32) and the experts' SwiGLU weights
    ``[E, D, F]`` / ``[E, F, D]`` (fan-in on axis 1), ``E`` the padded
    count."""
    ep = cfg.padded_experts
    D, Fh = cfg.d_model, cfg.d_ff
    init = lambda shape, dt=dtype, in_axis=1: dense_init(
        gen, shape, in_axis=in_axis, dtype=dt, device=device)
    return {"router": init((D, ep), torch.float32, in_axis=0),
            "w_gate": init((ep, D, Fh)),
            "w_up": init((ep, D, Fh)),
            "w_down": init((ep, Fh, D))}


def _local_expert_ffn(x_e, wg, wu, wd):
    """x_e [..., C, D] tokens for one expert (or ``[E, C, D]`` for all,
    with stacked weights) -> [..., C, D]."""
    return (F.silu(x_e @ wg) * (x_e @ wu)) @ wd


def moe_capacity(T: int, E: int, cfg: MoEConfig) -> int:
    """Tokens an expert takes in a call of ``T`` tokens over ``E``
    (padded) experts: the reference's ``cap``."""
    return max(1, min(T, max(8, int(cfg.capacity_factor * cfg.top_k * T
                                    / E))))


def _route(p, xt: torch.Tensor, cfg: MoEConfig
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each token's experts ``[T, k]`` and their gates ``[T, k]`` (f32).
    The logits are f32: the router is upcast, as JAX promotes its
    bf16-cast router against the f32 tokens."""
    E = p["w_gate"].shape[0]
    logits = xt.float() @ p["router"].float()
    if E > cfg.n_experts:
        pad = torch.arange(E, device=xt.device) >= cfg.n_experts
        logits = logits.masked_fill(pad, -1e30)
    gate_vals, gate_idx = torch.topk(logits, min(cfg.top_k, E), dim=-1)
    return gate_idx, torch.softmax(gate_vals, dim=-1)


@torch.profiler.record_function(MOE_RANGE)
def moe_single(p, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """x [B, S, D] -> [B, S, D] on one device (``_moe_single``)."""
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    E = p["w_gate"].shape[0]
    gate_idx, gates = _route(p, xt, cfg)
    # each expert's weight of each token, 0 where the token is not routed
    # to it (a token's k experts are distinct: one write each)
    w_tok = torch.zeros(T, E, dtype=torch.float32, device=x.device) \
        .scatter(1, gate_idx, gates)
    cap = moe_capacity(T, E, cfg)
    sel_w, sel_idx = torch.topk(w_tok.t(), cap, dim=1)        # [E, cap]
    x_e = xt.index_select(0, sel_idx.reshape(-1)).reshape(E, cap, D)
    y = _local_expert_ffn(x_e, p["w_gate"], p["w_up"], p["w_down"])
    y = y.float() * sel_w[..., None]
    out = torch.zeros(T, D, dtype=torch.float32, device=x.device)
    for e in range(E):
        out.index_add_(0, sel_idx[e], y[e])
    return out.reshape(B, S, D).to(x.dtype)


def expert_load(p, x: torch.Tensor, cfg: MoEConfig
                ) -> Tuple[torch.Tensor, int]:
    """The tokens of ``x`` [B, S, D] routed to each expert ``[E]`` and the
    call's capacity: an expert keeps ``min(routed, cap)`` of them (a
    routed token's weight is above every unrouted one's 0), so
    ``(routed - cap).clamp_min(0).sum()`` tokens are dropped."""
    T = x.shape[0] * x.shape[1]
    E = p["w_gate"].shape[0]
    gate_idx, _ = _route(p, x.reshape(T, -1), cfg)
    return (torch.bincount(gate_idx.reshape(-1), minlength=E),
            moe_capacity(T, E, cfg))


def moe_apply(params: dict, x: torch.Tensor, cfg: MoEConfig, *, mesh,
              model_axis: str = "model", dp_axes=("pod", "data")):
    """Expert parallelism over a mesh's model axis: not on one card."""
    raise LPFFatalError(
        "moe_apply shards the experts over a device mesh's model axis, "
        "which one card does not have (ROADMAP A10, its multi-GPU part); "
        "one device runs moe_single")
