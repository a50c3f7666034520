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
duplicate indices with atomics, in no fixed order).  The combine is one
autograd op (:class:`_Combine`) whose backward is one gather of the
output's gradient at every expert's rows: recorded op by op, each
``y[e]`` would make autograd fill a zero gradient of all of ``y`` and
add the ``E`` of them, where the nonzero parts are that gather alone.
Every shape is fixed by the call's shapes and nothing is read on the
host, so a decode step through this block can be captured as a CUDA
graph.

Expert parallelism (:func:`moe_apply`, the JAX package's ``shard_map``
body over a mesh's model axis) runs the mesh's devices as virtual shards
(:mod:`repro_torch.core.mesh`): the batch splits over the ``n_dp``
shards of the data-parallel axes, each routing its own ``T / n_dp``
tokens with its own capacity, so a mesh drops other tokens than one
device does; model shard ``m`` adds its experts ``[m E/M, (m+1) E/M)``
into an f32 partial of its own, and the ``M`` partials are summed in
shard order (the ``psum``).  The ``n_dp`` shards are batched as the
experts are: one ``topk`` over ``[n_dp, E, T / n_dp]``, each expert's
tokens of every shard in one row of the gather.  :func:`moe_single` is
the same computation with one shard of each kind.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..core.errors import LPFFatalError
from ..core.mesh import mesh_shards, split
from ..core.trace import count, span, tracing
from .common import dense_init

__all__ = ["MoEConfig", "moe_params", "moe_capacity", "moe_single",
           "moe_apply", "expert_load", "MOE_RANGE"]

#: the span (:mod:`repro_torch.core.trace`) around :func:`moe_single` and
#: :func:`moe_apply`: the block's share of a prefill's, a decode step's or
#: a training step's device time, on one device or a mesh.  Inside it,
#: ``moe.route``, ``moe.dispatch``, ``moe.experts`` and ``moe.combine``.
#: With no profiler a span costs one flag check; under one, a
#: ``record_function`` range (12-16 us of host time a call, where an
#: unguarded one cost 9-15 us with no profiler)
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


class _Combine(torch.autograd.Function):
    """The experts' weighted outputs ``y`` [E, R, D] added into the
    output [n_rows, D] at their tokens' ``rows`` [E, R], in ``y``'s dtype
    (f32 in the block): model shard ``m`` adds its experts into a partial
    of its own in expert order, and the partials are summed in shard
    order (the ``psum``).  Every partial takes the whole output's
    gradient, so the gradient of ``y`` is that gradient gathered at
    ``rows``: the values autograd gives the loop."""

    @staticmethod
    def forward(ctx, y, rows, n_model: int, n_rows: int):
        E, _, D = y.shape
        per = E // n_model
        out = None
        for m in range(n_model):
            # model shard m's partial: its experts in expert order
            part = y.new_zeros(n_rows, D)
            for e in range(m * per, (m + 1) * per):
                part.index_add_(0, rows[e], y[e])
            out = part if out is None else out + part
        ctx.save_for_backward(rows)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        rows, = ctx.saved_tensors
        grad_y = grad_out.index_select(0, rows.reshape(-1)) \
            .view(*rows.shape, grad_out.shape[-1])
        return grad_y, None, None, None


def _moe_shards(p, xs: torch.Tensor, cfg: MoEConfig, n_model: int
                ) -> torch.Tensor:
    """xs [n, T, D], ``n`` batch shards of ``T`` tokens each, through the
    experts split over ``n_model`` model shards -> the f32 output
    [n * T, D] (token ``i`` of shard ``s`` at row ``s * T + i``)."""
    n, T, D = xs.shape
    xt = xs.reshape(n * T, D)
    E = p["w_gate"].shape[0]
    with span("moe.route"):
        gate_idx, gates = _route(p, xt, cfg)
        # each expert's weight of each token, 0 where the token is not
        # routed to it (a token's k experts are distinct: one write each)
        w_tok = torch.zeros(n, T, E, dtype=torch.float32,
                            device=xs.device) \
            .scatter(2, gate_idx.reshape(n, T, -1), gates.reshape(n, T, -1))
        cap = moe_capacity(T, E, cfg)
        if tracing() and torch._C._current_graph_task_id() == -1:
            # a forward's routes and drops, reckoned as expert_load
            # reckons them (a remat recompute, which runs inside the
            # backward, is not counted again)
            count("moe.routed", gate_idx.numel())
            load = _load(gate_idx, n, E)
            count("moe.dropped", (load - cap).clamp_min(0).sum())
        sel_w, sel_idx = torch.topk(w_tok.transpose(1, 2), cap, dim=2)
        # [n, E, cap] -> each expert's tokens of every shard, in shard
        # order, as rows of xt: [E, n * cap]
        if n > 1:
            sel_idx = sel_idx + (torch.arange(n, device=xs.device) * T)[
                :, None, None]
        rows = sel_idx.transpose(0, 1).reshape(E, n * cap)
        sel_w = sel_w.transpose(0, 1).reshape(E, n * cap)
    with span("moe.dispatch"):
        x_e = xt.index_select(0, rows.reshape(-1)).reshape(E, n * cap, D)
    with span("moe.experts"):
        y = _local_expert_ffn(x_e, p["w_gate"], p["w_up"], p["w_down"])
        y = y.float() * sel_w[..., None]
    with span("moe.combine"):
        return _Combine.apply(y, rows, n_model, n * T)


@span(MOE_RANGE)
def moe_single(p, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """x [B, S, D] -> [B, S, D] on one device (``_moe_single``)."""
    B, S, D = x.shape
    out = _moe_shards(p, x.reshape(1, B * S, D), cfg, 1)
    return out.reshape(B, S, D).to(x.dtype)


def _dp_shards(x: torch.Tensor, mesh, dp_axes) -> torch.Tensor:
    """x [B, S, D] as the ``n_dp`` batch shards' tokens [n_dp, T, D]."""
    B, S, D = x.shape
    n = mesh_shards(mesh, dp_axes)
    return split(x, 0, n, "moe_apply's batch").reshape(n, B // n * S, D)


def expert_load(p, x: torch.Tensor, cfg: MoEConfig, *, mesh=None,
                dp_axes=("pod", "data")) -> Tuple[torch.Tensor, int]:
    """The tokens of ``x`` [B, S, D] routed to each expert ``[E]`` and the
    call's capacity: an expert keeps ``min(routed, cap)`` of them (a
    routed token's weight is above every unrouted one's 0), so
    ``(routed - cap).clamp_min(0).sum()`` tokens are dropped.  On a
    ``mesh``, each batch shard's loads ``[n_dp, E]`` and the capacity of
    a shard (:func:`moe_apply`'s)."""
    E = p["w_gate"].shape[0]
    xs = x.reshape(1, -1, x.shape[-1]) if mesh is None \
        else _dp_shards(x, mesh, dp_axes)
    n, T, D = xs.shape
    gate_idx, _ = _route(p, xs.reshape(n * T, D), cfg)
    load = _load(gate_idx, n, E)
    return load[0] if mesh is None else load, moe_capacity(T, E, cfg)


def _load(gate_idx: torch.Tensor, n: int, E: int) -> torch.Tensor:
    """The tokens each of ``n`` batch shards routes to each expert
    ``[n, E]``, from the shards' stacked expert indices ``[n * T, k]``."""
    load = torch.zeros(n, E, dtype=torch.long, device=gate_idx.device)
    return load.scatter_add_(1, gate_idx.reshape(n, -1),
                             torch.ones_like(gate_idx).reshape(n, -1))


@span(MOE_RANGE)
def moe_apply(params: dict, x: torch.Tensor, cfg: MoEConfig, *, mesh,
              model_axis: str = "model",
              dp_axes=("pod", "data")) -> torch.Tensor:
    """x [B, S, D] -> [B, S, D] with the experts split over ``mesh``'s
    model axis and the batch over its ``dp_axes`` (the JAX package's
    ``shard_map`` body, over virtual shards: module docstring).  Each
    batch shard's capacity comes from its own tokens.  The experts
    (``ep_degree`` pads them) must split evenly over the model axis; a
    batch must split over the dp shards."""
    if mesh is None or model_axis not in mesh.axis_names:
        raise LPFFatalError(
            f"moe_apply splits the experts over a mesh's {model_axis!r} "
            f"axis, and {mesh!r} has none; without a mesh the block is "
            f"moe_single")
    E = params["w_gate"].shape[0]
    M = mesh.shape[model_axis]
    if E % M:
        raise LPFFatalError(
            f"moe_apply: {E} experts do not split over the {M} shards of "
            f"the {model_axis!r} axis (ep_degree={M} pads them)")
    B, S, D = x.shape
    out = _moe_shards(params, _dp_shards(x, mesh, dp_axes), cfg, M)
    return out.reshape(B, S, D).to(x.dtype)
