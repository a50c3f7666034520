"""What every plain reference of a trained model shares, in float32:
the weights from the seed, the sampled first gradient, the control's
rounding of products, AdamW and the check's three steps.

A model's reference module (``reference/<name>.py``, named by the
configuration's ``"reference"`` key) gives ``param_specs(m)``, the
``(name, shape, fan_in)`` of every leaf as the port lays its tree out;
``loss(params, tokens, labels, m, low)``, the mean next-token
cross-entropy with every product through :func:`mm`; and
``port_sizes(cfg)``, the port's config read back under the published
keys of the configuration file, for the check that both run one model.

The weights are made here, from the seed, leaf by leaf on the device,
and handed to both sides: :func:`make_leaf` gives any leaf again without
the others, so a side can work out the change of a leaf from its start.

``low="fp8"`` is the control: every product the configuration computes
in bfloat16 takes operands rounded to float8 e4m3 and its incoming
gradient rounded to float8 e5m2, each with a scale per tensor."""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

Spec = Tuple[str, tuple, Optional[int]]


# --------------------------------------------------------------------------
# the weights
# --------------------------------------------------------------------------

def leaf_seed(seed: int, index: int) -> int:
    """The generator seed of leaf ``index`` (or of the token pool, index
    -1) of a run's ``seed``."""
    return (int(seed) * 1_000_003 + index + 1) % (1 << 63)


def make_leaf(seed: int, index: int, spec: Spec, device) -> torch.Tensor:
    """Leaf ``index`` of the weights of ``seed``: N(0, 1 / fan_in) in
    float32, drawn on ``device`` in one call; a norm weight (``fan_in``
    None) is 0."""
    _, shape, fan_in = spec
    if fan_in is None:
        return torch.zeros(shape, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, index))
    t = torch.randn(shape, device=device, generator=gen)
    return t.mul_(1.0 / math.sqrt(fan_in))


def make_params(seed: int, specs: List[Spec],
                device) -> Dict[str, torch.Tensor]:
    return {s[0]: make_leaf(seed, i, s, device) for i, s in enumerate(specs)}


#: elements of each leaf at which the first gradient is compared
GRAD_SAMPLES = 1 << 20


def sample_index(seed: int, index: int, numel: int, device) -> torch.Tensor:
    """The flat positions of leaf ``index`` at which both sides keep the
    first gradient: ``GRAD_SAMPLES`` drawn from the seed (all of a smaller
    leaf)."""
    if numel <= GRAD_SAMPLES:
        return torch.arange(numel, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, 1000 + index))
    return torch.randint(numel, (GRAD_SAMPLES,), device=device,
                         generator=gen)


def grad_sample(seed: int, index: int, g: torch.Tensor) -> torch.Tensor:
    """Leaf ``index``'s gradient ``g`` at its sampled positions, in
    float32 on the host."""
    g = g.reshape(-1)
    return g[sample_index(seed, index, g.numel(), g.device)].float().cpu()


# --------------------------------------------------------------------------
# precision of the products
# --------------------------------------------------------------------------

def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Operand(torch.autograd.Function):
    """Rounds a product's operand to float8 e4m3; the gradient passes."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return g


class _Incoming(torch.autograd.Function):
    """Leaves a product's result alone; rounds the gradient coming into
    it to float8 e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def mm(a, b, low):
    """``a @ b``, or with ``low="fp8"`` the control's product."""
    if low is None:
        return a @ b
    if low != "fp8":
        raise ValueError(f"low={low!r}: the control is 'fp8'")
    return _Incoming.apply(_Operand.apply(a) @ _Operand.apply(b))


# --------------------------------------------------------------------------
# the optimizer and the steps the check follows
# --------------------------------------------------------------------------

LossFn = Callable[..., torch.Tensor]


def adamw_steps(params: Dict[str, torch.Tensor], batches, loss: LossFn,
                opt: dict, seed: int, low: Optional[str] = None) -> dict:
    """Trains ``params`` (updated in place) over ``batches`` (``(tokens,
    labels)`` each) with AdamW, global-norm clipping and weight decay on
    every leaf of more than one dimension as stored; ``loss(params,
    tokens, labels, low)``.  Returns each step's loss and the first
    step's gradient leaf by leaf: its norms before clipping (``grad0``)
    and as the optimizer took it, clipped (``grad1``), and the clipped
    gradient itself (``first``)."""
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    lr, wd, clip = opt["lr"], opt["weight_decay"], opt["clip_norm"]
    names = list(params)
    mom = {k: torch.zeros_like(params[k]) for k in names}
    vel = {k: torch.zeros_like(params[k]) for k in names}
    out = {"loss": [], "grad0": {}, "grad1": {}, "first": {}}
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for t, (tokens, labels) in enumerate(batches, start=1):
            leaves = [params[k].requires_grad_(True) for k in names]
            value = loss(params, tokens, labels, low)
            grads = torch.autograd.grad(value, leaves)
            for p in leaves:
                p.requires_grad_(False)
            out["loss"].append(value.item())
            gnorm = torch.sqrt(sum(g.square().sum() for g in grads))
            scale = torch.clamp(clip / (gnorm + 1e-9), max=1.0)
            c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
            for i, (k, g) in enumerate(zip(names, grads)):
                if t == 1:
                    out["grad0"][k] = g.norm().item()
                g = g * scale
                if t == 1:
                    out["grad1"][k] = g.norm().item()
                    out["first"][k] = grad_sample(seed, i, g)
                mom[k].mul_(b1).add_(g, alpha=1 - b1)
                vel[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                delta = (mom[k] / c1) / ((vel[k] / c2).sqrt() + eps)
                if params[k].ndim > 1:
                    delta = delta + wd * params[k]
                params[k].sub_(lr * delta)
            del grads
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev_tf32
    return out


def change_norms(params: Dict[str, torch.Tensor], seed: int,
                 specs: List[Spec]) -> Dict[str, float]:
    """Each leaf's distance from where the weights of ``seed`` start."""
    out = {}
    for i, s in enumerate(specs):
        p = params[s[0]]
        out[s[0]] = (p.detach() - make_leaf(seed, i, s, p.device)) \
            .norm().item()
    return out


def follow(seed: int, specs: List[Spec], loss: LossFn, opt: dict, batches,
           device, low: Optional[str] = None) -> dict:
    """The reference's readings of the check: the weights of ``seed``
    trained over ``batches``; each step's loss, the first gradient's leaf
    norms and its values at the sampled positions, and each leaf's change
    after the last step."""
    params = make_params(seed, specs, device)
    out = adamw_steps(params, batches, loss, opt, seed, low)
    out["change"] = change_norms(params, seed, specs)
    del params
    return out
