"""Shared model machinery: norms, RoPE, initialisers, dtype policy.

Every function keeps the JAX package's layout and precision policy
(``repro.models.common``): norms and RoPE compute in f32 and cast back
to the input's dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

__all__ = ["DTYPES", "DtypePolicy", "dtype_of", "rms_norm", "layer_norm", "rope_freqs",
           "apply_rope", "sinusoidal_positions", "dense_init"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    """Parameter, compute and accumulation dtypes (the JAX package's
    defaults: f32 parameters, bf16 compute, f32 accumulation)."""

    param: torch.dtype = torch.float32
    compute: torch.dtype = torch.bfloat16
    accum: torch.dtype = torch.float32

    def cast_in(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm in f32; ``plus_one`` scales by ``1 + w``."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    scale = (1.0 + w.float()) if plus_one else w.float()
    return (y * scale).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] (int).  Half-split convention,
    f32 math, cast back to x's dtype."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                    # [d/2]
    ang = positions[..., None].float() * freqs                # [B, S, d/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return y.to(x.dtype)


def sinusoidal_positions(seq_len: int, dim: int, device=None) -> torch.Tensor:
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=device) * (-math.log(10000.0) / dim))
    pe = torch.zeros(seq_len, dim, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def dense_init(generator: torch.Generator, shape: Sequence[int],
               in_axis: int = 0, dtype: torch.dtype = torch.float32,
               scale: float = 1.0, device=None) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1) cut to [-2, 2], times
    ``scale / sqrt(shape[in_axis])``; drawn in f32 from ``generator``
    (which must live on ``device``).  Scaled in place: the f32 draw is
    the only full-size temporary (deepseek-v3's expert leaf [256, 7168,
    2048] is 15 GB in f32)."""
    fan_in = shape[in_axis] if len(shape) else 1
    std = scale / math.sqrt(max(fan_in, 1))
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(std).to(dtype)
