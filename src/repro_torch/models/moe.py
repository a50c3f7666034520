"""Mixture-of-Experts block — configuration only, for now.

:class:`MoEConfig` is here so that model configurations port whole.  The
block itself (routing, expert parallelism) is ROADMAP A8;
:mod:`repro_torch.models.blocks` refuses an ``ffn="moe"`` block.
"""

from __future__ import annotations

import dataclasses

__all__ = ["MoEConfig"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                 # per-expert hidden
    n_experts: int            # logical experts (pre-padding)
    top_k: int
    capacity_factor: float = 1.25
    ep_degree: int = 1        # model-axis size at runtime
    router_dtype: str = "float32"
