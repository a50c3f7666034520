"""Mamba-2 (SSD) mixer — configuration only, for now.

:class:`MambaConfig` is here so that model configurations port whole.  The
mixer itself (chunked-scan prefill, the ``ssd_scan`` kernel behind
``mamba_apply(impl="kernel")``, the recurrent decode) is ROADMAP A8/B4;
:mod:`repro_torch.models.blocks` refuses a ``mixer="mamba"`` block.
"""

from __future__ import annotations

import dataclasses

__all__ = ["MambaConfig"]


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_model: int
    d_state: int = 128          # N
    expand: int = 2
    head_dim: int = 64          # P
    n_groups: int = 1           # G
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state
