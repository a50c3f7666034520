"""Sync/message attributes — the paper's extension point (S2.1, S6).

``lpf_sync`` accepts attributes that let an implementation relax
guarantees for better effective (g, l):

* ``method``      — h-relation execution algorithm: ``auto`` | ``direct``
                    | ``bruck`` | ``valiant``.
* ``no_conflict`` — caller asserts no overlapping writes: skips CRCW
                    arbitration ordering so rounds pack tighter.
* ``reduce_op``   — accumulating-put supersteps: overlapping destination
                    writes *combine* elementwise (``sum``/``max``/``min``)
                    instead of CRCW-arbitrating.
* ``compress``    — quantise payloads (int8) before the wire.  The
                    planner prices it; this port's executor does not
                    implement it yet and refuses such supersteps.
* ``stale``       — tolerated staleness in supersteps; interpreted by an
                    outer loop, not by core sync.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional

__all__ = ["CompressSpec", "SyncAttributes", "LPF_SYNC_DEFAULT"]


@dataclasses.dataclass(frozen=True)
class CompressSpec:
    """Payload quantisation spec (applies to floating slots only)."""

    bits: int = 8               # 8 -> int8 symmetric quantisation
    stochastic: bool = False    # stochastic rounding

    @property
    def ratio(self) -> float:
        return self.bits / 32.0


@dataclasses.dataclass(frozen=True)
class SyncAttributes:
    method: Literal["auto", "direct", "bruck", "valiant"] = "auto"
    no_conflict: bool = False
    #: combine overlapping destination writes instead of arbitrating;
    #: one of "sum" | "max" | "min" (None = CRCW overwrite semantics)
    reduce_op: Optional[Literal["sum", "max", "min"]] = None
    compress: Optional[CompressSpec] = None
    stale: int = 0
    #: two-phase Valiant routing seed (static configuration)
    valiant_seed: int = 0x5DEECE66D

    def replace(self, **kw) -> "SyncAttributes":
        return dataclasses.replace(self, **kw)


LPF_SYNC_DEFAULT = SyncAttributes()
