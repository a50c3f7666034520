"""Machine models and ``lpf_probe`` — the paper's (p, g, l) introspection.

``probe`` returns an :class:`LPFMachine` derived from a hardware table (a
Theta(1) lookup, as the paper allows).  The port's default table is
:data:`H100_SXM`: one NVIDIA H100 hosting ``p`` *virtual processes* whose
slots share the card's HBM, so a superstep is a device-memory gather and
scatter and its link class is ``"vp"``.

All bandwidths are bytes/second, latencies seconds, compute flop/second.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

__all__ = [
    "LinkModel",
    "HardwareModel",
    "LPFMachine",
    "H100_SXM",
    "probe",
    "axis_kind_default",
]


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """One interconnect class."""

    bw: float        # per-process injection bandwidth over this link class (B/s)
    latency: float   # per-superstep launch/sync latency (seconds)


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Static description of one chip + its interconnects.  The field
    names match the JAX package's model so one model's fields can build
    the other (``repro_torch.interop.hardware_from_fields``)."""

    name: str
    peak_flops_bf16: float
    peak_flops_fp32: float
    hbm_bw: float                      # bytes/s
    hbm_bytes: float                   # capacity per chip
    vmem_bytes: float                  # on-chip memory one kernel block may use
    links: Mapping[str, LinkModel]     # kind -> link model

    def link(self, kind: str) -> LinkModel:
        if kind not in self.links:
            raise KeyError(f"{self.name} has no link class {kind!r}")
        return self.links[kind]


#: NVIDIA H100 SXM, data-sheet values: 989 TFLOP/s dense bf16 tensor
#: cores, 67 TFLOP/s fp32 outside the tensor cores, 80 GB HBM3 at
#: 3.35 TB/s, 232,448 B of shared memory per block (at the 700 W limit).
#: The ``"vp"`` link is the total exchange between p = 8 virtual processes
#: that share the card's HBM, fitted by ``chip_smoke.py`` (phase 6: timed
#: total exchanges of h = 28 B to 58.7 MB per process, each superstep
#: synchronised) on an NVIDIA H100 80GB HBM3 at a 700 W power limit:
#: g = 7.24e-12 s/B, l = 3.22e-4 s, so bw = (7/8)/g and latency =
#: l/log2(8).  The latency is the host's staging and planning of the
#: superstep's 64 messages; the device's copy is a small share of it.
H100_SXM = HardwareModel(
    name="h100_sxm",
    peak_flops_bf16=989e12,
    peak_flops_fp32=67e12,
    hbm_bw=3.35e12,
    hbm_bytes=80e9,
    vmem_bytes=232448,
    links={
        "vp": LinkModel(bw=1.208e11, latency=1.072e-4),
    },
)


@dataclasses.dataclass(frozen=True)
class LPFMachine:
    """What ``lpf_probe`` returns: the BSP machine (p, g, l) + compute rate.

    ``g`` is seconds per *byte* of h-relation; ``l`` is seconds per
    superstep.  ``r`` is seconds per flop so that (g, l) can be normalised
    as in paper Table 3.
    """

    p: int
    g: float
    l: float
    r: float
    hardware: HardwareModel = H100_SXM

    def t_comm(self, h_bytes: float, supersteps: int = 1) -> float:
        """BSP cost of communicating an h-relation: h*g + l per superstep."""
        return h_bytes * self.g + supersteps * self.l

    def normalised(self, word_bytes: int = 8) -> tuple[float, float]:
        """(g, l) in the paper's Table-3 units."""
        g_norm = (self.g * word_bytes) / (self.r * word_bytes)
        l_norm = self.l / (self.g * word_bytes)
        return g_norm, l_norm


def axis_kind_default(axis_name: str) -> str:
    """Map an axis name to an interconnect class: the port's own
    virtual-process axis ``"vp"``, the JAX package's pod axes, else
    ``"ici"``."""
    if axis_name == "vp":
        return "vp"
    return "dcn" if axis_name in ("pod", "dcn", "slice") else "ici"


def probe(
    axis_sizes: Mapping[str, int],
    hardware: HardwareModel = H100_SXM,
    axis_kinds: Mapping[str, str] | None = None,
) -> LPFMachine:
    """``lpf_probe``: the BSP machine for a context spanning ``axis_sizes``.

    For several axes the effective ``g`` is the slowest link class
    involved and the latency the sum of the per-axis latencies.  A
    total exchange over ``p`` processes sends a fraction ``(p-1)/p`` of
    its bytes off-process, which is folded into ``g``.
    """
    if not axis_sizes:
        # Sequential LPF_ROOT context: communication is memcpy.
        return LPFMachine(p=1, g=1.0 / hardware.hbm_bw, l=0.0,
                          r=1.0 / hardware.peak_flops_fp32, hardware=hardware)
    axis_kinds = axis_kinds or {}
    p = 1
    worst_g = 0.0
    total_l = 0.0
    for name, size in axis_sizes.items():
        p *= int(size)
        if int(size) == 1:
            continue
        link = hardware.link(axis_kinds.get(name, axis_kind_default(name)))
        frac = (size - 1) / size  # fraction of traffic leaving the process
        worst_g = max(worst_g, frac / link.bw)
        total_l += link.latency * max(1.0, math.log2(size))
    if worst_g == 0.0:
        worst_g = 1.0 / hardware.hbm_bw
    return LPFMachine(
        p=p,
        g=worst_g,
        l=total_l,
        r=1.0 / hardware.peak_flops_fp32,
        hardware=hardware,
    )
