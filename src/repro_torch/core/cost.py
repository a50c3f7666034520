"""BSP cost accounting — every superstep's h-relation, rounds and bytes.

Each ``lpf_sync`` appends a :class:`SuperstepCost` record with its
h-relation (max over processes of bytes sent/received), the number of
collective rounds the plan schedules and the wire bytes it schedules.
The executed ledger entry is by construction the plan's prediction.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from .machine import LPFMachine

__all__ = ["SuperstepCost", "CostLedger", "FUSED_METHODS",
           "OVERLAP_L_FRACTION", "overlap_cost", "schedule_seconds"]

#: methods that lower onto one fused exchange (single round by
#: construction; their wire bytes equal the exchange's schedule)
FUSED_METHODS = frozenset(
    {"fused", "fused_ag", "fused_rs", "fused_scatter", "fused_gather"})

#: residual latency of issuing one *additional* overlapped superstep as a
#: fraction of the full superstep latency ``l`` (an engineering
#: assumption, kept equal to the JAX package's so ledgers price alike)
OVERLAP_L_FRACTION = 0.25


@dataclasses.dataclass(frozen=True)
class SuperstepCost:
    label: str
    h_bytes: int          # BSP h-relation of the *requested* pattern (bytes)
    wire_bytes: int       # bytes actually scheduled per process (max), incl. padding
    total_wire_bytes: int # sum over processes of bytes on the wire
    rounds: int           # collective rounds issued
    n_msgs: int           # messages in the superstep
    method: str           # direct | bruck | valiant | fused* | overlap[k] | noop
    #: number of *additional* split-phase supersteps overlapped under this
    #: one (k - 1 for a k-member overlap group; 0 for a plain superstep)
    overlap_extra: int = 0

    @property
    def is_fused(self) -> bool:
        return self.method in FUSED_METHODS

    def predicted_seconds(self, machine: LPFMachine) -> float:
        return (self.wire_bytes * machine.g + self.rounds * machine.l
                + self.overlap_extra * OVERLAP_L_FRACTION * machine.l)


def overlap_cost(costs: Sequence[SuperstepCost],
                 label: str = "") -> SuperstepCost:
    """The ledger record of ``k`` split-phase supersteps issued as one
    overlap group: ``max_i(wire_i)`` time-equivalent wire, ``max_i(rounds_i)``
    barriers, and ``OVERLAP_L_FRACTION * l`` of issue latency for each
    member past the first.  Total wire bytes stay the sum."""
    costs = list(costs)
    if not costs:
        raise ValueError("overlap_cost of an empty group")
    if len(costs) == 1:
        return dataclasses.replace(costs[0], label=label)
    return SuperstepCost(
        label=label,
        h_bytes=max(c.h_bytes for c in costs),
        wire_bytes=max(c.wire_bytes for c in costs),
        total_wire_bytes=sum(c.total_wire_bytes for c in costs),
        rounds=max(c.rounds for c in costs),
        n_msgs=sum(c.n_msgs for c in costs),
        method=f"overlap[{'+'.join(c.method for c in costs)}]",
        overlap_extra=len(costs) - 1)


def schedule_seconds(cost_groups: Sequence[Sequence[SuperstepCost]],
                     machine: LPFMachine) -> float:
    """BSP time of a whole schedule: a sequence of issue groups, each a
    list of member superstep costs (singletons priced as plain
    supersteps, larger groups as one :func:`overlap_cost` entry)."""
    total = 0.0
    for costs in cost_groups:
        costs = list(costs)
        c = costs[0] if len(costs) == 1 else overlap_cost(costs)
        total += c.predicted_seconds(machine)
    return total


class CostLedger:
    """Per-context append-only log of superstep costs."""

    def __init__(self) -> None:
        self.records: List[SuperstepCost] = []

    def add(self, record: SuperstepCost) -> None:
        self.records.append(record)

    # -- aggregate views --------------------------------------------------
    @property
    def h_bytes(self) -> int:
        return sum(r.h_bytes for r in self.records)

    @property
    def wire_bytes(self) -> int:
        return sum(r.wire_bytes for r in self.records)

    @property
    def total_wire_bytes(self) -> int:
        return sum(r.total_wire_bytes for r in self.records)

    @property
    def rounds(self) -> int:
        return sum(r.rounds for r in self.records)

    @property
    def supersteps(self) -> int:
        return len(self.records)

    def predicted_seconds(self, machine: LPFMachine) -> float:
        return sum(r.predicted_seconds(machine) for r in self.records)

    def report(self, machine: Optional[LPFMachine] = None) -> str:
        lines = [f"{'label':<28}{'method':<14}{'h(B)':>12}{'wire(B)':>12}"
                 f"{'rounds':>8}{'msgs':>7}"
                 + (f"{'T_pred(us)':>12}" if machine else "")]
        for r in self.records:
            line = (f"{r.label:<28}{r.method:<14}{r.h_bytes:>12}"
                    f"{r.wire_bytes:>12}{r.rounds:>8}{r.n_msgs:>7}")
            if machine:
                line += f"{r.predicted_seconds(machine) * 1e6:>12.2f}"
            lines.append(line)
        total = (f"{'TOTAL':<28}{'':<14}{self.h_bytes:>12}"
                 f"{self.wire_bytes:>12}"
                 f"{self.rounds:>8}{sum(r.n_msgs for r in self.records):>7}")
        if machine:
            total += f"{self.predicted_seconds(machine) * 1e6:>12.2f}"
        lines.append(total)
        return "\n".join(lines)
