"""Recorded programs — the record half of the JAX package's
``core/program.py``.

:meth:`repro_torch.core.LPFContext.record` (or the ``ctx.program()``
context manager) turns ``ctx.sync`` into a deferred operation: each sync
snapshots its ``(message table, attrs, label)`` into a pending trace as a
:class:`ProgramStep`.  Local compute is a *dataflow-precise* barrier:
reading a slot executes exactly the pending supersteps in its
:func:`dependency_cone` (the slot's writers, closed backwards under
must-precede conflicts), leaving independent supersteps recorded; the end
of the recording executes the rest.

This port executes a flushed trace in recorded order, one planned
superstep per recorded sync.  The JAX package's trace optimizer
(coalescing, dead-transfer elimination, batching, overlap, schedule
search), its program cache, certification and compiled replay are not
ported yet; a trace whose supersteps can never batch (the BSP FFT's
redistribute and reorder, separated by a compute dependency) ledgers the
same either way.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from .attrs import SyncAttributes
from .sync import Msg

__all__ = ["ProgramStep", "dependency_cone"]


@dataclasses.dataclass(frozen=True)
class ProgramStep:
    """One recorded ``sync``: the staged table + its attributes."""

    msgs: Tuple[Msg, ...]
    attrs: SyncAttributes
    label: str


def _ranges_overlap(a_off: int, a_size: int, b_off: int, b_size: int) -> bool:
    return a_off < b_off + b_size and b_off < a_off + a_size


def _writes_overlap(a: Msg, b: Msg) -> bool:
    return (a.dst == b.dst and a.dst_slot.sid == b.dst_slot.sid
            and _ranges_overlap(a.dst_off, a.size, b.dst_off, b.size))


def _reads_write(reader: Msg, writer: Msg) -> bool:
    """Does ``reader``'s source range observe ``writer``'s destination?"""
    return (reader.src == writer.dst
            and reader.src_slot.sid == writer.dst_slot.sid
            and _ranges_overlap(reader.src_off, reader.size,
                                writer.dst_off, writer.size))


def _msgs_conflict(ma: Msg, mb: Msg) -> bool:
    """Do two messages from different supersteps fail to commute?  True
    when either reads the other's write (RAW/WAR) or their destination
    ranges overlap (WAW — ordering would elect the winner)."""
    return (_reads_write(mb, ma) or _reads_write(ma, mb)
            or _writes_overlap(ma, mb))


def _tables_conflict(ta: Sequence[Msg], tb: Sequence[Msg]) -> bool:
    for ma in ta:
        for mb in tb:
            if _msgs_conflict(ma, mb):
                return True
    return False


def _must_precede(a: ProgramStep, b: ProgramStep) -> bool:
    """Must ``a`` (staged before ``b``) still execute before ``b``?  True
    when reordering them is observable (RAW, WAR or WAW)."""
    return _tables_conflict(a.msgs, b.msgs)


def dependency_cone(steps: Sequence[ProgramStep], sid: int,
                    include_reads: bool = False) -> List[int]:
    """The dataflow-precise flush set: indices (sorted, ascending) of the
    pending supersteps a local read of slot ``sid`` depends on — the
    steps that write the slot, closed backwards under
    :func:`_must_precede`, so executing the cone now and the remaining
    steps later is indistinguishable from executing the whole trace in
    order.  With ``include_reads`` (a local *write* of the slot) steps
    that read the slot join the initial set too."""
    need: set = set()
    for i, st in enumerate(steps):
        for m in st.msgs:
            if m.dst_slot.sid == sid or (include_reads
                                         and m.src_slot.sid == sid):
                need.add(i)
                break
    # backward closure only: a deferred step *after* a cone step keeps
    # its relative order when it flushes later.  Each step enters the
    # frontier once, so every (x, y) pair is tested at most once.
    frontier = sorted(need, reverse=True)
    while frontier:
        y = frontier.pop()
        for x in range(y):
            if x not in need and _must_precede(steps[x], steps[y]):
                need.add(x)
                frontier.append(x)
    return sorted(need)
