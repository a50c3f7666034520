"""Static race/hazard linter over recorded LPF traces.

:func:`lint_trace` walks a list of :class:`repro_torch.core.ProgramStep` and
reports stable-coded diagnostics without executing anything:

==========  ========  =================================================
code        severity  meaning
==========  ========  =================================================
``LPF001``  error     write-write race in a table the user asserted
                      ``no_conflict`` on — the result depends on CRCW
                      arbitration order, which ``no_conflict`` lowering
                      is licensed to ignore
``LPF002``  error     read of a slot region never written since the
                      slot was declared undefined (pass ``undefined=``)
``LPF003``  error     message references a slot deregistered earlier in
                      the recording (pass ``events=``); as a *warning*,
                      a slot registered during the recording that is
                      never deregistered (leak across the recording)
``LPF004``  error     malformed message: pid out of range, negative
                      size, source/destination extent out of bounds of
                      the registered slot, dtype mismatch, or a
                      remotely-referred ``register_local`` slot
``LPF005``  warning   self-message whose source and destination ranges
                      overlap but are shifted — the copy aliases itself
                      and the result depends on copy direction
``LPF006``  warning   dead transfer: the destination range is fully
                      overwritten by a later superstep before any read
                      (:func:`lint_program` reports the ones that
                      *survive* optimization)
==========  ========  =================================================

The interval/conflict logic here is deliberately self-contained (it
re-implements the three-line overlap predicates instead of importing
the optimizer's) so a bug in ``repro_torch.core.program``'s hazard relations
cannot blind the linter to it.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple

from ..core.attrs import SyncAttributes
from ..core.program import ProgramStep, SuperstepProgram, canonical_order
from ..core.sync import Msg, find_conflict

__all__ = ["Diagnostic", "ERROR", "WARNING", "lint_trace", "lint_program"]

ERROR = "error"
WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One linter/verifier finding, printable as
    ``CODE severity step[N]: message  <offending Msg>``."""

    code: str               # "LPF001".."LPF006" / "LPF1xx" (verifier)
    severity: str           # ERROR | WARNING
    step: int               # step rank it anchors to; -1 = whole trace
    message: str
    msg: Optional[Msg] = None

    def __str__(self) -> str:
        where = f"step[{self.step}]" if self.step >= 0 else "trace"
        tail = f"  {self.msg}" if self.msg is not None else ""
        return f"{self.code} {self.severity} {where}: {self.message}{tail}"


# --------------------------------------------------------------------------
# self-contained interval / hazard primitives
# --------------------------------------------------------------------------

def _overlaps(a_off: int, a_size: int, b_off: int, b_size: int) -> bool:
    return a_off < b_off + b_size and b_off < a_off + a_size


def _reads(reader: Msg, writer: Msg) -> bool:
    """Does ``reader``'s source range observe ``writer``'s destination?"""
    return (reader.src == writer.dst
            and reader.src_slot.sid == writer.dst_slot.sid
            and _overlaps(reader.src_off, reader.size,
                          writer.dst_off, writer.size))


def _waw(a: Msg, b: Msg) -> bool:
    return (a.dst == b.dst and a.dst_slot.sid == b.dst_slot.sid
            and _overlaps(a.dst_off, a.size, b.dst_off, b.size))


def _merge_intervals(ivs: Iterable[Sequence[int]]) -> List[List[int]]:
    """Normalize half-open ``[lo, hi)`` intervals: sorted and disjoint
    (touching intervals merge)."""
    out: List[List[int]] = []
    for lo, hi in sorted(tuple(iv) for iv in ivs):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def _covered(ivs: Sequence[Sequence[int]], lo: int, hi: int) -> bool:
    """Is ``[lo, hi)`` fully inside the (merged) interval set?"""
    if lo >= hi:
        return True
    for a, b in ivs:
        if a <= lo < b:
            lo = b
            if lo >= hi:
                return True
    return False


def _dead_transfers(tables: Sequence[Sequence[Msg]],
                    attrs_list: Sequence[SyncAttributes]
                    ) -> List[Tuple[int, Msg, int]]:
    """``(step, msg, overwriting_step)`` for every transfer whose
    destination range is fully overwritten before any read.

    Deliberately *permissive* (a union of one later superstep's writes
    counts as an overwrite, compressed supersteps are skipped as
    overwriters but their reads still protect) — this is the deadness
    the verifier accepts as justification for a dropped transfer, so it
    must never be stricter than what the optimizer actually kills."""
    out: List[Tuple[int, Msg, int]] = []
    for i, tbl in enumerate(tables):
        for m in tbl:
            if m.size <= 0:
                continue
            for j in range(i + 1, len(tables)):
                if any(_reads(r, m) for r in tables[j]):
                    break           # observed before any full overwrite
                if attrs_list[j].compress is not None:
                    continue        # lossy wire: not a clean overwrite
                writes = [(w.dst_off, w.dst_off + w.size)
                          for w in tables[j]
                          if w.dst == m.dst and w.size > 0
                          and w.dst_slot.sid == m.dst_slot.sid]
                if writes and _covered(_merge_intervals(writes),
                                       m.dst_off, m.dst_off + m.size):
                    out.append((i, m, j))
                    break
    return out


# --------------------------------------------------------------------------
# per-message extent lint (LPF004) — a non-raising Msg.validate
# --------------------------------------------------------------------------

def _lint_msg(m: Msg, p: int, step: int) -> List[Diagnostic]:
    out: List[Diagnostic] = []

    def err(text: str) -> None:
        out.append(Diagnostic("LPF004", ERROR, step, text, m))

    if not (0 <= m.src < p and 0 <= m.dst < p):
        err(f"pid out of range for p={p}")
    if m.size < 0:
        err("negative size")
    else:
        if m.src_off < 0 or m.src_off + m.size > m.src_slot.size:
            err(f"source range [{m.src_off}, {m.src_off + m.size}) exceeds "
                f"slot {m.src_slot.name}#{m.src_slot.sid} of size "
                f"{m.src_slot.size}")
        if m.dst_off < 0 or m.dst_off + m.size > m.dst_slot.size:
            err(f"destination range [{m.dst_off}, {m.dst_off + m.size}) "
                f"exceeds slot {m.dst_slot.name}#{m.dst_slot.sid} of size "
                f"{m.dst_slot.size}")
    if m.src_slot.dtype != m.dst_slot.dtype:
        err("source/destination dtype mismatch")
    if m.src != m.dst:
        need_global = {"put": (m.dst_slot,), "get": (m.src_slot,),
                       "table": (m.src_slot, m.dst_slot)}
        for slot in need_global.get(m.origin, ()):
            if slot.kind != "global":
                err(f"remotely-referred slot {slot.name}#{slot.sid} is "
                    f"register_local (origin {m.origin!r})")
    return out


# --------------------------------------------------------------------------
# the trace linter
# --------------------------------------------------------------------------

def lint_trace(steps: Sequence[ProgramStep], p: int, *,
               undefined: Iterable[int] = (),
               events: Iterable[Tuple[int, str, int]] = (),
               check_dead: bool = True) -> List[Diagnostic]:
    """Lint a recorded trace; returns diagnostics in step order.

    ``undefined`` — sids whose initial contents are undefined (output
    buffers); reads of their never-written regions are LPF002 errors.
    ``events`` — ``(step, "register"|"deregister", sid)`` slot-lifetime
    events, each taking effect *before* step ``step`` (``len(steps)``
    means after the last step); they drive LPF003.  ``check_dead=False``
    skips the LPF006 dead-transfer scan (the sanitizer does, reporting
    instead the dead transfers that *survive* optimization via
    :func:`lint_program`)."""
    steps = list(steps)
    diags: List[Diagnostic] = []

    # LPF004 — malformed messages
    for i, st in enumerate(steps):
        for m in st.msgs:
            diags.extend(_lint_msg(m, p, i))

    # LPF001 — user-asserted no_conflict vs an actual write-write race
    # (reduce_op tables combine overlapping writes by construction)
    for i, st in enumerate(steps):
        if st.attrs.no_conflict and st.attrs.reduce_op is None:
            pair = find_conflict(st.msgs)
            if pair is not None:
                diags.append(Diagnostic(
                    "LPF001", ERROR, i,
                    "table asserted no_conflict but two messages write "
                    f"overlapping destination ranges ({pair[0]} vs "
                    f"{pair[1]}) — the result depends on CRCW "
                    "arbitration order", pair[0]))

    # LPF002 — read of an undefined slot region
    undefined = set(undefined)
    if undefined:
        defined = {}        # (pid, sid) -> merged [lo, hi) interval list
        for i, st in enumerate(steps):
            for m in st.msgs:       # reads observe pre-superstep state
                if m.size > 0 and m.src_slot.sid in undefined and \
                        not _covered(defined.get((m.src, m.src_slot.sid),
                                                 ()),
                                     m.src_off, m.src_off + m.size):
                    diags.append(Diagnostic(
                        "LPF002", ERROR, i,
                        f"read of undefined region [{m.src_off}, "
                        f"{m.src_off + m.size}) of slot "
                        f"{m.src_slot.name}#{m.src_slot.sid} on pid "
                        f"{m.src}", m))
            for m in st.msgs:       # then the superstep's writes land
                if m.size > 0 and m.dst_slot.sid in undefined:
                    key = (m.dst, m.dst_slot.sid)
                    defined[key] = _merge_intervals(
                        list(defined.get(key, []))
                        + [[m.dst_off, m.dst_off + m.size]])

    # LPF003 — slot lifetime vs the trace
    events = sorted(events, key=lambda e: e[0])
    if events:
        by_step: dict = {}
        for (estep, kind, sid) in events:
            by_step.setdefault(estep, []).append((kind, sid))
        dereg_at: dict = {}         # sid -> step it was deregistered before
        live_regs: set = set()      # registered during the trace, not freed
        for i in range(len(steps) + 1):
            for kind, sid in by_step.get(i, ()):
                if kind == "register":
                    dereg_at.pop(sid, None)
                    live_regs.add(sid)
                else:
                    dereg_at[sid] = i
                    live_regs.discard(sid)
            if i == len(steps):
                break
            for m in steps[i].msgs:
                for slot, role in ((m.src_slot, "source"),
                                   (m.dst_slot, "destination")):
                    if slot.sid in dereg_at:
                        diags.append(Diagnostic(
                            "LPF003", ERROR, i,
                            f"{role} slot {slot.name}#{slot.sid} was "
                            f"deregistered before step "
                            f"{dereg_at[slot.sid]} (use after "
                            "deregister)", m))
        for sid in sorted(live_regs):
            diags.append(Diagnostic(
                "LPF003", WARNING, -1,
                f"slot #{sid} registered during the recording is never "
                "deregistered (leaks across the recording)"))

    # LPF005 — overlapping shifted self-message (memmove-style aliasing)
    for i, st in enumerate(steps):
        for m in st.msgs:
            if (m.src == m.dst and m.src_slot.sid == m.dst_slot.sid
                    and m.size > 0 and m.src_off != m.dst_off
                    and _overlaps(m.src_off, m.size, m.dst_off, m.size)):
                diags.append(Diagnostic(
                    "LPF005", WARNING, i,
                    "self-message source and destination ranges overlap "
                    "but are shifted — the copy aliases itself", m))

    # LPF006 — dead transfers in the raw trace
    if check_dead:
        tables = [list(st.msgs) for st in steps]
        for (i, m, j) in _dead_transfers(tables,
                                         [st.attrs for st in steps]):
            diags.append(Diagnostic(
                "LPF006", WARNING, i,
                f"dead transfer: destination range fully overwritten by "
                f"step[{j}] before any read", m))

    diags.sort(key=lambda d: (d.step if d.step >= 0 else len(steps),
                              d.code))
    return diags


def lint_program(prog: SuperstepProgram, steps: Sequence[ProgramStep],
                 order: Optional[Sequence[int]] = None
                 ) -> List[Diagnostic]:
    """LPF006 over the *optimized* schedule: dead transfers that
    survived optimization (the cost gate refused the kill, or the
    overwrite needed a union of writes the single-message eliminator
    cannot see).  ``steps`` is the recorded trace the program was built
    from (or any trace with the same signature)."""
    steps = list(steps)
    if order is None:
        order = canonical_order(steps) if prog.canonical \
            else list(range(len(steps)))
    entries = prog.materialize(steps, order=order)
    tables = [e[0] for e in entries]
    attrs_list = [e[1] for e in entries]
    return [Diagnostic(
                "LPF006", WARNING, i,
                f"dead transfer survives optimization: destination range "
                f"fully overwritten by scheduled step[{j}] before any "
                "read", m)
            for (i, m, j) in _dead_transfers(tables, attrs_list)]
