"""Schedule verifier: a machine-checked legality certificate for every
optimized :class:`repro_torch.core.SuperstepProgram`.

Given the recorded trace and the :class:`repro_torch.core.OptimizedStep`
schedule the optimizer emitted for it, :func:`verify_program`
*independently re-derives* the must-precede conflict DAG of the
surviving transfers and certifies, without executing anything:

==========  ==========================================================
``LPF101``  schedule structure: ``merged_from`` ranks partition the
            recorded trace, overlap groups are consecutive ranges,
            canonical slot indices resolve against the trace
``LPF102``  the issue order is a legal topological order of the
            must-precede DAG (conflicting recorded supersteps keep
            their staged relative order)
``LPF103``  every merged superstep's members commute under the merge
            contract: no member reads an earlier member's write (RAW),
            no cross-member destination overlap (WAW), the member's
            CRCW slot-pair application order is preserved, and attrs
            are unchanged unless a rewrite is declared
``LPF104``  every overlap group satisfies the ``_can_overlap``
            contract: members pairwise commute (no RAW either way, no
            WAW) and every member's planned method is overlappable
``LPF105``  every Valiant rewrite sits on a ``conflict_free`` table,
            has a scratch slot, and rewrote only valiant-eligible
            members (no reduce/compress, method auto|direct)
``LPF106``  cost compliance: every cached plan equals a freshly
            planned one (method + cost), and ``ledger_costs`` entries
            equal the plans' predicted costs (``overlap_cost`` for
            groups) — what execution will ledger is what the model
            predicts
``LPF107``  transfer survival: every recorded transfer is either
            carried (possibly coalesced) by its scheduled superstep or
            provably dead, and no scheduled transfer moves bytes the
            recording never staged
==========  ==========================================================

All verifier diagnostics are error severity; ``ok`` means zero.  The
hazard predicates are re-implemented locally (three-liners) rather than
imported from the optimizer, so the certificate does not inherit the
optimizer's bugs.  Known limitation: multiplicity of *overlapping*
``reduce_op`` contributions is not tracked (the range-coverage survival
check is count-blind); the differential oracle covers that axis.

The certificate is cheap (pure Python, one fresh plan per scheduled
superstep) and is memoized per :class:`repro_torch.core.ProgramCache` entry
by :meth:`~repro_torch.core.ProgramCache.certify`; compiled artifacts are
only cached for certified keys.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..core.cost import overlap_cost
from ..core.errors import LPFFatalError
from ..core.program import (ProgramStep, SuperstepProgram, canonical_order,
                            trace_slot_map)
from ..core.sync import (Msg, OVERLAPPABLE_METHODS, find_conflict,
                         plan_sync)
from .linter import (Diagnostic, ERROR, _covered, _dead_transfers,
                     _merge_intervals, _reads, _waw)

__all__ = ["VerifierReport", "verify_program"]


@dataclasses.dataclass(frozen=True)
class VerifierReport:
    """The checkable certificate: ``ok`` iff zero diagnostics."""

    ok: bool
    n_steps: int
    n_groups: int
    n_rewrites: int
    diagnostics: Tuple[Diagnostic, ...] = ()

    def summary(self) -> str:
        if self.ok:
            return (f"verified: {self.n_steps} steps, {self.n_groups} "
                    f"groups, {self.n_rewrites} rewrites, 0 diagnostics")
        codes = ",".join(sorted({d.code for d in self.diagnostics}))
        return (f"NOT verified: {len(self.diagnostics)} diagnostics "
                f"({codes})")


def _conflict_witness(ta: Sequence[Msg], tb: Sequence[Msg]
                      ) -> Optional[Tuple[Msg, Msg]]:
    """First non-commuting pair across two tables: a RAW in either
    direction or a destination overlap (WAW)."""
    for ma in ta:
        for mb in tb:
            if _reads(mb, ma) or _reads(ma, mb) or _waw(ma, mb):
                return (ma, mb)
    return None


def _slot_pair_order(msgs: Sequence[Msg]) -> List[Tuple[int, int]]:
    """Slot-pair groups in first-occurrence order — the cross-group
    CRCW application order of the direct executor."""
    seen: List[Tuple[int, int]] = []
    for m in msgs:
        k = (m.src_slot.sid, m.dst_slot.sid)
        if k not in seen:
            seen.append(k)
    return seen


def _same_route(a: Msg, b: Msg) -> bool:
    return (a.src == b.src and a.dst == b.dst
            and a.src_slot.sid == b.src_slot.sid
            and a.dst_slot.sid == b.dst_slot.sid
            and a.origin == b.origin)


def _covering(r: Msg, table: Sequence[Msg]) -> Optional[Msg]:
    """The scheduled message carrying recorded transfer ``r``: same
    route, same src->dst shift (coalescing is contiguous in both
    offsets), and ``r``'s source range inside it."""
    for m in table:
        if (_same_route(r, m)
                and m.src_off <= r.src_off
                and r.src_off + r.size <= m.src_off + m.size
                and m.dst_off - m.src_off == r.dst_off - r.src_off):
            return m
    return None


def verify_program(steps: Sequence[ProgramStep], prog: SuperstepProgram,
                   scratch=None,
                   order: Optional[Sequence[int]] = None
                   ) -> VerifierReport:
    """Certify that ``prog`` is a legal schedule of the recorded trace
    ``steps``.  ``scratch`` must be the same scratch slot the optimizer
    planned with (it parameterizes Valiant plans); ``order`` is an
    optional precomputed :func:`repro_torch.core.canonical_order` of
    ``steps``."""
    steps = list(steps)
    diags: List[Diagnostic] = []
    seen: Set[Tuple[str, int]] = set()

    def fail(code: str, step: int, message: str,
             msg: Optional[Msg] = None) -> None:
        if (code, step) in seen:
            return              # one diagnostic per (code, anchor step)
        seen.add((code, step))
        diags.append(Diagnostic(code, ERROR, step, message, msg))

    n_groups = len(prog.groups())
    n_rewrites = sum(1 for st in prog.steps if st.rewrite)

    def report() -> VerifierReport:
        return VerifierReport(ok=not diags, n_steps=len(prog.steps),
                              n_groups=n_groups, n_rewrites=n_rewrites,
                              diagnostics=tuple(diags))

    # ---- LPF101: structure -------------------------------------------
    n_rec = len(steps)
    if prog.n_recorded != n_rec:
        fail("LPF101", -1,
             f"program records {prog.n_recorded} supersteps but the "
             f"trace has {n_rec}")
        return report()
    ranks = sorted(r for st in prog.steps for r in st.merged_from)
    if ranks != list(range(n_rec)):
        fail("LPF101", -1,
             "merged_from ranks do not partition the recorded trace")
        return report()
    groups = prog.groups()
    flat = [i for grp in groups for i in grp]
    if flat != list(range(len(prog.steps))) or any(
            tuple(grp) != tuple(range(grp[0], grp[0] + len(grp)))
            for grp in groups):
        fail("LPF101", -1, "overlap groups are not consecutive ranges "
             "partitioning the schedule")
        return report()

    if prog.canonical:
        if order is None:
            order = canonical_order(steps)
    else:
        order = list(range(n_rec))
    ordered = [steps[i] for i in order]
    slot_map = trace_slot_map(steps, order)

    mats: List[List[Msg]] = []
    for si, st in enumerate(prog.steps):
        try:
            mats.append([Msg(src, dst, slot_map[s_i], so, slot_map[d_i],
                             do, sz, origin=o)
                         for (src, dst, s_i, so, d_i, do, sz, o)
                         in st.table])
        except IndexError:
            fail("LPF101", si,
                 "canonical slot index out of range for this trace")
            return report()

    step_of: Dict[int, int] = {}
    for si, st in enumerate(prog.steps):
        for r in st.merged_from:
            step_of[r] = si
    group_of: Dict[int, int] = {}
    for gi, grp in enumerate(groups):
        for i in grp:
            group_of[i] = gi

    # ---- LPF107: transfer survival -----------------------------------
    rec_tables = [list(st.msgs) for st in ordered]
    rec_attrs = [st.attrs for st in ordered]
    dead = {(i, id(m)) for (i, m, _) in
            _dead_transfers(rec_tables, rec_attrs)}

    surv: List[List[Msg]] = [[] for _ in range(n_rec)]
    for k in range(n_rec):
        si = step_of[k]
        for r in rec_tables[k]:
            if r.size == 0:
                continue
            if _covering(r, mats[si]) is not None:
                surv[k].append(r)
            elif (k, id(r)) not in dead:
                fail("LPF107", si,
                     f"recorded transfer of canonical rank {k} was "
                     "dropped but is not provably dead", r)
    for si, st in enumerate(prog.steps):
        for m in mats[si]:
            if m.size == 0:
                continue
            pieces = [(r.src_off, r.src_off + r.size)
                      for k in st.merged_from for r in rec_tables[k]
                      if _same_route(r, m) and r.size > 0
                      and m.src_off <= r.src_off
                      and r.src_off + r.size <= m.src_off + m.size
                      and m.dst_off - m.src_off == r.dst_off - r.src_off]
            if not _covered(_merge_intervals(pieces), m.src_off,
                            m.src_off + m.size):
                fail("LPF107", si,
                     "scheduled transfer moves bytes no recorded "
                     "transfer of its members staged", m)

    # ---- LPF103 / LPF105: merge + rewrite legality -------------------
    for si, st in enumerate(prog.steps):
        mf = st.merged_from
        if st.rewrite == "":
            for k in mf:
                if ordered[k].attrs != st.attrs:
                    fail("LPF103", si,
                         f"attrs of canonical rank {k} changed without "
                         "a declared rewrite")
        elif st.rewrite == "valiant":
            if scratch is None:
                fail("LPF105", si,
                     "valiant rewrite but no scratch slot to route "
                     "phase 1 through")
            a = st.attrs
            if a.method != "valiant" or a.reduce_op is not None \
                    or a.compress is not None:
                fail("LPF105", si,
                     f"valiant rewrite carries non-valiant attrs {a}")
            for k in mf:
                ra = ordered[k].attrs
                if ra.reduce_op is not None or ra.compress is not None \
                        or ra.method not in ("auto", "direct"):
                    fail("LPF105", si,
                         f"canonical rank {k} is not valiant-eligible "
                         "(reduce/compress/explicit method) — a method "
                         "rewrite may not change its semantics")
            pair = find_conflict(mats[si])
            if pair is not None:
                fail("LPF105", si,
                     "valiant rewrite on a table that is not "
                     "conflict_free — two-phase routing would arbitrate "
                     "CRCW winners in intermediate-pid order", pair[0])
        else:
            fail("LPF105", si, f"unknown rewrite {st.rewrite!r}")
        if len(mf) > 1:
            for q in range(1, len(mf)):
                earlier = [m for k in mf[:q] for m in surv[k]]
                later = surv[mf[q]]
                for m2 in later:
                    raw = next((m1 for m1 in earlier if _reads(m2, m1)),
                               None)
                    if raw is not None:
                        fail("LPF103", si,
                             "merged member reads an earlier member's "
                             "write (RAW) — merged reads observe "
                             "pre-superstep state", m2)
                    if st.rewrite == "":
                        waw = next((m1 for m1 in earlier
                                    if _waw(m1, m2)), None)
                        if waw is not None:
                            fail("LPF103", si,
                                 "merged members write overlapping "
                                 "destination ranges (WAW) — merging "
                                 "re-arbitrates the winner", m2)
                if st.rewrite == "" and st.attrs.reduce_op is None:
                    later_groups = set(_slot_pair_order(later))
                    merged = [g for g in
                              _slot_pair_order(earlier + list(later))
                              if g in later_groups]
                    if merged != _slot_pair_order(later):
                        fail("LPF103", si,
                             "merge reorders the member's CRCW "
                             "slot-pair application order")

    # ---- LPF104: overlap groups --------------------------------------
    for gi, grp in enumerate(groups):
        if len(grp) == 1:
            continue
        for i in grp:
            if prog.steps[i].plan.method not in OVERLAPPABLE_METHODS:
                fail("LPF104", i,
                     f"overlap group member planned method "
                     f"{prog.steps[i].plan.method!r} is not "
                     "overlappable")
        for ai in range(len(grp)):
            for bi in range(ai + 1, len(grp)):
                w = _conflict_witness(mats[grp[ai]], mats[grp[bi]])
                if w is not None:
                    fail("LPF104", grp[bi],
                         f"overlap group members {grp[ai]} and "
                         f"{grp[bi]} do not commute (finish order "
                         "would be observable)", w[1])

    # ---- LPF102: topological order of the must-precede DAG -----------
    reads_fp = [{(m.src, m.src_slot.sid) for m in surv[k]}
                for k in range(n_rec)]
    writes_fp = [{(m.dst, m.dst_slot.sid) for m in surv[k]}
                 for k in range(n_rec)]
    for a in range(n_rec):
        for b in range(a + 1, n_rec):
            if step_of[a] == step_of[b]:
                continue            # intra-merge: LPF103's domain
            if group_of[step_of[a]] == group_of[step_of[b]]:
                continue            # intra-group: LPF104's domain
            if not ((writes_fp[a] & reads_fp[b])
                    or (writes_fp[b] & reads_fp[a])
                    or (writes_fp[a] & writes_fp[b])):
                continue
            w = _conflict_witness(surv[a], surv[b])
            if w is None:
                continue
            if group_of[step_of[a]] > group_of[step_of[b]]:
                fail("LPF102", step_of[b],
                     f"canonical rank {a} must precede rank {b} (they "
                     "conflict) but the schedule issues it later — not "
                     "a topological order of the must-precede DAG",
                     w[0])

    # ---- LPF106: cost compliance -------------------------------------
    fresh_costs = []
    for si, st in enumerate(prog.steps):
        try:
            fresh = plan_sync(mats[si], prog.p, st.attrs, scratch)
        except LPFFatalError as e:
            fail("LPF106", si,
                 f"re-planning the scheduled table failed: {e}")
            fresh_costs.append(None)
            continue
        if fresh.method != st.plan.method or fresh.cost != st.plan.cost:
            fail("LPF106", si,
                 f"cached plan (method {st.plan.method!r}, "
                 f"{st.plan.cost}) diverges from a fresh plan (method "
                 f"{fresh.method!r}, {fresh.cost})")
        fresh_costs.append(fresh.cost)
    if all(c is not None for c in fresh_costs):
        ledger = prog.ledger_costs()
        for gi, grp in enumerate(groups):
            exp = fresh_costs[grp[0]] if len(grp) == 1 else \
                overlap_cost([fresh_costs[i] for i in grp])
            got = dataclasses.replace(ledger[gi], label="")
            if got != dataclasses.replace(exp, label=""):
                fail("LPF106", grp[0],
                     f"ledger entry of issue group {gi} does not equal "
                     "the plans' predicted cost")

    return report()
