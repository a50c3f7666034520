"""SuperstepProgram — record, optimize and replay whole LPF programs.

The port of the JAX package's ``core/program.py``, schedule for schedule:
the same canonical order, signatures, rewrites, cost gates and overlap
groups, so a trace recorded here gets the schedule the JAX package gives
it.

* **record** — :meth:`repro_torch.core.LPFContext.record` (or the
  ``ctx.program()`` context manager) turns ``ctx.sync`` into a deferred
  operation: each sync snapshots its ``(message table, attrs, label)``
  into a pending trace as a :class:`ProgramStep`.  Local compute is a
  *dataflow-precise* barrier: reading a slot executes exactly the pending
  supersteps in its :func:`dependency_cone` (the slot's writers, closed
  backwards under must-precede conflicts), leaving independent
  supersteps recorded.
* **optimize** — :func:`optimize_program` is a cost-model-driven
  *schedule search* over the trace's dependency DAG.  The trace is first
  brought into :func:`canonical_order` — a deterministic topological order
  of the must-precede DAG keyed by step content, so legal reorderings of
  one recording canonicalize (and cache) identically — then rewritten:

  1. *coalescing* — same-``(src, dst, slot-pair)`` messages contiguous in
     both offsets merge into one fatter message (kept only when the plan
     of the rewritten table is not predicted slower);
  2. *dead-transfer elimination* — a message whose destination range is
     completely overwritten by a later superstep before any read is
     dropped, gated the same way;
  3. *superstep batching as list scheduling* — each emitted superstep
     absorbs any still-unscheduled step whose predecessors are placed
     (**non-adjacent** independent supersteps hoist over intervening
     ones), every merge gated by the BSP model (``h_merged*g + l <
     sum(h_i*g + l)``);
  4. *Valiant-aware attr rewrites* — a conflict-free, round-heavy
     superstep (merged or alone) may be rerouted through two-phase
     Valiant routing when that is predicted strictly cheaper
     (:data:`VALIANT_REWRITE_MIN_ROUNDS`);
  5. *split-phase overlap as list scheduling* — independent supersteps the
     merge gate keeps apart are grouped for overlapped issue (all starts,
     then all finishes; :func:`repro_torch.core.sync.execute_overlapped`),
     a k-member group priced ``max_i(h_i)g + max_i(rounds_i)l +
     (k-1)*l_overlap`` and admitted only below the sequential sum.

  ``search=False`` keeps recorded order and the adjacent-pairs peephole —
  the baseline ``scripts/schedule_search.py`` measures the search against.
  :meth:`SuperstepProgram.explain` renders the found schedule.
* **certify** — :meth:`ProgramCache.certify` runs the schedule verifier
  (:func:`repro_torch.analysis.verify_program`) before a program may run.
* **replay** — optimized traces are cached in a :class:`ProgramCache`
  keyed by the canonical program signature (slot ids renamed by first
  occurrence across the whole ordered trace) and the machine's (g, l), so
  a collective called per layer, an FFT called per batch, a loop body
  called per iteration, skip the optimizer and the planner.  A program
  runs through :func:`repro_torch.core.sync.execute_schedule`, dispatched
  superstep by superstep or as a :class:`CompiledProgram`: on the card a
  CUDA graph captured once and replayed, on the CPU the same schedule
  over a :class:`~repro_torch.core.sync.ValueStore`.

Every optimized superstep carries its :class:`SuperstepPlan`, so the
ledger entry appended at execution is by construction the plan's
predicted :class:`SuperstepCost`.

:func:`simulate_program` is a pure-numpy reference interpreter of the
p >= 2 superstep semantics (reads observe pre-superstep state; CRCW writes
arbitrate in ascending ``(src, dst, dst_off)`` order per slot-pair group,
groups in first-occurrence order; ``reduce_op`` supersteps combine with
first-write-replaces semantics), the oracle the optimized schedules are
held to bit for bit.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import (Any, Callable, Dict, Hashable, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from . import faultpoints as _fp
from .attrs import SyncAttributes
from .cost import SuperstepCost, overlap_cost, schedule_seconds
from .errors import LPFAnalysisError, LPFFatalError
from .machine import LPFMachine
from .memslot import Slot, dtype_name
from .sync import (CacheStats, Msg, OVERLAPPABLE_METHODS, PlanCache,
                   SuperstepPlan, ValueStore, conflict_free,
                   execute_schedule, keep_indices, plan_sync)

__all__ = [
    "ProgramStep", "OptimizedStep", "SuperstepProgram", "ProgramCache",
    "CompiledProgram", "compile_program", "global_program_cache",
    "program_signature", "optimize_program", "simulate_program",
    "dependency_cone", "canonical_order", "trace_slot_map",
]

#: combined planned rounds at which the scheduler bothers pricing a
#: two-phase Valiant route for a (merged) superstep: thin well-formed
#: relations never profit from the doubled wire, so the rewrite search
#: is reserved for skewed/fragmented fat schedules
VALIANT_REWRITE_MIN_ROUNDS = 4

#: completions the canonical-form tie-break may explore per trace:
#: ties that survive :func:`_structural_ranks` (WL-equivalent but
#: non-automorphic steps — e.g. a hexagon and two triangles of
#: slot-sharing between bit-identical steps refine to one colour) are
#: broken by *comparing the finished signatures* of each candidate's
#: completion; the budget bounds the branching on adversarially
#: symmetric traces, beyond which the recorded-index fallback applies
TIE_BRANCH_BUDGET = 256

#: canonical message: (src, dst, src_slot_idx, src_off, dst_slot_idx,
#: dst_off, size, origin) with slot indices assigned by first occurrence
#: across the whole trace
CanonMsg = Tuple[int, int, int, int, int, int, int, str]


@dataclasses.dataclass(frozen=True)
class ProgramStep:
    """One recorded ``sync``: the staged table + its attributes."""

    msgs: Tuple[Msg, ...]
    attrs: SyncAttributes
    label: str


@dataclasses.dataclass(frozen=True)
class OptimizedStep:
    """One superstep of the optimized trace, in canonical (slot-renamed)
    form plus its pre-computed plan.  ``merged_from`` names the
    *canonical ranks* (positions in :func:`canonical_order` of the
    recorded trace) this superstep executes; ``unchanged`` marks a step
    no rewrite touched, letting replay reuse the staged messages
    verbatim instead of rebuilding them from the canonical table.
    ``rewrite`` records an attr rewrite the scheduler applied (e.g.
    ``"valiant"`` — the step's attrs are no longer the recorded ones)."""

    table: Tuple[CanonMsg, ...]
    attrs: SyncAttributes
    label: str
    plan: SuperstepPlan
    merged_from: Tuple[int, ...]
    unchanged: bool = False
    rewrite: str = ""


@dataclasses.dataclass(frozen=True)
class SuperstepProgram:
    """An optimized, replayable trace (the program-level IR)."""

    p: int
    steps: Tuple[OptimizedStep, ...]
    n_recorded: int          # supersteps in the raw trace
    n_coalesced: int         # messages removed by coalescing
    n_eliminated: int        # messages removed as dead transfers
    n_merged: int            # supersteps saved by batching
    #: partition of ``range(len(steps))`` into overlap groups, in step
    #: order: a group of k >= 2 adjacent compute-independent supersteps is
    #: issued split-phase (all starts, then all dones) and ledgered as ONE
    #: entry costing ``max_i(h_i)*g + max_i(rounds_i)*l + (k-1)*l_overlap``
    overlap_groups: Tuple[Tuple[int, ...], ...] = ()
    n_overlapped: int = 0    # supersteps hidden under another's wire time
    n_rewritten: int = 0     # supersteps whose attrs the scheduler rewrote
    n_hoisted: int = 0       # non-adjacent merge/overlap moves performed
    #: how this program's ``merged_from`` ranks and canonical slot
    #: indices were assigned: ``True`` = :func:`canonical_order` of the
    #: recorded trace (the searched/cached path), ``False`` = recorded
    #: order (a ``search=False`` peephole program) — ``materialize``
    #: must resolve ranks the same way the program was built
    canonical: bool = True
    #: the recorded supersteps' own planned costs (canonical order) —
    #: the in-order baseline :meth:`explain` reports the search against
    in_order_costs: Tuple[SuperstepCost, ...] = ()

    def groups(self) -> Tuple[Tuple[int, ...], ...]:
        """``overlap_groups``, defaulting to one singleton per step."""
        if self.overlap_groups:
            return self.overlap_groups
        return tuple((i,) for i in range(len(self.steps)))

    def predicted_seconds(self, machine: LPFMachine) -> float:
        """BSP time of the optimized schedule, overlap priced in."""
        return schedule_seconds(
            [[self.steps[i].plan.cost for i in grp]
             for grp in self.groups()], machine)

    def in_order_seconds(self, machine: LPFMachine) -> float:
        """BSP time of executing the recorded trace superstep by
        superstep, each under its own plan — the baseline the schedule
        search starts from."""
        return sum(c.predicted_seconds(machine)
                   for c in self.in_order_costs)

    def explain(self, machine: Optional[LPFMachine] = None,
                steps: Optional[Sequence["ProgramStep"]] = None,
                scratch: Optional[Slot] = None) -> str:
        """Human-readable rendering of the searched schedule: issue
        groups with member labels, merges/hoists/attr rewrites applied,
        and (when ``machine`` is given) the predicted BSP time of every
        group plus the in-order-vs-scheduled comparison.  The last line
        is the schedule verifier's certificate summary — computed
        fresh from the recorded ``steps`` when given, else the one
        :meth:`ProgramCache.certify` attached."""
        lines = [
            f"SuperstepProgram: {self.n_recorded} recorded -> "
            f"{len(self.steps)} supersteps in {len(self.groups())} "
            f"issue groups",
            f"  rewrites: {self.n_coalesced} coalesced msgs, "
            f"{self.n_eliminated} dead transfers, {self.n_merged} merged, "
            f"{self.n_overlapped} overlapped, {self.n_rewritten} "
            f"attr-rewritten, {self.n_hoisted} non-adjacent hoists",
        ]
        for gi, grp in enumerate(self.groups()):
            costs = [self.steps[i].plan.cost for i in grp]
            c = costs[0] if len(costs) == 1 else overlap_cost(costs)
            head = " || ".join(self.steps[i].label for i in grp)
            line = (f"  [{gi}] {head:<36} {c.method:<28} "
                    f"wire {c.wire_bytes:>8}B  rounds {c.rounds}")
            if machine is not None:
                line += f"  {c.predicted_seconds(machine) * 1e6:>9.2f}us"
            lines.append(line)
            for i in grp:
                st = self.steps[i]
                notes = []
                if len(st.merged_from) > 1:
                    notes.append("merged from recorded steps "
                                 f"{tuple(st.merged_from)}")
                if st.rewrite:
                    notes.append(f"attrs rewritten -> {st.rewrite}")
                if notes:
                    lines.append(f"        {st.label}: "
                                 + "; ".join(notes))
        if machine is not None and self.in_order_costs:
            in_order = self.in_order_seconds(machine)
            sched = self.predicted_seconds(machine)
            ratio = in_order / sched if sched > 0 else float("inf")
            lines.append(
                f"  in-order BSP time {in_order * 1e6:.2f}us -> "
                f"scheduled {sched * 1e6:.2f}us  ({ratio:.2f}x)")
        cert = getattr(self, "_certificate", None)
        if steps is not None:
            from ..analysis.verifier import verify_program
            cert = verify_program(steps, self, scratch=scratch)
        if cert is not None:
            lines.append(f"  {cert.summary()}")
        return "\n".join(lines)

    def slot_map(self, steps: Sequence[ProgramStep]) -> List[Slot]:
        """The slot list this program's canonical indices refer to, for
        a replaying trace ``steps`` — first occurrence in
        :func:`canonical_order` for searched programs, recorded order
        for ``search=False`` ones.  Use this (or pass ``steps``
        directly) rather than a bare ``trace_slot_map`` call, whose
        default ordering only matches canonical programs."""
        return trace_slot_map(
            steps, None if self.canonical else list(range(len(steps))))

    def materialize(self, slot_map_or_steps,
                    labels: Optional[Sequence[str]] = None,
                    order: Optional[Sequence[int]] = None
                    ) -> List[Tuple[List[Msg], SyncAttributes, str,
                                    SuperstepPlan]]:
        """Rebind the canonical tables to actual slots.  Pass either the
        replaying trace's raw :class:`ProgramStep` list (untouched steps
        reuse their staged messages verbatim; rewritten ones rebuild
        from the canonical table via the trace's canonical-order
        first-occurrence slot map) or a pre-computed slot list.
        ``labels`` are the replaying trace's per-step labels *in
        recorded order*, so a cached program replayed under new labels
        ledgers under those (merged supersteps join theirs with ``+``);
        ``merged_from`` ranks are resolved through the replaying trace's
        own :func:`canonical_order`, which — the signature being shared
        — matches the order the program was built in."""
        raw_steps: Optional[Sequence[ProgramStep]] = None
        slot_map: Optional[List[Slot]] = None
        if slot_map_or_steps and isinstance(slot_map_or_steps[0],
                                            ProgramStep):
            raw_steps = slot_map_or_steps
            if not self.canonical:
                order = list(range(len(raw_steps)))
            elif order is None:
                order = canonical_order(raw_steps)
        else:
            slot_map = list(slot_map_or_steps)
            if labels is not None and order is None:
                if self.canonical:
                    # ranks are canonical; without the steps (or an
                    # explicit order) recorded labels cannot be mapped
                    raise LPFFatalError(
                        "materialize(slot_list, labels=...) on a "
                        "searched program needs order= (or pass the "
                        "raw steps), else labels would be resolved by "
                        "canonical rank instead of recorded position")
                order = list(range(self.n_recorded))
        out = []
        for st in self.steps:
            if raw_steps is not None and st.unchanged:
                msgs = list(raw_steps[order[st.merged_from[0]]].msgs)
            else:
                if slot_map is None:
                    slot_map = trace_slot_map(raw_steps, order)
                msgs = [Msg(src, dst, slot_map[si], so, slot_map[di], do,
                            sz, origin=origin)
                        for (src, dst, si, so, di, do, sz, origin)
                        in st.table]
            if labels is None:
                label = st.label
            else:
                label = "+".join(
                    labels[i if order is None else order[i]]
                    for i in st.merged_from)
            out.append((msgs, st.attrs, label, st.plan))
        return out

    def ledger_costs(self, labels: Optional[Sequence[str]] = None,
                     order: Optional[Sequence[int]] = None
                     ) -> List[SuperstepCost]:
        """The exact ledger entries replaying this program appends, in
        issue order: one ``plan.cost_with_label`` per singleton group and
        one :func:`repro_torch.core.cost.overlap_cost` entry per overlap group
        — precisely what :func:`repro_torch.core.sync.execute_schedule`
        returns.  Labels resolve the way :meth:`materialize` resolves
        them (``labels`` in recorded order, ``merged_from`` ranks mapped
        through ``order``), so the compiled whole-program path — which
        cannot thread cost records through a jitted body — ledgers
        bit-for-bit what the step-by-step path would."""
        out: List[SuperstepCost] = []
        for grp in self.groups():
            lbls = []
            for i in grp:
                st = self.steps[i]
                if labels is None:
                    lbls.append(st.label)
                else:
                    lbls.append("+".join(
                        labels[j if order is None else order[j]]
                        for j in st.merged_from))
            if len(grp) == 1:
                out.append(self.steps[grp[0]].plan.cost_with_label(
                    lbls[0]))
            else:
                out.append(overlap_cost(
                    [self.steps[i].plan.cost for i in grp],
                    label="||".join(lbls)))
        return out


# ==========================================================================
# canonicalization + signatures
# ==========================================================================

_DTYPE_STR: Dict[object, str] = {}


def _dtype_str(dtype) -> str:
    """The numpy-style dtype name the JAX package's signatures spell."""
    s = _DTYPE_STR.get(dtype)
    if s is None:
        s = _DTYPE_STR[dtype] = dtype_name(dtype)
    return s


def _slot_canon() -> Tuple[Dict[int, int], List[Tuple[int, str, str]],
                           Callable[[Slot], int]]:
    canon: Dict[int, int] = {}
    descrs: List[Tuple[int, str, str]] = []

    def key(slot: Slot) -> int:
        idx = canon.get(slot.sid)
        if idx is None:
            idx = canon[slot.sid] = len(canon)
            descrs.append((slot.size, _dtype_str(slot.dtype), slot.kind))
        return idx

    return canon, descrs, key


def trace_slot_map(steps: Sequence[ProgramStep],
                   order: Optional[Sequence[int]] = None) -> List[Slot]:
    """Actual slots of a raw trace in canonical-order first-occurrence —
    the inverse of the canonical renaming.  ``order`` (a precomputed
    :func:`canonical_order`) avoids recomputing the DAG sort.  The
    default ordering matches *searched* programs only; when holding a
    :class:`SuperstepProgram`, prefer :meth:`SuperstepProgram.slot_map`
    (or pass the steps straight to ``materialize``), which honours the
    program's own rank ordering (``search=False`` programs use recorded
    order)."""
    if order is None:
        order = canonical_order(steps)
    seen: Dict[int, Slot] = {}
    for i in order:
        for m in steps[i].msgs:
            for slot in (m.src_slot, m.dst_slot):
                if slot.sid not in seen:
                    seen[slot.sid] = slot
    return list(seen.values())


def _attrs_key(attrs: SyncAttributes) -> Hashable:
    return (attrs.method, attrs.no_conflict, attrs.reduce_op,
            attrs.compress, attrs.stale, attrs.valiant_seed)


def _sortable_attrs_key(attrs: SyncAttributes) -> Tuple:
    """Like :func:`_attrs_key` but totally ordered (no ``None``/object
    fields), so ready-step keys can be compared during canonicalization."""
    return (attrs.method, bool(attrs.no_conflict), attrs.reduce_op or "",
            "" if attrs.compress is None else repr(attrs.compress),
            attrs.stale, attrs.valiant_seed)


def _structural_ranks(steps: Sequence[ProgramStep],
                      preds: Sequence[set]) -> List[int]:
    """Order-invariant structural rank of every step — the canonical-tie
    break.  Steps with bit-identical content keys can still be
    structurally distinct: one may feed a later reader (a conflict-DAG
    successor) or share a slot with a step the other never touches.
    Recorded position cannot break such ties — two legal reorderings
    disagree on it, splitting one program into two cache entries — so
    ties are broken by iterated (Weisfeiler-Leman style) colour
    refinement over structure only:

    * initial colour: the step's order-free content (attrs footprint +
      message table with slots named by per-step first occurrence and
      descriptor — the table *shape*);
    * refinement relations: directed must-precede edges (identical
      across legal reorderings — only non-conflicting steps may be
      reordered) and undirected slot-sharing edges labelled by the
      (role-set, role-set, descriptor) of each shared slot — read-read
      sharing creates no DAG edge yet distinguishes a step whose output
      is observed from an identical one whose output is not.

    Colours are re-ranked to dense ints each round until the partition
    stabilizes.  Steps left in one colour class are symmetric under
    both relations: picking either yields the same signature, so the
    caller's recorded-index fallback is then safe."""
    n = len(steps)

    def dense_ranks(ks: List[Tuple]) -> List[int]:
        rank = {k: r for r, k in enumerate(sorted(set(ks)))}
        return [rank[k] for k in ks]

    def static_key(st: ProgramStep) -> Tuple:
        local: Dict[int, int] = {}

        def ref(slot: Slot) -> Tuple:
            li = local.setdefault(slot.sid, len(local))
            return (slot.size, _dtype_str(slot.dtype), slot.kind, li)

        return (_sortable_attrs_key(st.attrs),
                tuple((m.src, m.dst, ref(m.src_slot), m.src_off,
                       ref(m.dst_slot), m.dst_off, m.size, m.origin)
                      for m in st.msgs))

    colors = dense_ranks([static_key(st) for st in steps])

    descr: Dict[int, Tuple] = {}
    roles: List[Dict[int, Tuple]] = []
    for st in steps:
        rmap: Dict[int, set] = {}
        for m in st.msgs:
            rmap.setdefault(m.src_slot.sid, set()).add("r")
            rmap.setdefault(m.dst_slot.sid, set()).add("w")
            for slot in (m.src_slot, m.dst_slot):
                descr.setdefault(slot.sid, (slot.size,
                                            _dtype_str(slot.dtype),
                                            slot.kind))
        roles.append({sid: tuple(sorted(rs)) for sid, rs in rmap.items()})

    edges: List[List[Tuple[Tuple, int]]] = [[] for _ in range(n)]
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            labs: List[Tuple] = []
            if i in preds[j]:
                labs.append(("dag", "succ"))
            if j in preds[i]:
                labs.append(("dag", "pred"))
            for sid in roles[i].keys() & roles[j].keys():
                labs.append(("slot", roles[i][sid], roles[j][sid],
                             descr[sid]))
            if labs:
                edges[i].append((tuple(sorted(labs)), j))

    for _ in range(n):
        refined = dense_ranks([
            (colors[i], tuple(sorted((lab, colors[j])
                                     for lab, j in edges[i])))
            for i in range(n)])
        if refined == colors:
            break
        colors = refined
    return colors


def _order_sig(steps: Sequence[ProgramStep],
               order: Sequence[int]) -> Tuple:
    """Totally-ordered content signature of a completed order — what the
    canonical-form tie-break compares.  Same renaming discipline as
    :func:`program_signature` (slots by first occurrence across the
    ordered trace) but with :func:`_sortable_attrs_key` so candidate
    signatures compare under ``min`` even when attrs hold ``None`` or
    :class:`CompressSpec` fields."""
    _, _, key = _slot_canon()
    out = []
    for i in order:
        st = steps[i]
        out.append((_sortable_attrs_key(st.attrs),
                    tuple((m.src, m.dst, key(m.src_slot), m.src_off,
                           key(m.dst_slot), m.dst_off, m.size, m.origin)
                          for m in st.msgs)))
    return tuple(out)


def canonical_order(steps: Sequence[ProgramStep]) -> List[int]:
    """A deterministic topological order of the trace's must-precede DAG,
    chosen by step *content* rather than recorded position: among ready
    steps the one with the smallest content key (attributes + message
    table, slots referred to by their already-assigned canonical index
    or, when unseen, by descriptor) is scheduled first.

    Two recordings that are legal reorderings of each other have the
    same DAG and the same step contents, so they canonicalize to the
    same sequence — which is what lets :func:`program_signature` give
    them one :class:`ProgramCache` entry.  Steps with bit-identical
    content keys are separated by :func:`_structural_ranks` (footprint +
    table-shape colour refinement over the conflict DAG and slot-sharing
    relation — order-invariant, so both reorderings break the tie the
    same way).  Refinement is incomplete (it is 1-WL): steps can share a
    colour class without any automorphism mapping one to the other, and
    there the recorded-index fallback would split one program into two
    cache entries.  Such residual ties are resolved by *canonical-form
    comparison*: each tied candidate's completion is computed and the
    one whose finished :func:`_order_sig` is smallest wins — a choice
    that depends only on content, never on recorded position.  Truly
    symmetric candidates produce equal signatures, so either completion
    is the same signature and the pick is free.  The branching is
    bounded by :data:`TIE_BRANCH_BUDGET`; past it the recorded-index
    fallback applies (benign only for automorphic ties)."""
    n = len(steps)
    if n <= 1:
        return list(range(n))
    preds = _conflict_dag([st.msgs for st in steps])
    succs: List[List[int]] = [[] for _ in range(n)]
    for j, pr in enumerate(preds):
        for i in pr:
            succs[i].append(j)
    sids = [{m.src_slot.sid for m in st.msgs}
            | {m.dst_slot.sid for m in st.msgs} for st in steps]
    ranks_box: List[Optional[List[int]]] = [None]  # lazy: ties are rare
    budget = [TIE_BRANCH_BUDGET]

    def step_key(st: ProgramStep, canon: Dict[int, int]) -> Tuple:
        local: Dict[int, int] = {}

        def ref(slot: Slot) -> Tuple:
            idx = canon.get(slot.sid)
            if idx is not None:
                return (0, idx, "", "", 0)
            li = local.setdefault(slot.sid, len(local))
            return (1, slot.size, _dtype_str(slot.dtype), slot.kind, li)

        return (_sortable_attrs_key(st.attrs),
                tuple((m.src, m.dst, ref(m.src_slot), m.src_off,
                       ref(m.dst_slot), m.dst_off, m.size, m.origin)
                      for m in st.msgs))

    def place(i: int, canon: Dict[int, int], npreds: List[int],
              ready: List[int], keys: Dict[int, Tuple],
              order: List[int]) -> None:
        ready.remove(i)
        order.append(i)
        newly: set = set()
        for m in steps[i].msgs:
            for slot in (m.src_slot, m.dst_slot):
                if slot.sid not in canon:
                    canon[slot.sid] = len(canon)
                    newly.add(slot.sid)
        if newly:
            # a slot just gained its canonical index: keys that referred
            # to it by descriptor must be recomputed
            for k in ready:
                if sids[k] & newly:
                    keys.pop(k, None)
        for j in succs[i]:
            npreds[j] -= 1
            if npreds[j] == 0:
                ready.append(j)

    def complete(canon: Dict[int, int], npreds: List[int],
                 ready: List[int], order: List[int]) -> List[int]:
        keys: Dict[int, Tuple] = {}
        while ready:
            for i in ready:
                if i not in keys:
                    keys[i] = step_key(steps[i], canon)
            best = min(ready, key=lambda i: (keys[i], i))
            tied = [i for i in ready if keys[i] == keys[best]]
            if len(tied) > 1:
                if ranks_box[0] is None:
                    ranks_box[0] = _structural_ranks(steps, preds)
                ranks = ranks_box[0]
                rbest = min(ranks[i] for i in tied)
                tied = [i for i in tied if ranks[i] == rbest]
                best = min(tied)
                if len(tied) > 1 and budget[0] >= len(tied):
                    # canonical-form comparison: finish the order once
                    # per candidate, keep the smallest finished
                    # signature (content-only, order-invariant)
                    budget[0] -= len(tied)
                    cands = []
                    for i in tied:
                        c2, np2 = dict(canon), list(npreds)
                        r2, o2 = list(ready), list(order)
                        place(i, c2, np2, r2, {}, o2)
                        done = complete(c2, np2, r2, o2)
                        cands.append((_order_sig(steps, done), done))
                    return min(cands, key=lambda c: c[0])[1]
            place(best, canon, npreds, ready, keys, order)
        return order

    npreds0 = [len(pr) for pr in preds]
    return complete({}, npreds0,
                    [i for i in range(n) if npreds0[i] == 0], [])


def program_signature(steps: Sequence[ProgramStep], p: int,
                      scratch: Optional[Slot] = None,
                      order: Optional[Sequence[int]] = None) -> Hashable:
    """Canonical key of a recorded trace: steps taken in
    :func:`canonical_order` — so legal reorderings of the same program
    share one key — with slot ids renamed by first occurrence across
    *all* ordered supersteps (a slot reused by two supersteps must keep
    the same index — cross-superstep dataflow is part of the program),
    plus per-step attributes and message order."""
    if order is None:
        order = canonical_order(steps)
    _, descrs, key = _slot_canon()
    step_sigs = []
    for i in order:
        st = steps[i]
        table = tuple((m.src, m.dst, key(m.src_slot), m.src_off,
                       key(m.dst_slot), m.dst_off, m.size, m.origin)
                      for m in st.msgs)
        step_sigs.append((_attrs_key(st.attrs), table))
    scratch_sig = None if scratch is None else \
        (scratch.size, _dtype_str(scratch.dtype))
    return (p, scratch_sig, tuple(descrs), tuple(step_sigs))


# ==========================================================================
# the optimizer
# ==========================================================================

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


def _coalesce_step(msgs: List[Msg], attrs: SyncAttributes
                   ) -> Tuple[List[Msg], int]:
    """Merge same-(src, dst, slot-pair, origin) messages contiguous in
    both offsets.  With CRCW semantics a merged write must not conflict
    with any *other* message of the step (merging would move it in the
    arbitration order); accumulating supersteps combine commutatively,
    so contiguity alone suffices."""
    if len(msgs) < 2:
        return msgs, 0
    groups: "collections.OrderedDict[Tuple, List[int]]" = \
        collections.OrderedDict()
    for i, m in enumerate(msgs):
        groups.setdefault((m.src, m.dst, m.src_slot.sid, m.dst_slot.sid,
                           m.origin), []).append(i)
    merged: Dict[int, Msg] = {}      # first-piece index -> merged msg
    dropped: set = set()
    for idxs in groups.values():
        if len(idxs) < 2:
            continue
        run = sorted(idxs, key=lambda i: msgs[i].src_off)
        k = 0
        while k < len(run):
            first = run[k]
            cur = msgs[first]
            pieces = [first]
            while k + 1 < len(run):
                nxt = msgs[run[k + 1]]
                if (cur.src_off + cur.size == nxt.src_off
                        and cur.dst_off + cur.size == nxt.dst_off):
                    cur = dataclasses.replace(cur, size=cur.size + nxt.size)
                    pieces.append(run[k + 1])
                    k += 1
                else:
                    break
            k += 1
            if len(pieces) == 1:
                continue
            if attrs.reduce_op is None:
                others = [m for j, m in enumerate(msgs)
                          if j not in pieces]
                if any(_writes_overlap(cur, o) for o in others):
                    continue   # merging would reorder a CRCW conflict
            merged[min(pieces)] = cur
            dropped.update(p_ for p_ in pieces if p_ != min(pieces))
    if not merged:
        return msgs, 0
    out = [merged.get(i, m) for i, m in enumerate(msgs) if i not in dropped]
    return out, len(dropped)


def _group_order(msgs: Sequence[Msg]) -> List[Tuple[int, int]]:
    """Slot-pair groups in first-occurrence order — the order the direct
    executor applies them in (cross-group CRCW arbitration)."""
    seen: List[Tuple[int, int]] = []
    for m in msgs:
        k = (m.src_slot.sid, m.dst_slot.sid)
        if k not in seen:
            seen.append(k)
    return seen


def _dead_msgs(tables: List[List[Msg]],
               attrs_list: List[SyncAttributes], i: int) -> List[int]:
    """Indices into ``tables[i]`` of messages whose destination range is
    completely overwritten by a single later message before any read
    (message sources are the only reads inside a trace; local compute
    flushes the trace, so a flushed trace has no interior compute reads;
    the trace end is a read of everything)."""
    dead = []
    for k, m in enumerate(tables[i]):
        for j in range(i + 1, len(tables)):
            if any(_reads_write(r, m) for r in tables[j]):
                break               # observed before any full overwrite
            if attrs_list[j].compress is not None:
                continue            # lossy wire: not a clean overwrite
            if any(w.dst == m.dst
                   and w.dst_slot.sid == m.dst_slot.sid
                   and w.dst_off <= m.dst_off
                   and w.dst_off + w.size >= m.dst_off + m.size
                   for w in tables[j]):
                dead.append(k)
                break
    return dead


def _msgs_conflict(ma: Msg, mb: Msg) -> bool:
    """Do two messages from different supersteps fail to commute?
    True when either reads the other's write (RAW/WAR) or their
    destination ranges overlap (WAW — ordering would elect the winner).
    The single source of truth for both the cone flush's must-precede
    relation and the overlap gate's commutation check."""
    return (_reads_write(mb, ma) or _reads_write(ma, mb)
            or _writes_overlap(ma, mb))


def _must_precede(a: ProgramStep, b: ProgramStep) -> bool:
    """Must ``a`` (staged before ``b``) still execute before ``b``?
    True when reordering them is observable: ``b`` reads ``a``'s writes
    (RAW), ``a`` reads ranges ``b`` writes (WAR — executing ``b`` first
    would leak its writes into ``a``'s reads), or their destination
    ranges overlap (WAW — arbitration order would flip)."""
    return _tables_conflict(a.msgs, b.msgs)


def dependency_cone(steps: Sequence[ProgramStep], sid: int,
                    include_reads: bool = False) -> List[int]:
    """The dataflow-precise flush set: indices (sorted, ascending) of the
    pending supersteps a local read of slot ``sid`` depends on — the
    steps that write the slot, closed backwards under
    :func:`_must_precede` so that executing the cone now and the
    remaining steps later is indistinguishable from executing the whole
    trace in order.  With ``include_reads`` (a local *write* of the
    slot) steps that read the slot join the initial set too (they must
    observe the pre-write value)."""
    need: set = set()
    for i, st in enumerate(steps):
        for m in st.msgs:
            if m.dst_slot.sid == sid or (include_reads
                                         and m.src_slot.sid == sid):
                need.add(i)
                break
    # backward closure only: a deferred step *after* a cone step keeps
    # its original relative order when it flushes later, so only earlier
    # steps can be pulled in.  Worklist form: each step enters the
    # frontier once, so every (x, y) pair is tested at most once —
    # O(n^2) _must_precede calls per flush, not a fixpoint re-scan.
    frontier = sorted(need, reverse=True)
    while frontier:
        y = frontier.pop()
        for x in range(y):
            if x not in need and _must_precede(steps[x], steps[y]):
                need.add(x)
                frontier.append(x)
    return sorted(need)


def _independent(earlier: Sequence[Msg], later: Sequence[Msg],
                 reduce_op: Optional[str]) -> bool:
    """May ``later`` run in the same superstep as ``earlier``?  Requires
    that no later message reads an earlier write (merged reads observe
    pre-superstep state) and no destination ranges overlap across the
    two (merged CRCW arbitration could elect a different winner; merged
    accumulation would combine instead of overwrite).  For CRCW steps
    the concatenation must also preserve ``later``'s internal group
    order: a slot-pair group already present in ``earlier`` would hoist
    to its position, reordering ``later``'s own cross-group conflicts."""
    for m2 in later:
        for m1 in earlier:
            if _reads_write(m2, m1) or _writes_overlap(m1, m2):
                return False
    if reduce_op is None:
        later_groups = set(_group_order(later))
        merged_order = [g for g in _group_order(list(earlier) + list(later))
                        if g in later_groups]
        if merged_order != _group_order(later):
            return False
    return True


def _cost_of(plan: SuperstepPlan, machine: LPFMachine) -> float:
    return plan.cost.wire_bytes * machine.g + plan.cost.rounds * machine.l


def _can_overlap(earlier: Sequence[Msg], later: Sequence[Msg]) -> bool:
    """May ``later`` issue split-phase alongside ``earlier``?  The two
    supersteps must *commute*: no read of either may observe a write of
    the other (RAW in both directions — the split-phase lowering runs
    all reads before all writes, but commutation is what the reference
    interpreter validates and what keeps the members order-free), and no
    destination ranges may overlap (WAW — finish order would elect the
    winner).  Note this is weaker than :func:`_independent`: the tables
    are never concatenated, so each member keeps its own attributes,
    plan and internal CRCW arbitration order."""
    for m2 in later:
        for m1 in earlier:
            if _msgs_conflict(m1, m2):
                return False
    return True


def _tables_conflict(ta: Sequence[Msg], tb: Sequence[Msg]) -> bool:
    """Must-precede over rewritten tables (post coalesce/DTE): same
    relation as :func:`_must_precede`, on message lists."""
    for ma in ta:
        for mb in tb:
            if _msgs_conflict(ma, mb):
                return True
    return False


def _conflict_dag(tables: Sequence[Sequence[Msg]]) -> List[set]:
    """``preds[j] = {i < j : tables[i] must precede tables[j]}`` — the
    single must-precede DAG builder shared by :func:`canonical_order`
    and the scheduler passes, with a cheap (pid, slot) footprint
    prefilter: two steps can only conflict when a write footprint meets
    the other's read or write footprint, so the O(m_a*m_b) interval
    scan runs only on overlapping footprints."""
    n = len(tables)
    reads = [{(m.src, m.src_slot.sid) for m in t} for t in tables]
    writes = [{(m.dst, m.dst_slot.sid) for m in t} for t in tables]
    preds: List[set] = [set() for _ in range(n)]
    for i in range(n):
        for j in range(i + 1, n):
            if ((writes[i] & reads[j]) or (writes[j] & reads[i])
                    or (writes[i] & writes[j])) \
                    and _tables_conflict(tables[i], tables[j]):
                preds[j].add(i)
    return preds


def _merge_reads_ok(earlier: Sequence[Msg], later: Sequence[Msg]) -> bool:
    """No message of ``later`` reads a range ``earlier`` writes — the
    RAW half of merge legality (merged reads observe pre-superstep
    state; WAR is legal in a merge, WAW is checked by the caller via
    :func:`repro_torch.core.sync.conflict_free` for method rewrites)."""
    for m2 in later:
        for m1 in earlier:
            if _reads_write(m2, m1):
                return False
    return True


@dataclasses.dataclass
class _Group:
    """Scheduler working state for one output superstep."""

    msgs: List[Msg]
    attrs: SyncAttributes
    label: str
    members: List[int]          # canonical ranks merged into this step
    plan: SuperstepPlan
    rewrite: str = ""


def optimize_program(steps: Sequence[ProgramStep], p: int,
                     machine: LPFMachine,
                     plan_cache: Optional[PlanCache] = None,
                     scratch: Optional[Slot] = None,
                     search: bool = True,
                     order: Optional[Sequence[int]] = None
                     ) -> SuperstepProgram:
    """Rewrite one recorded trace: coalesce, eliminate dead transfers,
    then run the cost-gated DAG list-scheduling search — non-adjacent
    superstep batching, Valiant-aware attr rewrites, non-adjacent
    split-phase overlap grouping — and plan every surviving superstep.
    Pure Python — no tensor ops.

    ``search=False`` keeps the trace in recorded order and restores the
    adjacent-pairs peephole (the pre-search optimizer), as the baseline
    the schedule benchmarks measure against.  ``order`` is an optional
    precomputed :func:`canonical_order` (the caller may share one with
    :func:`program_signature`)."""
    plan = (plan_cache.get_or_plan if plan_cache is not None
            else lambda m, p_, a, s=None: plan_sync(m, p_, a, s))

    def plan_of(msgs: List[Msg], attrs: SyncAttributes) -> SuperstepPlan:
        return plan(msgs, p, attrs, scratch)

    if not search:
        order = list(range(len(steps)))
    elif order is None:
        order = canonical_order(steps)
    steps = [steps[i] for i in order]

    tables = [list(st.msgs) for st in steps]
    attrs_list = [st.attrs for st in steps]
    labels = [st.label for st in steps]
    modified = [False] * len(tables)

    # (1) coalesce within each superstep, gated on the planned cost
    n_coalesced = 0
    for i in range(len(tables)):
        cand, n = _coalesce_step(tables[i], attrs_list[i])
        if n == 0:
            continue
        if _cost_of(plan_of(cand, attrs_list[i]), machine) <= \
                _cost_of(plan_of(tables[i], attrs_list[i]), machine):
            tables[i] = cand
            modified[i] = True
            n_coalesced += n

    # (2) dead-transfer elimination across supersteps, gated per step —
    # removing a message can demote a fused classification (a total
    # exchange minus one message is coloured rounds), so a rewrite only
    # lands when the planned cost does not regress
    n_eliminated = 0
    for i in range(len(tables)):
        dead = _dead_msgs(tables, attrs_list, i)
        if not dead:
            continue
        # removing a group's first message can reorder the cross-group
        # CRCW application order; admit kills one by one, keeping the
        # surviving groups' relative order intact
        kill: List[int] = []
        for k in dead:
            trial = set(kill) | {k}
            cand = [m for idx, m in enumerate(tables[i])
                    if idx not in trial]
            surviving = {(m.src_slot.sid, m.dst_slot.sid) for m in cand}
            old_order = [g for g in _group_order(tables[i])
                         if g in surviving]
            if attrs_list[i].reduce_op is not None or \
                    _group_order(cand) == old_order:
                kill.append(k)
        if not kill:
            continue
        cand = [m for idx, m in enumerate(tables[i])
                if idx not in set(kill)]
        if _cost_of(plan_of(cand, attrs_list[i]), machine) <= \
                _cost_of(plan_of(tables[i], attrs_list[i]), machine):
            tables[i] = cand
            modified[i] = True
            n_eliminated += len(kill)

    n = len(tables)
    n_hoisted = 0
    n_rewritten = 0

    def merged_plan_or_none(cand: List[Msg], attrs: SyncAttributes
                            ) -> Optional[SuperstepPlan]:
        try:
            return plan_of(cand, attrs)
        except LPFFatalError:       # e.g. bruck multigraph limits,
            return None             # valiant scratch overflow

    def valiant_eligible(attrs: SyncAttributes) -> bool:
        # a method rewrite must not change CRCW winners or combine
        # semantics, and needs the context's scratch slot provisioned
        return (scratch is not None and attrs.reduce_op is None
                and attrs.compress is None
                and attrs.method in ("auto", "direct"))

    def valiant_attrs(a: SyncAttributes,
                      b: Optional[SyncAttributes] = None) -> SyncAttributes:
        no_conf = a.no_conflict and (b is None or b.no_conflict)
        return a.replace(method="valiant", no_conflict=no_conf)

    # the rewritten tables are fixed from here on: plan each once (the
    # growth loop re-scans candidates, and must not re-consult the
    # planner per scan)
    step_plans = [plan_of(tables[i], attrs_list[i]) for i in range(n)]
    # the in-order baseline explain() reports against: untouched steps
    # reuse their step plan, only coalesced/DTE'd ones re-plan raw msgs
    in_order_costs = tuple(
        (step_plans[i] if not modified[i]
         else plan_of(list(steps[i].msgs), attrs_list[i])).cost
        for i in range(n))

    def try_merge(g: _Group, j: int) -> bool:
        """Attempt to fold canonical rank ``j`` into group ``g``; both
        the equal-attrs merge and the Valiant-aware rewrite are gated on
        the planned cost of the merged table strictly beating the best
        alternative schedule of the members — separate supersteps, or
        (when both commute and are overlappable) a split-phase overlap
        group, which the later overlap pass could otherwise form."""
        msgs_j, attrs_j = tables[j], attrs_list[j]
        if not g.msgs or not msgs_j:
            return False
        plan_j = step_plans[j]
        sep = _cost_of(g.plan, machine) + _cost_of(plan_j, machine)
        if g.plan.method in OVERLAPPABLE_METHODS \
                and plan_j.method in OVERLAPPABLE_METHODS \
                and _can_overlap(g.msgs, msgs_j):
            sep = min(sep, overlap_cost(
                [g.plan.cost, plan_j.cost]).predicted_seconds(machine))
        if not g.rewrite and attrs_j == g.attrs and \
                _independent(g.msgs, msgs_j, g.attrs.reduce_op):
            cand = g.msgs + msgs_j
            mp = merged_plan_or_none(cand, g.attrs)
            if mp is not None and _cost_of(mp, machine) < sep:
                g.msgs, g.plan = cand, mp
                return True
        # Valiant-aware rewrite: the merge gate refused (differing
        # attrs, or the merged plan priced higher).  For plain
        # conflict-free CRCW traffic whose separate schedules are
        # round-heavy (skewed/fragmented), price the merged fat
        # superstep routed through two-phase Valiant instead; a method
        # rewrite is only admissible when arbitration order cannot be
        # observed (conflict_free) and no member reads another's writes.
        if valiant_eligible(g.attrs) and valiant_eligible(attrs_j) \
                and g.plan.cost.rounds + plan_j.cost.rounds \
                >= VALIANT_REWRITE_MIN_ROUNDS \
                and _merge_reads_ok(g.msgs, msgs_j):
            cand = g.msgs + msgs_j
            if conflict_free(cand):
                vattrs = valiant_attrs(g.attrs, attrs_j)
                vp = merged_plan_or_none(cand, vattrs)
                if vp is not None and _cost_of(vp, machine) < sep:
                    g.msgs, g.attrs, g.plan = cand, vattrs, vp
                    g.rewrite = "valiant"
                    return True
        return False

    def maybe_valiant_upgrade(g: _Group) -> None:
        """A skewed/fragmented fat superstep on its own: rewrite its
        attrs to route it two-phase iff strictly cheaper."""
        if g.rewrite or not valiant_eligible(g.attrs) \
                or g.plan.cost.rounds < VALIANT_REWRITE_MIN_ROUNDS \
                or not conflict_free(g.msgs):
            return
        vp = merged_plan_or_none(g.msgs, valiant_attrs(g.attrs))
        if vp is not None and _cost_of(vp, machine) < \
                _cost_of(g.plan, machine):
            g.attrs, g.plan, g.rewrite = valiant_attrs(g.attrs), vp, \
                "valiant"

    # (3) superstep batching as DAG list scheduling: walk the
    # must-precede DAG over the rewritten tables; each emitted superstep
    # greedily absorbs ANY still-unscheduled step whose predecessors are
    # already placed — non-adjacent independent supersteps hoist over
    # intervening steps — with every fold cost-gated, and refused folds
    # offered to the Valiant-aware rewrite.
    groups: List[_Group] = []
    if search:
        preds = _conflict_dag(tables)
        scheduled: set = set()
        remaining = list(range(n))
        while remaining:
            first = next(k for k in remaining if preds[k] <= scheduled)
            g = _Group(msgs=tables[first], attrs=attrs_list[first],
                       label=labels[first], members=[first],
                       plan=step_plans[first])
            grew = True
            while grew:
                grew = False
                mset = set(g.members)
                for j in remaining:
                    if j in mset or not (preds[j] <= scheduled | mset):
                        continue
                    if try_merge(g, j):
                        # a hoist is non-adjacency in the RECORDED
                        # order (canonicalization may already have
                        # moved steps next to each other)
                        if order[j] != order[g.members[-1]] + 1:
                            n_hoisted += 1
                        g.members.append(j)
                        g.label = f"{g.label}+{labels[j]}"
                        mset.add(j)
                        grew = True
            maybe_valiant_upgrade(g)
            if g.rewrite:
                n_rewritten += 1
            groups.append(g)
            scheduled |= set(g.members)
            member_set = set(g.members)
            remaining = [k for k in remaining if k not in member_set]
    else:
        # the adjacent-pairs peephole (pre-search baseline)
        for i, (msgs, attrs, label) in enumerate(zip(tables, attrs_list,
                                                     labels)):
            if groups:
                g = groups[-1]
                if (g.msgs and msgs and attrs == g.attrs
                        and _independent(g.msgs, msgs, attrs.reduce_op)):
                    cand = g.msgs + msgs
                    mp = merged_plan_or_none(cand, attrs)
                    if mp is not None and _cost_of(mp, machine) < \
                            _cost_of(g.plan, machine) + \
                            _cost_of(step_plans[i], machine):
                        g.msgs, g.plan = cand, mp
                        g.label = f"{g.label}+{label}"
                        g.members.append(i)
                        continue
            groups.append(_Group(msgs=msgs, attrs=attrs, label=label,
                                 members=[i], plan=step_plans[i]))
    n_merged = len(tables) - len(groups)

    # (4) overlap grouping as DAG list scheduling: supersteps the merge
    # gate kept separate (differing attrs, or a merged plan the model
    # prices higher) are issued split-phase — all starts, then all
    # dones — priced max(h_i)*g + max(rounds_i)*l + (k-1)*l_overlap.
    # The search hoists any READY superstep (all predecessors emitted)
    # into the group, non-adjacent or not; a group only grows while the
    # overlapped time is predicted below the sequential sum.
    m = len(groups)
    ogroups: List[List[int]] = []
    if search:
        gpreds = _conflict_dag([g.msgs for g in groups])
        emitted: set = set()
        gremaining = list(range(m))
        while gremaining:
            i = next(k for k in gremaining if gpreds[k] <= emitted)
            grp = [i]
            if groups[i].plan.method in OVERLAPPABLE_METHODS:
                for j in gremaining:
                    if j == i or j in grp:
                        continue
                    if groups[j].plan.method not in OVERLAPPABLE_METHODS:
                        continue
                    # a member of grp is not yet emitted: j must not
                    # depend on one (its start would read stale state)
                    if not (gpreds[j] <= emitted):
                        continue
                    if not all(_can_overlap(groups[k].msgs,
                                            groups[j].msgs) for k in grp):
                        continue
                    costs = [groups[k].plan.cost for k in grp] \
                        + [groups[j].plan.cost]
                    if overlap_cost(costs).predicted_seconds(machine) < \
                            sum(c.predicted_seconds(machine)
                                for c in costs):
                        # recorded-order adjacency, as in the merge pass
                        if min(order[r] for r in groups[j].members) != \
                                max(order[r] for r in
                                    groups[grp[-1]].members) + 1:
                            n_hoisted += 1
                        grp.append(j)
            ogroups.append(grp)
            emitted |= set(grp)
            grp_set = set(grp)
            gremaining = [k for k in gremaining if k not in grp_set]
    else:
        for j in range(m):
            if ogroups and groups[j].plan.method in OVERLAPPABLE_METHODS:
                cur = ogroups[-1]
                members_ok = all(
                    groups[i].plan.method in OVERLAPPABLE_METHODS
                    and _can_overlap(groups[i].msgs, groups[j].msgs)
                    for i in cur)
                if members_ok:
                    seq = sum(groups[i].plan.cost.predicted_seconds(
                        machine) for i in cur) \
                        + groups[j].plan.cost.predicted_seconds(machine)
                    grouped = overlap_cost(
                        [groups[i].plan.cost for i in cur]
                        + [groups[j].plan.cost]).predicted_seconds(machine)
                    if grouped < seq:
                        cur.append(j)
                        continue
            ogroups.append([j])
    n_overlapped = len(groups) - len(ogroups)

    # emit in the scheduled order: the overlap pass's emission sequence
    # is the program's execution order; overlap_groups become ranges of
    # consecutive output positions
    perm = [i for grp in ogroups for i in grp]
    out_ogroups: List[Tuple[int, ...]] = []
    pos = 0
    for grp in ogroups:
        out_ogroups.append(tuple(range(pos, pos + len(grp))))
        pos += len(grp)

    _, _, canon_key = _slot_canon()
    # canonical indices must follow the (canonically ordered) trace's
    # first-occurrence order — what trace_slot_map of a replayed trace
    # reproduces — not the optimized tables' (an eliminated or hoisted
    # first occurrence would skew them)
    for st in steps:
        for msg in st.msgs:
            canon_key(msg.src_slot)
            canon_key(msg.dst_slot)

    opt_steps = []
    for gi in perm:
        g = groups[gi]
        table = tuple((msg.src, msg.dst, canon_key(msg.src_slot),
                       msg.src_off, canon_key(msg.dst_slot), msg.dst_off,
                       msg.size, msg.origin)
                      for msg in g.msgs)
        opt_steps.append(OptimizedStep(
            table=table, attrs=g.attrs, label=g.label,
            plan=g.plan, merged_from=tuple(g.members),
            unchanged=(len(g.members) == 1 and not modified[g.members[0]]
                       and not g.rewrite),
            rewrite=g.rewrite))
    return SuperstepProgram(
        p=p, steps=tuple(opt_steps), n_recorded=len(steps),
        n_coalesced=n_coalesced, n_eliminated=n_eliminated,
        n_merged=n_merged,
        overlap_groups=tuple(out_ogroups),
        n_overlapped=n_overlapped, n_rewritten=n_rewritten,
        n_hoisted=n_hoisted, in_order_costs=in_order_costs,
        canonical=search)


# ==========================================================================
# compiled replay
# ==========================================================================

#: calls the compiled program times each way before it chooses
TRIAL_CALLS = 2


@dataclasses.dataclass
class CompiledProgram:
    """An optimized program bound to canonical slots on one device.

    Dispatched replay rebinds every superstep's messages to the trace's
    slots and lowers it from Python on every flush.  A compiled program
    builds the schedule once over *canonical* slots (slot id == canonical
    index, the scratch slot id -1) and runs it against a
    :class:`~repro_torch.core.sync.ValueStore`:

    * on a CUDA device it times the schedule run eagerly against its
      replay as one ``torch.cuda.CUDAGraph`` and keeps the faster.  The
      first call runs it eagerly, which learns which canonical slots it
      reads before writing them (:attr:`reads`) and which it writes
      (:attr:`writes`) and builds the executors' index tensors on the
      device; the next :data:`TRIAL_CALLS` run it eagerly and are timed
      (:attr:`eager_s`); the next captures the schedule over input
      buffers of the ``reads`` slots and replays it; the next
      :data:`TRIAL_CALLS` replay it and are timed (:attr:`replay_s`).
      Then :attr:`use_graph` says which was faster, and every later call
      goes that way; a graph that lost is dropped with its memory pool,
      and a context then runs the dispatched schedule instead.
      A replay copies the ``reads`` values into the input buffers and
      clones the ``writes`` values out of the graph's memory pool, which
      the next replay overwrites — :attr:`copy_bytes` a call, the price
      of keeping every value the caller holds unchanged; it pays where
      launching the schedule from Python costs more (many rounds, small
      messages).  A timed call synchronizes the device before and after.
      In the graph an overlap group's start halves run on the device's
      side streams (:func:`~repro_torch.core.sync.fork_streams`: the
      capture records the fork and the join as parallel branches), and
      eagerly on the current stream, so the trial times the streamed
      graph against the one-stream dispatch;
    * on the CPU it is the plain version: every call runs the schedule
      over a ``ValueStore`` and nothing is captured or timed.

    Validity is anchored to the program signature: the canonical tables
    name slots by canonical index and the signature pins every index's
    (size, dtype, kind) and the scratch's, so any trace that maps to the
    cache key can run through this program.  The ledger is not produced
    here: callers append :meth:`SuperstepProgram.ledger_costs`, identical
    to what dispatched execution returns."""

    prog: SuperstepProgram
    slots: Tuple[Slot, ...]          # canonical slots, sid == index
    scratch: Optional[Slot]          # canonical scratch (valiant), or None
    device: torch.device
    entries: List[Tuple[List[Msg], SyncAttributes, str, SuperstepPlan]] = \
        dataclasses.field(repr=False, default_factory=list)
    n_calls: int = 0
    n_replays: int = 0
    #: canonical sids whose entry value the schedule reads / that it writes
    reads: Tuple[int, ...] = ()
    writes: Tuple[int, ...] = ()
    #: bytes a replay copies into the graph's inputs and out of its pool
    copy_bytes: int = 0
    #: host seconds of the timed eager calls and graph replays
    eager_s: List[float] = dataclasses.field(default_factory=list)
    replay_s: List[float] = dataclasses.field(default_factory=list)
    #: None until the timed calls choose; then whether calls replay
    use_graph: Optional[bool] = None
    graph: Any = dataclasses.field(repr=False, default=None)
    _inputs: Dict[int, torch.Tensor] = dataclasses.field(
        repr=False, default_factory=dict)
    _outputs: Dict[int, torch.Tensor] = dataclasses.field(
        repr=False, default_factory=dict)
    #: the index tensors the graph reads (sync.keep_indices): the memo is
    #: an LRU, and a graph holds no reference to them
    _indices: Dict[Tuple, torch.Tensor] = dataclasses.field(
        repr=False, default_factory=dict)

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def __call__(self, values: Sequence[torch.Tensor],
                 scratch_val: Optional[torch.Tensor] = None
                 ) -> Dict[int, torch.Tensor]:
        """Run the schedule on ``values`` (one ``[p, size]`` tensor per
        canonical slot, in canonical order) and the scratch value; returns
        ``{canonical sid: new value}`` for every slot it wrote (sid -1:
        the scratch).  No input tensor is written."""
        self.n_calls += 1
        vals = dict(enumerate(values))
        if self.scratch is not None:
            vals[self.scratch.sid] = scratch_val
        if self.device.type != "cuda" or self.use_graph is False:
            return self._run(vals)
        if self.n_calls == 1:
            with keep_indices(self._indices):
                return self._run(vals)
        if len(self.eager_s) < TRIAL_CALLS:
            return self._timed(self._run, vals, self.eager_s)
        if self.graph is None:
            self._capture(vals)
            return self._replay(vals)   # its first launch uploads the graph
        if self.use_graph is None:
            out = self._timed(self._replay, vals, self.replay_s)
            if len(self.replay_s) == TRIAL_CALLS:
                self.use_graph = min(self.replay_s) < min(self.eager_s)
                if not self.use_graph:
                    self.graph, self._inputs, self._outputs = None, {}, {}
                    self._indices = {}
            return out
        return self._replay(vals)

    def _run(self, vals: Dict[int, torch.Tensor]) -> Dict[int, torch.Tensor]:
        store = ValueStore(vals, self.prog.p)
        execute_schedule(self.entries, self.prog.groups(), store,
                         scratch=self.scratch)
        if self.n_calls == 1:
            self.reads = tuple(sorted(store.read_first))
            self.writes = tuple(sorted(store.written))
        return {sid: store.value(self._slot(sid)) for sid in self.writes}

    def _replay(self, vals: Dict[int, torch.Tensor]
                ) -> Dict[int, torch.Tensor]:
        for sid, buf in self._inputs.items():
            buf.copy_(vals[sid])
        self.graph.replay()
        self.n_replays += 1
        return {sid: out.clone() for sid, out in self._outputs.items()}

    def _timed(self, fn: Callable, vals: Dict[int, torch.Tensor],
               sink: List[float]) -> Dict[int, torch.Tensor]:
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        out = fn(vals)
        torch.cuda.synchronize(self.device)
        sink.append(time.perf_counter() - t0)
        return out

    def _slot(self, sid: int) -> Slot:
        return self.scratch if sid < 0 else self.slots[sid]

    def _capture(self, vals: Dict[int, torch.Tensor]) -> None:
        self._inputs = {sid: vals[sid].clone() for sid in self.reads}
        graph = torch.cuda.CUDAGraph()
        with keep_indices(self._indices), torch.cuda.graph(graph):
            store = ValueStore(self._inputs, self.prog.p)
            execute_schedule(self.entries, self.prog.groups(), store,
                             scratch=self.scratch)
            outputs = {sid: store.value(self._slot(sid))
                       for sid in self.writes}
        if tuple(sorted(store.written)) != self.writes:
            raise RuntimeError("the captured schedule wrote other slots "
                               "than its eager run")
        self.graph, self._outputs = graph, outputs
        self.copy_bytes = sum(
            t.numel() * t.element_size()
            for t in list(self._inputs.values()) + list(outputs.values()))


def compile_program(prog: SuperstepProgram, steps: Sequence[ProgramStep],
                    order: Sequence[int], p: int, device,
                    scratch: Optional[Slot] = None) -> CompiledProgram:
    """Bind ``prog`` to canonical slots as a :class:`CompiledProgram` for
    ``device`` (a CUDA graph on the card, the plain version on the CPU).

    ``steps``/``order`` are any trace/canonical-order pair matching the
    program's signature — only their slot *descriptors* are consulted (to
    synthesize the canonical slot list), so the compiled program serves
    every trace that hits the same cache entry."""
    # fault seam: an armed plan may stand in for a capture failure here;
    # callers degrade to the dispatched schedule
    _fp.fire("compile", label=getattr(prog, "label", ""))

    actual = trace_slot_map(steps, order)
    slots = tuple(Slot(i, f"__prog_slot{i}", s.size, s.dtype, s.kind,
                       (s.size,))
                  for i, s in enumerate(actual))
    # valiant phase-1 bounces through the scratch slot; sid -1 cannot
    # collide with a canonical index
    need_scratch = any(st.plan.method == "valiant" for st in prog.steps)
    if need_scratch and scratch is None:
        raise LPFFatalError("program contains valiant supersteps but the "
                            "context has no scratch slot")
    cscratch = Slot(-1, "__prog_scratch", scratch.size, scratch.dtype,
                    "global", (scratch.size,)) if need_scratch else None

    entries = []
    for st in prog.steps:
        # rebuild from the canonical table unconditionally (an
        # ``unchanged`` step's table IS its staged messages modulo the
        # slot renaming, and the compiled schedule speaks canonical sids)
        msgs = [Msg(src, dst, slots[si], so, slots[di], do, sz,
                    origin=origin)
                for (src, dst, si, so, di, do, sz, origin) in st.table]
        entries.append((msgs, st.attrs, st.label, st.plan))
    return CompiledProgram(prog=prog, slots=slots, scratch=cscratch,
                           device=torch.device(device), entries=entries)


# ==========================================================================
# the program cache
# ==========================================================================

class ProgramCache:
    """LRU memo of :class:`SuperstepProgram` keyed by
    :func:`program_signature` and the machine's (g, l) — the
    program-level twin of :class:`repro_torch.core.sync.PlanCache`.  A
    replayed trace skips the optimizer *and* the planner (every optimized
    step carries its plan).  Each entry may carry its schedule-verifier
    certificate (:meth:`certify`) and, per device, its compiled form
    (:meth:`set_compiled`, only for certified entries).

    With a persistent store attached (:meth:`attach_store`, or
    ``LPFContext(persist_dir=...)`` / ``LPF_PROGRAM_CACHE_DIR``),
    certified entries are written back to disk (on certification, on
    eviction, and on :meth:`flush`) and an in-memory miss consults the
    disk before paying the schedule search.  A loaded entry is
    **re-verified** against the actual recorded trace
    (``verify_program``) before it is served — corruption, version skew,
    or a stale schedule degrades to a cold miss (counted in
    ``stats.invalidated``), never an unverified execution."""

    #: bounded-backoff retry budget for one persistent-store operation
    #: (transient I/O only; corruption is never retried)
    DISK_RETRIES = 2
    DISK_BACKOFF = 0.01      # seconds, doubled per retry
    #: consecutive failed store *operations* after which the cache
    #: degrades to memory-only mode (detaches the store) — a dead disk
    #: must not tax every miss with a retry loop
    DISK_STRIKE_LIMIT = 3

    def __init__(self, maxsize: int = 256,
                 persist_dir: Optional[str] = None):
        self.maxsize = maxsize
        self._programs: "collections.OrderedDict[Hashable, SuperstepProgram]" \
            = collections.OrderedDict()
        #: program key -> {device: CompiledProgram}; a compiled artifact
        #: is only valid alongside its program entry, so eviction drops
        #: both (LRU coherence)
        self._compiled: Dict[Hashable, Dict[str, CompiledProgram]] = {}
        #: program key -> schedule-verifier certificate
        #: (:class:`repro_torch.analysis.VerifierReport`); ``set_compiled``
        #: refuses keys without a passing one
        self._certs: Dict[Hashable, Any] = {}
        self.stats = CacheStats()
        #: recorded-order signature -> (canonical order, signature)
        #: (:meth:`canonicalize`)
        self._canon: "collections.OrderedDict[Hashable, Tuple]" = \
            collections.OrderedDict()
        #: (key, device) pairs whose compilation or replay failed: later
        #: flushes go straight to the dispatched path
        self._quarantined: Dict[Hashable, set] = {}
        #: the exception that quarantined each (key, device)
        self.compile_errors: Dict[Tuple[Hashable, str], BaseException] = {}
        #: keys exempt from LRU eviction (:meth:`pin`); ``maxsize`` bounds
        #: the *unpinned* population, and pins are never silently dropped
        self._pinned: set = set()
        self._store = None
        #: keys known to be on disk already (avoids rewriting an entry on
        #: every certify/evict of the same program)
        self._persisted: set = set()
        #: entry filenames that failed decode/re-verification AND could
        #: not be removed (read-only cache dir): poisoned in memory so a
        #: corrupt-but-undeletable file costs ONE decode + verify, not
        #: one per miss
        self._poisoned: set = set()
        self._disk_strikes = 0
        #: why the cache went memory-only, or None while the store is
        #: attached (or was never attached)
        self.memory_only_reason: Optional[str] = None
        if persist_dir:
            self.attach_store(persist_dir)

    def __len__(self) -> int:
        return len(self._programs)

    @property
    def store(self):
        """The attached :class:`repro_torch.core.persist.PersistentStore`,
        or ``None`` when the cache is memory-only."""
        return self._store

    def attach_store(self, directory: str):
        """Attach (or switch) the persistent store.  The directory is
        indexed immediately — the warm-load; entries deserialize and
        re-verify lazily, each on the first trace that maps to its
        signature (verification needs the recorded steps).

        Best-effort: an unusable directory (permissions, full disk) leaves
        the cache memory-only — a broken cache dir must never take down
        the context that merely mentioned it."""
        from .persist import PersistentStore
        if self._store is not None and \
                self._store.directory == str(directory):
            return self._store
        try:
            self._store = PersistentStore(directory)
        except OSError as e:
            self.stats.disk_errors += 1
            self._store = None
            self.memory_only_reason = f"attach failed: {e}"
            return None
        self._persisted = set()
        self._poisoned = set()
        self._disk_strikes = 0
        self.memory_only_reason = None
        return self._store

    # -- disk degradation ladder ----------------------------------------
    def _disk_op(self, fn):
        """Run one persistent-store operation with bounded-backoff
        retries.  Returns ``(ok, result)``; after the budget is spent the
        failure is counted (``stats.disk_errors``) and — past
        ``DISK_STRIKE_LIMIT`` consecutive failures — the store is
        detached (memory-only mode).  I/O failures cost the warm start,
        never the execution."""
        delay = self.DISK_BACKOFF
        for attempt in range(self.DISK_RETRIES + 1):
            try:
                out = fn()
            except OSError as e:
                if attempt == self.DISK_RETRIES:
                    self.stats.disk_errors += 1
                    self._disk_strikes += 1
                    if self._disk_strikes >= self.DISK_STRIKE_LIMIT:
                        self._store = None
                        self.memory_only_reason = \
                            f"{self._disk_strikes} consecutive I/O " \
                            f"failures, last: {e}"
                    return False, None
                time.sleep(delay)
                delay *= 2
            else:
                self._disk_strikes = 0
                return True, out
        return False, None     # pragma: no cover - loop always returns

    def clear(self) -> None:
        """Drop the in-memory state (programs, artifacts, certificates,
        pins, quarantines, counters).  On-disk entries are untouched — a
        cleared cache warm-starts from its store, which is the point of
        having one."""
        self._programs.clear()
        self._compiled.clear()
        self._certs.clear()
        self._canon.clear()
        self._quarantined = {}
        self.compile_errors = {}
        self._pinned = set()
        self._persisted = set()
        self._poisoned = set()
        self._disk_strikes = 0
        self.stats = CacheStats()

    def _write_back(self, key: Hashable, prog: SuperstepProgram,
                    cert) -> None:
        """Best-effort persist of one certified entry (shared by
        certify-time write-back and eviction write-back): retried with
        bounded backoff on I/O failure, counted in ``stats.disk_errors``,
        degrading to memory-only mode past the strike limit — a cache
        must never take down the program it accelerates."""
        if self._store is None:
            return
        from .persist import PersistError
        store = self._store

        def op():
            try:
                return store.save(key, prog, cert)
            except PersistError:
                return None      # encoding refusal: final, not retried
        ok, path = self._disk_op(op)
        if ok and path is not None:
            self._persisted.add(key)
            # a fresh good entry supersedes any poison on its filename
            self._poisoned.discard(store.filename(key))

    def _maybe_persist(self, key: Hashable) -> None:
        """Write-back one entry if it is certified and not yet on disk.
        Persistence is strictly best-effort: an I/O or encoding failure
        costs the warm start, never the execution."""
        if self._store is None or key in self._persisted:
            return
        prog = self._programs.get(key)
        cert = self._certs.get(key)
        if prog is None or cert is None or not cert.ok:
            return
        self._write_back(key, prog, cert)

    def compiled(self, key: Hashable,
                 device) -> Optional[CompiledProgram]:
        """The compiled form of the cached program under ``key`` for a
        device, if one has been built."""
        return self._compiled.get(key, {}).get(str(device))

    def set_compiled(self, key: Hashable, device,
                     cp: CompiledProgram) -> None:
        if key not in self._programs:
            raise LPFFatalError(
                "set_compiled for a key with no cached program")
        cert = self._certs.get(key)
        if cert is None:
            raise LPFAnalysisError(
                "set_compiled for an uncertified program: call "
                "ProgramCache.certify(key, steps) first — compiled "
                "artifacts are only cached for verified schedules")
        if not cert.ok:
            raise LPFAnalysisError(
                "set_compiled for a program whose schedule failed "
                f"verification: {cert.summary()}")
        self._compiled.setdefault(key, {})[str(device)] = cp

    def certify(self, key: Hashable, steps: Sequence[ProgramStep],
                prog: Optional[SuperstepProgram] = None,
                scratch: Optional[Slot] = None,
                order: Optional[Sequence[int]] = None):
        """Run the schedule verifier on the cached program under ``key``
        against its recorded trace and memoize the resulting
        :class:`repro_torch.analysis.VerifierReport`.  ``scratch``/
        ``order`` must match what :meth:`get_or_build_keyed` optimized
        with.  Idempotent per key; :meth:`set_compiled` requires a passing
        certificate."""
        cert = self._certs.get(key)
        if cert is not None:
            return cert
        if prog is None:
            prog = self._programs.get(key)
        if prog is None:
            raise LPFFatalError("certify for a key with no cached program")
        from ..analysis.verifier import verify_program
        cert = verify_program(steps, prog, scratch=scratch, order=order)
        self._certs[key] = cert
        object.__setattr__(prog, "_certificate", cert)
        # write-back on insert: certification is the earliest point an
        # entry is both optimized and proven, so it is the persist point
        self._maybe_persist(key)
        return cert

    def certificate(self, key: Hashable):
        """The memoized certificate for ``key``, or ``None`` if
        :meth:`certify` has not run."""
        return self._certs.get(key)

    def get_or_build(self, steps: Sequence[ProgramStep], p: int,
                     machine: LPFMachine,
                     plan_cache: Optional[PlanCache] = None,
                     scratch: Optional[Slot] = None,
                     order: Optional[Sequence[int]] = None
                     ) -> SuperstepProgram:
        return self.get_or_build_keyed(steps, p, machine, plan_cache,
                                       scratch, order)[0]

    def canonicalize(self, steps: Sequence[ProgramStep], p: int,
                     scratch: Optional[Slot] = None
                     ) -> Tuple[List[int], Hashable]:
        """``(canonical_order(steps), program_signature(...))``, memoized
        by the trace's *recorded-order* signature.  Both depend on slot
        identities only through equality, so two recordings with one
        recorded-order signature (the same program re-recorded through
        fresh slots, in the same order) share them.  The JAX package pays
        canonicalization once, when it traces; a flush here pays it every
        time, and on a trace of many content-identical steps (the
        bucketed trace's tie-breaks) it costs as much as the search."""
        raw = program_signature(steps, p, scratch, range(len(steps)))
        hit = self._canon.get(raw)
        if hit is not None:
            self._canon.move_to_end(raw)
            return list(hit[0]), hit[1]
        order = canonical_order(steps)
        sig = program_signature(steps, p, scratch, order)
        self._canon[raw] = (tuple(order), sig)
        if len(self._canon) > 4 * self.maxsize:
            self._canon.popitem(last=False)
        return order, sig

    def get_or_build_keyed(self, steps: Sequence[ProgramStep], p: int,
                           machine: LPFMachine,
                           plan_cache: Optional[PlanCache] = None,
                           scratch: Optional[Slot] = None,
                           order: Optional[Sequence[int]] = None,
                           signature: Optional[Hashable] = None
                           ) -> Tuple[SuperstepProgram, Hashable]:
        """Like :meth:`get_or_build` but also returns the cache key, the
        handle :meth:`compiled`/:meth:`set_compiled` attach the compiled
        artifact to.  Without ``order`` the trace is canonicalized
        through :meth:`canonicalize`; a caller that has canonicalized
        passes both ``order`` and its ``signature``."""
        # the machine's (g, l) keys the cache too: the cost gates price
        # rewrites with them, so contexts over different link classes
        # must not share optimization decisions
        if order is None:
            order, sig = self.canonicalize(steps, p, scratch)
        elif signature is None:
            sig = program_signature(steps, p, scratch, order)
        else:
            sig = signature
        key = (sig, machine.g, machine.l)
        prog = self._programs.get(key)
        if prog is not None:
            self.stats.hits += 1
            self._programs.move_to_end(key)
            return prog, key
        prog = self._load_persisted(key, steps, scratch, order)
        if prog is not None:
            return prog, key
        prog = optimize_program(steps, p, machine, plan_cache, scratch,
                                order=order)
        self.stats.misses += 1
        self._insert(key, prog)
        return prog, key

    def _load_persisted(self, key: Hashable,
                        steps: Sequence[ProgramStep],
                        scratch: Optional[Slot],
                        order: Sequence[int]
                        ) -> Optional[SuperstepProgram]:
        """The warm-start path: on an in-memory miss, try the attached
        store.  A loaded program is re-certified via ``verify_program``
        against the ACTUAL recorded trace before it is served — the
        persisted certificate is a record of what some process once
        proved, never a substitute for proving it here.  Any failure
        (integrity, version skew, key mismatch, failed re-verification)
        invalidates the entry and falls through to a cold build.

        Degradation: the poison set short-circuits entries that proved
        invalid but could not be removed (read-only cache dir); a
        transient I/O *error* (as opposed to corruption) is retried with
        backoff and then degrades to a cold miss WITHOUT invalidating —
        the entry on disk may be perfectly fine."""
        if self._store is None:
            return None
        store = self._store
        fname = store.filename(key)
        if fname is not None and fname in self._poisoned:
            self.stats.disk_misses += 1
            return None

        def op():
            status_, entry_ = store.load(key)
            if status_ == "error":
                # surface the transient classification to _disk_op so one
                # ladder owns retries, counting, and detachment
                raise OSError("transient I/O failure reading "
                              f"persisted entry {fname}")
            return status_, entry_
        ok, result = self._disk_op(op)
        if not ok:
            self.stats.disk_misses += 1
            return None
        status, entry = result
        if status == "miss":
            self.stats.disk_misses += 1
            return None
        if status == "invalid":
            self._drop_invalid(key, fname)
            return None
        prog, _stored_cert = entry
        from ..analysis.verifier import verify_program
        try:
            cert = verify_program(steps, prog, scratch=scratch,
                                  order=order)
        except Exception:
            cert = None
        if cert is None or not cert.ok:
            self._drop_invalid(key, fname)
            return None
        self.stats.disk_hits += 1
        self._insert(key, prog)
        self._certs[key] = cert
        object.__setattr__(prog, "_certificate", cert)
        self._persisted.add(key)
        return prog

    def _drop_invalid(self, key: Hashable, fname: Optional[str]) -> None:
        """An entry proved bad (corruption or failed re-verification):
        count it, remove it from disk, and — when removal fails (a
        read-only cache dir) — poison its filename in memory so the
        decode+verify cost is paid once, not per miss."""
        self.stats.invalidated += 1
        if self._store is not None and not self._store.invalidate(key) \
                and fname is not None:
            self._poisoned.add(fname)

    # -- pinned entries -------------------------------------------------
    def pin(self, key: Hashable) -> None:
        """Exempt ``key`` from LRU eviction (a serving loop's hot decode
        programs).  Pinning a key with no cached program is a fatal
        error (there is nothing to protect)."""
        if key not in self._programs:
            raise LPFFatalError("pin for a key with no cached program")
        self._pinned.add(key)

    def unpin(self, key: Hashable) -> None:
        """Return ``key`` to normal LRU eviction (idempotent)."""
        self._pinned.discard(key)

    @property
    def pinned(self) -> frozenset:
        """The keys currently exempt from eviction."""
        return frozenset(self._pinned)

    def keys(self) -> Tuple[Hashable, ...]:
        """The cached program keys, LRU-oldest first."""
        return tuple(self._programs.keys())

    def flush(self) -> int:
        """Best-effort write-back of every certified in-memory entry not
        yet on disk (the graceful-drain hook: a stopping server flushes so
        the next process warm-starts with the hot decode set).  Returns
        the number of entries newly persisted.  No-op without an attached
        store."""
        if self._store is None:
            return 0
        before = len(self._persisted)
        for key in list(self._programs):
            self._maybe_persist(key)
        return len(self._persisted) - before

    # -- compile quarantine ---------------------------------------------
    def quarantine_compile(self, key: Hashable, device,
                           err: Optional[BaseException] = None) -> None:
        """Record that compiling (or replaying) ``key`` on a device failed:
        later flushes take the dispatched ``execute_schedule`` path (same
        certified program, identical ledger) instead of failing again.
        Counted in ``stats.compile_fallbacks``; the exception is kept in
        :attr:`compile_errors`."""
        self._quarantined.setdefault(key, set()).add(str(device))
        self._compiled.get(key, {}).pop(str(device), None)
        if err is not None:
            self.compile_errors[(key, str(device))] = err
        self.stats.compile_fallbacks += 1

    def compile_quarantined(self, key: Hashable, device) -> bool:
        """Has compilation of ``key`` for this device been quarantined by
        a prior failure?"""
        return str(device) in self._quarantined.get(key, ())

    @property
    def quarantined(self) -> Dict[Hashable, frozenset]:
        """Every quarantined key and its devices."""
        return {k: frozenset(v) for k, v in self._quarantined.items()}

    def artifacts(self) -> List[CompiledProgram]:
        """Every compiled artifact the cache holds."""
        return [cp for per in self._compiled.values()
                for cp in per.values()]

    def _insert(self, key: Hashable, prog: SuperstepProgram) -> None:
        self._programs[key] = prog
        # maxsize bounds the UNPINNED population: eviction picks the
        # least-recently-used unpinned entry
        if len(self._programs) - len(self._pinned) <= self.maxsize:
            return
        evicted = next((k for k in self._programs
                        if k not in self._pinned), None)
        if evicted is None:      # pragma: no cover - all-pinned cache
            return
        eprog = self._programs.pop(evicted)
        cert = self._certs.pop(evicted, None)
        self._compiled.pop(evicted, None)
        self._quarantined.pop(evicted, None)
        self.stats.evictions += 1
        # write-back on evict: an entry leaving memory keeps its disk copy
        # (or gains one) so the next process — or the next cold lookup
        # here — warm-starts instead of re-searching
        if evicted not in self._persisted and cert is not None \
                and cert.ok:
            self._write_back(evicted, eprog, cert)


_GLOBAL_PROGRAM_CACHE = ProgramCache()


def global_program_cache() -> ProgramCache:
    """The process-wide program cache (shared across contexts)."""
    return _GLOBAL_PROGRAM_CACHE


# ==========================================================================
# numpy reference interpreter (the differential-test oracle)
# ==========================================================================

_NP_REDUCE = {"sum": np.add, "max": np.maximum, "min": np.minimum}


def simulate_program(step_tables: Sequence[Tuple[Sequence[Msg],
                                                 SyncAttributes]],
                     values: Dict[int, np.ndarray]) -> Dict[int, np.ndarray]:
    """Execute supersteps on host arrays under the p >= 2 LPF semantics.

    ``values`` maps slot sid -> ``[p, slot.size]`` array (one row per
    process).  Each superstep: all reads observe the pre-superstep
    state; writes apply per slot-pair group in first-occurrence order,
    within a group in ascending ``(src, dst, dst_off)`` — exactly the
    arbitration :func:`repro_torch.core.sync.plan_sync` encodes in its round
    structure.  ``reduce_op`` supersteps combine overlapping writes with
    first-write-replaces semantics.  Returns new arrays (inputs are not
    mutated).  Compression is not modelled (it is lossy by design)."""
    values = {sid: np.array(v) for sid, v in values.items()}
    for msgs, attrs in step_tables:
        if attrs.compress is not None:
            raise ValueError("simulate_program cannot model lossy "
                             "compressed supersteps")
        pre = {sid: v.copy() for sid, v in values.items()}
        reduce_fn = _NP_REDUCE[attrs.reduce_op] if attrs.reduce_op else None
        written: Dict[int, np.ndarray] = {}
        groups: "collections.OrderedDict[Tuple[int, int], List[Msg]]" = \
            collections.OrderedDict()
        for m in msgs:
            groups.setdefault((m.src_slot.sid, m.dst_slot.sid),
                              []).append(m)
        for group in groups.values():
            for m in sorted(group, key=lambda m_: (m_.src, m_.dst,
                                                   m_.dst_off)):
                chunk = pre[m.src_slot.sid][m.src,
                                            m.src_off:m.src_off + m.size]
                dst = values[m.dst_slot.sid]
                seg = (m.dst, slice(m.dst_off, m.dst_off + m.size))
                if reduce_fn is None:
                    dst[seg] = chunk
                else:
                    wr = written.setdefault(
                        m.dst_slot.sid,
                        np.zeros(dst.shape, bool))
                    dst[seg] = np.where(wr[seg],
                                        reduce_fn(dst[seg], chunk), chunk)
                    wr[seg] = True
    return values
