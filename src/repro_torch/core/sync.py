"""The superstep compiler — ``lpf_sync``'s four phases on a stacked store.

The paper implements ``lpf_sync`` in four phases: (1) barrier + meta-data
exchange, (2) write-conflict resolution, (3) data exchange, (4) barrier.
The communication pattern of a BSP superstep is known on the host before
any data moves, so phases (1)-(2) run in a planner, split into three
stages as in the JAX package:

* **plan** — :func:`plan_sync` analyses the staged message table, resolves
  write conflicts by deterministic arbitration (ascending source PID; the
  last writer — highest PID — wins), classifies fast paths, edge-colours
  the message multigraph, and predicts the superstep's
  :class:`SuperstepCost`.  The result is a :class:`SuperstepPlan` — a
  pure-Python IR with **no tensor ops**, identical plan-for-plan to the
  JAX package's planner.
* **cache** — :class:`PlanCache` memoises plans under a canonical
  signature of ``(p, attributes, message table)`` with slot ids renamed to
  first-occurrence indices.
* **execute** — :func:`begin_plan` lowers a :class:`SuperstepPlan`
  split-phase to row and column copies, rolls and reductions over the
  stacked ``[p, size]`` slot values of the ``p`` virtual processes
  (:mod:`repro_torch.core.memslot`): a start half that only reads and a
  finish closure that only writes.  :func:`execute_plan` runs both
  halves and returns the (already predicted) cost;
  :func:`execute_overlapped` runs an overlap group's starts before its
  finishes (in a CUDA-graph capture the starts on side streams of a
  small per-device pool, :func:`fork_streams`), and
  :func:`execute_schedule` issues a whole optimized program against a
  registry or a :class:`ValueStore`.

Every method the planner returns executes: ``noop``, ``seq`` (p == 1),
``direct`` (coloured rounds, the uniform-permutation fast path,
``reduce_op`` combines), ``bruck`` (log-p rounds, each a roll of row
sets along the stacked process axis), ``valiant`` (two ``direct`` phases
through the context's scratch slot), and the fused patterns ``fused``,
``fused_ag``, ``fused_rs``, ``fused_scatter`` and ``fused_gather``, each
one reshape, permute or reduction of the stacked ``[p, size]`` block.
``attrs.compress`` quantises float payloads to int8 on ``direct``,
``fused`` and ``fused_ag`` supersteps, as the JAX package does.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import os
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .attrs import SyncAttributes
from .cost import SuperstepCost, overlap_cost
from .errors import LPFFatalError
from .memslot import Slot, SlotRegistry, as_torch_dtype, dtype_name

__all__ = [
    "Msg", "RoundPlan", "SuperstepPlan", "PlanCache", "CacheStats",
    "plan_sync", "plan_signature", "execute_plan", "execute_sync",
    "plan_cost", "conflict_free", "find_conflict", "global_plan_cache",
    "EXECUTED_METHODS", "OVERLAPPABLE_METHODS", "begin_plan",
    "execute_overlapped", "execute_schedule", "ValueStore",
    "fork_streams", "on_stream",
]


@dataclasses.dataclass(frozen=True)
class Msg:
    """One staged one-sided transfer (a ``lpf_put``; ``lpf_get`` is staged
    as a put from the remote side — the table is globally known)."""

    src: int
    dst: int
    src_slot: Slot
    src_off: int
    dst_slot: Slot
    dst_off: int
    size: int
    #: which call staged this: "put" (src is the caller's own memory, may
    #: be local-registered), "get" (dst is the caller's own), or "table"
    #: (fully general: both ends remotely referred -> both global)
    origin: str = "table"

    def validate(self, p: int) -> None:
        if not (0 <= self.src < p and 0 <= self.dst < p):
            raise LPFFatalError(f"pid out of range in {self}")
        if self.size < 0:
            raise LPFFatalError(f"negative size in {self}")
        if self.src_off < 0 or self.src_off + self.size > self.src_slot.size:
            raise LPFFatalError(f"source range OOB in {self}")
        if self.dst_off < 0 or self.dst_off + self.size > self.dst_slot.size:
            raise LPFFatalError(f"destination range OOB in {self}")
        if self.src_slot.dtype != self.dst_slot.dtype:
            raise LPFFatalError(f"dtype mismatch in {self}")
        if self.src != self.dst:
            # the remotely-referred side must be collectively registered
            # (paper S2.1); the caller's own side may be register_local
            need_global = {"put": (self.dst_slot,),
                           "get": (self.src_slot,),
                           "table": (self.src_slot, self.dst_slot)}
            for slot in need_global[self.origin]:
                if slot.kind != "global":
                    raise LPFFatalError(
                        f"remotely-referred slot {slot} must be "
                        f"register_global ({self.origin} in {self})")


def _itemsize(dtype) -> int:
    return as_torch_dtype(dtype).itemsize


def _is_floating(dtype) -> bool:
    return as_torch_dtype(dtype).is_floating_point


#: elementwise combine functions for accumulating-put supersteps
_REDUCE_FNS = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}


# ==========================================================================
# Stage 1: PLAN — pure Python, no JAX ops
# ==========================================================================

@dataclasses.dataclass(frozen=True)
class RoundPlan:
    """One partial permutation of the ``direct`` method.

    ``msg_idx`` indexes into the message list the plan was built from (the
    superstep queue, or a Valiant phase list); per-PID offset tables are
    rebuilt from those messages at lowering time — only the *decisions*
    (membership, order, padding, fast-path) are cached."""

    msg_idx: Tuple[int, ...]
    size: int                        # padded payload (elements)
    static_src_off: Optional[int]    # uniform-round fast path, else None


@dataclasses.dataclass(frozen=True)
class SuperstepPlan:
    """The planned superstep: everything ``lpf_sync`` decides on the
    host, decoupled from slot identities and slot values.

    A plan built for one message table is valid for any table with the
    same :func:`plan_signature` — same ``p``, attributes, and per-message
    ``(src, dst, slot shape/dtype/kind pattern, offsets, size)`` with slot
    ids renamed by first occurrence."""

    #: noop | seq | direct | bruck | valiant | fused | fused_ag |
    #: fused_rs | fused_scatter | fused_gather
    method: str
    p: int
    n_msgs: int
    cost: SuperstepCost                                   # label == ""
    rounds: Tuple[RoundPlan, ...] = ()                    # direct
    seq_order: Tuple[int, ...] = ()                       # p == 1 memcpys
    fused_w: int = 0                                      # all fused methods
    ag_src_off: Tuple[int, ...] = ()                      # fused_ag, per pid
    ag_exclude_self: bool = False
    reduce_op: Optional[str] = None                       # accumulate mode
    rs_dst_off: Tuple[int, ...] = ()                      # fused_rs, per dst
    fused_root: int = -1                                  # scatter / gather
    sc_dst_off: Tuple[int, ...] = ()                      # fused_scatter
    sc_mask: Tuple[int, ...] = ()                         # fused_scatter
    g_src_off: Tuple[int, ...] = ()                       # fused_gather
    g_has_self: bool = False                              # fused_gather
    bruck_w: int = 0
    bruck_steps: Tuple[Tuple[int, Tuple[int, ...]], ...] = ()  # (step, rows)
    valiant_order: Tuple[int, ...] = ()                   # sorted msg indices
    valiant_via: Tuple[int, ...] = ()                     # intermediate pid
    valiant_off: Tuple[int, ...] = ()                     # scratch offset
    valiant_phase1: Tuple[RoundPlan, ...] = ()
    valiant_phase2: Tuple[RoundPlan, ...] = ()

    def cost_with_label(self, label: str) -> SuperstepCost:
        return dataclasses.replace(self.cost, label=label)


def _conflicts(a: Msg, b: Msg) -> bool:
    return (a.dst == b.dst and a.dst_slot.sid == b.dst_slot.sid
            and a.dst_off < b.dst_off + b.size
            and b.dst_off < a.dst_off + a.size)


def conflict_free(msgs: Sequence[Msg]) -> bool:
    """No two messages of the table write overlapping destination ranges.

    A conflict-free table's final state is independent of write
    arbitration order, which is the precondition for rewriting its
    execution *method*: ``direct`` arbitrates by ascending source pid
    while ``valiant`` phase 2 applies writes in intermediate-pid order,
    so the optimizer's Valiant-aware attr rewrite is only admissible on
    tables this predicate accepts (``reduce_op`` tables commute by
    construction but take no method rewrite — valiant cannot combine)."""
    return find_conflict(msgs) is None


def find_conflict(msgs: Sequence[Msg]) -> Optional[Tuple[Msg, Msg]]:
    """First pair of messages writing overlapping destination ranges,
    or ``None`` for a conflict-free table.  The witness pair is what the
    linter reports when a user-asserted ``no_conflict`` table races."""
    msgs = list(msgs)
    for i, a in enumerate(msgs):
        for b in msgs[i + 1:]:
            if _conflicts(a, b):
                return (a, b)
    return None


def _colour_rounds(idxs: Sequence[int], msgs: Sequence[Msg],
                   no_conflict: bool) -> List[List[int]]:
    """Greedy edge colouring preserving CRCW arbitration order.

    Messages are placed in ascending (src, dst, dst_off) order; a message
    that overlaps an earlier message's destination region must land in a
    strictly later round so that the higher-PID write is applied last.
    Returns rounds as lists of indices into ``msgs``.
    """
    order = sorted(idxs, key=lambda i: (msgs[i].src, msgs[i].dst,
                                        msgs[i].dst_off))
    rounds: List[List[int]] = []
    send_busy: List[set] = []
    recv_busy: List[set] = []
    placed: List[Tuple[int, int]] = []
    for i in order:
        m = msgs[i]
        floor = 0
        if not no_conflict:
            for prev, r in placed:
                if _conflicts(msgs[prev], m):
                    floor = max(floor, r + 1)
        r = floor
        while True:
            while r >= len(rounds):
                rounds.append([])
                send_busy.append(set())
                recv_busy.append(set())
            if m.src not in send_busy[r] and m.dst not in recv_busy[r]:
                rounds[r].append(i)
                send_busy[r].add(m.src)
                recv_busy[r].add(m.dst)
                placed.append((i, r))
                break
            r += 1
    return rounds


def _is_uniform(idxs: Sequence[int], msgs: Sequence[Msg]) -> bool:
    """True if all messages share offsets and size (static-slice fast path)."""
    m0 = msgs[idxs[0]]
    return all(msgs[i].src_off == m0.src_off and msgs[i].dst_off == m0.dst_off
               and msgs[i].size == m0.size for i in idxs)


def _detect_total_exchange(msgs: Sequence[Msg], p: int
                           ) -> Optional[Tuple[Slot, Slot, int]]:
    """Detect the canonical total exchange: every (s, d) pair sends ``w``
    elements with src_off = d*w and dst_off = s*w -> one fused exchange."""
    if len(msgs) != p * p or p == 1:
        return None
    m0 = msgs[0]
    w = m0.size
    if w == 0:
        return None
    seen = set()
    for m in msgs:
        if (m.src_slot.sid != m0.src_slot.sid
                or m.dst_slot.sid != m0.dst_slot.sid
                or m.size != w or m.src_off != m.dst * w
                or m.dst_off != m.src * w or (m.src, m.dst) in seen):
            return None
        seen.add((m.src, m.dst))
    if m0.src_slot.size < p * w or m0.dst_slot.size < p * w:
        return None
    return (m0.src_slot, m0.dst_slot, w)


def _detect_allgather(msgs: Sequence[Msg], p: int
                      ) -> Optional[Tuple[Slot, Slot, int, np.ndarray]]:
    """Detect the canonical all-gather: every src sends the *same* ``w``
    elements (from a per-src constant offset) to every other process at
    dst_off = src*w -> one fused gather."""
    if p == 1 or len(msgs) not in (p * p, p * (p - 1)):
        return None
    m0 = msgs[0]
    w = m0.size
    if w == 0:
        return None
    seen = set()
    src_off = np.full(p, -1, np.int64)
    for m in msgs:
        if (m.src_slot.sid != m0.src_slot.sid
                or m.dst_slot.sid != m0.dst_slot.sid
                or m.size != w
                or m.dst_off != m.src * w or (m.src, m.dst) in seen):
            return None
        if src_off[m.src] == -1:
            src_off[m.src] = m.src_off
        elif src_off[m.src] != m.src_off:
            return None
        seen.add((m.src, m.dst))
    if m0.src_slot.size < w or m0.dst_slot.size < p * w:
        return None
    if len(msgs) == p * (p - 1) and any(s == d for s, d in seen):
        return None
    src_off[src_off == -1] = 0
    return (m0.src_slot, m0.dst_slot, w, src_off)


def _detect_reduce_scatter(msgs: Sequence[Msg], p: int,
                           attrs: SyncAttributes
                           ) -> Optional[Tuple[Slot, Slot, int, np.ndarray]]:
    """Detect the canonical reduce-scatter: every (s, d) pair sends ``w``
    elements with src_off = d*w to a per-destination constant offset,
    all p contributions combining under ``attrs.reduce_op`` -> one
    fused exchange + local combine."""
    if attrs.reduce_op is None or attrs.compress is not None:
        return None
    if p == 1 or len(msgs) != p * p:
        return None
    m0 = msgs[0]
    w = m0.size
    if w == 0:
        return None
    seen = set()
    dst_off = np.full(p, -1, np.int64)
    for m in msgs:
        if (m.src_slot.sid != m0.src_slot.sid
                or m.dst_slot.sid != m0.dst_slot.sid
                or m.size != w or m.src_off != m.dst * w
                or (m.src, m.dst) in seen):
            return None
        if dst_off[m.dst] == -1:
            dst_off[m.dst] = m.dst_off
        elif dst_off[m.dst] != m.dst_off:
            return None
        seen.add((m.src, m.dst))
    if m0.src_slot.size < p * w:
        return None
    return (m0.src_slot, m0.dst_slot, w, dst_off)


def _detect_scatter(msgs: Sequence[Msg], p: int
                    ) -> Optional[Tuple[Slot, Slot, int, int,
                                        np.ndarray, np.ndarray]]:
    """Detect the canonical root scatter: one source sends chunk d
    (src_off = d*w) to every process d at a per-destination offset ->
    one masked fused exchange (1 round instead of p-1 permutation rounds; equal
    h, so the fused schedule strictly dominates on latency)."""
    if p == 1 or len(msgs) not in (p, p - 1):
        return None
    m0 = msgs[0]
    root = m0.src
    w = m0.size
    if w == 0:
        return None
    seen_dst = set()
    dst_off = np.zeros(p, np.int64)
    mask = np.zeros(p, np.int8)
    for m in msgs:
        if (m.src != root or m.src_slot.sid != m0.src_slot.sid
                or m.dst_slot.sid != m0.dst_slot.sid
                or m.size != w or m.src_off != m.dst * w
                or m.dst in seen_dst):
            return None
        seen_dst.add(m.dst)
        dst_off[m.dst] = m.dst_off
        mask[m.dst] = 1
    if len(msgs) == p - 1 and root in seen_dst:
        return None   # the p-1 variant is exactly "everyone but root"
    if m0.src_slot.size < p * w:
        return None
    return (m0.src_slot, m0.dst_slot, w, root, dst_off, mask)


def _detect_gather(msgs: Sequence[Msg], p: int
                   ) -> Optional[Tuple[Slot, Slot, int, int,
                                       np.ndarray, bool]]:
    """Detect the canonical gather to root: every process sends ``w``
    elements (from a per-source constant offset) to one root at
    dst_off = src*w -> one masked fused gather."""
    if p == 1 or len(msgs) not in (p, p - 1):
        return None
    m0 = msgs[0]
    root = m0.dst
    w = m0.size
    if w == 0:
        return None
    seen_src = set()
    src_off = np.zeros(p, np.int64)
    for m in msgs:
        if (m.dst != root or m.src_slot.sid != m0.src_slot.sid
                or m.dst_slot.sid != m0.dst_slot.sid
                or m.size != w or m.dst_off != m.src * w
                or m.src in seen_src):
            return None
        seen_src.add(m.src)
        src_off[m.src] = m.src_off
    has_self = root in seen_src
    if len(msgs) == p - 1 and has_self:
        return None   # the p-1 variant is exactly "everyone but root"
    if m0.dst_slot.size < p * w or m0.src_slot.size < w:
        return None
    return (m0.src_slot, m0.dst_slot, w, root, src_off, has_self)


def plan_cost(msgs: Sequence[Msg], p: int, attrs: SyncAttributes,
              label: str, method: str, rounds: int,
              wire_sent: Dict[int, int], wire_recv: Dict[int, int]) -> SuperstepCost:
    sent = np.zeros(p, dtype=np.int64)
    recv = np.zeros(p, dtype=np.int64)
    for m in msgs:
        if m.src != m.dst:
            nbytes = m.size * _itemsize(m.src_slot.dtype)
            sent[m.src] += nbytes
            recv[m.dst] += nbytes
    h_bytes = int(max(np.max(sent, initial=0), np.max(recv, initial=0)))
    wire = 0
    total = 0
    for pid in range(p):
        wire = max(wire, wire_sent.get(pid, 0), wire_recv.get(pid, 0))
        total += wire_sent.get(pid, 0)
    return SuperstepCost(label=label, h_bytes=h_bytes, wire_bytes=wire,
                         total_wire_bytes=total, rounds=rounds,
                         n_msgs=len(msgs), method=method)


def _round_compressed(rd: RoundPlan, msgs: Sequence[Msg],
                      attrs: SyncAttributes) -> bool:
    """Whether int8 wire compression applies to this round's payload."""
    return (attrs.compress is not None
            and _is_floating(msgs[rd.msg_idx[0]].src_slot.dtype))


def _plan_direct(msgs: Sequence[Msg], attrs: SyncAttributes,
                 wire_sent: Dict[int, int], wire_recv: Dict[int, int]
                 ) -> Tuple[Tuple[RoundPlan, ...], int]:
    """Group by slot pair, colour each group, and account wire traffic.

    Groups are ordered by first occurrence in the message list (never by
    raw slot id) so that equivalent tables — same pattern through freshly
    registered slots — produce identical plans and can share one cache
    entry."""
    groups: "collections.OrderedDict[Tuple[int, int], List[int]]" = \
        collections.OrderedDict()
    for i, m in enumerate(msgs):
        groups.setdefault((m.src_slot.sid, m.dst_slot.sid), []).append(i)
    rounds: List[RoundPlan] = []
    # combining writes are order-free (sum/max/min commute), so reduce
    # supersteps pack rounds as tightly as a no-conflict assertion
    relaxed = attrs.no_conflict or attrs.reduce_op is not None
    for idxs in groups.values():
        for round_idxs in _colour_rounds(idxs, msgs, relaxed):
            size = max((msgs[i].size for i in round_idxs), default=0)
            static = msgs[round_idxs[0]].src_off \
                if round_idxs and _is_uniform(round_idxs, msgs) else None
            rounds.append(RoundPlan(tuple(round_idxs), size, static))

    n_collectives = 0
    for rd in rounds:
        remote = [(msgs[i].src, msgs[i].dst) for i in rd.msg_idx
                  if msgs[i].src != msgs[i].dst]
        if not remote:
            continue
        compressed = _round_compressed(rd, msgs, attrs)
        itemsize = _itemsize(msgs[rd.msg_idx[0]].dst_slot.dtype)
        wire_elem = (rd.size // 4 + 1) if compressed else rd.size
        n_collectives += 2 if compressed else 1
        for s, d in remote:
            wire_sent[s] = wire_sent.get(s, 0) + wire_elem * itemsize
            wire_recv[d] = wire_recv.get(d, 0) + wire_elem * itemsize
    return tuple(rounds), max(n_collectives, 1)


def _plan_bruck(msgs: Sequence[Msg], p: int, attrs: SyncAttributes,
                wire_sent: Dict[int, int], wire_recv: Dict[int, int]
                ) -> Tuple[int, Tuple[Tuple[int, Tuple[int, ...]], ...], int]:
    pairs = set()
    for m in msgs:
        key = (m.src, m.dst)
        if key in pairs:
            raise LPFFatalError("bruck method requires unique (src,dst) pairs; "
                                "use method='direct' for multigraphs")
        pairs.add(key)
    m0 = msgs[0]
    for m in msgs:
        if (m.src_slot.sid != m0.src_slot.sid
                or m.dst_slot.sid != m0.dst_slot.sid):
            raise LPFFatalError("bruck method requires a single slot pair")
    w = max(m.size for m in msgs)
    itemsize = _itemsize(m0.src_slot.dtype)
    nrounds = max(1, math.ceil(math.log2(p))) if p > 1 else 0
    steps: List[Tuple[int, Tuple[int, ...]]] = []
    n_collectives = 0
    for k in range(nrounds):
        step = 1 << k
        rows = tuple(r for r in range(1, p) if r & step)
        if not rows:
            continue
        steps.append((step, rows))
        n_collectives += 1
        vol = len(rows) * w * itemsize
        for pid in range(p):
            wire_sent[pid] = wire_sent.get(pid, 0) + vol
            wire_recv[pid] = wire_recv.get(pid, 0) + vol
    return w, tuple(steps), max(n_collectives, 1)


def _plan_valiant_split(msgs: Sequence[Msg], p: int, seed: int,
                        scratch: Slot
                        ) -> Tuple[List[int], List[int], List[int]]:
    """Assign each message a seeded-hash intermediate and scratch offset."""
    cursor = np.zeros(p, dtype=np.int64)
    order = sorted(range(len(msgs)),
                   key=lambda i: (msgs[i].src, msgs[i].dst, msgs[i].dst_off))
    via: List[int] = []
    offs: List[int] = []
    for rank, i in enumerate(order):
        m = msgs[i]
        t = (m.src * 2654435761 + m.dst * 40503 + rank * 97 + seed) % p
        off = int(cursor[t])
        if off + m.size > scratch.size:
            raise LPFFatalError(
                "valiant scratch overflow; resize_message_queue with a "
                "larger payload capacity")
        cursor[t] += m.size
        via.append(t)
        offs.append(off)
    return order, via, offs


def _valiant_phase_msgs(msgs: Sequence[Msg], order: Sequence[int],
                        via: Sequence[int], offs: Sequence[int],
                        scratch: Slot) -> Tuple[List[Msg], List[Msg]]:
    phase1 = [Msg(msgs[i].src, t, msgs[i].src_slot, msgs[i].src_off,
                  scratch, off, msgs[i].size)
              for i, t, off in zip(order, via, offs)]
    phase2 = [Msg(t, msgs[i].dst, scratch, off,
                  msgs[i].dst_slot, msgs[i].dst_off, msgs[i].size)
              for i, t, off in zip(order, via, offs)]
    return phase1, phase2


def plan_sync(msgs: Sequence[Msg], p: int, attrs: SyncAttributes,
              scratch: Optional[Slot] = None) -> SuperstepPlan:
    """Phases (1)-(2): validate, arbitrate, classify, colour, and cost one
    superstep.  Pure Python on static metadata — no tensor ops — so it
    can run (and be property-tested) without any device."""
    msgs = list(msgs)
    for m in msgs:
        m.validate(p)
    if attrs.reduce_op is not None:
        if attrs.reduce_op not in _REDUCE_FNS:
            raise LPFFatalError(
                f"unknown reduce_op {attrs.reduce_op!r}; expected one of "
                f"{sorted(_REDUCE_FNS)}")
        if attrs.method in ("bruck", "valiant"):
            raise LPFFatalError(
                "reduce_op supersteps support method 'auto' or 'direct' "
                f"only, not {attrs.method!r}")
    wire_sent: Dict[int, int] = {}
    wire_recv: Dict[int, int] = {}

    if not msgs or p == 0:
        return SuperstepPlan(
            method="noop", p=max(p, 1), n_msgs=len(msgs),
            cost=plan_cost(msgs, max(p, 1), attrs, "", "noop", 0,
                           wire_sent, wire_recv))

    if p == 1:
        # LPF_ROOT / sequential context: puts degenerate to memcpys.
        order = tuple(sorted(range(len(msgs)),
                             key=lambda i: (msgs[i].src, msgs[i].dst,
                                            msgs[i].dst_off)))
        return SuperstepPlan(
            method="seq", p=p, n_msgs=len(msgs), seq_order=order,
            reduce_op=attrs.reduce_op,
            cost=plan_cost(msgs, p, attrs, "", "noop", 0,
                           wire_sent, wire_recv))

    method = attrs.method
    det_rs = det_te = det_ag = det_sc = det_ga = None
    if method == "auto":
        if (det_rs := _detect_reduce_scatter(msgs, p, attrs)) is not None:
            method = "fused_rs"
        elif (det_te := _detect_total_exchange(msgs, p)) is not None:
            method = "fused"
        elif (det_ag := _detect_allgather(msgs, p)) is not None:
            method = "fused_ag"
        elif attrs.compress is None and \
                (det_sc := _detect_scatter(msgs, p)) is not None:
            method = "fused_scatter"
        elif attrs.compress is None and \
                (det_ga := _detect_gather(msgs, p)) is not None:
            method = "fused_gather"
        elif attrs.reduce_op is not None:
            method = "direct"    # bruck cannot combine conflicting writes
        else:
            # latency heuristic: many small messages per process -> bruck
            per_src: Dict[int, int] = {}
            for m in msgs:
                per_src[m.src] = per_src.get(m.src, 0) + 1
            max_deg = max(per_src.values())
            uniq = len({(m.src, m.dst) for m in msgs}) == len(msgs)
            one_pair = len({(m.src_slot.sid, m.dst_slot.sid)
                            for m in msgs}) == 1
            sizes = [m.size for m in msgs]
            small = max(sizes) <= 4 * max(1, min(sizes))
            if uniq and one_pair and small and max_deg > 4 * math.ceil(
                    math.log2(p)):
                method = "bruck"
            else:
                method = "direct"

    if method == "fused_rs":
        src_slot, dst_slot, w, rs_off = det_rs
        itemsize = _itemsize(src_slot.dtype)
        for pid in range(p):
            wire_sent[pid] = (p - 1) * w * itemsize
            wire_recv[pid] = (p - 1) * w * itemsize
        return SuperstepPlan(
            method="fused_rs", p=p, n_msgs=len(msgs), fused_w=w,
            reduce_op=attrs.reduce_op,
            rs_dst_off=tuple(int(o) for o in rs_off),
            cost=plan_cost(msgs, p, attrs, "", "fused_rs", 1,
                           wire_sent, wire_recv))

    if method == "fused_scatter":
        src_slot, dst_slot, w, root, sc_off, sc_mask = det_sc
        itemsize = _itemsize(src_slot.dtype)
        # the fused exchange schedule moves (p-1)*w per process — same h as
        # the root's send volume, for a single l instead of p-1
        for pid in range(p):
            wire_sent[pid] = (p - 1) * w * itemsize
            wire_recv[pid] = (p - 1) * w * itemsize
        return SuperstepPlan(
            method="fused_scatter", p=p, n_msgs=len(msgs), fused_w=w,
            fused_root=root, reduce_op=attrs.reduce_op,
            sc_dst_off=tuple(int(o) for o in sc_off),
            sc_mask=tuple(int(m_) for m_ in sc_mask),
            cost=plan_cost(msgs, p, attrs, "", "fused_scatter", 1,
                           wire_sent, wire_recv))

    if method == "fused_gather":
        src_slot, dst_slot, w, root, g_off, g_self = det_ga
        itemsize = _itemsize(src_slot.dtype)
        for pid in range(p):
            wire_sent[pid] = (p - 1) * w * itemsize
            wire_recv[pid] = (p - 1) * w * itemsize
        return SuperstepPlan(
            method="fused_gather", p=p, n_msgs=len(msgs), fused_w=w,
            fused_root=root, reduce_op=attrs.reduce_op,
            g_src_off=tuple(int(o) for o in g_off), g_has_self=g_self,
            cost=plan_cost(msgs, p, attrs, "", "fused_gather", 1,
                           wire_sent, wire_recv))

    if method == "fused_ag":
        src_slot, dst_slot, w, src_off = det_ag
        compressed = attrs.compress is not None and _is_floating(
            src_slot.dtype)
        itemsize = 1 if compressed else _itemsize(src_slot.dtype)
        for pid in range(p):
            wire_sent[pid] = (p - 1) * w * itemsize
            wire_recv[pid] = (p - 1) * w * itemsize
        return SuperstepPlan(
            method="fused_ag", p=p, n_msgs=len(msgs), fused_w=w,
            ag_src_off=tuple(int(o) for o in src_off),
            ag_exclude_self=len(msgs) == p * (p - 1),
            cost=plan_cost(msgs, p, attrs, "", "fused_ag", 1,
                           wire_sent, wire_recv))

    if method == "fused":
        src_slot, dst_slot, w = det_te
        compressed = attrs.compress is not None and _is_floating(
            src_slot.dtype)
        itemsize = 1 if compressed else _itemsize(src_slot.dtype)
        for pid in range(p):
            wire_sent[pid] = (p - 1) * w * itemsize
            wire_recv[pid] = (p - 1) * w * itemsize
        return SuperstepPlan(
            method="fused", p=p, n_msgs=len(msgs), fused_w=w,
            cost=plan_cost(msgs, p, attrs, "", "fused", 1,
                           wire_sent, wire_recv))

    if method == "valiant":
        if scratch is None:
            raise LPFFatalError("valiant routing needs a scratch slot; the "
                                "context provisions one via "
                                "resize_message_queue(payload=...)")
        order, via, offs = _plan_valiant_split(msgs, p, attrs.valiant_seed,
                                               scratch)
        ph1, ph2 = _valiant_phase_msgs(msgs, order, via, offs, scratch)
        sub = attrs.replace(method="direct")
        rounds1, r1 = _plan_direct(ph1, sub, wire_sent, wire_recv)
        rounds2, r2 = _plan_direct(ph2, sub, wire_sent, wire_recv)
        return SuperstepPlan(
            method="valiant", p=p, n_msgs=len(msgs),
            valiant_order=tuple(order), valiant_via=tuple(via),
            valiant_off=tuple(offs),
            valiant_phase1=rounds1, valiant_phase2=rounds2,
            cost=plan_cost(msgs, p, attrs, "", "valiant", r1 + r2,
                           wire_sent, wire_recv))

    if method == "bruck":
        w, steps, rounds = _plan_bruck(msgs, p, attrs, wire_sent, wire_recv)
        return SuperstepPlan(
            method="bruck", p=p, n_msgs=len(msgs), bruck_w=w,
            bruck_steps=steps,
            cost=plan_cost(msgs, p, attrs, "", "bruck", rounds,
                           wire_sent, wire_recv))

    rounds_plan, rounds = _plan_direct(msgs, attrs, wire_sent, wire_recv)
    return SuperstepPlan(
        method="direct", p=p, n_msgs=len(msgs), rounds=rounds_plan,
        reduce_op=attrs.reduce_op,
        cost=plan_cost(msgs, p, attrs, "", "direct", rounds,
                       wire_sent, wire_recv))


# ==========================================================================
# Stage 2: CACHE — canonical signatures and memoised plans
# ==========================================================================

def plan_signature(msgs: Sequence[Msg], p: int, attrs: SyncAttributes,
                   scratch: Optional[Slot] = None) -> Hashable:
    """A hashable key identifying every input :func:`plan_sync` reads.

    Slot ids are renamed to first-occurrence indices and described by
    ``(size, dtype, kind)``, so the same h-relation staged through freshly
    registered slots (a collective called in a loop, a per-layer gradient
    sync) maps to the same key.  Message *order* is part of the key: CRCW
    arbitration is order-sensitive, so a permuted table is a different
    plan."""
    canon: Dict[int, int] = {}
    slots: List[Tuple[int, str, str]] = []

    def slot_key(slot: Slot) -> int:
        idx = canon.get(slot.sid)
        if idx is None:
            idx = canon[slot.sid] = len(canon)
            slots.append((slot.size, dtype_name(slot.dtype), slot.kind))
        return idx

    table = tuple((m.src, m.dst, slot_key(m.src_slot), m.src_off,
                   slot_key(m.dst_slot), m.dst_off, m.size, m.origin)
                  for m in msgs)
    if attrs.method == "valiant":
        scratch_sig = (attrs.valiant_seed,
                       None if scratch is None
                       else (scratch.size, dtype_name(scratch.dtype)))
    else:
        scratch_sig = None
    return (p, attrs.method, attrs.no_conflict, attrs.reduce_op,
            attrs.compress, scratch_sig, tuple(slots), table)


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    #: warm starts served from a persistent store (entry loaded from
    #: disk, re-verified, promoted to memory — no re-plan, no re-search)
    disk_hits: int = 0
    #: in-memory misses that also found no usable entry on disk (only
    #: counted while a persistent store is attached)
    disk_misses: int = 0
    #: on-disk entries rejected — corruption, version skew, signature
    #: mismatch, or failed re-verification — each degraded to a cold miss
    invalidated: int = 0
    #: persistent-store I/O failures (full disk, read-only dir, read
    #: errors) absorbed by the degradation ladder: each cost a retry
    #: loop and at worst the warm start, never the execution.  Past
    #: ``ProgramCache.DISK_STRIKE_LIMIT`` consecutive failures the
    #: cache detaches its store and runs memory-only.
    disk_errors: int = 0
    #: whole-program compilations that failed and fell back to the
    #: dispatched ``execute_schedule`` path (same certified program,
    #: ledger bit-for-bit); the failing signature is quarantined so
    #: replays skip the doomed compile
    compile_fallbacks: int = 0

    @property
    def plans(self) -> int:
        """Planning passes actually run (== misses)."""
        return self.misses

    def reset(self) -> None:
        """Zero the counters in place (the cache contents stay warm) —
        benchmarks and replay tests measure hit/miss deltas without a
        process restart or a cold cache."""
        self.hits = self.misses = self.evictions = 0
        self.disk_hits = self.disk_misses = self.invalidated = 0
        self.disk_errors = self.compile_fallbacks = 0


class PlanCache:
    """LRU memo of :class:`SuperstepPlan` keyed by :func:`plan_signature`.

    Planning is host-side Python, so a 64-superstep FFT whose stages
    repeat a handful of distinct relations re-plans each relation once and
    replays the cached IR for the other supersteps."""

    def __init__(self, maxsize: int = 1024):
        self.maxsize = maxsize
        self._plans: "collections.OrderedDict[Hashable, SuperstepPlan]" = \
            collections.OrderedDict()
        self.stats = CacheStats()

    def __len__(self) -> int:
        return len(self._plans)

    def clear(self) -> None:
        self._plans.clear()
        self.stats = CacheStats()

    def get_or_plan(self, msgs: Sequence[Msg], p: int,
                    attrs: SyncAttributes,
                    scratch: Optional[Slot] = None) -> SuperstepPlan:
        key = plan_signature(msgs, p, attrs, scratch)
        plan = self._plans.get(key)
        if plan is not None:
            self.stats.hits += 1
            self._plans.move_to_end(key)
            return plan
        plan = plan_sync(msgs, p, attrs, scratch)
        self.stats.misses += 1
        self._plans[key] = plan
        if len(self._plans) > self.maxsize:
            self._plans.popitem(last=False)
            self.stats.evictions += 1
        return plan


_GLOBAL_PLAN_CACHE = PlanCache()


def global_plan_cache() -> PlanCache:
    """The process-wide plan cache (shared across contexts)."""
    return _GLOBAL_PLAN_CACHE


# ==========================================================================
# Stage 3: EXECUTE — row and column views of the stacked store
# ==========================================================================
#
# Every method reads the pre-superstep values (LPF reads observe the state
# before the superstep) and writes into fresh tensors: a destination is
# cloned once, written, and set back, so a view taken of any slot value
# before the writes stays the pre-superstep state.  Payloads move as row
# and column views of the ``[p, size]`` values; index tensors have length
# p (or p * p for Bruck's working rows), never the payload's length.
#
# Each method lowers split-phase (:func:`begin_plan`): a *start* half that
# only reads slot values and computes the payloads, and a *finish* closure
# that applies the slot writes.  The store is functional — no tensor a slot
# holds is ever written in place — so the start half's views stay valid
# whatever the finish halves of an overlap group write.

#: index tensors kept on their device, keyed by (values, device): a
#: superstep replayed with the same table reuses them instead of copying
#: its index table from the host again — a pageable host-to-device copy,
#: which CUDA-graph capture refuses
_INDEX_MEMO: "collections.OrderedDict[Tuple, torch.Tensor]" = \
    collections.OrderedDict()
_INDEX_MEMO_SIZE = 8192
#: the key -> tensor dicts of the :func:`keep_indices` blocks now open
_INDEX_KEEPERS: List[Dict[Tuple, torch.Tensor]] = []


def _capturing(device: torch.device) -> bool:
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


@contextlib.contextmanager
def keep_indices(kept: Dict[Tuple, torch.Tensor]):
    """Record into ``kept`` every index tensor :func:`_index` returns in
    the block, and look tables up there when the memo has dropped them.

    A CUDA graph reads its index tensors on every replay but holds no
    reference to them, and the memo is an LRU: whoever owns a graph owns
    the ``kept`` dict of its capture, so the tensors live as long as the
    graph."""
    _INDEX_KEEPERS.append(kept)
    try:
        yield kept
    finally:
        _INDEX_KEEPERS.remove(kept)


def _index(arr, device) -> torch.Tensor:
    """``arr`` (1-D ints) as an int64 tensor on ``device``, built once and
    kept (:data:`_INDEX_MEMO`, and the open :func:`keep_indices`)."""
    key = (tuple(np.asarray(arr, np.int64).reshape(-1).tolist()),
           torch.device(device))
    t = _INDEX_MEMO.get(key)
    if t is not None:
        _INDEX_MEMO.move_to_end(key)
    else:
        t = next((k[key] for k in _INDEX_KEEPERS if key in k), None)
    if t is None:
        if _capturing(key[1]):
            raise RuntimeError(
                "a superstep's index table was first built inside a CUDA "
                "graph capture; run the schedule once eagerly before "
                "capturing it")
        t = torch.tensor(key[0], dtype=torch.int64).to(key[1])
        _INDEX_MEMO[key] = t
        if len(_INDEX_MEMO) > _INDEX_MEMO_SIZE:
            _INDEX_MEMO.popitem(last=False)
    for kept in _INDEX_KEEPERS:
        kept[key] = t
    return t


def _uniform(values: Sequence[int]) -> Optional[int]:
    """The common value of ``values``, or None when they differ."""
    first = values[0]
    return first if all(v == first for v in values) else None


def _fresh(registry, slot: Slot) -> torch.Tensor:
    """A writable copy of the slot's value."""
    return registry.value(slot).clone(memory_format=torch.contiguous_format)


def _windows(val: torch.Tensor, rows: Sequence[int], offs: Sequence[int],
             w: int) -> torch.Tensor:
    """``[len(rows), w]``: window ``i`` is ``val[rows[i], offs[i]:+w]``,
    zero past the end of the slot (the reference's fill mode)."""
    size = val.shape[1]
    o = _uniform(offs)
    if o is not None and o + w <= size:
        if list(rows) == list(range(val.shape[0])):
            return val[:, o:o + w]                 # every row: a view
        return val[_index(rows, val.device), o:o + w]
    if max(offs) + w > size:
        val = torch.nn.functional.pad(val, (0, max(offs) + w - size))
    return val.unfold(1, w, 1)[_index(rows, val.device),
                                _index(offs, val.device)]


def _write_rows(out: torch.Tensor, rows: Sequence[int],
                offs: Sequence[int], data: torch.Tensor,
                sizes: Optional[Sequence[int]] = None) -> None:
    """``out[rows[i], offs[i]:offs[i] + n_i] = data[i, :n_i]`` for distinct
    rows, ``n_i = sizes[i]`` (default: the width of ``data``)."""
    if not rows:
        return
    sizes = [data.shape[1]] * len(rows) if sizes is None else list(sizes)
    o, n = _uniform(offs), _uniform(sizes)
    if o is not None and n is not None:
        out[_index(rows, out.device), o:o + n] = data[:, :n]
        return
    for i, (r, off, k) in enumerate(zip(rows, offs, sizes)):
        out[r, off:off + k] = data[i, :k]


def _quantize(x: torch.Tensor, spec) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 symmetric quantisation along the last axis, one scale a row:
    ``max|x| / 127 + 1e-30``, round half to even, clip to +-127 (the
    reference's order of operations, so CPU values agree bit for bit).
    The division is the product with ``1/127`` that XLA compiles the
    reference's ``/ 127.0`` into: the two differ in the last bit."""
    if spec.bits != 8:
        raise LPFFatalError(f"unsupported compression bits={spec.bits}")
    scale = x.abs().amax(dim=-1) * (1.0 / 127.0) + 1e-30
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _squeeze_wire(x: torch.Tensor, spec) -> torch.Tensor:
    """What a compressed wire delivers of ``x``'s rows: each row quantised
    with its own scale (a float32 scale, as the reference ships it)."""
    q, scale = _quantize(x, spec)
    return (q.to(torch.float32) * scale.to(torch.float32)[..., None]).to(
        x.dtype)


Finish = Callable[[], None]


def _seq_begin(plan: SuperstepPlan, registry,
               msgs: Sequence[Msg]) -> Finish:
    """p == 1: the puts are ordered memcpys.  Every payload is read in the
    start half, before any write lands (LPF reads observe the
    pre-superstep state)."""
    reduce_fn = _REDUCE_FNS[plan.reduce_op] if plan.reduce_op else None
    chunks = [registry.value(msgs[i].src_slot)[
        0, msgs[i].src_off:msgs[i].src_off + msgs[i].size]
        for i in plan.seq_order]

    def finish() -> None:
        new: Dict[int, torch.Tensor] = {}
        written: Dict[int, np.ndarray] = {}
        for i, piece in zip(plan.seq_order, chunks):
            m = msgs[i]
            dst = new.get(m.dst_slot.sid)
            if dst is None:
                dst = new[m.dst_slot.sid] = _fresh(registry, m.dst_slot)
            lo, hi = m.dst_off, m.dst_off + m.size
            if reduce_fn is not None:
                wr = written.setdefault(m.dst_slot.sid,
                                        np.zeros(m.dst_slot.size, bool))
                seg = wr[lo:hi].copy()
                if seg.all():
                    piece = reduce_fn(dst[0, lo:hi], piece)
                elif seg.any():
                    # combine where this superstep already wrote
                    hit = _index(np.flatnonzero(seg), dst.device)
                    piece = piece.clone()
                    piece[hit] = reduce_fn(dst[0, lo:hi][hit], piece[hit])
                wr[lo:hi] = True
            dst[0, lo:hi] = piece
        for i in plan.seq_order:
            slot = msgs[i].dst_slot
            if slot.sid in new:
                registry.set_value(slot, new.pop(slot.sid))

    return finish


def _direct_begin(registry, msgs: Sequence[Msg],
                  rounds: Sequence[RoundPlan], attrs: SyncAttributes,
                  reduce_op: Optional[str] = None) -> Finish:
    """Planned ``direct`` rounds.  The start half takes every round's
    payloads from the pre-superstep values; the finish closure applies
    the deliveries in round order (later rounds win — the planner placed
    conflicting higher-pid writes in later rounds).  A round is a partial
    permutation, so its destination rows are distinct.  With
    ``reduce_op`` a delivery that overlaps an earlier delivery of this
    superstep combines with it.  On a compressed wire every message of a
    float round travels quantised, scaled over the round's padded width
    as in the reference."""
    reduce_fn = _REDUCE_FNS[reduce_op] if reduce_op is not None else None
    # ---- start: extraction (reads observe pre-superstep values) ----
    deliveries = []
    for rd in rounds:
        rd_msgs = [msgs[i] for i in rd.msg_idx]
        src_slot, dst_slot = rd_msgs[0].src_slot, rd_msgs[0].dst_slot
        val = registry.value(src_slot)
        squeeze = _round_compressed(rd, msgs, attrs)
        if rd.static_src_off is not None and reduce_fn is None \
                and not squeeze:
            # uniform round: one row gather of a static column range
            m0 = rd_msgs[0]
            payload = val[_index([m.src for m in rd_msgs], val.device),
                          m0.src_off:m0.src_off + m0.size]
            deliveries.append((dst_slot, [m.dst for m in rd_msgs],
                               m0.dst_off, payload))
            continue
        if squeeze:
            wire = _squeeze_wire(_windows(
                val, [m.src for m in rd_msgs], [m.src_off for m in rd_msgs],
                rd.size), attrs.compress)
            payloads = [wire[i, :m.size] for i, m in enumerate(rd_msgs)]
        else:
            payloads = [val[m.src, m.src_off:m.src_off + m.size]
                        for m in rd_msgs]
        for m, payload in zip(rd_msgs, payloads):
            deliveries.append((dst_slot, m.dst, m.dst_off, payload))

    # ---- finish: delivery, in round order ----
    def finish() -> None:
        new: Dict[int, torch.Tensor] = {}
        written: Dict[int, torch.Tensor] = {}
        order: List[Slot] = []
        for dst_slot, dst, dst_off, payload in deliveries:
            cur = new.get(dst_slot.sid)
            if cur is None:
                cur = new[dst_slot.sid] = _fresh(registry, dst_slot)
                order.append(dst_slot)
            if isinstance(dst, list):
                _write_rows(cur, dst, [dst_off] * len(dst), payload)
                continue
            seg = cur[dst, dst_off:dst_off + payload.shape[0]]
            if reduce_fn is None:
                seg.copy_(payload)
                continue
            wr = written.get(dst_slot.sid)
            if wr is None:
                wr = written[dst_slot.sid] = torch.zeros(
                    cur.shape, dtype=torch.bool, device=cur.device)
            seen = wr[dst, dst_off:dst_off + payload.shape[0]]
            seg.copy_(torch.where(seen, reduce_fn(seg, payload), payload))
            seen.fill_(True)
        for slot in order:
            registry.set_value(slot, new[slot.sid])

    return finish


def _fused_begin(plan: SuperstepPlan, registry, msgs: Sequence[Msg],
                 attrs: SyncAttributes) -> Finish:
    """The canonical total exchange: process ``s`` sends chunk ``d`` of
    its first ``p*w`` source elements to process ``d``, which stores it at
    chunk ``s``.  On the stacked store that is one permute of the
    ``[p_src, p_dst, w]`` block.  A compressed wire quantises each
    destination chunk with its own scale."""
    p, w = registry.p, plan.fused_w
    src_slot, dst_slot = msgs[0].src_slot, msgs[0].dst_slot
    x = registry.value(src_slot)[:, :p * w].reshape(p, p, w)
    if attrs.compress is not None and _is_floating(src_slot.dtype):
        # per-destination-row scales travel alongside the payload; the
        # reference multiplies by them in the payload's dtype
        q, scale = _quantize(x, attrs.compress)
        x = (q.to(torch.float32) * scale[..., None]).to(x.dtype)
    y = x.permute(1, 0, 2).contiguous().view(p, p * w)   # [dst, src*w]

    def finish() -> None:
        out = y
        if dst_slot.size != p * w:
            out = _fresh(registry, dst_slot)
            out[:, :p * w] = y
        registry.set_value(dst_slot, out)

    return finish


def _fused_ag_begin(plan: SuperstepPlan, registry, msgs: Sequence[Msg],
                    attrs: SyncAttributes) -> Finish:
    """All-gather: every process's ``w`` elements (from its own source
    offset) land at chunk ``s`` of every destination; the exclude-self
    variant keeps each process's own chunk.  A compressed wire quantises
    each process's chunk with its own scale."""
    p, w = registry.p, plan.fused_w
    src_slot, dst_slot = msgs[0].src_slot, msgs[0].dst_slot
    x = _windows(registry.value(src_slot), range(p), plan.ag_src_off, w)
    if attrs.compress is not None and _is_floating(src_slot.dtype):
        x = _squeeze_wire(x, attrs.compress)
    y = x.reshape(1, p * w)

    def finish() -> None:
        if dst_slot.size == p * w and not plan.ag_exclude_self:
            registry.set_value(dst_slot, y.expand(p, p * w).contiguous())
            return
        old = registry.value(dst_slot)
        out = _fresh(registry, dst_slot)
        out[:, :p * w] = y
        if plan.ag_exclude_self:
            # exclude-self variant: keep own chunk as-is
            diag = torch.arange(p, device=out.device)
            out[:, :p * w].view(p, p, w)[diag, diag] = \
                old[:, :p * w].reshape(p, p, w)[diag, diag]
        registry.set_value(dst_slot, out)

    return finish


def _fused_rs_begin(plan: SuperstepPlan, registry, msgs: Sequence[Msg],
                    attrs: SyncAttributes) -> Finish:
    """Reduce-scatter: chunk ``d`` of every process combines under
    ``reduce_op`` (a sum over the stacked source axis, or max/min) and
    lands at process ``d``'s destination offset; the destination's old
    contents there are replaced, not combined."""
    p, w = registry.p, plan.fused_w
    src_slot, dst_slot = msgs[0].src_slot, msgs[0].dst_slot
    x = registry.value(src_slot)[:, :p * w].reshape(p, p, w)  # [src, dst]
    if plan.reduce_op == "sum":
        y = x.sum(0)
    elif plan.reduce_op == "max":
        y = x.amax(0)
    else:
        y = x.amin(0)
    y = y.to(dst_slot.dtype)
    offs = plan.rs_dst_off

    def finish() -> None:
        if dst_slot.size == w and _uniform(offs) == 0:
            registry.set_value(dst_slot, y.contiguous())
            return
        out = _fresh(registry, dst_slot)
        _write_rows(out, range(p), offs, y)
        registry.set_value(dst_slot, out)

    return finish


def _fused_scatter_begin(plan: SuperstepPlan, registry,
                         msgs: Sequence[Msg],
                         attrs: SyncAttributes) -> Finish:
    """Root scatter: chunk ``d`` of the root's source lands at process
    ``d``'s offset; processes outside ``sc_mask`` keep their data."""
    p, w, root = registry.p, plan.fused_w, plan.fused_root
    src_slot, dst_slot = msgs[0].src_slot, msgs[0].dst_slot
    x = registry.value(src_slot)[root, :p * w].view(p, w)   # row d -> d
    rows = [d for d in range(p) if plan.sc_mask[d]]
    data = x.index_select(0, _index(rows, x.device)).to(dst_slot.dtype)

    def finish() -> None:
        out = _fresh(registry, dst_slot)
        _write_rows(out, rows, [plan.sc_dst_off[d] for d in rows], data)
        registry.set_value(dst_slot, out)

    return finish


def _fused_gather_begin(plan: SuperstepPlan, registry,
                        msgs: Sequence[Msg],
                        attrs: SyncAttributes) -> Finish:
    """Gather to root: process ``s``'s ``w`` elements land at chunk ``s``
    of the root's destination; without a root -> root message the root
    keeps its own chunk.  Other processes keep their data."""
    p, w, root = registry.p, plan.fused_w, plan.fused_root
    src_slot, dst_slot = msgs[0].src_slot, msgs[0].dst_slot
    x = _windows(registry.value(src_slot), range(p), plan.g_src_off, w)
    rows = [s for s in range(p) if plan.g_has_self or s != root]
    data = x.index_select(0, _index(rows, x.device)).to(dst_slot.dtype)

    def finish() -> None:
        out = _fresh(registry, dst_slot)
        out[root, :p * w].view(p, w)[_index(rows, out.device)] = data
        registry.set_value(dst_slot, out)

    return finish


def _bruck_begin(plan: SuperstepPlan, registry, msgs: Sequence[Msg],
                 attrs: SyncAttributes) -> Finish:
    """Planned Bruck rounds.  Row ``r`` of a process's ``[p, w]`` working
    matrix holds the payload it carries whose original relative distance
    (dst - origin mod p) is ``r``; a round rolls its row set ``step``
    processes along the stacked process axis (the start half).  The
    finish closure applies the deliveries in ascending ``r``, as the
    reference applies them (CRCW determinism)."""
    p, w = registry.p, plan.bruck_w
    src_slot, dst_slot = msgs[0].src_slot, msgs[0].dst_slot
    # tables[src, rel] -> offset/size/mask of the message src -> src+rel
    src_off = np.zeros((p, p), np.int64)
    dst_off = np.zeros((p, p), np.int64)
    sizes = np.zeros((p, p), np.int64)
    mask = np.zeros((p, p), bool)
    for m in msgs:
        rel = (m.dst - m.src) % p
        src_off[m.src, rel] = m.src_off
        dst_off[m.dst, rel] = m.dst_off   # indexed by the *receiver* pid
        sizes[m.src, rel] = m.size
        mask[m.src, rel] = True
    buf = _windows(registry.value(src_slot), np.repeat(np.arange(p), p),
                   src_off.reshape(-1).tolist(), w).reshape(p, p, w)
    for step, rows in plan.bruck_steps:
        idx = _index(rows, buf.device)
        buf[:, idx] = torch.roll(buf.index_select(1, idx), step, 0)

    def finish() -> None:
        out = _fresh(registry, dst_slot)
        for r in range(p):
            # row r of process me arrived from origin (me - r) % p
            me = [d for d in range(p) if mask[(d - r) % p, r]]
            _write_rows(out, me, [int(dst_off[d, r]) for d in me],
                        buf[_index(me, buf.device), r],
                        [int(sizes[(d - r) % p, r]) for d in me])
        registry.set_value(dst_slot, out)

    return finish


def _valiant_begin(plan: SuperstepPlan, registry, msgs: Sequence[Msg],
                   attrs: SyncAttributes, scratch: Optional[Slot]) -> Finish:
    """Two-phase routing: phase 1 puts every message into the scratch
    slot of its seeded-hash intermediate, phase 2 delivers from there;
    each phase runs its planned ``direct`` rounds.  Phase 2 reads what
    phase 1 wrote, so phase 1 completes inside the start half — the
    reason the optimizer never overlaps a Valiant superstep."""
    if scratch is None:
        raise LPFFatalError("valiant plan lowered without a scratch slot")
    ph1, ph2 = _valiant_phase_msgs(msgs, plan.valiant_order,
                                   plan.valiant_via, plan.valiant_off,
                                   scratch)
    sub = attrs.replace(method="direct")
    _direct_begin(registry, ph1, plan.valiant_phase1, sub)()
    return _direct_begin(registry, ph2, plan.valiant_phase2, sub)


_FUSED_BEGIN = {
    "fused": _fused_begin, "fused_ag": _fused_ag_begin,
    "fused_rs": _fused_rs_begin, "fused_scatter": _fused_scatter_begin,
    "fused_gather": _fused_gather_begin, "bruck": _bruck_begin,
}

#: plan methods :func:`execute_plan` implements: every method
#: :func:`plan_sync` can return
EXECUTED_METHODS = frozenset(
    {"noop", "seq", "direct", "valiant"} | set(_FUSED_BEGIN))

#: methods the overlap rewrite may schedule split-phase: their start half
#: performs no slot writes (valiant's phase-1 scratch writes land in the
#: start half, so two overlapped valiant supersteps would race the scratch)
OVERLAPPABLE_METHODS = frozenset(
    {"noop", "seq", "direct", "bruck", "fused", "fused_ag", "fused_rs",
     "fused_scatter", "fused_gather"})


def begin_plan(plan: SuperstepPlan, registry, msgs: Sequence[Msg],
               attrs: SyncAttributes,
               scratch: Optional[Slot] = None) -> Finish:
    """Phase (3), split-phase: read the superstep's payloads (the *start*
    half) and return a closure that applies its slot writes (the *finish*
    half).

    The start half reads source values and computes what each message
    delivers, but writes no slot; every destination read and write
    happens inside the returned closure.  :func:`execute_overlapped` runs
    all starts of an overlap group before any finish, so every member
    observes the group-entry state.  (``valiant`` is the exception: its
    phase-1 scratch writes land in the start half.)  ``registry`` is a
    :class:`~repro_torch.core.memslot.SlotRegistry` or a
    :class:`ValueStore`."""
    if plan.method == "noop":
        return lambda: None
    if plan.method == "seq":
        return _seq_begin(plan, registry, msgs)
    if plan.method == "direct":
        return _direct_begin(registry, msgs, plan.rounds, attrs,
                             plan.reduce_op)
    if plan.method == "valiant":
        return _valiant_begin(plan, registry, msgs, attrs, scratch)
    return _FUSED_BEGIN[plan.method](plan, registry, msgs, attrs)


def execute_plan(plan: SuperstepPlan, registry, msgs: Sequence[Msg],
                 attrs: SyncAttributes, label: str,
                 scratch: Optional[Slot] = None) -> SuperstepCost:
    """Phase (3): apply ``plan`` to the registry's stacked slot values
    (``begin_plan(...)()``).

    ``msgs`` must be the table the plan was built from, or any table with
    the same :func:`plan_signature` (the cache guarantees this).  Replaces
    the destination slots' values (and, for ``valiant``, the scratch
    slot's); returns the superstep's ledger entry — identical to the
    plan's predicted cost, with the label attached."""
    begin_plan(plan, registry, msgs, attrs, scratch=scratch)()
    return plan.cost_with_label(label)


# ==========================================================================
# CUDA streams for split-phase overlap
# ==========================================================================

#: side streams a device's pool holds at most
_POOL_WIDTH = 4

_STREAM_POOLS: Dict[torch.device, List["torch.cuda.Stream"]] = {}


def _stream_pool(device: torch.device, n: int) -> list:
    pool = _STREAM_POOLS.setdefault(device, [])
    while len(pool) < n:
        pool.append(torch.cuda.Stream(device))
    return pool[:n]


@contextlib.contextmanager
def fork_streams(device, n: int):
    """Fork ``n`` independent pieces of work onto side streams; yields one
    stream a piece, or ``None`` where it stays on the current stream.

    The pieces fork only inside a CUDA-graph capture, where the fork and
    the join are parallel branches of the graph, joined before the
    capture ends.  Dispatched, the fork and join cost more host time than
    the overlap hides, so the pieces stay on the current stream, as on
    the CPU; ``LPF_OVERLAP_STREAMS=0`` keeps them there in a capture too.
    Each side stream first waits for what the current stream has queued;
    on exit — also when the block raises — the current stream waits for
    every side stream.  Pieces beyond the pool's width share its streams
    in turn.  Side streams run only between such a fork and join, which
    orders the memory they touch without ``record_stream``: a block
    freed on a side stream is reused there only after a later fork,
    behind the current stream's work; one freed on the current stream
    after the join, behind the side streams' work.  So the side work must
    read only tensors that outlive the join.  A stream that cannot be
    made, forked or joined raises :class:`LPFFatalError`: the work never
    falls back to one stream."""
    device = torch.device(device)
    if not _capturing(device) or n < 1 or \
            os.environ.get("LPF_OVERLAP_STREAMS") == "0":
        yield [None] * n
        return
    try:
        pool = _stream_pool(device, min(n, _POOL_WIDTH))
        cur = torch.cuda.current_stream(device)
        for s in pool:
            s.wait_stream(cur)
    except Exception as e:
        raise LPFFatalError(f"forking {n} pieces of work onto CUDA side "
                            f"streams failed: {type(e).__name__}: {e}"
                            ) from e
    try:
        yield [pool[i % len(pool)] for i in range(n)]
    finally:
        try:
            for s in pool:
                cur.wait_stream(s)
        except Exception as e:
            raise LPFFatalError(f"joining the CUDA side streams failed: "
                                f"{type(e).__name__}: {e}") from e


def on_stream(stream):
    """``torch.cuda.stream(stream)``, or nothing for ``None``."""
    return contextlib.nullcontext() if stream is None \
        else torch.cuda.stream(stream)


def execute_overlapped(items: Sequence[Tuple[SuperstepPlan, Sequence[Msg],
                                             SyncAttributes, str]],
                       registry, scratch: Optional[Slot] = None
                       ) -> SuperstepCost:
    """Issue one overlap group of independent supersteps split-phase: all
    *start* halves first (every member reads the group-entry slot state),
    then all *finish* halves in program order.  Returns the group's single
    ledger entry, by construction :func:`repro_torch.core.cost.
    overlap_cost` of the members' planned costs.

    Inside a CUDA-graph capture each start half runs on a side stream of
    the device's pool (:func:`fork_streams`), so the members' reads and
    payload work run side by side; the current stream joins them all
    before the finishes write, in program order on the current stream.
    The values are those of the one-stream order bit for bit: a start
    half writes no slot, and each member computes the same thing on
    whichever stream it runs."""
    with fork_streams(registry.device, len(items)) as streams:
        finishes = []
        for (plan, msgs, attrs, _), s in zip(items, streams):
            with on_stream(s):
                finishes.append(begin_plan(plan, registry, list(msgs),
                                           attrs, scratch=scratch))
    for finish in finishes:
        finish()
    return overlap_cost([plan.cost for plan, _, _, _ in items],
                        label="||".join(label for _, _, _, label in items))


class ValueStore:
    """The slot-value surface the executors consume — a duck type of
    :class:`~repro_torch.core.memslot.SlotRegistry` holding only
    ``sid -> [p, size]`` values.  Every lowering touches its store only
    through ``p``, ``value`` and ``set_value``, which is what lets a whole
    optimized program run against canonical slots
    (:class:`repro_torch.core.program.CompiledProgram`).  It records which
    slots the schedule read before writing them (``read_first``) and
    which it wrote (``written``): the values a replay has to copy in and
    out.  No registration or shape checks — the registry re-validates the
    results when they are written back."""

    def __init__(self, values: Dict[int, torch.Tensor], p: int):
        self._values = dict(values)
        self.p = int(p)
        #: where the values live (the first one's device; the CPU if none)
        self.device = next((v.device for v in self._values.values()
                            if isinstance(v, torch.Tensor)),
                           torch.device("cpu"))
        self.read_first: set = set()
        self.written: set = set()

    def value(self, slot: Slot) -> torch.Tensor:
        if slot.sid not in self.written:
            self.read_first.add(slot.sid)
        return self._values[slot.sid]

    def set_value(self, slot: Slot, value: torch.Tensor) -> None:
        self.written.add(slot.sid)
        self._values[slot.sid] = value


def execute_schedule(entries, groups, registry,
                     scratch: Optional[Slot] = None) -> List[SuperstepCost]:
    """Issue one optimized program's schedule: ``entries`` are the
    materialized ``(msgs, attrs, label, plan)`` supersteps and ``groups``
    the issue partition (singletons via :func:`execute_plan`, overlap
    groups via :func:`execute_overlapped`).  The one executor loop of the
    dispatched path and of a compiled program — both ledger the same plans'
    costs.  ``registry`` may be a :class:`SlotRegistry` or a
    :class:`ValueStore`."""
    costs: List[SuperstepCost] = []
    for grp in groups:
        if len(grp) == 1:
            msgs, attrs, label, plan = entries[grp[0]]
            costs.append(execute_plan(plan, registry, msgs, attrs, label,
                                      scratch=scratch))
        else:
            costs.append(execute_overlapped(
                [(entries[i][3], entries[i][0], entries[i][1],
                  entries[i][2]) for i in grp],
                registry, scratch=scratch))
    return costs


# ==========================================================================
# entry point (plan + execute in one call)
# ==========================================================================

def execute_sync(registry: SlotRegistry, queue: Sequence[Msg],
                 attrs: SyncAttributes, label: str,
                 scratch: Optional[Slot] = None,
                 cache: Optional[PlanCache] = None) -> SuperstepCost:
    """Run one superstep over the registry's ``p`` processes; replaces
    slot values; returns its cost record.

    With ``cache`` the planning stage is memoised; pass ``None`` to force
    a fresh planning pass."""
    msgs = list(queue)
    if cache is not None:
        plan = cache.get_or_plan(msgs, registry.p, attrs, scratch)
    else:
        plan = plan_sync(msgs, registry.p, attrs, scratch)
    return execute_plan(plan, registry, msgs, attrs, label, scratch=scratch)
