"""The port's split-phase executor and overlap groups
(``repro_torch.core.sync.begin_plan`` / ``execute_overlapped`` /
``execute_schedule``) against its own contract and the JAX package.

* every method lowers split-phase: the start half writes no slot (and
  leaves every value the caller holds unchanged), the finish half
  applies the writes; start then finish equals ``execute_plan``;
* an overlap group executes all starts, then all finishes: bit-equal to
  its members one after the other, in either order;
* the overlap cost term and grouping equal the JAX package's, and the
  groups the optimizer forms commute (int32 payloads, bit-equal).
"""

import dataclasses

import pytest
import torch

import test_overlap_engine as toe
from repro import core as jlpf
from repro.core import machine as jmachine
from repro.core import program as jprog
from repro_torch import core as tlpf
from repro_torch.core import program as tprog
from repro_torch.interop import hardware_from_fields, steps_from_fields

JM = jmachine.probe({"x": 8}, jmachine.CPU_HOST)
TM = tlpf.probe({"x": 8}, hardware_from_fields(
    dataclasses.asdict(jmachine.CPU_HOST)))


def slot(sid, size, dtype=torch.int32, kind="global"):
    return tlpf.Slot(sid, f"s{sid}", size, dtype, kind, (size,))


def to_port(steps):
    return steps_from_fields([dataclasses.asdict(s) for s in steps])


def test_overlappable_methods_match_jax():
    assert tlpf.OVERLAPPABLE_METHODS == jlpf.OVERLAPPABLE_METHODS
    assert "valiant" not in tlpf.OVERLAPPABLE_METHODS


@pytest.mark.parametrize("k", [1, 2, 3])
def test_overlap_cost_matches_jax(k):
    def costs(mod):
        return [mod.SuperstepCost(label=f"c{i}", h_bytes=100 - 30 * i,
                                  wire_bytes=100 - 20 * i,
                                  total_wire_bytes=400 + i, rounds=1 + i,
                                  n_msgs=4 + i, method=m)
                for i, m in enumerate(["fused_ag", "fused_rs", "direct"][:k])]
    j = jlpf.overlap_cost(costs(jlpf), label="g")
    t = tlpf.overlap_cost(costs(tlpf), label="g")
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.predicted_seconds(JM) == t.predicted_seconds(TM)


# ---------------------------------------------------------------------------
# split-phase lowering: the start half writes nothing
# ---------------------------------------------------------------------------

def _case(method, p=4, w=3):
    """(msgs, attrs, slots, scratch) of one superstep planned to
    ``method``."""
    A, B = slot(1, p * w), slot(2, p * w)
    scratch = None
    attrs = tlpf.SyncAttributes()
    if method == "fused":
        msgs = [(s, d, A, d * w, B, s * w, w) for s in range(p)
                for d in range(p)]
    elif method == "fused_ag":
        msgs = [(s, d, A, 0, B, s * w, w) for s in range(p)
                for d in range(p)]
    elif method == "fused_rs":
        B = slot(2, w)
        msgs = [(s, d, A, d * w, B, 0, w) for s in range(p)
                for d in range(p)]
        attrs = tlpf.SyncAttributes(reduce_op="sum")
    elif method == "fused_scatter":
        msgs = [(1, d, A, d * w, B, 0, w) for d in range(p)]
    elif method == "fused_gather":
        msgs = [(s, 2, A, 0, B, s * w, w) for s in range(p)]
    elif method == "bruck":
        msgs = [(s, d, A, 0, B, s, 1) for s in range(p) for d in range(p)
                if s != d]
        attrs = tlpf.SyncAttributes(method="bruck")
    elif method == "valiant":
        msgs = [(s, (s + 1) % p, A, 0, B, 2, 5) for s in range(p)]
        attrs = tlpf.SyncAttributes(method="valiant")
        scratch = slot(9, 64)
    elif method == "direct_sum":
        msgs = [(s, 0, A, s, B, 1, 4) for s in range(p)]
        attrs = tlpf.SyncAttributes(reduce_op="sum")
    elif method == "seq":
        msgs = [(0, 0, A, 0, B, 4, 5), (0, 0, A, 2, B, 6, 3)]
        attrs = tlpf.SyncAttributes(reduce_op="max")
    else:
        msgs = [(s, (s + 1) % p, A, 1, B, 4, 5) for s in range(p)]
    msgs = [tlpf.Msg(*m) for m in msgs]
    slots = [A, B] + ([scratch] if scratch is not None else [])
    return msgs, attrs, slots, scratch


METHODS = ["direct", "direct_sum", "bruck", "valiant", "fused", "fused_ag",
           "fused_rs", "fused_scatter", "fused_gather", "seq"]


@pytest.mark.parametrize("method", METHODS)
def test_start_half_writes_no_slot(method):
    p = 1 if method == "seq" else 4
    msgs, attrs, slots, scratch = _case(method, p=p,
                                        w=12 if method == "seq" else 3)
    gen = torch.Generator().manual_seed(5)
    init = {s.sid: torch.randint(-99, 99, (p, s.size), dtype=torch.int32,
                                 generator=gen) for s in slots}
    copies = {sid: v.clone() for sid, v in init.items()}
    plan = tlpf.plan_sync(msgs, p, attrs, scratch)
    want_method = {"direct_sum": "direct", "seq": "seq"}.get(method, method)
    assert plan.method == want_method

    store = tlpf.ValueStore(dict(init), p)
    finish = tlpf.begin_plan(plan, store, msgs, attrs, scratch=scratch)
    for s in slots:
        if method == "valiant" and s is scratch:
            continue          # phase 1 lands in the start half, by design
        assert s.sid not in store.written, s
    finish()
    # the values the caller holds never change
    for sid, v in init.items():
        assert torch.equal(v, copies[sid])
    ref = tlpf.ValueStore(dict(copies), p)
    tlpf.execute_plan(plan, ref, msgs, attrs, "x", scratch=scratch)
    for s in slots:
        assert torch.equal(store.value(s), ref.value(s))
    # and the simulator agrees on the destination (valiant's scratch is
    # its own business)
    if method != "seq":
        sim = tlpf.simulate_program(
            [(msgs, attrs)], {sid: v.numpy() for sid, v in copies.items()})
        assert (store.value(slots[1]).numpy() == sim[slots[1].sid]).all()


def test_registry_views_keep_the_pre_superstep_state():
    """A view of a slot taken before an overlap group still shows the
    group-entry state after it (the store is functional)."""
    ctx = tlpf.LPFContext(4, device="cpu")
    ctx.resize_memory_register(3)
    ctx.resize_message_queue(16)
    a = ctx.register_global("a", torch.arange(16).reshape(4, 4))
    b = ctx.register_global("b", torch.zeros(4, 4, dtype=torch.int64))
    c = ctx.register_global("c", torch.zeros(4, 4, dtype=torch.int64))
    va, vb = ctx.value(a)[:, 1:3], ctx.value(b)
    with ctx.program("views"):
        ctx.put(a, b, to=lambda s: (s + 1) % 4)
        ctx.sync(label="ab")
        ctx.put(a, c, to=lambda s: (s + 3) % 4)
        ctx.sync(tlpf.SyncAttributes(no_conflict=True), label="ac")
    assert torch.equal(va, torch.arange(16).reshape(4, 4)[:, 1:3])
    assert torch.equal(vb, torch.zeros(4, 4, dtype=torch.int64))
    assert torch.equal(ctx.value(b), torch.arange(16).reshape(4, 4).roll(1, 0))
    assert torch.equal(ctx.value(c), torch.arange(16).reshape(4, 4).roll(-1, 0))
    (grp,) = ctx.last_program.groups()
    assert len(grp) == 2
    assert ctx.ledger.records[-1].method == "overlap[direct+direct]"


# ---------------------------------------------------------------------------
# overlap groups: the DDP bucket chain, and random traces
# ---------------------------------------------------------------------------

def test_ddp_bucket_chain_overlaps_as_in_jax():
    steps = toe._rs_ag_trace(4, 3)
    tsteps = to_port(steps)
    jp = jprog.optimize_program(steps, 4, JM)
    tp = tprog.optimize_program(tsteps, 4, TM)
    assert tp.overlap_groups == jp.overlap_groups == ((0, 1, 2), (3, 4, 5))
    assert [s.plan.method for s in tp.steps] == \
        ["fused_rs"] * 3 + ["fused_ag"] * 3
    assert (tp.n_overlapped, tp.n_merged, tp.n_hoisted) == \
        (jp.n_overlapped, jp.n_merged, jp.n_hoisted)
    peep = tprog.optimize_program(tsteps, 4, TM, search=False)
    assert peep.overlap_groups == ((0,), (1, 2), (3, 4), (5,))
    assert tp.predicted_seconds(TM) < peep.predicted_seconds(TM)
    # executed split-phase: the two group entries, bit-equal to the
    # simulator
    values = toe.initial_values(
        sorted({m.src_slot for st in steps for m in st.msgs}
               | {m.dst_slot for st in steps for m in st.msgs},
               key=lambda s: s.sid), 4, 3)
    store = tlpf.ValueStore({sid: torch.from_numpy(v.copy())
                             for sid, v in values.items()}, 4)
    order = tprog.canonical_order(tsteps)
    costs = tlpf.execute_schedule(tp.materialize(tsteps, order=order),
                                  tp.groups(), store)
    assert [c.method for c in costs] == \
        ["overlap[fused_rs+fused_rs+fused_rs]",
         "overlap[fused_ag+fused_ag+fused_ag]"]
    want = jlpf.simulate_program([(s.msgs, s.attrs) for s in steps],
                                 values)
    for sid in want:
        got = store.value(slot(sid, 0))
        assert (got.numpy() == want[sid]).all()


@pytest.mark.parametrize("seed", range(60))
def test_overlap_groups_commute_bit_for_bit(seed):
    """The JAX test's random traces: each overlap group executed through
    the port's split-phase executor, its members' starts and finishes in
    reversed order too, leaves every slot bit-equal to recorded-order
    simulation; the groups and predicted seconds equal the JAX
    package's."""
    p, slots, steps = toe.random_program(seed)
    tsteps = to_port(steps)
    jp = jprog.optimize_program(steps, p, JM)
    tp = tprog.optimize_program(tsteps, p, TM)
    assert tp.groups() == jp.groups()
    assert tp.predicted_seconds(TM) == jp.predicted_seconds(JM)
    values = toe.initial_values(slots, p, seed)
    eager = jlpf.simulate_program([(s.msgs, s.attrs) for s in steps],
                                  values)
    entries = tp.materialize(tsteps, order=tprog.canonical_order(tsteps))
    for reverse in (False, True):
        groups = [tuple(reversed(g)) if reverse else g for g in tp.groups()]
        store = tlpf.ValueStore({sid: torch.from_numpy(v.copy())
                                 for sid, v in values.items()}, p)
        tlpf.execute_schedule(entries, groups, store)
        for sid in eager:
            got = store.value(slot(sid, 0))
            assert (got.numpy() == eager[sid]).all(), (sid, reverse)


@pytest.mark.parametrize("seed", range(60))
def test_overlap_never_regresses_predicted_schedule(seed):
    p, slots, steps = toe.random_program(seed)
    tsteps = to_port(steps)
    prog = tprog.optimize_program(tsteps, p, TM)
    raw = sum(tlpf.plan_sync(list(s.msgs), p, s.attrs).cost
              .predicted_seconds(TM) for s in tsteps)
    assert prog.predicted_seconds(TM) <= raw + 1e-15
    for grp in prog.groups():
        if len(grp) < 2:
            continue
        costs = [prog.steps[i].plan.cost for i in grp]
        assert tlpf.overlap_cost(costs).predicted_seconds(TM) < \
            sum(c.predicted_seconds(TM) for c in costs)
        for i in grp:
            assert prog.steps[i].plan.method in tlpf.OVERLAPPABLE_METHODS
