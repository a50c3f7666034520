"""Parity of the PyTorch port's LPF core (``repro_torch.core``) with the
JAX reference (``repro.core``) on the CPU.

The same seeded numpy message tables and slot data go to both packages:
plans, plan signatures, plan-cache counters, dependency cones, executed
slot values (bit for bit) and ledgers must agree exactly.  JAX runs on the
8-device CPU mesh; the port runs p = 8 virtual processes with
``device="cpu"``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import core as jlpf
from repro_torch import core as tlpf
from repro_torch.interop import hardware_from_fields, msgs_from_table

DTYPES = ["float32", "int32", "float64", "complex64"]


# ---------------------------------------------------------------------------
# seeded message tables, built once as rows and handed to both packages
# ---------------------------------------------------------------------------

def random_rows(seed, p=None, n_slots=None, max_msgs=16):
    """A random legal h-relation as plain rows + slot table."""
    rng = np.random.default_rng(seed)
    p = int(rng.integers(2, 9)) if p is None else p
    dtype = str(rng.choice(DTYPES))
    n_slots = int(rng.integers(1, 4)) if n_slots is None else n_slots
    slots = {100 + i: (int(rng.integers(8, 33)), "global")
             for i in range(n_slots)}
    sids = sorted(slots)
    rows = []
    for _ in range(int(rng.integers(1, max_msgs))):
        a, b = (sids[int(rng.integers(len(sids)))] for _ in range(2))
        size = int(rng.integers(1, min(slots[a][0], slots[b][0]) + 1))
        rows.append((int(rng.integers(p)), int(rng.integers(p)), a,
                     int(rng.integers(slots[a][0] - size + 1)), b,
                     int(rng.integers(slots[b][0] - size + 1)), size, dtype))
    return p, rows, slots


def canonical_rows(kind, p, w=3, dtype="float32"):
    """The planner's fused patterns (and a Bruck-shaped relation)."""
    slots = {1: (p * w, "global"), 2: (p * w, "global")}
    if kind == "total_exchange":
        rows = [(s, d, 1, d * w, 2, s * w, w, dtype)
                for s in range(p) for d in range(p)]
    elif kind == "allgather":
        rows = [(s, d, 1, 0, 2, s * w, w, dtype)
                for s in range(p) for d in range(p)]
    elif kind == "allgather_ex":
        rows = [(s, d, 1, 0, 2, s * w, w, dtype)
                for s in range(p) for d in range(p) if s != d]
    elif kind == "reduce_scatter":
        rows = [(s, d, 1, d * w, 2, 0, w, dtype)
                for s in range(p) for d in range(p)]
    elif kind == "scatter":
        rows = [(0, d, 1, d * w, 2, 0, w, dtype) for d in range(p)]
    elif kind == "gather":
        rows = [(s, 0, 1, 0, 2, s * w, w, dtype) for s in range(p)]
    elif kind == "shift":
        rows = [(s, (s + 1) % p, 1, 0, 2, 0, w, dtype) for s in range(p)]
    elif kind == "bruck":
        slots = {1: (p * p, "global"), 2: (p * p, "global")}
        rows = [(s, d, 1, d, 2, s, 1, dtype)
                for s in range(p) for d in range(p) if s != d]
    else:
        raise ValueError(kind)
    return rows, slots


def jax_msgs(rows, slots):
    made = {}

    def slot(sid, dt):
        if sid not in made:
            size, kind = slots[sid]
            made[sid] = jlpf.Slot(sid=sid, name=f"s{sid}", size=size,
                                  dtype=np.dtype(dt), kind=kind,
                                  orig_shape=(size,))
        return made[sid]

    return [jlpf.Msg(s, d, slot(a, dt), so, slot(b, dt), do, n)
            for s, d, a, so, b, do, n, dt in rows]


def jax_attrs(**kw):
    if kw.get("compress"):
        kw["compress"] = jlpf.CompressSpec()
    return jlpf.SyncAttributes(**kw)


def torch_attrs(**kw):
    if kw.get("compress"):
        kw["compress"] = tlpf.CompressSpec()
    return tlpf.SyncAttributes(**kw)


def plan_both(rows, slots, p, scratch=0, **attrs):
    """(jax outcome, port outcome): the plan as a plain dict, or the
    name of the exception class."""
    out = []
    name = rows[0][7] if rows else "float32"
    for lpf, msgs, mk_attrs, dt in (
            (jlpf, jax_msgs(rows, slots), jax_attrs, np.dtype(name)),
            (tlpf, msgs_from_table(rows, slots), torch_attrs,
             tlpf.memslot.as_torch_dtype(name))):
        sc = lpf.Slot(sid=999, name="scratch", size=scratch, dtype=dt,
                      kind="global", orig_shape=(scratch,)) \
            if scratch else None
        try:
            plan = lpf.plan_sync(msgs, p, mk_attrs(**attrs), sc)
            out.append(dataclasses.asdict(plan))
        except Exception as e:  # both packages must refuse alike
            out.append(type(e).__name__)
    return out


ATTR_VARIANTS = [
    {},
    {"method": "direct"},
    {"method": "direct", "no_conflict": True},
    {"reduce_op": "sum"},
    {"reduce_op": "max", "method": "direct"},
    {"compress": True},
    {"method": "bruck"},
    {"method": "valiant"},
]


@pytest.mark.parametrize("seed", range(24))
def test_planner_parity_random_tables(seed):
    p, rows, slots = random_rows(seed)
    for attrs in ATTR_VARIANTS:
        scratch = 256 if attrs.get("method") == "valiant" else 0
        j, t = plan_both(rows, slots, p, scratch=scratch, **attrs)
        assert j == t, (seed, attrs)


@pytest.mark.parametrize("kind", ["total_exchange", "allgather",
                                  "allgather_ex", "reduce_scatter",
                                  "scatter", "gather", "shift", "bruck"])
@pytest.mark.parametrize("p", [1, 4, 8])
def test_planner_parity_canonical_patterns(kind, p):
    rows, slots = canonical_rows(kind, p)
    for attrs in ATTR_VARIANTS:
        j, t = plan_both(rows, slots, p, **attrs)
        assert j == t, (kind, p, attrs)
    if kind in ("total_exchange", "allgather", "scatter") and p > 1:
        j, _ = plan_both(rows, slots, p)
        assert j["method"].startswith("fused")


def _norm_sig(sig):
    comp = sig[4]
    return sig[:4] + (None if comp is None else dataclasses.astuple(comp),) \
        + sig[5:]


@pytest.mark.parametrize("seed", range(8))
def test_signature_cache_and_conflicts_parity(seed):
    """plan_signature, PlanCache counters and find_conflict agree; the
    same pattern through renamed slots hits the cache in both."""
    p, rows, slots = random_rows(seed)
    renamed = [(s, d, a + 50, so, b + 50, do, n, dt)
               for s, d, a, so, b, do, n, dt in rows]
    slots2 = {k + 50: v for k, v in slots.items()}
    jm, tm = jax_msgs(rows, slots), msgs_from_table(rows, slots)
    for attrs in ({}, {"method": "direct", "no_conflict": True},
                  {"compress": True}):
        assert _norm_sig(jlpf.plan_signature(jm, p, jax_attrs(**attrs))) \
            == _norm_sig(tlpf.plan_signature(tm, p, torch_attrs(**attrs)))
    jc, tc = jlpf.PlanCache(), tlpf.PlanCache()
    for rs, sl in ((rows, slots), (renamed, slots2), (rows, slots)):
        jc.get_or_plan(jax_msgs(rs, sl), p, jlpf.SyncAttributes())
        tc.get_or_plan(msgs_from_table(rs, sl), p, tlpf.SyncAttributes())
    assert dataclasses.asdict(jc.stats) == dataclasses.asdict(tc.stats)
    assert (tc.stats.hits, tc.stats.misses) == (2, 1)
    jf, tf = jlpf.find_conflict(jm), tlpf.find_conflict(tm)
    assert (jf is None) == (tf is None)
    if jf is not None:
        assert (jm.index(jf[0]), jm.index(jf[1])) == \
            (tm.index(tf[0]), tm.index(tf[1]))
    assert jlpf.conflict_free(jm) == tlpf.conflict_free(tm)


@pytest.mark.parametrize("seed", range(6))
def test_dependency_cone_parity(seed):
    """Random traces over shared slots: the dataflow-precise flush set
    of every slot, for reads and writes, is the reference's."""
    rng = np.random.default_rng(1000 + seed)
    p, _, slots = random_rows(seed, p=4, n_slots=4)
    jsteps, tsteps = [], []
    for i in range(6):
        _, rows, _ = random_rows(int(rng.integers(1 << 30)), p=4,
                                 n_slots=4, max_msgs=5)
        # re-home the random messages onto this trace's slots
        rows = [(s, d, a, so, b, do, n, "float32")
                for s, d, a, so, b, do, n, _ in rows
                if so + n <= slots[a][0] and do + n <= slots[b][0]]
        jsteps.append(jlpf.ProgramStep(tuple(jax_msgs(rows, slots)),
                                       jlpf.SyncAttributes(), f"s{i}"))
        tsteps.append(tlpf.ProgramStep(tuple(msgs_from_table(rows, slots)),
                                       tlpf.SyncAttributes(), f"s{i}"))
    for sid in slots:
        for reads in (False, True):
            assert jlpf.dependency_cone(jsteps, sid, reads) == \
                tlpf.dependency_cone(tsteps, sid, reads)


# ---------------------------------------------------------------------------
# executor parity: values bit for bit, ledgers exactly
# ---------------------------------------------------------------------------

EXEC_CASES = [
    ("random", 3, {}), ("random", 4, {"method": "direct"}),
    ("random", 5, {"no_conflict": True, "method": "direct"}),
    ("random", 6, {"reduce_op": "sum"}),
    ("random", 7, {"reduce_op": "max"}),
    ("random", 8, {"reduce_op": "min"}),
    ("random", 9, {}),
    ("total_exchange", 0, {}), ("shift", 0, {}),
]


def _exec_tables():
    out = []
    for kind, seed, attrs in EXEC_CASES:
        if kind == "random":
            _, rows, slots = random_rows(seed, p=8)
            rows = [r[:7] + ("float32",) for r in rows]
        else:
            rows, slots = canonical_rows(kind, 8, w=5)
        out.append((rows, slots, attrs))
    return out


def _slot_data(sid, size, p=8):
    """Integer-valued float32 data: sums/max/min are exact in both."""
    return (np.arange(p)[:, None] * 1000 + sid * 37
            + np.arange(size)[None, :]).astype(np.float32)


def test_executor_parity_values_and_ledger(mesh8):
    """One JAX program and one port program run every case as an eager
    superstep over its own slots; every destination value is bit-equal
    and the ledgers are equal field by field."""
    cases = _exec_tables()

    def run(lpf, ctx, data_of, mk_attrs):
        outs = []
        for i, (rows, slots, attrs) in enumerate(cases):
            ctx.resize_memory_register(ctx.registry.n_active + len(slots))
            ctx.resize_message_queue(len(rows))
            handles = {sid: ctx.register_global(f"c{i}.{sid}",
                                                data_of(sid, size))
                       for sid, (size, _) in slots.items()}
            ctx.put_msgs([(s, d, handles[a], so, handles[b], do, n)
                          for s, d, a, so, b, do, n, _ in rows])
            ctx.sync(mk_attrs(**attrs), label=f"case{i}")
            outs += [ctx.value(handles[sid]) for sid in sorted(slots)]
        return outs

    def jspmd(ctx, s, p, _):
        return tuple(run(jlpf, ctx, lambda sid, size: jnp.asarray(
            _slot_data(sid, size))[s], jax_attrs))

    n_out = sum(len(sl) for _, sl, _ in cases)
    jout, jled = jlpf.exec_(mesh8, jspmd, None,
                            out_specs=(P("x"),) * n_out, return_ledger=True)

    def tspmd(ctx, s, p, _):
        return run(tlpf, ctx, lambda sid, size: torch.from_numpy(
            _slot_data(sid, size)), torch_attrs)

    tout, tled = tlpf.exec_(8, tspmd, None, device="cpu",
                            return_ledger=True)
    for j, t in zip(jout, tout):
        np.testing.assert_array_equal(np.asarray(j).reshape(8, -1),
                                      t.numpy())
    assert [dataclasses.asdict(r) for r in jled.records] == \
        [dataclasses.asdict(r) for r in tled.records]


def test_seq_executor_parity_p1():
    """p == 1 (the LPF_ROOT context): ordered memcpys with CRCW and
    reduce_op combines, against the JAX root context."""
    rows = [(0, 0, 1, 0, 2, 2, 6, "float32"), (0, 0, 2, 1, 2, 0, 4,
                                               "float32"),
            (0, 0, 1, 4, 1, 0, 3, "float32")]
    slots = {1: (10, "global"), 2: (10, "global")}
    for attrs in ({}, {"reduce_op": "sum"}, {"reduce_op": "max"}):
        jctx, tctx = jlpf.LPFContext(()), tlpf.LPFContext(1, device="cpu")
        res = []
        for lpf, ctx, mk, wrap in (
                (jlpf, jctx, jax_attrs, lambda a: jnp.asarray(a[0])),
                (tlpf, tctx, torch_attrs, torch.from_numpy)):
            ctx.resize_memory_register(2)
            ctx.resize_message_queue(3)
            h = {sid: ctx.register_global(
                f"s{sid}", wrap(_slot_data(sid, size, p=1)))
                for sid, (size, _) in slots.items()}
            ctx.put_msgs([(s, d, h[a], so, h[b], do, n)
                          for s, d, a, so, b, do, n, _ in rows])
            cost = ctx.sync(mk(**attrs), label="seq")
            res.append(([np.asarray(ctx.value(h[s])).reshape(-1)
                         for s in (1, 2)], dataclasses.asdict(cost)))
        (jv, jc), (tv, tc) = res
        assert jc == tc and tc["method"] == "noop"
        for a, b in zip(jv, tv):
            np.testing.assert_array_equal(a, b)


def _quickstart_jax(ctx, s, p, args):
    ctx.resize_memory_register(2)
    ctx.resize_message_queue(p)
    a = ctx.register_global("a", jnp.arange(4.0) + 10 * ctx.pid)
    b = ctx.register_global("b", jnp.zeros(4))
    ctx.put(a, b, to=lambda s: (s + 1) % p)
    ctx.sync(label="shift")
    return ctx.value(b)


def _quickstart_port(ctx, s, p, args):
    ctx.resize_memory_register(2)
    ctx.resize_message_queue(p)
    a = ctx.register_global("a", torch.arange(4.0) + 10 * ctx.pid)
    b = ctx.register_global("b", ctx.replicate(torch.zeros(4)))
    ctx.put(a, b, to=lambda s: (s + 1) % p)
    ctx.sync(label="shift")
    return ctx.value(b)


def test_quickstart_parity(mesh8):
    """The README quickstart: bit-equal values and equal ledgers,
    priced alike on the same machine."""
    jout, jled = jlpf.exec_(mesh8, _quickstart_jax, None,
                            out_specs=P("x"), return_ledger=True)
    tout, tled = tlpf.exec_(8, _quickstart_port, None, device="cpu",
                            return_ledger=True)
    np.testing.assert_array_equal(np.asarray(jout),
                                  tout.numpy().reshape(-1))
    assert [dataclasses.asdict(r) for r in jled.records] == \
        [dataclasses.asdict(r) for r in tled.records]
    rec = tled.records[0]
    assert (rec.label, rec.method, rec.h_bytes, rec.n_msgs) == \
        ("shift", "direct", 16, 8)
    jm = jlpf.probe({"x": 8}, jlpf.TPU_V5E)
    tm = tlpf.probe({"x": 8},
                    hardware_from_fields(dataclasses.asdict(jlpf.TPU_V5E)))
    assert (jm.p, jm.g, jm.l, jm.r) == (tm.p, tm.g, tm.l, tm.r)
    assert jled.predicted_seconds(jm) == tled.predicted_seconds(tm)


def test_unported_methods_refuse_by_name():
    """Executor methods not ported yet raise naming the method; nothing
    is written."""
    ctx = tlpf.LPFContext(4, device="cpu")
    ctx.resize_memory_register(2)
    ctx.resize_message_queue(16)
    a = ctx.register_global("a", torch.ones(4, 12))
    b = ctx.register_global("b", torch.zeros(4, 12))
    ctx.put_msgs([(s, d, a, 0, b, s * 3, 3)
                  for s in range(4) for d in range(4)])
    with pytest.raises(tlpf.LPFFatalError, match="fused_ag"):
        ctx.sync()
    assert torch.equal(ctx.value(b), torch.zeros(4, 12))
    ctx._queue = []      # a fatal sync leaves its queue, as in the reference
    ctx.put(a, b, to=lambda s: (s + 1) % 4, size=3)
    with pytest.raises(tlpf.LPFFatalError, match="compressed wire"):
        ctx.sync(tlpf.SyncAttributes(compress=tlpf.CompressSpec()))
    assert not ctx.ledger.records


# ---------------------------------------------------------------------------
# the process-axis rule, registration and capacity errors
# ---------------------------------------------------------------------------

def test_process_axis_is_explicit():
    ctx = tlpf.LPFContext(4, device="cpu")
    ctx.resize_memory_register(3)
    with pytest.raises(tlpf.LPFFatalError, match="leading dimension"):
        ctx.register_global("shared", torch.zeros(6))    # no process axis
    s = ctx.register_global("shared", ctx.replicate(torch.arange(6.0)))
    assert s.size == 6 and s.orig_shape == (6,)
    assert torch.equal(ctx.value(s), torch.arange(6.0).expand(4, 6))
    m = ctx.register_global("mat", torch.zeros(4, 2, 3))
    assert (m.size, m.orig_shape) == (6, (2, 3))
    assert ctx.tensor(m).shape == (4, 2, 3)
    assert ctx.pid.shape == (4, 1)
    with pytest.raises(tlpf.LPFFatalError, match="leading dimension"):
        ctx.write(m, torch.ones(6))
    ctx.write(m, torch.ones(4, 6))
    assert torch.equal(ctx.value(m), torch.ones(4, 6))


def test_stale_handle_and_register_capacity():
    ctx = tlpf.LPFContext(2, device="cpu")
    ctx.resize_memory_register(1)
    a = ctx.register_global("a", torch.zeros(2, 3))
    with pytest.raises(tlpf.LPFCapacityError) as ei:
        ctx.register_global("b", torch.zeros(2, 3))
    assert (ei.value.kind, ei.value.required, ei.value.capacity) == \
        ("register", 2, 1)
    ctx.deregister(a)
    b = ctx.register_global("b", torch.zeros(2, 3))
    assert b.sid == a.sid
    with pytest.raises(tlpf.LPFFatalError, match="stale handle"):
        ctx.value(a)


def test_queue_capacity_error_is_side_effect_free():
    ctx = tlpf.LPFContext(4, device="cpu")
    ctx.resize_memory_register(2)
    ctx.resize_message_queue(3)
    a = ctx.register_global("a", torch.ones(4, 2))
    b = ctx.register_global("b", torch.zeros(4, 2))
    with pytest.raises(tlpf.LPFCapacityError) as ei:
        ctx.put(a, b, to=lambda s: (s + 1) % 4)
    assert (ei.value.kind, ei.value.required) == ("queue", 4)
    assert ctx._queue == []
    assert tlpf.classify(ei.value) == "mitigable"


def _capacity_body(lpf, wrap, attempts):
    def body(c):
        attempts.append((c.registry.capacity, c._queue_capacity))
        a = c.register_global("a", wrap(np.ones((c.p, 4), np.float32)))
        b = c.register_global("b", wrap(np.zeros((c.p, 4), np.float32)))
        c.put(a, b, to=lambda s: (s + 1) % c.p)
        c.sync(label="retry")
        out = np.asarray(c.value(b))
        c.deregister(a)
        c.deregister(b)
        return out
    return body


def test_with_capacity_parity():
    """Resize-and-retry grows register then queue in the same steps as
    the reference's root context, and the retried region runs once."""
    jctx, tctx = jlpf.LPFContext(()), tlpf.LPFContext(1, device="cpu")
    ja, ta = [], []
    jout = jctx.with_capacity(_capacity_body(
        jlpf, lambda a: jnp.asarray(a[0]), ja), max_attempts=5)
    tout = tctx.with_capacity(_capacity_body(
        tlpf, torch.from_numpy, ta), max_attempts=5)
    assert ja == ta and len(ta) > 1
    np.testing.assert_array_equal(np.asarray(jout).reshape(-1),
                                  tout.reshape(-1))
    assert [r.label for r in tctx.ledger.records] == ["retry"]
    with pytest.raises(tlpf.LPFCapacityError):
        tlpf.LPFContext(1, device="cpu").with_capacity(
            _capacity_body(tlpf, torch.from_numpy, []), max_attempts=1)


def test_program_abort_discards_recorded_supersteps():
    """An exception inside ``ctx.program()`` discards the level's
    recorded supersteps: nothing executes, nothing is ledgered."""
    ctx = tlpf.LPFContext(4, device="cpu")
    ctx.resize_memory_register(2)
    ctx.resize_message_queue(6)
    a = ctx.register_global("a", torch.ones(4, 2))
    b = ctx.register_global("b", torch.zeros(4, 2))
    with pytest.raises(tlpf.LPFCapacityError):
        with ctx.program("abort"):
            ctx.put(a, b, to=lambda s: (s + 1) % 4)
            ctx.sync()
            ctx.put(a, b, to=lambda s: (s + 2) % 4)
            ctx.put(a, b, to=lambda s: (s + 3) % 4)   # 8 > 6: capacity
    assert ctx._rec_pending == [] and ctx._rec_depth == 0
    assert ctx.ledger.records == []
    assert torch.equal(ctx.value(b), torch.zeros(4, 2))

    # through with_capacity: the retry runs the whole region once
    def region(c):
        with c.program("retry"):
            c.put(a, b, to=lambda s: (s + 1) % 4)
            c.sync(label="one")
            c.put(a, b, to=lambda s: (s + 2) % 4, dst_off=1, size=1)
            c.put(a, b, to=lambda s: (s + 3) % 4, dst_off=0, size=1)
            c.sync(label="two")
        return c.value(b)

    ctx.resize_message_queue(6)
    ctx.with_capacity(region)
    assert [r.label for r in ctx.ledger.records] == ["one", "two"]


def test_cone_flush_keeps_independent_supersteps_recorded():
    ctx = tlpf.LPFContext(4, device="cpu")
    ctx.resize_memory_register(4)
    ctx.resize_message_queue(8)
    a = ctx.register_global("a", torch.arange(8.0).reshape(4, 2))
    b = ctx.register_global("b", torch.zeros(4, 2))
    c = ctx.register_global("c", torch.arange(8.0).reshape(4, 2) + 100)
    d = ctx.register_global("d", torch.zeros(4, 2))
    with ctx.program("cone"):
        ctx.put(a, b, to=lambda s: (s + 1) % 4)
        ctx.sync(label="ab")
        ctx.put(c, d, to=lambda s: (s + 1) % 4)
        ctx.sync(label="cd")
        vb = ctx.value(b)                        # flushes only "ab"
        assert [r.label for r in ctx.ledger.records] == ["ab"]
        ctx.deregister(c)                        # deferred: "cd" reads c
        assert ctx.registry.is_registered(c)
    assert [r.label for r in ctx.ledger.records] == ["ab", "cd"]
    assert not ctx.registry.is_registered(c)
    assert torch.equal(vb, torch.arange(8.0).reshape(4, 2).roll(1, 0))
    assert torch.equal(ctx.value(d),
                       (torch.arange(8.0).reshape(4, 2) + 100).roll(1, 0))


def test_rehook_holds_parent():
    ctx = tlpf.LPFContext(2, device="cpu")
    seen = []

    def sub(c, s, p, _):
        with pytest.raises(tlpf.LPFFatalError, match="on hold"):
            ctx.sync()
        seen.append((p, c.device))
        return c.pid.reshape(-1).tolist()

    assert tlpf.rehook(ctx, sub) == [0, 1]
    assert seen == [(2, ctx.device)] and not ctx._on_hold


# ---------------------------------------------------------------------------
# errors and machine models
# ---------------------------------------------------------------------------

def test_error_codes_and_classify_parity():
    cases = [lambda m: m.LPFCapacityError("x"), lambda m: m.LPFFatalError("x"),
             lambda m: m.LPFTransientError("x"),
             lambda m: m.LPFAnalysisError("x"), lambda m: m.InjectedFault("x"),
             lambda m: OSError("x"), lambda m: TimeoutError("x"),
             lambda m: ValueError("x")]
    for mk in cases:
        je, te = mk(jlpf), mk(tlpf)
        assert jlpf.classify(je) == tlpf.classify(te)
        assert getattr(je, "code", None) == getattr(te, "code", None)
    assert (jlpf.LPF_SUCCESS, jlpf.LPF_ERR_OUT_OF_MEMORY, jlpf.LPF_ERR_FATAL,
            jlpf.LPF_ERR_TRANSIENT) == (
        tlpf.LPF_SUCCESS, tlpf.LPF_ERR_OUT_OF_MEMORY, tlpf.LPF_ERR_FATAL,
        tlpf.LPF_ERR_TRANSIENT)


def test_machine_models():
    fields = dataclasses.asdict(jlpf.TPU_V5E)
    hw = hardware_from_fields(fields)
    assert dataclasses.asdict(hw) == fields
    for axes in ({"x": 8}, {"pod": 2, "data": 4}, {}):
        jm, tm = jlpf.probe(axes, jlpf.TPU_V5E), tlpf.probe(axes, hw)
        assert (jm.p, jm.g, jm.l, jm.r) == (tm.p, tm.g, tm.l, tm.r)
        assert jm.normalised() == tm.normalised()
    h = tlpf.H100_SXM
    assert (h.peak_flops_bf16, h.hbm_bw, h.hbm_bytes, h.vmem_bytes) == \
        (989e12, 3.35e12, 80e9, 232448)
    m = tlpf.LPFContext(8, device="cpu").probe()
    assert m.p == 8 and m.hardware is h and m.g > 0 and m.l > 0
    cost = tlpf.SuperstepCost("x", 10, 10, 80, 1, 8, "direct")
    assert cost.predicted_seconds(m) == 10 * m.g + m.l


def test_capacity_seam_injects_a_mitigable_error():
    """An injector armed at the ``capacity`` seam raises the same
    mitigable error as a real overflow; ``with_capacity`` absorbs it."""
    from repro_torch.core import faultpoints

    class Once:
        fired = 0

        def fire(self, seam, **info):
            if seam == "capacity" and not self.fired:
                self.fired += 1
                raise tlpf.LPFCapacityError(
                    "injected", required=info["staged"] + info["new"],
                    capacity=info["capacity"], kind="queue")

    prev = faultpoints._install(Once())
    try:
        ctx = tlpf.LPFContext(2, device="cpu")
        ctx.resize_memory_register(2)
        ctx.resize_message_queue(2)
        a = ctx.register_global("a", torch.ones(2, 3))
        b = ctx.register_global("b", torch.zeros(2, 3))

        def body(c):
            c.put(a, b, to=lambda s: 1 - s)
            c.sync(label="after-injection")
            return c.value(b)

        assert torch.equal(ctx.with_capacity(body), torch.ones(2, 3))
        assert [r.label for r in ctx.ledger.records] == ["after-injection"]
    finally:
        faultpoints._install(prev)
