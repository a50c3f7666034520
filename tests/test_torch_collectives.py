"""Parity of the port's executor methods and BSP collectives
(``repro_torch.core.sync``, ``repro_torch.bsp``) with the JAX package on
the CPU.

The same seeded numpy data goes to both packages: JAX on the 8-device CPU
mesh, the port over p = 8 virtual processes with ``device="cpu"``.  Values
are bit-equal on integer-valued data and on the int8 wire (both quantise
in the same order of operations); float sums, which run in another order,
agree within 1e-6 relative.  Ledgers are equal field by field.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import bsp as jbsp
from repro import core as jlpf
from repro_torch import bsp as tbsp
from repro_torch import core as tlpf
from repro_torch.interop import hardware_from_fields

P8 = 8


def ledger_rows(ledger):
    return [dataclasses.asdict(r) for r in ledger.records]


def run_jax(mesh8, spmd, n_out):
    """``spmd(ctx, s, p) -> tuple of n_out per-process arrays`` on the
    mesh; returns ([p, ...] numpy arrays, ledger)."""
    outs, led = jlpf.exec_(mesh8, lambda ctx, s, p, _: spmd(ctx, s, p),
                           None, out_specs=(P("x"),) * n_out,
                           return_ledger=True)
    return [np.asarray(o).reshape(P8, -1) for o in outs], led


def run_port(spmd):
    outs, led = tlpf.exec_(P8, lambda ctx, s, p, _: spmd(ctx, s, p),
                           None, device="cpu", return_ledger=True)
    return [o.reshape(P8, -1).numpy() for o in outs], led


def assert_same(j, t, exact=True, rtol=0.0, atol=0.0):
    jv, jled = j
    tv, tled = t
    assert ledger_rows(jled) == ledger_rows(tled)
    for a, b in zip(jv, tv):
        if exact:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# one superstep, per executor method
# ---------------------------------------------------------------------------

def int_data(sid, size, p=P8):
    """Integer-valued float32 slot data: sums, maxes and mins are exact."""
    return (np.arange(p)[:, None] * 1000 + sid * 37
            + np.arange(size)[None, :]).astype(np.float32)


def normal_data(sid, size, p=P8):
    rng = np.random.default_rng(sid)
    return (rng.standard_normal((p, size))
            * (1.0 + np.arange(p))[:, None]).astype(np.float32)


def table_case(kind, p=P8, w=5):
    """(rows, slot sizes) of one superstep: rows are (src, dst, src_sid,
    src_off, dst_sid, dst_off, size)."""
    big = {1: p * w + 7, 2: p * w + 3}
    if kind == "allgather":
        return [(s, d, 1, 0, 2, s * w, w)
                for s in range(p) for d in range(p)], big
    if kind == "allgather_ex":
        return [(s, d, 1, 0, 2, s * w, w)
                for s in range(p) for d in range(p) if s != d], big
    if kind == "allgather_offs":
        return [(s, d, 1, (3 * s) % 7, 2, s * w, w)
                for s in range(p) for d in range(p)], big
    if kind == "reduce_scatter":
        return [(s, d, 1, d * w, 2, d % 3, w)
                for s in range(p) for d in range(p)], big
    if kind == "scatter":
        return [(0, d, 1, d * w, 2, (2 * d) % 5, w) for d in range(p)], big
    if kind == "scatter_ex":
        return [(5, d, 1, d * w, 2, 1, w) for d in range(p) if d != 5], big
    if kind == "gather":
        return [(s, 3, 1, s % 4, 2, s * w, w) for s in range(p)], big
    if kind == "gather_ex":
        return [(s, 6, 1, 2, 2, s * w, w) for s in range(p) if s != 6], big
    if kind == "total_exchange":
        return [(s, d, 1, d * w, 2, s * w, w)
                for s in range(p) for d in range(p)], big
    if kind == "bruck":
        return [(s, d, 1, (d * 3) % 11, 2, (s * 2) % 9, 1 + (s + d) % 3)
                for s in range(p) for d in range(p) if s != d], \
            {1: 16, 2: 16}
    if kind == "shift":
        # mixed sizes: the wire's windows run past the source's end
        return [(s, (s + 3) % p, 1, 12 - s % 3 - s % 2, 2, 7 - s % 3,
                 4 + s % 3) for s in range(p)], {1: 16, 2: 16}
    raise ValueError(kind)


METHOD_CASES = [
    # (id, table, attrs, data, expected method)
    ("fused_ag", "allgather", {}, int_data, "fused_ag"),
    ("fused_ag_exclude_self", "allgather_ex", {}, int_data, "fused_ag"),
    ("fused_ag_source_offsets", "allgather_offs", {}, int_data, "fused_ag"),
    ("fused_rs_sum", "reduce_scatter", {"reduce_op": "sum"}, int_data,
     "fused_rs"),
    ("fused_rs_max", "reduce_scatter", {"reduce_op": "max"}, normal_data,
     "fused_rs"),
    ("fused_rs_min", "reduce_scatter", {"reduce_op": "min"}, normal_data,
     "fused_rs"),
    ("fused_scatter_root0", "scatter", {}, int_data, "fused_scatter"),
    ("fused_scatter_root5", "scatter_ex", {}, int_data, "fused_scatter"),
    ("fused_gather_self", "gather", {}, int_data, "fused_gather"),
    ("fused_gather_no_self", "gather_ex", {}, int_data, "fused_gather"),
    ("bruck", "bruck", {"method": "bruck"}, int_data, "bruck"),
    ("valiant", "total_exchange", {"method": "valiant"}, int_data,
     "valiant"),
    ("compressed_direct", "shift", {"compress": True}, normal_data,
     "direct"),
    ("compressed_fused", "total_exchange", {"compress": True}, normal_data,
     "fused"),
    ("compressed_fused_ag", "allgather_ex", {"compress": True},
     normal_data, "fused_ag"),
    ("compressed_valiant", "bruck", {"method": "valiant",
                                     "compress": True}, normal_data,
     "valiant"),
]


def one_superstep(lpf, wrap, rows, slots, attrs, data, scratch=0):
    """An spmd function running one superstep over fresh slots; returns
    the slots' values after it."""
    kw = dict(attrs)
    if kw.get("compress"):
        kw["compress"] = lpf.CompressSpec()

    def spmd(ctx, s, p):
        ctx.resize_message_queue(len(rows), valiant_payload=scratch)
        ctx.resize_memory_register(len(slots))
        h = {sid: ctx.register_global(f"s{sid}", wrap(data(sid, size), s))
             for sid, size in sorted(slots.items())}
        ctx.put_msgs([(a, b, h[x], xo, h[y], yo, n)
                      for a, b, x, xo, y, yo, n in rows])
        ctx.sync(lpf.SyncAttributes(**kw), label="case")
        return tuple(ctx.value(h[sid]) for sid in sorted(slots))

    return spmd


def both_one_superstep(mesh8, rows, slots, attrs, data, scratch=0):
    j = run_jax(mesh8, one_superstep(
        jlpf, lambda a, s: jnp.asarray(a)[s], rows, slots, attrs, data,
        scratch), len(slots))
    t = run_port(one_superstep(
        tlpf, lambda a, s: torch.from_numpy(a), rows, slots, attrs, data,
        scratch))
    return j, t


@pytest.mark.parametrize("case", METHOD_CASES, ids=[c[0] for c in METHOD_CASES])
def test_executor_method_parity(mesh8, case):
    _, kind, attrs, data, method = case
    rows, slots = table_case(kind)
    scratch = 256 if attrs.get("method") == "valiant" else 0
    j, t = both_one_superstep(mesh8, rows, slots, attrs, data, scratch)
    assert [r["method"] for r in ledger_rows(t[1])] == [method]
    assert_same(j, t)


def random_table(seed, unique_pairs):
    """A random legal one-slot-pair table (unique (src, dst) pairs for
    Bruck), over slots of 24 and 20 elements."""
    rng = np.random.default_rng(seed)
    rows, seen = [], set()
    for _ in range(int(rng.integers(4, 40))):
        s, d = int(rng.integers(P8)), int(rng.integers(P8))
        if unique_pairs and (s, d) in seen:
            continue
        seen.add((s, d))
        n = int(rng.integers(1, 9))
        rows.append((s, d, 1, int(rng.integers(24 - n + 1)), 2,
                     int(rng.integers(20 - n + 1)), n))
    return rows, {1: 24, 2: 20}


@pytest.mark.parametrize("seed", range(6))
def test_bruck_random_tables(mesh8, seed):
    rows, slots = random_table(seed, unique_pairs=True)
    j, t = both_one_superstep(mesh8, rows, slots, {"method": "bruck"},
                              int_data)
    assert ledger_rows(t[1])[0]["method"] == "bruck"
    assert_same(j, t)


@pytest.mark.parametrize("seed", range(6))
def test_valiant_random_tables(mesh8, seed):
    rows, slots = random_table(100 + seed, unique_pairs=False)
    j, t = both_one_superstep(mesh8, rows, slots, {"method": "valiant"},
                              int_data, scratch=512)
    assert ledger_rows(t[1])[0]["method"] == "valiant"
    assert_same(j, t)


def test_executed_methods_are_every_planned_method():
    """Every method the planner returns over the canonical patterns and
    the forced methods executes; the executor names no other."""
    seen = set()
    for kind in ("allgather", "allgather_ex", "reduce_scatter", "scatter",
                 "gather", "total_exchange", "bruck", "shift"):
        rows, slots = table_case(kind)
        made = {sid: tlpf.Slot(sid, f"s{sid}", size, torch.float32,
                               "global", (size,))
                for sid, size in slots.items()}
        msgs = [tlpf.Msg(a, b, made[x], xo, made[y], yo, n)
                for a, b, x, xo, y, yo, n in rows]
        scratch = tlpf.Slot(99, "scratch", 4096, torch.float32, "global",
                            (4096,))
        for attrs in ({}, {"reduce_op": "sum"}, {"method": "direct"},
                      {"method": "bruck"}, {"method": "valiant"}):
            try:
                plan = tlpf.plan_sync(msgs, P8, tlpf.SyncAttributes(**attrs),
                                      scratch)
            except tlpf.LPFFatalError:
                continue
            seen.add(plan.method)
    one = tlpf.Msg(0, 0, made[1], 0, made[2], 0, 1)
    seen.add(tlpf.plan_sync([one], 1, tlpf.SyncAttributes()).method)
    seen.add(tlpf.plan_sync([], P8, tlpf.SyncAttributes()).method)
    assert seen == set(tlpf.EXECUTED_METHODS)


# ---------------------------------------------------------------------------
# the Valiant scratch slot
# ---------------------------------------------------------------------------

def test_valiant_refused_without_scratch(mesh8):
    """Without a provisioned scratch slot ``method="valiant"`` raises the
    same LPFFatalError in both packages, before anything is written."""
    rows, slots = table_case("total_exchange")
    msgs = []
    for lpf, wrap in ((jlpf, lambda a, s: jnp.asarray(a)[s]),
                      (tlpf, lambda a, s: torch.from_numpy(a))):
        spmd = one_superstep(lpf, wrap, rows, slots, {"method": "valiant"},
                             int_data)
        with pytest.raises(lpf.LPFFatalError) as ei:
            if lpf is jlpf:
                run_jax(mesh8, spmd, len(slots))
            else:
                run_port(spmd)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] and "scratch" in msgs[1]


def reprovision_trace(lpf, wrap, s):
    """A recorded valiant superstep, then a larger scratch provisioned
    while it is pending: the trace runs against the old slot first."""
    def spmd(ctx, s, p):
        ctx.resize_message_queue(p, valiant_payload=8)
        ctx.resize_memory_register(2)
        a = ctx.register_global("a", wrap(int_data(1, 4), s))
        b = ctx.register_global("b", wrap(int_data(2, 4) * 0, s))
        old = ctx._scratch
        with ctx.program("t"):
            ctx.put(a, b, to=lambda q: (q + 3) % p, size=4)
            ctx.sync(lpf.SyncAttributes(method="valiant"), label="v")
            pending = len(ctx._rec_pending)
            ctx.resize_message_queue(p, valiant_payload=64)
            flushed = len(ctx._rec_pending)
            assert ctx._scratch.size == 64
            assert not ctx.registry.is_registered(old)
        assert (pending, flushed, ctx.registry.n_active) == (1, 0, 3)
        assert ctx.registry.capacity == 3
        return (ctx.value(b),)
    return spmd


def test_reprovisioning_flushes_a_pending_trace(mesh8):
    j = run_jax(mesh8, reprovision_trace(
        jlpf, lambda a, s: jnp.asarray(a)[s], None), 1)
    t = run_port(reprovision_trace(tlpf, lambda a, s: torch.from_numpy(a),
                                   None))
    assert_same(j, t)
    want = int_data(1, 4)[(np.arange(P8) - 3) % P8]
    np.testing.assert_array_equal(t[0][0], want)


# ---------------------------------------------------------------------------
# the collectives (tests/test_collectives.py, against the JAX package)
# ---------------------------------------------------------------------------

def both(mesh8, jspmd, tspmd, n_out):
    return run_jax(mesh8, jspmd, n_out), run_port(tspmd)


def pid_f(ctx, lpf):
    return ctx.pid.astype(jnp.float32) if lpf is jlpf \
        else ctx.pid.to(torch.float32)


def test_collectives_suite(mesh8):
    def make(lpf, bsp, xp):
        def spmd(ctx, s, p):
            pid = pid_f(ctx, lpf)
            ar = bsp.allreduce(ctx, xp.arange(10.0) + 100.0 * pid)
            bc = bsp.broadcast(ctx, xp.arange(7.0) + 100.0 * pid, root=3)
            ag = bsp.allgather(ctx, xp.ones(2) * pid)
            sc = bsp.exscan(ctx, xp.ones(3) * (pid + 1))
            a2a = bsp.alltoall(ctx, xp.arange(8.0) + 10.0 * pid)
            return ar, bc, ag, sc, a2a
        return spmd

    j, t = both(mesh8, make(jlpf, jbsp, jnp), make(tlpf, tbsp, torch), 5)
    assert_same(j, t)
    ar, bc, ag, sc, a2a = t[0]
    np.testing.assert_allclose(ar[4], np.arange(10.0) * 8 + 100.0 * 28)
    np.testing.assert_allclose(bc, np.tile(np.arange(7.0) + 300.0, (8, 1)))
    np.testing.assert_allclose(ag[5], np.repeat(np.arange(8.0), 2))
    np.testing.assert_allclose(sc[:, 0],
                               [sum(range(1, i + 1)) for i in range(8)])
    np.testing.assert_allclose(a2a[2], [2.0 + 10.0 * s for s in range(8)])
    methods = [r["method"] for r in ledger_rows(t[1])]
    assert methods == ["fused_rs", "fused_ag", "fused_scatter", "fused_ag",
                       "fused_ag", "fused_ag", "fused"]


def test_allreduce_nondivisible_length(mesh8):
    j, t = both(mesh8, lambda ctx, s, p: (jbsp.allreduce(ctx, jnp.ones(13)),),
                lambda ctx, s, p: (tbsp.allreduce(
                    ctx, torch.ones(p, 13)),), 1)
    assert_same(j, t)
    np.testing.assert_array_equal(t[0][0], np.full((8, 13), 8.0))


def test_allreduce_max_min_ops(mesh8):
    """max/min take fused_rs and never leak the zero staging buffers
    into all-negative / all-positive results."""
    def make(bsp, xp, mx, mn, lpf):
        def spmd(ctx, s, p):
            pid = pid_f(ctx, lpf)
            neg = bsp.allreduce(ctx, -(xp.arange(11.0) + 1.0 + pid),
                                op=mx, label="mx")
            pos = bsp.allreduce(ctx, xp.arange(11.0) + 1.0 + pid,
                                op=mn, label="mn")
            return neg, pos
        return spmd

    j, t = both(mesh8, make(jbsp, jnp, jnp.maximum, jnp.minimum, jlpf),
                make(tbsp, torch, torch.maximum, torch.minimum, tlpf), 2)
    assert_same(j, t)
    neg, pos = t[0]
    np.testing.assert_array_equal(neg, np.tile(-(np.arange(11.0) + 1.0),
                                               (8, 1)))
    np.testing.assert_array_equal(pos, np.tile(np.arange(11.0) + 1.0,
                                               (8, 1)))


@pytest.mark.parametrize("method", ["bruck", "valiant", "direct"])
def test_allreduce_explicit_method(mesh8, method):
    """An explicit bruck/valiant request routes through the exchange
    algorithm (those schedules cannot combine); direct stages the
    accumulating pair as coloured rounds."""
    def make(lpf, bsp, xp):
        def spmd(ctx, s, p):
            if method == "valiant":
                ctx.resize_message_queue(p * p, valiant_payload=256)
            return (bsp.allreduce(ctx, xp.ones(16) + pid_f(ctx, lpf),
                                  attrs=lpf.SyncAttributes(method=method)),)
        return spmd

    j, t = both(mesh8, make(jlpf, jbsp, jnp), make(tlpf, tbsp, torch), 1)
    assert_same(j, t)
    np.testing.assert_array_equal(t[0][0], np.full((8, 16), 8.0 + 28.0))
    recs = ledger_rows(t[1])
    assert [r["method"] for r in recs] == [method, method]
    if method == "bruck":
        assert [r["rounds"] for r in recs] == [3, 3]


def test_reduce_to_root_vs_allreduce_cost(mesh8):
    """reduce runs (and bills) reduce-scatter + gather to root, not an
    allreduce; the result lands at root only."""
    def make(bsp, xp, lpf):
        return lambda ctx, s, p: (bsp.reduce(
            ctx, xp.arange(24.0) * (1.0 + pid_f(ctx, lpf)), root=2),)

    j, t = both(mesh8, make(jbsp, jnp, jlpf), make(tbsp, torch, tlpf), 1)
    assert_same(j, t)
    out = t[0][0]
    want = np.arange(24.0) * sum(1.0 + i for i in range(8))
    np.testing.assert_allclose(out[2], want)
    assert (out[np.arange(8) != 2] == 0).all()
    assert [r["method"] for r in ledger_rows(t[1])] == ["fused_rs",
                                                        "fused_gather"]


def test_compressed_allreduce_error_bounded(mesh8):
    """The int8 wire: fused + fused_ag, compressed; within the JAX test's
    0.05 of the exact sum, and bit-equal to the JAX package."""
    def make(bsp, xp, lpf, lin):
        def spmd(ctx, s, p):
            x = lin * (1.0 + 0.01 * pid_f(ctx, lpf))
            return (bsp.allreduce(ctx, x, attrs=lpf.SyncAttributes(
                compress=lpf.CompressSpec(bits=8))),)
        return spmd

    lin = np.linspace(-1, 1, 64).astype(np.float32)
    j, t = both(mesh8, make(jbsp, jnp, jlpf, jnp.asarray(lin)),
                make(tbsp, torch, tlpf, torch.from_numpy(lin)), 1)
    # the wire is bit-equal (test_executor_method_parity); the local sum
    # of the exchanged chunks runs in another order
    assert_same(j, t, exact=False, rtol=1e-6, atol=1e-6)
    exact = np.linspace(-1, 1, 64) * (8 + 0.01 * 28)
    rel = np.abs(t[0][0][0] - exact).max() / np.abs(exact).max()
    assert rel < 0.05
    recs = ledger_rows(t[1])
    assert [r["method"] for r in recs] == ["fused", "fused_ag"]
    assert all(r["wire_bytes"] < r["h_bytes"] for r in recs)


# ---------------------------------------------------------------------------
# reduction supersteps (tests/test_reduction_supersteps.py)
# ---------------------------------------------------------------------------

def test_allreduce_ledger_parts(mesh8):
    n, p = 1024, P8
    rng = np.random.default_rng(7)
    x = rng.standard_normal((p, n)).astype(np.float32)
    j, t = both(mesh8, lambda ctx, s, p_: (jbsp.allreduce(
        ctx, jnp.asarray(x)[s]),),
        lambda ctx, s, p_: (tbsp.allreduce(ctx, torch.from_numpy(x)),), 1)
    # sums in another order: the JAX test's f32 tolerance
    assert_same(j, t, exact=False, rtol=1e-6, atol=1e-5)
    rs, ag = t[1].records
    assert (rs.method, ag.method, rs.rounds + ag.rounds) == \
        ("fused_rs", "fused_ag", 2)
    c = n // p
    assert rs.wire_bytes + ag.wire_bytes <= 2 * c * (p - 1) * 4
    np.testing.assert_allclose(t[0][0], np.tile(x.sum(0), (p, 1)),
                               rtol=1e-5, atol=1e-5)


def test_reduce_is_a_genuine_reduction_to_root(mesh8):
    n, p, root = 512, P8, 3

    def make(bsp, xp, lpf):
        return lambda ctx, s, p_: (bsp.reduce(
            ctx, xp.arange(n, dtype=xp.float32) + pid_f(ctx, lpf),
            root=root),)

    j, t = both(mesh8, make(jbsp, jnp, jlpf), make(tbsp, torch, tlpf), 1)
    assert_same(j, t)
    rs, gather = t[1].records
    c = n // p
    assert (rs.method, gather.method) == ("fused_rs", "fused_gather")
    assert rs.wire_bytes == gather.wire_bytes == (p - 1) * c * 4
    out = t[0][0]
    want = np.sum(np.stack([np.arange(n, dtype=np.float64) + i
                            for i in range(p)]), axis=0)
    np.testing.assert_allclose(out[root], want, rtol=1e-6)
    assert (out[np.arange(p) != root] == 0.0).all()


def test_scatter_gather_supersteps(mesh8):
    w, root_s, root_g = 4, 2, 5

    def make(lpf, xp, wrap):
        def spmd(ctx, s, p):
            ctx.resize_memory_register(3)
            ctx.resize_message_queue(2 * p)
            full = ctx.register_global("full", xp.arange(
                p * w, dtype=xp.float32) * (1.0 + pid_f(ctx, lpf)))
            mine = ctx.register_global("mine", wrap(np.zeros((p, w),
                                                             np.float32), s))
            back = ctx.register_global("back", wrap(np.full(
                (p, p * w), -1.0, np.float32), s))
            ctx.put_msgs([(root_s, d, full, d * w, mine, 0, w)
                          for d in range(p)])
            ctx.sync(label="scatter")
            ctx.put_msgs([(q, root_g, mine, 0, back, q * w, w)
                          for q in range(p)])
            ctx.sync(label="gather")
            return ctx.tensor(mine), ctx.tensor(back)
        return spmd

    j, t = both(mesh8, make(jlpf, jnp, lambda a, s: jnp.asarray(a)[s]),
                make(tlpf, torch, lambda a, s: torch.from_numpy(a)), 2)
    assert_same(j, t)
    sc, ga = t[1].records
    assert (sc.method, ga.method, sc.rounds, ga.rounds) == \
        ("fused_scatter", "fused_gather", 1, 1)
    assert sc.wire_bytes == sc.h_bytes == (P8 - 1) * w * 4
    mine, back = t[0]
    want = np.stack([np.arange(P8 * w)[d * w:(d + 1) * w] * (1.0 + root_s)
                     for d in range(P8)])
    np.testing.assert_allclose(mine, want)
    np.testing.assert_allclose(back[root_g], want.reshape(-1))
    assert (back[np.arange(P8) != root_g] == -1.0).all()


def test_broadcast_takes_two_fused_rounds(mesh8):
    def make(bsp, xp, lpf):
        return lambda ctx, s, p: (bsp.broadcast(
            ctx, xp.arange(64.0) + 100.0 * pid_f(ctx, lpf), root=6),)

    j, t = both(mesh8, make(jbsp, jnp, jlpf), make(tbsp, torch, tlpf), 1)
    assert_same(j, t)
    scatter, ag = t[1].records
    assert (scatter.method, scatter.rounds, ag.method, ag.rounds) == \
        ("fused_scatter", 1, "fused_ag", 1)
    np.testing.assert_array_equal(t[0][0], np.tile(np.arange(64.0) + 600.0,
                                                   (8, 1)))


def test_plan_cache_reuses_reduction_plans():
    """Two allreduces through fresh slots plan their two relations once:
    the second replays the whole recorded program from the program cache
    without consulting the planner (as the JAX package's test holds), and
    their ledger entries are the first's but for the labels."""
    cache, pcache = tlpf.PlanCache(), tlpf.ProgramCache()
    ctx = tlpf.LPFContext(P8, device="cpu", plan_cache=cache,
                          program_cache=pcache)
    y = tbsp.allreduce(ctx, torch.zeros(P8, 64), label="ar1")
    tbsp.allreduce(ctx, y, label="ar2")
    assert cache.stats.misses == 2
    assert (pcache.stats.misses, pcache.stats.hits) == (1, 1)
    a, b, c, d = ctx.ledger.records
    assert dataclasses.replace(a, label="") == dataclasses.replace(c,
                                                                   label="")
    assert dataclasses.replace(b, label="") == dataclasses.replace(d,
                                                                   label="")


def reduction_spmd(lpf, wrap, vals, w, method, reduce_op, dst_init):
    def spmd(ctx, s, p):
        ctx.resize_memory_register(2)
        ctx.resize_message_queue(p * p)
        src = ctx.register_global("src", wrap(
            vals[None, :] + 1000 * np.arange(p)[:, None], s))
        dst = ctx.register_global("dst", wrap(
            np.full((p, w), dst_init, np.int32), s))
        ctx.put_msgs([(q, d, src, d * w, dst, 0, w)
                      for q in range(p) for d in range(p)])
        ctx.sync(lpf.SyncAttributes(method=method, reduce_op=reduce_op))
        return (ctx.tensor(dst),)
    return spmd


@pytest.mark.parametrize("reduce_op", ["sum", "max", "min"])
@pytest.mark.parametrize("seed", range(4))
def test_fused_rs_matches_direct_bitwise_int(mesh8, reduce_op, seed):
    """fused_rs and the coloured-round schedule agree exactly on int32,
    in both packages, ignoring the destination's old contents."""
    rng = np.random.default_rng(seed)
    p, w = P8, int(rng.integers(1, 5))
    vals = rng.integers(-1000, 1000, size=p * w).astype(np.int32)
    jwrap = lambda a, s: jnp.asarray(a.astype(np.int32))[s]     # noqa: E731
    twrap = lambda a, s: torch.from_numpy(a.astype(np.int32))   # noqa: E731
    outs = {}
    for method in ("auto", "direct"):
        outs[method] = both(
            mesh8, reduction_spmd(jlpf, jwrap, vals, w, method, reduce_op,
                                  77),
            reduction_spmd(tlpf, twrap, vals, w, method, reduce_op, 77), 1)
        assert_same(*outs[method])
    fused, direct = outs["auto"][1][0][0], outs["direct"][1][0][0]
    assert outs["auto"][1][1].records[0].method == "fused_rs"
    assert (fused == direct).all()
    contrib = np.stack([vals.reshape(p, w) + 1000 * q for q in range(p)])
    oracle = {"sum": contrib.sum(0), "max": contrib.max(0),
              "min": contrib.min(0)}[reduce_op]
    assert (fused == oracle).all()


@pytest.mark.parametrize("seed", range(3))
def test_generic_accumulating_superstep_matches_oracle(mesh8, seed):
    """Non-canonical conflicting tables combine through the direct
    accumulate schedule: first write replaces, later ones add."""
    rng = np.random.default_rng(100 + seed)
    p, size = P8, 6
    table = [(int(rng.integers(p)), int(rng.integers(3)),
              int(rng.integers(3)), int(rng.integers(1, 4)))
             for _ in range(int(rng.integers(2, 10)))]

    def make(lpf, wrap):
        def spmd(ctx, s, p_):
            ctx.resize_memory_register(2)
            ctx.resize_message_queue(len(table))
            src = ctx.register_global("src", wrap(
                np.arange(size)[None, :] + 10 * np.arange(p)[:, None], s))
            dst = ctx.register_global("dst", wrap(np.full((p, size), 5), s))
            ctx.put_msgs([(q, d, src, so, dst, so, sz)
                          for (q, d, so, sz) in table])
            ctx.sync(lpf.SyncAttributes(reduce_op="sum"))
            return (ctx.tensor(dst),)
        return spmd

    j, t = both(mesh8,
                make(jlpf, lambda a, s: jnp.asarray(a.astype(np.int32))[s]),
                make(tlpf, lambda a, s: torch.from_numpy(a.astype(np.int32))),
                1)
    assert_same(j, t)
    want = np.tile(np.full(size, 5, np.int64), (8, 1))
    written = np.zeros((8, size), bool)
    for (q, d, so, sz) in table:
        chunk = np.arange(size, dtype=np.int64)[so:so + sz] + 10 * q
        seg = slice(so, so + sz)
        was = written[d, seg]
        want[d, seg] = np.where(was, want[d, seg] + chunk, chunk)
        written[d, seg] = True
    assert (t[0][0] == want).all()


# ---------------------------------------------------------------------------
# split-phase allreduce and exscan
# ---------------------------------------------------------------------------

def test_allreduce_start_done_and_exscan(mesh8):
    """Two allreduces started inside one recording, then finished (the
    second averaged), and an exscan: values and ledgers as in JAX."""
    def make(lpf, bsp, xp):
        def spmd(ctx, s, p):
            pid = pid_f(ctx, lpf)
            with ctx.program("ddp"):
                h1 = bsp.allreduce_start(ctx, xp.arange(12.0) + pid,
                                         label="b1")
                h2 = bsp.allreduce_start(ctx, xp.ones(9) * (pid + 1),
                                         label="b2")
                a = bsp.allreduce_done(ctx, h1)
                b = bsp.allreduce_done(ctx, h2, mean=True)
            e = bsp.exscan(ctx, xp.arange(5.0) * (pid + 1))
            return a, b, e
        return spmd

    j, t = both(mesh8, make(jlpf, jbsp, jnp), make(tlpf, tbsp, torch), 3)
    assert_same(j, t)
    a, b, e = t[0]
    np.testing.assert_array_equal(a, np.tile(np.arange(12.0) * 8 + 28,
                                             (8, 1)))
    np.testing.assert_array_equal(b, np.full((8, 9), 36.0 / 8))
    for q in range(8):
        np.testing.assert_array_equal(e[q], np.arange(5.0) * sum(
            range(1, q + 1)))


def test_collective_ledger_prices_alike():
    """One machine prices both packages' allreduce ledgers alike."""
    jm = jlpf.probe({"x": P8}, jlpf.TPU_V5E)
    tm = tlpf.probe({"x": P8}, hardware_from_fields(
        dataclasses.asdict(jlpf.TPU_V5E)))
    ctx = tlpf.LPFContext(P8, device="cpu")
    tbsp.allreduce(ctx, torch.ones(P8, 4096))
    recs = ctx.ledger.records
    jrecs = [jlpf.SuperstepCost(**dataclasses.asdict(r)) for r in recs]
    assert [r.predicted_seconds(jm) for r in jrecs] == \
        [r.predicted_seconds(tm) for r in recs]
