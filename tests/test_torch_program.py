"""Parity of the port's program layer (``repro_torch.core.program``) with
the JAX package's: the optimizer, the simulator, the cache and compiled
replay.

Both packages are handed the same numpy-built traces — the canned traces
and the random traces of ``tests/test_schedule_search.py`` and
``tests/test_program_equivalence.py`` (their ``random_program(seed)``,
the same seeds) — converted to port objects through
``repro_torch.interop.steps_from_fields``, and priced on one machine
(``interop.hardware_from_fields``).  Schedules must be identical field by
field: canonical order, signature, groups, canonical tables, attrs,
plans, predicted and in-order seconds and the ``explain`` text.
Execution is bit-equal (int32 payloads, data movement and int32 sums):
the port's context against ``simulate_program`` of both packages and
against the JAX package's ``exec_`` on 8 host devices, with equal ledgers,
overlap-group entries included.  Every tolerance here is exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import test_program_equivalence as tpe
import test_schedule_search as tss
from repro import core as jlpf
from repro.analysis import traces as jtraces
from repro.core import machine as jmachine
from repro.core import program as jprog
from repro_torch import core as tlpf
from repro_torch.analysis import traces as ttraces
from repro_torch.core import faultpoints
from repro_torch.core import program as tprog
from repro_torch.interop import (hardware_from_fields, program_from_fields,
                                 slot_from_fields, steps_from_fields)

P8 = 8
JM = jmachine.probe({"x": P8}, jmachine.CPU_HOST)
TM = tlpf.probe({"x": P8}, hardware_from_fields(
    dataclasses.asdict(jmachine.CPU_HOST)))
GENERATORS = {"schedule_search": tss.random_program,
              "program_equivalence": tpe.random_program}


def to_port(steps, scratch=None):
    """The port's trace (and scratch slot) from a JAX package trace."""
    tsteps = steps_from_fields([dataclasses.asdict(s) for s in steps])
    return tsteps, (None if scratch is None
                    else slot_from_fields(dataclasses.asdict(scratch)))


def assert_same_program(jp, tp, jm=JM, tm=TM, jsteps=None, tsteps=None,
                        jscratch=None, tscratch=None):
    for f in ("p", "n_recorded", "n_coalesced", "n_eliminated", "n_merged",
              "overlap_groups", "n_overlapped", "n_rewritten", "n_hoisted",
              "canonical"):
        assert getattr(jp, f) == getattr(tp, f), f
    assert [dataclasses.asdict(c) for c in jp.in_order_costs] == \
        [dataclasses.asdict(c) for c in tp.in_order_costs]
    assert len(jp.steps) == len(tp.steps)
    for a, b in zip(jp.steps, tp.steps):
        assert (a.table, a.label, a.merged_from, a.unchanged, a.rewrite) == \
            (b.table, b.label, b.merged_from, b.unchanged, b.rewrite)
        assert dataclasses.asdict(a.attrs) == dataclasses.asdict(b.attrs)
        # the whole plan: method, rounds, fused tables, cost (h_bytes,
        # wire_bytes, rounds, ...)
        assert dataclasses.asdict(a.plan) == dataclasses.asdict(b.plan)
    assert jp.groups() == tp.groups()
    assert jp.predicted_seconds(jm) == tp.predicted_seconds(tm)
    assert jp.in_order_seconds(jm) == tp.in_order_seconds(tm)
    assert jp.explain(jm) == tp.explain(tm)
    if jsteps is not None:
        assert jp.explain(jm, steps=jsteps, scratch=jscratch) == \
            tp.explain(tm, steps=tsteps, scratch=tscratch)


def assert_same_schedule(jsteps, p, jscratch=None, search=True):
    tsteps, tscratch = to_port(jsteps, jscratch)
    jorder, torder = (jprog.canonical_order(jsteps),
                      tprog.canonical_order(tsteps))
    assert jorder == torder
    assert jprog.program_signature(jsteps, p, jscratch) == \
        tprog.program_signature(tsteps, p, tscratch)
    jp = jprog.optimize_program(jsteps, p, JM, scratch=jscratch,
                                search=search)
    tp = tprog.optimize_program(tsteps, p, TM, scratch=tscratch,
                                search=search)
    assert_same_program(jp, tp, jsteps=jsteps, tsteps=tsteps,
                        jscratch=jscratch, tscratch=tscratch)
    return jp, tp, tsteps, tscratch


def test_machines_agree():
    assert (JM.g, JM.l) == (TM.g, TM.l)


def test_canned_traces_are_the_jax_packages():
    for name, build in ttraces.CANNED_TRACES.items():
        p, slots, steps, scratch = build()
        jp_, jslots, jsteps, jscratch = jtraces.CANNED_TRACES[name]()
        tsteps, tscratch = to_port(jsteps, jscratch)
        assert p == jp_
        assert tprog.program_signature(steps, p, scratch) == \
            tprog.program_signature(tsteps, p, tscratch)


@pytest.mark.parametrize("search", [True, False])
@pytest.mark.parametrize("name", sorted(jtraces.CANNED_TRACES))
def test_canned_schedule_matches_jax(name, search):
    p, _, steps, scratch = jtraces.CANNED_TRACES[name]()
    assert_same_schedule(steps, p, scratch, search)


@pytest.mark.parametrize("seed", range(60))
@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_random_schedule_matches_jax(gen, seed):
    """60 random traces per generator, both search settings."""
    p, _, steps = GENERATORS[gen](seed)
    for search in (True, False):
        assert_same_schedule(steps, p, None, search)


def test_canned_card_sizes_match_jax():
    """The sizes ``chip_smoke.py`` (o) runs: the same searched schedule and
    predictions in both packages under one (g, l)."""
    jm = jmachine.LPFMachine(p=P8, g=9.90e-12, l=1.44e-4, r=1.0)
    tm = tlpf.LPFMachine(p=P8, g=9.90e-12, l=1.44e-4, r=1.0)
    for name, args in (("fft_redistribute", (P8, 1 << 12)),
                       ("fragmented_valiant", (P8,)),
                       ("pagerank", (P8, 1 << 10))):
        p, _, steps, scratch = jtraces.CANNED_TRACES[name](*args)
        tsteps, tscratch = to_port(steps, scratch)
        for search in (True, False):
            assert_same_program(
                jprog.optimize_program(steps, p, jm, scratch=scratch,
                                       search=search),
                tprog.optimize_program(tsteps, p, tm, scratch=tscratch,
                                       search=search), jm, tm)


# ---------------------------------------------------------------------------
# execution: the simulator, the port's context, the JAX package's exec_
# ---------------------------------------------------------------------------

def _np_values(slots, p, seed):
    rng = np.random.default_rng(seed + 1)
    return {s.sid: rng.integers(-10_000, 10_000,
                                size=(p, s.size)).astype(np.int32)
            for s in slots}


def run_on_port(tsteps, tscratch, values, p, *, compiled, recorded=True,
                program_cache=None, hardware=None):
    """Run a port trace through a CPU context from ``values``; returns
    ({sid: np.ndarray}, ledger records, context)."""
    kw = {} if hardware is None else {"hardware": hardware}
    ctx = tlpf.LPFContext(p, device="cpu", program_cache=program_cache
                          if program_cache is not None
                          else tlpf.ProgramCache(), **kw)
    ctx.compile_programs = compiled
    slots = {m.src_slot.sid: m.src_slot for st in tsteps for m in st.msgs}
    slots.update({m.dst_slot.sid: m.dst_slot
                  for st in tsteps for m in st.msgs})
    slots = [slots[sid] for sid in sorted(slots) if sid in values]
    run, _, handles, _ = ttraces.bind_trace(
        ctx, slots, tsteps, tscratch,
        {s.sid: torch.from_numpy(values[s.sid].copy()) for s in slots})
    run(recorded=recorded)
    return ({sid: ctx.value(h).numpy() for sid, h in handles.items()},
            ctx.ledger.records, ctx)


@pytest.mark.parametrize("seed", range(60))
@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_optimized_execution_matches_simulators(gen, seed):
    """The port's flush (compiled plain version and dispatched) leaves
    every slot bit-equal to both packages' ``simulate_program`` of the
    recorded trace and of the optimized one, and ledgers
    ``ledger_costs``."""
    p, slots, steps = GENERATORS[gen](seed)
    values = _np_values(slots, p, seed)
    jeager = jprog.simulate_program([(s.msgs, s.attrs) for s in steps],
                                    values)
    tsteps, _ = to_port(steps)
    teager = tprog.simulate_program([(s.msgs, s.attrs) for s in tsteps],
                                    values)
    prog = tprog.optimize_program(tsteps, p, TM)
    topt = tprog.simulate_program(
        [(m, a) for m, a, _, _ in prog.materialize(tsteps)], values)
    used = {m.src_slot.sid for st in tsteps for m in st.msgs} | \
        {m.dst_slot.sid for st in tsteps for m in st.msgs}
    for compiled in (True, False):
        got, led, ctx = run_on_port(tsteps, None, values, p,
                                    compiled=compiled)
        order = tprog.canonical_order(tsteps)
        assert led == ctx.last_program.ledger_costs(
            [s.label for s in tsteps], order)
        for sid in used:
            assert (got[sid] == jeager[sid]).all(), sid
    for sid in jeager:
        assert (teager[sid] == jeager[sid]).all(), sid
        assert (topt[sid] == jeager[sid]).all(), sid


@pytest.mark.parametrize("name", sorted(jtraces.CANNED_TRACES))
def test_canned_execution_matches_jax_exec(mesh8, name):
    """Each canned trace through the JAX package's flush on 8 host
    devices and through the port's (compiled plain version, dispatched):
    the same values bit for bit and the same ledger, overlap-group
    entries included.  The port context prices with the JAX context's
    machine (TPU v5e's ici link as its "vp" link)."""
    p, slots, steps, scratch = jtraces.CANNED_TRACES[name]()
    values = _np_values(slots, p, 7)
    box = {}

    def spmd(ctx, s, p_, _):
        n = max(len(st.msgs) for st in steps)
        if scratch is not None:
            ctx.resize_message_queue(n, valiant_payload=scratch.size,
                                     payload_dtype=jnp.int32)
        else:
            ctx.resize_message_queue(n)
        ctx.resize_memory_register(len(slots) + 1)
        h = {sl.sid: ctx.register_global(
            sl.name, jnp.asarray(values[sl.sid])[s]) for sl in slots}
        with ctx.program(name):
            for st in steps:
                ctx.put_msgs([(m.src, m.dst, h[m.src_slot.sid], m.src_off,
                               h[m.dst_slot.sid], m.dst_off, m.size)
                              for m in st.msgs])
                ctx.sync(st.attrs, label=st.label)
        box["prog"] = ctx.last_program
        return tuple(ctx.value(h[sl.sid]) for sl in slots)

    jout, jled = jlpf.exec_(mesh8, spmd, None,
                            out_specs=tuple(P("x") for _ in slots),
                            return_ledger=True)
    jvals = {sl.sid: np.asarray(v).reshape(P8, sl.size)
             for sl, v in zip(slots, jout)}
    hw = hardware_from_fields(dataclasses.asdict(jmachine.TPU_V5E))
    hw = dataclasses.replace(hw, links=dict(hw.links, vp=hw.links["ici"]))
    tsteps, tscratch = to_port(steps, scratch)
    for compiled in (True, False):
        tvals, tled, ctx = run_on_port(tsteps, tscratch, values, p,
                                       compiled=compiled, hardware=hw)
        assert_same_program(box["prog"], ctx.last_program)
        assert [dataclasses.asdict(r) for r in jled.records] == \
            [dataclasses.asdict(r) for r in tled]
        for sid in jvals:
            assert (tvals[sid] == jvals[sid]).all(), (name, sid)


# ---------------------------------------------------------------------------
# the program cache and compiled replay (CPU: the plain version)
# ---------------------------------------------------------------------------

def _fft_trace():
    p, slots, steps, scratch = ttraces.canned_fft_trace(p=4, w=8)
    values = {s.sid: np.arange(p * s.size, dtype=np.int32).reshape(p, -1)
              + s.sid for s in slots}
    return p, slots, steps, scratch, values


def test_ten_replays_one_entry_one_artifact():
    """Ten flushes of one trace through fresh slots: one optimization,
    nine cache hits, one compiled artifact called ten times (on the CPU
    the plain version: nothing captured), the same values each time."""
    p, slots, steps, scratch, values = _fft_trace()
    pc = tlpf.ProgramCache()
    first = None
    for _ in range(10):
        got, led, _ = run_on_port(steps, scratch, values, p, compiled=True,
                                  program_cache=pc)
        first = first or (got, led)
        for sid in got:
            assert (got[sid] == first[0][sid]).all()
        assert [r.method for r in led] == [r.method for r in first[1]]
    assert len(pc) == 1 and (pc.stats.misses, pc.stats.hits) == (1, 9)
    (cp,) = pc.artifacts()
    assert (cp.n_calls, cp.n_replays, cp.captured) == (10, 0, False)
    assert cp.device.type == "cpu" and cp.use_graph is None
    assert cp.eager_s == cp.replay_s == []
    key = pc.keys()[0]
    assert pc.certificate(key).ok
    assert pc.compiled(key, "cpu") is cp


def test_kept_index_tensors_outlive_the_memo(monkeypatch):
    """An index tensor returned inside ``keep_indices`` stays in its
    dict after the memo drops it, and is found there again instead of
    being rebuilt: a CUDA graph that reads it holds no reference."""
    from repro_torch.core import sync as tsync
    monkeypatch.setattr(tsync, "_INDEX_MEMO_SIZE", 2)
    kept = {}
    with tsync.keep_indices(kept):
        t = tsync._index([3, 1, 2], "cpu")
    for i in range(16):
        tsync._index([i, i + 100], "cpu")
    key = ((3, 1, 2), torch.device("cpu"))
    assert key not in tsync._INDEX_MEMO and kept == {key: t}
    with tsync.keep_indices(kept):
        assert tsync._index(np.array([3, 1, 2]), "cpu") is t
    again = tsync._index([3, 1, 2], "cpu")
    assert again is not t and torch.equal(again, t)
    assert not tsync._INDEX_KEEPERS


def test_compile_programs_env_opt_out(monkeypatch):
    """``LPF_COMPILE_PROGRAMS=0``: the dispatched schedule, no artifact,
    the same values and ledger."""
    p, slots, steps, scratch, values = _fft_trace()
    want, wled, _ = run_on_port(steps, scratch, values, p, compiled=True)
    monkeypatch.setenv("LPF_COMPILE_PROGRAMS", "0")
    ctx = tlpf.LPFContext(p, device="cpu")
    assert ctx.compile_programs is False
    pc = tlpf.ProgramCache()
    got, led, ctx = run_on_port(steps, scratch, values, p,
                                compiled=ctx.compile_programs,
                                program_cache=pc)
    assert not pc.artifacts() and len(pc) == 1
    assert led == wled
    for sid in want:
        assert (got[sid] == want[sid]).all()


def test_program_cache_lru_pin_and_eviction():
    """Hits refresh recency, eviction takes the least recent unpinned
    entry with its artifact and certificate, pins survive and are
    exempt from ``maxsize``."""
    cache = tlpf.ProgramCache(maxsize=4)
    traces, keys = [], []
    for k in range(6):
        src = tss.make_slot(300 + 2 * k, 8 + k)
        dst = tss.make_slot(301 + 2 * k, 8 + k)
        steps, _ = to_port([jlpf.ProgramStep(
            (jlpf.Msg(0, 1, src, 0, dst, 0, 8 + k),),
            jlpf.SyncAttributes(), "s")])
        if k in (2, 4):
            cache.get_or_build(traces[0], 4, TM)     # touch the hot entry
        prog, key = cache.get_or_build_keyed(steps, 4, TM)
        assert cache.certify(key, steps).ok
        cache.set_compiled(key, "cpu", object())
        traces.append(steps)
        keys.append(key)
    assert cache.stats.evictions == 2
    before = cache.stats.misses
    cache.get_or_build(traces[0], 4, TM)
    assert cache.stats.misses == before
    assert len(cache._compiled) == len(cache._programs) == 4
    assert len(cache._certs) == 4
    # pins: the oldest entry pinned survives a burst of new programs
    oldest = cache.keys()[0]
    cache.pin(oldest)
    assert cache.pinned == {oldest}
    for k in range(6, 12):
        src = tss.make_slot(400 + 2 * k, 8 + k)
        steps, _ = to_port([jlpf.ProgramStep(
            (jlpf.Msg(0, 1, src, 0, src, 0, 8),), jlpf.SyncAttributes(),
            "t")])
        cache.get_or_build(steps, 4, TM)
    assert oldest in cache.keys() and len(cache) == 5
    cache.unpin(oldest)
    assert cache.pinned == frozenset()
    with pytest.raises(tlpf.LPFFatalError):
        cache.pin(("no", "such", "key"))
    # an unusable store directory leaves the cache memory-only
    assert cache.attach_store("/dev/null/store") is None
    assert cache.store is None and cache.memory_only_reason
    assert cache.flush() == 0
    cache.clear()
    assert len(cache) == 0 and cache.stats.misses == 0


def test_set_compiled_requires_a_passing_certificate():
    p, slots, steps, scratch, _ = _fft_trace()
    cache = tlpf.ProgramCache()
    prog, key = cache.get_or_build_keyed(steps, p, TM)
    with pytest.raises(tlpf.LPFAnalysisError, match="uncertified"):
        cache.set_compiled(key, "cpu", object())
    assert cache.certify(key, steps).ok
    cache.set_compiled(key, "cpu", object())
    with pytest.raises(tlpf.LPFFatalError):
        cache.set_compiled(("missing",), "cpu", object())


class _Seam:
    """An injector that raises ``InjectedFault`` at every ``seam`` call
    and injects no delay or corruption at the other seams."""

    def __init__(self, seam):
        self.seam, self.count = seam, 0

    def fire(self, seam, **info):
        if seam == self.seam:
            self.count += 1
            raise faultpoints.InjectedFault(f"injected at {seam}")

    def delay(self, seam, **info):
        return 0.0

    def corrupt(self, seam, blob):
        return blob


def test_compile_failure_falls_back_to_dispatched():
    """An injected compilation failure degrades to the dispatched
    schedule: values and ledger identical to a clean compiled run, the
    key quarantined with its exception kept, ``compile_fallbacks``
    counting it; a replay skips the doomed compile."""
    p, slots, steps, scratch, values = _fft_trace()
    want, wled, _ = run_on_port(steps, scratch, values, p, compiled=True)
    pc = tlpf.ProgramCache()
    seam = _Seam("compile")
    prev = faultpoints._install(seam)
    try:
        got, led, _ = run_on_port(steps, scratch, values, p, compiled=True,
                                  program_cache=pc)
        got2, led2, _ = run_on_port(steps, scratch, values, p,
                                    compiled=True, program_cache=pc)
    finally:
        faultpoints._install(prev)
    assert seam.count == 1
    assert led == wled == led2
    for sid in want:
        assert (got[sid] == want[sid]).all()
        assert (got2[sid] == want[sid]).all()
    (key,) = pc.keys()
    assert pc.compile_quarantined(key, "cpu")
    assert pc.stats.compile_fallbacks == 1 and not pc.artifacts()
    assert isinstance(pc.compile_errors[(key, "cpu")],
                      faultpoints.InjectedFault)
    assert pc.quarantined == {key: frozenset({"cpu"})}


def test_lpf_errors_never_degraded_around(monkeypatch):
    """An LPF error raised while compiling propagates: no fallback."""
    import repro_torch.core.context as context_mod
    p, slots, steps, scratch, values = _fft_trace()
    pc = tlpf.ProgramCache()

    def boom(*a, **k):
        raise tlpf.LPFFatalError("contract violation during lowering")

    monkeypatch.setattr(context_mod, "compile_program", boom)
    with pytest.raises(tlpf.LPFFatalError, match="contract violation"):
        run_on_port(steps, scratch, values, p, compiled=True,
                    program_cache=pc)
    assert pc.stats.compile_fallbacks == 0 and not pc.quarantined


def test_cache_stats_view_and_last_program():
    p, slots, steps, scratch, values = _fft_trace()
    pc, plc = tlpf.ProgramCache(), tlpf.PlanCache()
    ctx = tlpf.LPFContext(p, device="cpu", program_cache=pc,
                          plan_cache=plc)
    run, reset, handles, _ = ttraces.bind_trace(
        ctx, slots, steps, scratch,
        {s.sid: torch.from_numpy(values[s.sid]) for s in slots})
    run()
    stats = ctx.cache_stats
    assert stats["program"] is pc.stats and stats["plan"] is plc.stats
    assert pc.stats.misses == 1
    stats.reset()
    assert pc.stats.misses == 0 and plc.stats.misses == 0
    reset()
    run()
    assert (pc.stats.hits, pc.stats.misses) == (1, 0)
    text = ctx.last_program.explain(ctx.probe())
    assert text.startswith("SuperstepProgram: 4 recorded")
    assert "verified: " in text.splitlines()[-1]


def test_tampered_program_is_refused_before_any_slot_changes():
    """A cached schedule the verifier cannot certify (a tampered plan
    cost) is refused at flush with ``LPFAnalysisError``, and no slot
    value changed."""
    p, slots, steps, scratch, values = _fft_trace()
    pc = tlpf.ProgramCache()
    ctx = tlpf.LPFContext(p, device="cpu", program_cache=pc)
    run, reset, handles, bound = ttraces.bind_trace(
        ctx, slots, steps, scratch,
        {s.sid: torch.from_numpy(values[s.sid]) for s in slots})
    prog, key = pc.get_or_build_keyed(bound, p, ctx._machine())
    st0 = prog.steps[0]
    bad_cost = dataclasses.replace(st0.plan.cost,
                                   wire_bytes=st0.plan.cost.wire_bytes + 64)
    pc._programs[key] = dataclasses.replace(prog, steps=(
        dataclasses.replace(st0, plan=dataclasses.replace(
            st0.plan, cost=bad_cost)),) + prog.steps[1:])
    before = {sid: ctx.value(h).clone() for sid, h in handles.items()}
    with pytest.raises(tlpf.LPFAnalysisError, match="LPF106"):
        run()
    for sid, h in handles.items():
        assert torch.equal(ctx.value(h), before[sid])
    assert not ctx.ledger.records


def test_jax_program_runs_on_the_port():
    """A schedule the JAX package optimized, handed over as plain fields,
    certifies and executes on the port bit-equal to the simulator."""
    p, slots, steps, scratch = jtraces.canned_bucketed_trace(p=4, w=8)
    jp = jprog.optimize_program(steps, p, JM)
    tp = program_from_fields(dataclasses.asdict(jp))
    tsteps, _ = to_port(steps)
    from repro_torch.analysis import verify_program
    assert verify_program(tsteps, tp).ok
    values = _np_values(slots, p, 3)
    want = jprog.simulate_program([(s.msgs, s.attrs) for s in steps],
                                  values)
    store = tlpf.ValueStore({sid: torch.from_numpy(v.copy())
                             for sid, v in values.items()}, p)
    order = tprog.canonical_order(tsteps)
    costs = tlpf.execute_schedule(tp.materialize(tsteps, order=order),
                                  tp.groups(), store)
    assert costs == tp.ledger_costs()
    for sid in want:
        got = store.value(tlpf.Slot(sid, "", 0, torch.int32, "global", ()))
        assert (got.numpy() == want[sid]).all()
