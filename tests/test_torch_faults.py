"""Fault plans, the disk degradation ladder and the chaos harness of the
port (``repro_torch.runtime.faults``, ``repro_torch.core.faultpoints``)
against the JAX package's (``tests/test_faults.py``'s cases that reach
ported code).

* the injection machinery: the plan grammar's round trip, malformed
  specs, seeded determinism (``FaultPlan.random(seed)`` spec-equal to the
  JAX package's for seeds 0-99 over every workload's seams), one counting
  point per seam, zero-fault transparency, ``LPF_FAULT_PLAN`` arming;
* the ladder: persist I/O retry -> ``disk_errors`` -> memory-only mode,
  strikes reset by a working disk, a transient read that does not
  invalidate, corrupting reads that do, the poison set for undeletable
  entries, an unusable directory;
* the seams in the flush: ``straggler`` delays without touching values
  or ledger, ``compile`` quarantines to the dispatched schedule;
* the harness: every ``SMOKE_PLANS`` entry on the CPU gives the verdict
  the JAX harness gives (none ``MISMATCH`` or ``UNCLASSIFIED``), and a
  short ``--chaos`` soak passes.
"""

import dataclasses
import errno
import os
import time

import pytest
import torch

from repro.runtime import faults as jfaults
from repro_torch import core as tlpf
from repro_torch.core import faultpoints
from repro_torch.core.persist import entry_filename
from repro_torch.runtime import faults
from repro_torch.runtime.faults import (FaultEvent, FaultInjector,
                                        FaultPlan, SMOKE_PLANS)

P = 4
MACHINE = tlpf.LPFMachine(p=P, g=1e-9, l=1e-6, r=1e-10)


def make_slot(sid, size=16):
    return tlpf.Slot(sid=sid, name=f"s{sid}", size=size,
                     dtype=torch.float32, kind="global", orig_shape=(size,))


def shift_trace(n_steps=3, base_sid=0):
    steps = []
    for k in range(n_steps):
        a = make_slot(base_sid + 2 * k)
        b = make_slot(base_sid + 2 * k + 1)
        msgs = tuple(tlpf.Msg(s, (s + k + 1) % P, a, 0, b, 0, 4 * (k + 1),
                              origin="put") for s in range(P))
        steps.append(tlpf.ProgramStep(msgs, tlpf.LPF_SYNC_DEFAULT, f"s{k}"))
    return steps


def build_and_certify(cache, steps=None):
    steps = steps if steps is not None else shift_trace()
    prog, key = cache.get_or_build_keyed(steps, P, MACHINE)
    cert = cache.certify(key, steps, prog)
    assert cert.ok
    return prog, key, steps


@pytest.fixture(autouse=True)
def _unarmed(monkeypatch):
    """Every test starts and ends with nothing armed and no env plan."""
    monkeypatch.delenv("LPF_FAULT_PLAN", raising=False)
    monkeypatch.delenv("LPF_PROGRAM_CACHE_DIR", raising=False)
    faults.disarm()
    yield
    faults.disarm()


# ---------------------------------------------------------------------------
# plans: grammar, determinism, arming
# ---------------------------------------------------------------------------

def test_seams_equal_the_jax_packages():
    from repro.core import faultpoints as jfp
    assert faultpoints.SEAMS == jfp.SEAMS
    assert len(faultpoints.SEAMS) == 7
    assert faults._MODES == jfaults._MODES


def test_plan_spec_roundtrip():
    spec = ("persist_save@0;persist_load@1x2:bitflip;compile@0x-1;"
            "straggler@2=0.005;capacity@1x3")
    plan = FaultPlan.parse(spec)
    assert plan.spec() == spec
    assert FaultPlan.parse(plan.spec()).spec() == spec
    assert plan.seams() == ("capacity", "compile", "persist_load",
                            "persist_save", "straggler")
    assert plan.spec() == jfaults.FaultPlan.parse(spec).spec()


@pytest.mark.parametrize("bad", [
    "nosuchseam@0", "persist_save@-1", "persist_save@0x0",
    "persist_save@0:nosuchmode", "compile", "compile@", "@0",
])
def test_plan_rejects_malformed(bad):
    with pytest.raises(ValueError):
        FaultPlan.parse(bad)


@pytest.mark.parametrize("seams", [
    faultpoints.SEAMS, *(s for _fn, s in faults.WORKLOADS.values())],
    ids=["all", *faults.WORKLOADS])
def test_random_plans_equal_the_jax_draw(seams):
    """Seeds 0-99: the port's plan is spec-equal to the JAX package's."""
    for seed in range(100):
        spec = FaultPlan.random(seed, seams=seams).spec()
        assert spec == jfaults.FaultPlan.random(seed, seams=seams).spec()
        assert FaultPlan.parse(spec).spec() == spec


def test_random_plans_are_seed_deterministic():
    seams = ("compile", "straggler", "capacity")
    specs = [FaultPlan.random(seed, seams=seams).spec()
             for seed in range(50)]
    again = [FaultPlan.random(seed, seams=seams).spec()
             for seed in range(50)]
    assert specs == again
    assert len(set(specs)) > 10          # the space is actually explored
    for spec in specs:
        for e in FaultPlan.parse(spec).events:
            assert e.seam in seams


def test_event_due_semantics():
    one = FaultEvent(seam="compile", at=2)
    assert [one.due(i) for i in range(5)] == [False, False, True, False,
                                              False]
    rep = FaultEvent(seam="compile", at=1, repeat=2)
    assert [rep.due(i) for i in range(5)] == [False, True, True, False,
                                              False]
    forever = FaultEvent(seam="compile", at=3, repeat=-1)
    assert [forever.due(i) for i in range(6)] == [False] * 3 + [True] * 3


def test_unarmed_seams_are_noops():
    assert faults.active() is None and not faultpoints.armed()
    faultpoints.fire("persist_save")            # nothing raises
    assert faultpoints.corrupt("persist_load", b"abc") == b"abc"
    assert faultpoints.delay("straggler") == 0.0


def test_inject_restores_previous_injector():
    outer = faults.arm(FaultPlan.parse("compile@50"))
    with faults.inject(FaultPlan.parse("compile@60")) as inner:
        assert faults.active() is inner
    assert faults.active() is outer
    faults.disarm()
    assert faults.active() is None


def test_env_plan_arming(monkeypatch):
    monkeypatch.setenv("LPF_FAULT_PLAN", "persist_save@0")
    inj = faults.ensure_env_plan()
    assert inj is not None
    assert inj.plan.spec() == "persist_save@0"
    # idempotent: a second root context must not reset the counters
    inj.counts["persist_save"] = 5
    assert faults.ensure_env_plan() is inj


def test_root_context_arms_the_env_plan(monkeypatch):
    monkeypatch.setenv("LPF_FAULT_PLAN", "straggler@0=0.001")
    root = tlpf.LPFContext(P, device="cpu")
    inj = faults.active()
    assert inj is not None and inj.plan.spec() == "straggler@0=0.001"
    # a second root context keeps the armed injector; a sub-context never
    # arms
    tlpf.LPFContext(P, device="cpu")
    assert faults.active() is inj
    faults.disarm()
    tlpf.LPFContext(P, device="cpu", _parent=root)
    assert faults.active() is None


def test_injector_counts_and_fired_log():
    inj = FaultInjector(FaultPlan.parse("persist_save@1"))
    inj.fire("persist_save")                     # idx 0: pass
    with pytest.raises(OSError) as e:
        inj.fire("persist_save")                 # idx 1: ENOSPC
    assert e.value.errno == errno.ENOSPC
    assert inj.counts["persist_save"] == 2
    assert inj.fired == [("persist_save", 1, "default")]


@pytest.mark.parametrize("mode", ["oserror", "truncate", "bitflip"])
def test_corrupt_modes_equal_the_jax_injector(mode):
    blob = bytes(range(200))
    spec = f"persist_load@0:{mode}"
    t, j = FaultInjector(FaultPlan.parse(spec)), \
        jfaults.FaultInjector(jfaults.FaultPlan.parse(spec))
    if mode == "oserror":
        with pytest.raises(OSError):
            t.corrupt("persist_load", blob)
        with pytest.raises(OSError):
            j.corrupt("persist_load", blob)
    else:
        assert t.corrupt("persist_load", blob) == \
            j.corrupt("persist_load", blob) != blob
    assert t.fired == j.fired


# ---------------------------------------------------------------------------
# the persist seams + the disk degradation ladder
# ---------------------------------------------------------------------------

def test_save_fault_is_absorbed_and_counted(tmp_path):
    """An injected ENOSPC during write-back costs the warm start (and
    bumps disk_errors), never the execution."""
    cache = tlpf.ProgramCache(persist_dir=str(tmp_path))
    with faults.inject(FaultPlan.parse("persist_save@0x-1")) as inj:
        prog, key, steps = build_and_certify(cache)
    assert inj.fired
    assert cache.stats.disk_errors >= 1
    assert not os.path.exists(tmp_path / entry_filename(key))
    # the entry is served from memory regardless
    prog2, _ = cache.get_or_build_keyed(steps, P, MACHINE)
    assert prog2 is prog
    assert not [f for f in os.listdir(tmp_path) if f.startswith(".tmp")]


def test_persistent_disk_failure_degrades_to_memory_only(tmp_path):
    seed = tlpf.ProgramCache(persist_dir=str(tmp_path))
    traces = []
    for k in range(tlpf.ProgramCache.DISK_STRIKE_LIMIT):
        steps = shift_trace(n_steps=k + 1)
        build_and_certify(seed, steps=steps)
        traces.append(steps)

    warm = tlpf.ProgramCache(persist_dir=str(tmp_path))
    with faults.inject(FaultPlan.parse("persist_load@0x-1")):
        for steps in traces:      # every entry exists -> every read fails
            prog, _ = warm.get_or_build_keyed(steps, P, MACHINE)
            assert prog is not None              # cold build absorbed it
    assert warm.store is None
    assert "consecutive" in warm.memory_only_reason
    assert warm.stats.disk_errors == warm.DISK_STRIKE_LIMIT
    # re-attaching resets the ladder
    warm.attach_store(str(tmp_path))
    assert warm.store is not None
    assert warm.memory_only_reason is None


def test_successful_disk_op_resets_strikes(tmp_path):
    cache = tlpf.ProgramCache(persist_dir=str(tmp_path))
    with faults.inject(FaultPlan.parse("persist_save@0x-1")):
        for k in range(cache.DISK_STRIKE_LIMIT + 1):
            build_and_certify(cache, steps=shift_trace(n_steps=k + 1))
    assert cache.store is not None               # still attached
    assert cache.memory_only_reason is None
    assert cache.stats.disk_errors == cache.DISK_STRIKE_LIMIT + 1


def test_transient_load_error_does_not_invalidate(tmp_path):
    seed = tlpf.ProgramCache(persist_dir=str(tmp_path))
    _, key, steps = build_and_certify(seed)
    path = tmp_path / entry_filename(key)
    assert path.exists()

    warm = tlpf.ProgramCache(persist_dir=str(tmp_path))
    with faults.inject(FaultPlan.parse("persist_load@0x-1")) as inj:
        prog, _ = warm.get_or_build_keyed(steps, P, MACHINE)
    assert inj.fired
    assert prog is not None
    assert warm.stats.invalidated == 0
    assert warm.stats.disk_errors >= 1
    assert path.exists()                         # NOT invalidated

    clean = tlpf.ProgramCache(persist_dir=str(tmp_path))
    clean.get_or_build_keyed(steps, P, MACHINE)
    assert clean.stats.disk_hits == 1


@pytest.mark.parametrize("mode", ["truncate", "bitflip"])
def test_corrupting_load_fault_invalidates(tmp_path, mode):
    seed = tlpf.ProgramCache(persist_dir=str(tmp_path))
    _, key, steps = build_and_certify(seed)

    warm = tlpf.ProgramCache(persist_dir=str(tmp_path))
    with faults.inject(FaultPlan.parse(f"persist_load@0:{mode}")) as inj:
        prog, _ = warm.get_or_build_keyed(steps, P, MACHINE)
    assert inj.fired
    assert prog is not None
    assert warm.stats.invalidated == 1
    assert not (tmp_path / entry_filename(key)).exists()


def test_undeletable_invalid_entry_is_poisoned(tmp_path, monkeypatch):
    seed = tlpf.ProgramCache(persist_dir=str(tmp_path))
    _, key, steps = build_and_certify(seed)
    fname = entry_filename(key)
    path = tmp_path / fname
    blob = path.read_bytes()
    path.write_bytes(blob[:-4] + b"XXXX")

    warm = tlpf.ProgramCache(persist_dir=str(tmp_path))
    monkeypatch.setattr(os, "remove",
                        lambda p: (_ for _ in ()).throw(
                            OSError(errno.EROFS, "read-only", str(p))))
    prog, _ = warm.get_or_build_keyed(steps, P, MACHINE)
    assert prog is not None
    assert warm.stats.invalidated == 1
    assert fname in warm._poisoned
    assert path.exists()                         # could not be removed

    # the poisoned entry short-circuits: no second decode, no second
    # invalidation — just a disk miss
    warm._programs.clear()
    warm._certs.clear()
    before = warm.stats.invalidated
    prog2, _ = warm.get_or_build_keyed(steps, P, MACHINE)
    assert prog2 is not None
    assert warm.stats.invalidated == before


def test_attach_store_failure_is_memory_only(tmp_path):
    blocker = tmp_path / "blocker"
    blocker.write_text("not a directory")
    cache = tlpf.ProgramCache(persist_dir=str(blocker / "sub"))
    assert cache.store is None
    assert cache.memory_only_reason is not None
    assert cache.stats.disk_errors == 1
    prog, _, _ = build_and_certify(cache)
    assert prog is not None


def test_zero_fault_path_is_transparent(tmp_path):
    assert faults.active() is None
    c1 = tlpf.ProgramCache(persist_dir=str(tmp_path / "a"))
    c2 = tlpf.ProgramCache(persist_dir=str(tmp_path / "b"))
    _, k1, _ = build_and_certify(c1)
    _, k2, _ = build_and_certify(c2)
    assert k1 == k2
    blob1 = (tmp_path / "a" / entry_filename(k1)).read_bytes()
    blob2 = (tmp_path / "b" / entry_filename(k2)).read_bytes()
    assert blob1 == blob2                        # byte-identical entries
    assert c1.stats.disk_errors == 0 and c1.stats.compile_fallbacks == 0
    assert dataclasses.asdict(c1.stats) == dataclasses.asdict(c2.stats)


# ---------------------------------------------------------------------------
# the seams in the flush
# ---------------------------------------------------------------------------

def _bucketed(device="cpu", compile_programs=True):
    from repro_torch.analysis import traces
    p, slots, steps, scratch = traces.canned_bucketed_trace(p=8, w=8)
    pc = tlpf.ProgramCache()
    ctx = tlpf.LPFContext(p, device=device, program_cache=pc,
                          plan_cache=tlpf.PlanCache())
    ctx.compile_programs = compile_programs
    run, reset, handles, _ = traces.bind_trace(
        ctx, slots, steps, scratch,
        {s.sid: torch.arange(p * s.size, dtype=torch.int32).reshape(p, -1)
         + s.sid for s in slots})
    run()
    vals = {sid: ctx.value(h).clone() for sid, h in handles.items()}
    return vals, [dataclasses.asdict(r) for r in ctx.ledger.records], pc


def test_straggler_seam_delays_without_changing_the_result():
    want_vals, want_led, _ = _bucketed()
    with faults.inject(FaultPlan.parse("straggler@0=0.05")) as inj:
        t0 = time.perf_counter()
        vals, led, _ = _bucketed()
        took = time.perf_counter() - t0
    assert inj.fired == [("straggler", 0, "default")]
    assert took >= 0.05
    assert led == want_led
    assert all(torch.equal(vals[s], want_vals[s]) for s in want_vals)


def test_compile_seam_falls_back_to_the_dispatched_schedule():
    want_vals, want_led, _ = _bucketed(compile_programs=False)
    with faults.inject(FaultPlan.parse("compile@0")) as inj:
        vals, led, pc = _bucketed()
    assert inj.fired == [("compile", 0, "default")]
    assert pc.stats.compile_fallbacks == 1
    (key,) = pc.keys()
    assert pc.compile_quarantined(key, "cpu")
    assert isinstance(pc.compile_errors[(key, "cpu")],
                      faultpoints.InjectedFault)
    assert led == want_led
    assert all(torch.equal(vals[s], want_vals[s]) for s in want_vals)


def test_env_fault_plan_reaches_the_flush(monkeypatch):
    """``LPF_FAULT_PLAN`` armed by the root context: ``compile@0;
    straggler@1=0.005`` on the bucketed trace quarantines its program and
    leaves values and ledger equal to the unfaulted run's."""
    want_vals, want_led, _ = _bucketed()
    monkeypatch.setenv("LPF_FAULT_PLAN", "compile@0;straggler@0=0.005")
    vals, led, pc = _bucketed()
    inj = faults.active()
    assert inj is not None
    assert ("compile", 0, "default") in inj.fired
    assert ("straggler", 0, "default") in inj.fired
    assert pc.stats.compile_fallbacks == 1 and pc.quarantined
    assert led == want_led
    assert all(torch.equal(vals[s], want_vals[s]) for s in want_vals)


# ---------------------------------------------------------------------------
# the chaos harness on the CPU, verdict for verdict against the JAX one
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def baselines():
    return {}, {}


@pytest.mark.parametrize("workload,spec", SMOKE_PLANS,
                         ids=[f"{w}-{s}" for w, s in SMOKE_PLANS])
def test_smoke_plan_verdict_equals_the_jax_harness(workload, spec,
                                                   baselines):
    assert SMOKE_PLANS == jfaults.SMOKE_PLANS
    tb, jb = baselines
    verdict, detail = faults._run_one(workload, FaultPlan.parse(spec), tb,
                                      "cpu")
    jverdict, jdetail = jfaults._run_one(
        workload, jfaults.FaultPlan.parse(spec), jb)
    assert verdict in ("identical", "classified"), (verdict, detail)
    assert verdict == jverdict, (detail, jdetail)
    assert detail == jdetail


def test_chaos_soak_and_cli_on_the_cpu(capsys):
    assert faults.chaos_main(["--chaos", "--seeds", "8", "--device",
                              "cpu"]) == 0
    assert faults.chaos_main(["--plan", "compile@0;straggler@1=0.001",
                              "--workload", "decode", "--device",
                              "cpu"]) == 0
    out = capsys.readouterr().out
    assert "MISMATCH" not in out and "UNCLASSIFIED" not in out
    assert "chaos summary" in out
    with pytest.raises(SystemExit):
        faults.chaos_main(["--device", "cpu"])    # no mode picked
