"""Parity of the port's static analysis (``repro_torch.analysis``: the
linter, the schedule verifier, sanitizer mode) with the JAX package's.

Both packages lint and verify the same traces and schedules — the JAX
tests' fixtures (``tests/test_analysis.py``) handed to the port as plain
fields (``repro_torch.interop``) — and must give the same diagnostics
(code, severity, anchor step, offending message) and the same
certificates (``ok``, counts, summary).  Sanitizer mode on the port's
context raises before any data moves and collects warnings as the JAX
context does.
"""

import dataclasses

import numpy as np
import pytest
import torch

import test_analysis as tan
from repro import analysis as janalysis
from repro.core import machine as jmachine
from repro.core import program as jprog
from repro_torch import analysis as tanalysis
from repro_torch import core as tlpf
from repro_torch.interop import (hardware_from_fields, program_from_fields,
                                 slot_from_fields, steps_from_fields)

JM = tan.MACHINE
TM = tlpf.probe({"x": 8}, hardware_from_fields(
    dataclasses.asdict(jmachine.CPU_HOST)))


def to_port(steps):
    return steps_from_fields([dataclasses.asdict(s) for s in steps])


def port_slot(s):
    return None if s is None else slot_from_fields(dataclasses.asdict(s))


def diag_key(d):
    m = d.msg
    return (d.code, d.severity, d.step, None if m is None else (
        m.src, m.dst, m.src_slot.sid, m.src_off, m.dst_slot.sid, m.dst_off,
        m.size, m.origin))


def same_diags(jd, td):
    assert [diag_key(d) for d in jd] == [diag_key(d) for d in td]
    return [d.code for d in td]


S, A, B, C = tan.step, tan.A, tan.B, tan.C
LOCAL = tan.make_slot(500, 16, kind="local")
LINT_CASES = {
    "lpf001_race": ([S([tan.Msg(0, 1, A, 0, B, 0, 4),
                        tan.Msg(0, 1, A, 4, B, 2, 4)],
                       tan.SyncAttributes(no_conflict=True))], {}),
    "lpf001_reduce": ([S([tan.Msg(0, 1, A, 0, B, 0, 4),
                          tan.Msg(0, 1, A, 4, B, 2, 4)],
                         tan.SyncAttributes(no_conflict=True,
                                            reduce_op="sum"))], {}),
    "lpf002_undefined": ([S([tan.Msg(0, 1, B, 0, C, 0, 4)])],
                         {"undefined": [B.sid]}),
    "lpf002_partial": ([S([tan.Msg(1, 0, A, 0, B, 0, 2)]),
                        S([tan.Msg(0, 1, B, 0, C, 0, 4)])],
                       {"undefined": [B.sid]}),
    "lpf003_dereg": ([S([tan.Msg(0, 1, A, 0, B, 0, 4)]),
                      S([tan.Msg(0, 1, A, 0, B, 4, 4)])],
                     {"events": [(1, "deregister", A.sid)]}),
    "lpf003_leak": ([S([tan.Msg(0, 1, A, 0, B, 0, 4)])],
                    {"events": [(0, "register", A.sid)]}),
    "lpf004_oob": ([S([tan.Msg(0, 1, A, 12, B, 0, 8)]),
                    S([tan.Msg(0, 5, A, 0, B, 0, 4)]),
                    S([tan.Msg(0, 1, A, 0, LOCAL, 0, 4)])], {}),
    "lpf005_alias": ([S([tan.Msg(1, 1, A, 0, A, 2, 8)])], {}),
    "lpf006_dead": ([S([tan.Msg(0, 1, A, 0, B, 0, 8)], label="dead"),
                     S([tan.Msg(0, 1, C, 0, B, 0, 8)], label="clobber")], {}),
    "lpf006_read_between": (
        [S([tan.Msg(0, 1, A, 0, B, 0, 8)]), S([tan.Msg(1, 0, B, 0, C, 0, 4)]),
         S([tan.Msg(0, 1, C, 0, B, 0, 8)])], {}),
}


@pytest.mark.parametrize("name", sorted(LINT_CASES))
def test_lint_trace_matches_jax(name):
    steps, kw = LINT_CASES[name]
    codes = same_diags(janalysis.lint_trace(steps, 2, **kw),
                       tanalysis.lint_trace(to_port(steps), 2, **kw))
    want = name.split("_")[0].upper()
    if name not in ("lpf001_reduce", "lpf006_read_between"):
        assert want in codes
    else:
        assert want not in codes


def test_lint_program_matches_jax():
    """The dead transfer a union of two writes kills survives
    optimization in both packages; the single-write one is eliminated."""
    for trace, n_elim in (
            ([S([tan.Msg(0, 1, A, 0, B, 0, 8)], label="dead"),
              S([tan.Msg(0, 1, A, 8, B, 0, 4), tan.Msg(0, 1, A, 0, B, 4, 4)],
                label="clobber2")], 0),
            ([S([tan.Msg(0, 1, A, 0, B, 0, 8)], label="dead"),
              S([tan.Msg(0, 1, C, 0, B, 0, 8)], label="clobber")], 1)):
        jp = jprog.optimize_program(trace, 2, JM)
        tsteps = to_port(trace)
        tp = tlpf.optimize_program(tsteps, 2, TM)
        assert jp.n_eliminated == tp.n_eliminated == n_elim
        codes = same_diags(janalysis.lint_program(jp, trace),
                           tanalysis.lint_program(tp, tsteps))
        assert ("LPF006" in codes) == (n_elim == 0)
        assert tanalysis.verify_program(tsteps, tp).ok


def same_report(jr, tr):
    assert (jr.ok, jr.n_steps, jr.n_groups, jr.n_rewrites) == \
        (tr.ok, tr.n_steps, tr.n_groups, tr.n_rewrites)
    assert jr.summary() == tr.summary()
    same_diags(jr.diagnostics, tr.diagnostics)


@pytest.mark.parametrize("chunk", range(10))
def test_verifier_certifies_every_schedule_as_jax(chunk):
    """The JAX test's 300-seed sweep (random and structured traces, both
    search settings, with and without scratch), 30 seeds a case: the
    port's schedule of each certifies, with the JAX package's report."""
    for seed in range(30 * chunk, 30 * chunk + 30):
        p, _, steps, scratch = tan._sweep_trace(seed)
        hw = jmachine.TPU_V5E if seed % 5 == 0 else jmachine.CPU_HOST
        jm = jmachine.probe({"x": p}, hw)
        tm = tlpf.probe({"x": p}, hardware_from_fields(
            dataclasses.asdict(hw)))
        tsteps, tscratch = to_port(steps), port_slot(scratch)
        for search in (True, False):
            jp = jprog.optimize_program(steps, p, jm, scratch=scratch,
                                        search=search)
            tp = tlpf.optimize_program(tsteps, p, tm, scratch=tscratch,
                                       search=search)
            jr = janalysis.verify_program(steps, jp, scratch=scratch)
            tr = tanalysis.verify_program(tsteps, tp, scratch=tscratch)
            same_report(jr, tr)
            assert tr.ok, (seed, search, [str(d) for d in tr.diagnostics])


def _tamper(prog, i, **fields):
    st = prog.steps[i]
    return dataclasses.replace(prog, steps=prog.steps[:i] + (
        dataclasses.replace(st, **fields),) + prog.steps[i + 1:])


def _negative_fixtures():
    """The JAX tests' hand-built schedules, one per verifier code (and
    the legal one): (name, trace, program, scratch)."""
    W, R = tan.W, tan.R
    good = tan._build_program([W, R], 2, [(0,), (1,)])
    w2 = tan.step([tan.Msg(0, 1, C, 0, B, 2, 4)], label="w2")
    cost = good.steps[0].plan.cost
    smap = jprog.trace_slot_map([W, R], [0, 1])
    sidx = {s.sid: i for i, s in enumerate(smap)}
    extra = tan._canon([tan.Msg(0, 1, A, 8, B, 8, 4)], sidx)
    scratch = tan.make_slot(999, 4096)
    return [
        ("legal", [W, R], good, None),
        ("lpf101_count", [W, R], dataclasses.replace(good, n_recorded=3),
         None),
        ("lpf101_dup", [W, R], _tamper(good, 0, merged_from=(0, 0)), None),
        ("lpf102", [W, R], tan._build_program([W, R], 2, [(1,), (0,)]),
         None),
        ("lpf103_raw", [W, R], tan._build_program([W, R], 2, [(0, 1)]),
         None),
        ("lpf103_waw", [W, w2], tan._build_program([W, w2], 2, [(0, 1)]),
         None),
        ("lpf104", [W, R], tan._build_program(
            [W, R], 2, [(0,), (1,)], overlap_groups=((0, 1),)), None),
        ("lpf105_scratch", [W], tan._build_program(
            [W], 2, [(0,)], plan_scratch=scratch,
            rewrites={0: "valiant"}), None),
        ("lpf105_unknown", [W, R], _tamper(good, 0, rewrite="wat"), None),
        ("lpf106", [W, R], _tamper(good, 0, plan=dataclasses.replace(
            good.steps[0].plan, cost=dataclasses.replace(
                cost, wire_bytes=cost.wire_bytes + 64))), None),
        ("lpf107_dropped", [W, R], _tamper(good, 0, table=()), None),
        ("lpf107_fabricated", [W, R],
         _tamper(good, 0, table=good.steps[0].table + extra), None),
    ]


@pytest.mark.parametrize("case", range(12))
def test_verifier_refuses_what_jax_refuses(case):
    name, trace, prog, scratch = _negative_fixtures()[case]
    tp = program_from_fields(dataclasses.asdict(prog))
    jr = janalysis.verify_program(trace, prog, scratch=scratch)
    tr = tanalysis.verify_program(to_port(trace), tp,
                                  scratch=port_slot(scratch))
    same_report(jr, tr)
    if name == "legal":
        assert tr.ok
    else:
        assert not tr.ok
        assert name.split("_")[0].upper() in {d.code
                                               for d in tr.diagnostics}


# ---------------------------------------------------------------------------
# sanitizer mode on the port's context
# ---------------------------------------------------------------------------

def _ctx(sanitize=None, p=1):
    ctx = tlpf.LPFContext(p, device="cpu", sanitize=sanitize)
    ctx.resize_memory_register(4)
    ctx.resize_message_queue(16)
    return ctx


def _ints(*shape):
    return torch.arange(int(np.prod(shape)), dtype=torch.int32).reshape(
        *shape)


def test_sanitize_stale_handle_raises_at_put():
    ctx = _ctx(sanitize=True)
    a = ctx.register_global("a", torch.zeros(1, 8, dtype=torch.int32))
    ctx.deregister(a)
    c = ctx.register_global("c", torch.zeros(1, 8, dtype=torch.int32))
    assert c.sid == a.sid and c.gen != a.gen
    with pytest.raises(tlpf.LPFAnalysisError, match="LPF003"):
        ctx.put_msgs([(0, 0, c, 0, a, 0, 4)])
    assert not ctx._queue


def test_sanitize_no_conflict_race_raises_before_execution():
    ctx = _ctx(sanitize=True)
    a = ctx.register_global("a", _ints(1, 8))
    b = ctx.register_global("b", torch.zeros(1, 8, dtype=torch.int32))
    ctx.put_msgs([(0, 0, a, 0, b, 0, 4), (0, 0, a, 4, b, 2, 4)])
    before = ctx.registry.value(b).clone()
    with pytest.raises(tlpf.LPFAnalysisError, match="LPF001"):
        ctx.sync(tlpf.SyncAttributes(no_conflict=True))
    assert torch.equal(ctx.registry.value(b), before)


def test_sanitize_refuses_a_racy_recorded_program_before_it_runs():
    ctx = _ctx(sanitize=True, p=2)
    a = ctx.register_global("a", _ints(2, 8))
    b = ctx.register_global("b", torch.zeros(2, 8, dtype=torch.int32))
    before = ctx.registry.value(b).clone()
    with pytest.raises(tlpf.LPFAnalysisError, match="LPF001"):
        with ctx.program("racy"):
            ctx.put_msgs([(0, 1, a, 0, b, 0, 4), (1, 1, a, 4, b, 2, 4)])
            ctx.sync(tlpf.SyncAttributes(no_conflict=True))
    assert torch.equal(ctx.registry.value(b), before)
    assert not ctx.ledger.records


def test_sanitize_warnings_accumulate_on_diagnostics():
    ctx = _ctx(sanitize=True)
    a = ctx.register_global("a", _ints(1, 8))
    ctx.put_msgs([(0, 0, a, 0, a, 2, 4)])        # aliasing self-copy
    ctx.sync()
    assert any(d.code == "LPF005" for d in ctx.diagnostics)


def test_sanitize_recorded_trace_and_leak_warning():
    ctx = _ctx(sanitize=True)
    a = ctx.register_global("a", _ints(1, 8))
    with ctx.program("loop"):
        b = ctx.register_global("b", torch.zeros(1, 8, dtype=torch.int32))
        ctx.put_msgs([(0, 0, a, 0, b, 0, 8)])
        ctx.sync()
    assert any(d.code == "LPF003" and d.severity == "warning"
               for d in ctx.diagnostics)


def test_sanitize_env_default_and_inheritance(monkeypatch):
    monkeypatch.setenv("LPF_SANITIZE", "1")
    ctx = tlpf.LPFContext(2, device="cpu")
    assert ctx.sanitize
    seen = []
    ctx.compile_loop(lambda sub, c: seen.append(
        (sub.sanitize, sub.diagnostics is ctx.diagnostics)) or c,
        torch.zeros(2, 1), n_iters=1)
    assert seen == [(True, True)]
    monkeypatch.setenv("LPF_SANITIZE", "0")
    assert not tlpf.LPFContext(2, device="cpu").sanitize
    assert tlpf.LPFContext(2, device="cpu", sanitize=True).sanitize


def test_explain_renders_certificate_summary():
    p, _, steps, scratch = tanalysis.canned_fft_trace(4, 8)
    prog = tlpf.optimize_program(steps, p, TM, scratch=scratch)
    txt = prog.explain(TM, steps=steps, scratch=scratch)
    assert "verified:" in txt and "0 diagnostics" in txt
    cache = tlpf.ProgramCache()
    prog2, key = cache.get_or_build_keyed(steps, p, TM, scratch=scratch)
    cert = cache.certify(key, steps, scratch=scratch)
    assert cache.certify(key, steps) is cert
    assert "verified:" in prog2.explain()
