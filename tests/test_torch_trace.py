"""The port's spans and counters (``repro_torch.core.trace``): nothing
recorded and one shared no-op with no profiler; under the profiler on the
CPU, the span trees of ``bsp_fft``, an unrecorded superstep, a MoE
training step and a pod step, and the MoE block's route and drop
counters against ``expert_load``."""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.algorithms import bsp_fft
from repro_torch.configs import get_config
from repro_torch.core import ProgramCache, trace
from repro_torch.models import moe
from repro_torch.runtime.train_step import build_train_step

CPU = [ProfilerActivity.CPU]


def _spans(prof):
    """[(name, parent span's name or None)] of the traced spans, in
    order."""
    out = []
    for e in prof.events():
        if not e.is_user_annotation:
            continue
        up = e.cpu_parent
        while up is not None and not up.is_user_annotation:
            up = up.cpu_parent
        out.append((e.name, up.name if up is not None else None))
    return out


def test_span_off_is_the_shared_noop_and_records_nothing():
    assert not trace.tracing()
    s = trace.span("t.off")
    assert s is trace.span("t.off")
    with s as got:
        assert got is None
    calls = []

    @trace.span("t.deco")
    def f(x):
        calls.append(trace.tracing())
        return x + 1

    assert f(1) == 2 and calls == [False]
    trace.reset_counters()
    trace.count("t.n", 3)
    trace.count("t.n", torch.tensor(2))
    assert trace.counters() == {}
    # decorated while off, traced when called under a profiler
    with profile(activities=CPU) as prof:
        assert f(2) == 3
        trace.count("t.n", 3)
        trace.count("t.n", torch.tensor(2))
    assert ("t.deco", None) in _spans(prof)
    assert trace.counters() == {"t.n": 5}
    trace.reset_counters()
    assert trace.counters() == {}


def test_span_decorated_while_traced_checks_at_each_call(monkeypatch):
    with profile(activities=CPU):
        on = trace.span("t.on")

        @trace.span("t.deco_on")
        def f(x):
            return x + 1

    assert on is not trace.span("t.on")
    with profile(activities=CPU) as prof:
        with on:
            assert f(1) == 2
    assert _spans(prof) == [("t.on", None), ("t.deco_on", "t.on")]
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a: opened.append(a))
    assert f(2) == 3 and opened == []


class _Event:
    def __init__(self, name, cuda, annotation):
        self.name = self.key = name
        self.device_type = torch.autograd.DeviceType.CUDA if cuda \
            else torch.autograd.DeviceType.CPU
        self.is_user_annotation = annotation


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _reader_modules():
    import importlib.util
    import pathlib
    root = pathlib.Path(__file__).resolve().parent.parent
    out = []
    for path in (root / "chip_smoke.py", root / "scripts" / "_timing.py"):
        spec = importlib.util.spec_from_file_location(
            f"_reader_{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out.append(pytest.param(mod, id=path.stem))
    return out


@pytest.mark.parametrize("mod", _reader_modules())
def test_device_readers_leave_spans_out(mod):
    """A span shows on the device's timeline too, flagged as a user
    annotation (or only by its name, where the flag is missing): the
    readers of ``chip_smoke.py`` and ``scripts/_timing.py`` count only
    kernels and copies."""
    kernel = _Event("elementwise_kernel", True, False)
    events = [_Event("moe.combine", False, True),
              _Event("moe.combine", True, True),
              _Event("lpf.flush", False, True),
              _Event("lpf.flush", True, False),
              _Event("aten::add", False, False),
              kernel,
              _Event("Memcpy HtoD (Pageable -> Device)", True, False)]
    got = mod.device_work(_Prof(events), events)
    assert [e.name for e in got] == [
        "elementwise_kernel", "Memcpy HtoD (Pageable -> Device)"]


def _fft_calls(calls):
    pc = ProgramCache()
    x = torch.randn(1 << 10, dtype=torch.complex64,
                    generator=torch.Generator().manual_seed(0))
    out = []
    for _ in range(calls):
        with profile(activities=CPU) as prof:
            bsp_fft(x, p=4, device="cpu", program_cache=pc)
        out.append(_spans(prof))
    return out


def test_fft_span_tree():
    first, second = _fft_calls(2)
    for tree in (first, second):
        assert tree[0] == ("fft.call", None)
        assert ("lpf.exec", "fft.call") in tree
        for name in ("fft.local", "fft.twiddle", "fft.dft", "lpf.flush",
                     "lpf.sync"):
            assert (name, "lpf.exec") in tree, name
        flushes = tree.count(("lpf.flush", "lpf.exec"))
        assert flushes >= 1
        for stage in ("lookup", "certify", "compiled"):
            assert tree.count((f"lpf.program.{stage}", "lpf.flush")) \
                == flushes
        assert ("lpf.program.dispatch", "lpf.flush") not in tree
        assert {p for _, p in tree} <= {None, "fft.call", "lpf.exec",
                                        "lpf.flush"}
    # a fresh program cache compiles on the first call only
    assert ("lpf.program.compile", "lpf.flush") in first
    assert ("lpf.program.compile", "lpf.flush") not in second


def test_fft_span_tree_dispatched(monkeypatch):
    monkeypatch.setenv("LPF_COMPILE_PROGRAMS", "0")
    tree, = _fft_calls(1)
    n = tree.count(("lpf.flush", "lpf.exec"))
    assert n >= 1 and tree.count(("lpf.program.dispatch", "lpf.flush")) == n
    assert not any(name in ("lpf.program.compile", "lpf.program.compiled")
                   for name, _ in tree)


def test_unrecorded_sync_plans_under_its_span():
    from repro_torch.core import exec_

    def spmd(ctx, s, p, _):
        ctx.resize_memory_register(1)
        ctx.resize_message_queue(p)
        slot = ctx.register_global("x", s.float().expand(p, 4).clone())
        ctx.put(slot, slot, to=lambda i: (i + 1) % p, size=1)
        ctx.sync(label="ring")
        return ctx.tensor(slot)

    with profile(activities=CPU) as prof:
        exec_(4, spmd, device="cpu")
    tree = _spans(prof)
    assert tree[:3] == [("lpf.exec", None), ("lpf.sync", "lpf.exec"),
                        ("lpf.plan", "lpf.sync")]
    sync = next(e for e in prof.events() if e.name == "lpf.sync")
    assert sync.cpu_parent.name == "lpf.exec"


def _moe_block(capacity_factor, seed=0):
    cfg = dataclasses.replace(
        get_config("granite-moe-3b-a800m", smoke=True).moe,
        capacity_factor=capacity_factor)
    p = moe.moe_params(torch.Generator().manual_seed(seed), cfg,
                       torch.float32, "cpu")
    x = torch.randn(2, 32, cfg.d_model,
                    generator=torch.Generator().manual_seed(seed + 1))
    return cfg, p, x


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_counters_match_expert_load(capacity_factor):
    cfg, p, x = _moe_block(capacity_factor)
    load, cap = moe.expert_load(p, x, cfg)
    want = int((load - cap).clamp_min(0).sum())
    trace.reset_counters()
    moe.moe_single(p, x, cfg)
    assert trace.counters() == {}
    with profile(activities=CPU) as prof:
        moe.moe_single(p, x, cfg)
    got = trace.counters()
    assert got == {"moe.routed": 2 * 32 * cfg.top_k, "moe.dropped": want}
    if capacity_factor < 1:
        assert want > 0
    tree = _spans(prof)
    assert tree == [("moe_single", None)] + [
        (f"moe.{s}", "moe_single")
        for s in ("route", "dispatch", "experts", "combine")]
    trace.reset_counters()


def test_train_step_span_tree_and_counters():
    cfg = get_config("granite-moe-3b-a800m", smoke=True)
    assert cfg.remat == "full"
    ts = build_train_step(cfg, device="cpu")
    params, opt = ts.init_fn(0)
    B, S = 2, 16
    tokens = torch.randint(0, cfg.vocab, (B, S + 1),
                           generator=torch.Generator().manual_seed(3))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    trace.reset_counters()
    with profile(activities=CPU) as prof:
        ts.step_fn(params, opt, batch)
    tree = _spans(prof)
    assert tree[0] == ("train.step", None)
    for name in ("train.forward", "train.backward", "train.optimizer"):
        assert tree.count((name, "train.step")) == 1, name
    layers = cfg.groups[0].repeats
    # each layer's block in the forward and in its remat recompute
    assert tree.count(("moe_single", "train.forward")) == layers
    assert tree.count(("moe_single", "train.backward")) == layers
    for s in ("route", "dispatch", "experts", "combine"):
        assert tree.count((f"moe.{s}", "moe_single")) == 2 * layers
    # counted once a forward: the recompute is not counted again
    got = trace.counters()
    assert got["moe.routed"] == layers * B * S * cfg.moe.top_k
    assert 0 <= got["moe.dropped"] <= got["moe.routed"]
    trace.reset_counters()


def test_pod_step_span_tree():
    from repro_torch.launch.mesh import make_mesh
    cfg = get_config("llama3.2-1b", smoke=True)
    ts = build_train_step(cfg, make_mesh((2, 1, 1)), grad_sync="lpf",
                          device="cpu")
    params, opt = ts.init_fn(0)
    tokens = torch.randint(0, cfg.vocab, (2, 17),
                           generator=torch.Generator().manual_seed(1))
    with profile(activities=CPU) as prof:
        ts.step_fn(params, opt, {"tokens": tokens[:, :-1],
                                 "labels": tokens[:, 1:]})
    tree = _spans(prof)
    assert tree[0] == ("train.step", None)
    # one forward and backward a pod, then the sync and one update
    for name, n in (("train.forward", 2), ("train.backward", 2),
                    ("train.pod_sync", 1), ("train.optimizer", 1)):
        assert tree.count((name, "train.step")) == n, name
    names = [n for n, _ in tree]
    assert names.index("train.pod_sync") > max(
        i for i, n in enumerate(names) if n == "train.backward")
