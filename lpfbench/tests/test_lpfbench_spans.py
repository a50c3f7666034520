"""The readers of the program's own spans and counters: each gives a
number on traced CPU runs of the tiny cells (the leaf ATen ops' CPU
time standing in for device time, since the CPU runs no kernel), the MoE
combine is a part of the block, the drop share is ``expert_load``'s, and
the stall count and the idle attribution on synthetic traces."""

import math
import time
from types import SimpleNamespace

import pytest
import torch

from lpfbench import expert_load, harness
from lpfbench.drivers import train as train_driver
from lpfbench.metrics import _spans
from lpfbench_tiny import fft_cell, smoke_cell

from repro_torch.core import trace

CPU = torch.device("cpu")


def _leaf(e) -> bool:
    return e.name.startswith("aten::") and not e.cpu_children


class _Op:
    """A traced op whose time, if it is a leaf ATen op, plays its device
    time."""

    def __init__(self, e):
        self._e = e

    def __getattr__(self, name):
        return getattr(self._e, name)

    @property
    def self_device_time_total(self):
        return self._e.self_cpu_time_total if _leaf(self._e) else 0


def _as_device(prof):
    """``prof`` with its leaf ATen ops as the device's kernels."""
    prof.ops = [_Op(e) for e in prof.ops]
    prof.kernels = sorted(
        (e.name, max(e.time_range.start, prof.w0),
         min(e.time_range.end, prof.w1))
        for e in prof.ops if _leaf(e))
    prof.busy = harness._union([(a, b) for _, a, b in prof.kernels])
    prof.busy_s = sum(b - a for a, b in prof.busy) / 1e6
    return prof


def _read(cell, window, names):
    view = harness.TraceView(cell, window, _as_device(window.profile))
    return {n: harness.metric_reader(n)(view) for n in names}


def _traced_run(cell, seed=2 ** 31 + 11, seconds=0.3):
    trace.reset_counters()
    out = harness.driver_of(cell).run(cell, seed=seed, seconds=seconds,
                                      trace=True, device=CPU,
                                      clock_zero=time.perf_counter())
    assert out.window.profile is not None
    return out.window


@pytest.fixture(scope="module")
def fft_readings():
    cell = fft_cell()
    return _read(cell, _traced_run(cell), [
        "lpf_flush_host_ms", "device_idle_lpf.fft", "host_stalls.fft",
        "lpf_host_ms"])


@pytest.fixture(scope="module")
def train_readings():
    cell = smoke_cell()
    got = _read(cell, _traced_run(cell), [
        "optim_share", "moe_combine_share", "moe_drop_share",
        "host_stalls.train", "moe_share"])
    trace.reset_counters()
    return got


@pytest.mark.parametrize("name", ["lpf_flush_host_ms",
                                  "device_idle_lpf.fft", "host_stalls.fft"])
def test_fft_readers_give_numbers(fft_readings, name):
    value = fft_readings[name]
    assert value is not None and math.isfinite(value), fft_readings
    assert value >= 0


def test_flushes_are_part_of_the_call(fft_readings):
    # no CUDA runtime call on the CPU
    assert fft_readings["host_stalls.fft"] == 0
    assert 0 < fft_readings["lpf_flush_host_ms"] \
        < fft_readings["lpf_host_ms"]
    assert fft_readings["device_idle_lpf.fft"] < 100


@pytest.mark.parametrize("name", ["optim_share", "moe_combine_share",
                                  "moe_drop_share", "host_stalls.train"])
def test_train_readers_give_numbers(train_readings, name):
    value = train_readings[name]
    assert value is not None and math.isfinite(value), train_readings
    assert value >= 0


def test_moe_combine_is_part_of_the_block(train_readings):
    assert 0 < train_readings["moe_combine_share"] \
        <= train_readings["moe_share"] < 100
    assert 0 < train_readings["optim_share"] < 100
    assert 0 <= train_readings["moe_drop_share"] <= 100


def test_moe_drop_share_agrees_with_expert_load():
    """One traced step on batch 0 of the seed's weights drops what
    ``expert_load`` reckons of the same batch through the same forward."""
    cell, seed = smoke_cell(), 7
    want = expert_load.read(cell, seed, 1, CPU)
    assert want["dropped_share"] > 0
    pool = train_driver.token_pool(seed, cell.traffic,
                                   cell.config["model"]["vocab_size"], CPU)
    ts, params, opt = train_driver.build(cell, seed, CPU)
    trace.reset_counters()
    with harness.Window(time.perf_counter(), 60.0, CPU, trace=True) as w:
        ts.step_fn(params, opt, train_driver.batch_of(pool, 0))
    got = harness.metric_reader("moe_drop_share")(
        harness.TraceView(cell, w, w.profile))
    trace.reset_counters()
    assert got == pytest.approx(100 * want["dropped_share"], rel=1e-12)


def _ev(name, a, b, thread=1, parent=None, span=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(
        start=a, end=b), thread=thread, cpu_parent=parent,
        is_user_annotation=span, scope=0)


def test_stalls_counted_inside_the_unit_span_only():
    call = _ev("fft.call", 0, 100, span=True)
    node = _ev(harness._EVALUATE + "MulBackward0", 40, 60, thread=2)
    ops = [call,
           _ev("cudaStreamSynchronize", 10, 20, parent=call),
           _ev("cudaMalloc", 30, 35, parent=call),
           _ev("cudaLaunchKernel", 36, 37, parent=call),
           _ev("cudaMemcpyAsync", 37, 38, parent=call),
           _ev("cudaFree", 45, 50, thread=2, parent=node),  # the backward's
           _ev("cudaMalloc", 52, 53, thread=3),             # another thread
           _ev("cudaDeviceSynchronize", 101, 110)]          # the caller's
    assert _spans.stalls(ops, "fft.call") == {
        "cudaStreamSynchronize": 1, "cudaMalloc": 1, "cudaFree": 1}
    view = SimpleNamespace(profile=SimpleNamespace(ops=ops))
    assert _spans.stalls_per_unit(view, "fft.call") == 3
    assert _spans.stalls_per_unit(view, "train.step") is None
    assert [_spans.is_stall(n) for n in (
        "cudaMemcpy", "cudaMemcpyAsync", "cudaEventSynchronize",
        "cudaLaunchKernel")] == [True, False, True, False]


def test_idle_time_goes_to_the_innermost_span():
    call = _ev("fft.call", 0, 90, span=True)
    ops = [call, _ev("lpf.flush", 35, 55, parent=call, span=True),
           _ev("aten::mm", 40, 50, parent=call)]
    prof = SimpleNamespace(ops=ops, w0=0, w1=100, window_s=100e-6,
                           busy=[(10, 30), (60, 100)], busy_s=60e-6)
    by = _spans.idle_by_span(prof)
    assert by == pytest.approx({"fft.call": 20e-6, "lpf.flush": 20e-6})
    view = SimpleNamespace(profile=prof)
    assert _spans.idle_share_under(view, "lpf.") == pytest.approx(20.0)
    assert _spans.idle_share_under(view, "train.") is None
