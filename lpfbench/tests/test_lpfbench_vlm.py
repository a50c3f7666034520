"""The vision-language cell (``llava-train-b2s4096-672px``, driver
``train_vlm``): its configuration is the port's model, read back through
the reference; the planted faults of the driver, in a whole run at the
port's tower smoke config (float32 compute, where a sound run reads
float32 rounding), make ``correct`` false where the sound run is
correct; its four readers on traced CPU runs and on synthetic traces."""

import time
from types import SimpleNamespace

import pytest
import torch

from lpfbench import harness
from lpfbench.counts import flash, vlm
from lpfbench.drivers import train as train_driver
from lpfbench.drivers import train_vlm
from lpfbench.reference import llava_next
from lpfbench_tiny import line
from lpfbench_tiny_vlm import CELL, vlm_cell

from repro_torch.core import trace

CPU = torch.device("cpu")


def test_the_configuration_is_the_ports_model():
    cell = harness.load_cell(CELL)
    assert train_driver.reference_of(cell.config) is llava_next
    cfg = train_driver.program_config(cell.config)
    got = llava_next.port_sizes(cfg)
    assert got.items() <= train_driver.sizes(cell.config).items()
    assert cfg.n_layers == 12 and cfg.vision.run_layers == 23
    from repro_torch.runtime.train_step import build_train_step
    ts = build_train_step(cfg, device="cpu")
    tree = {n: tuple(p.shape) for n, p in
            ts.like_fn()[0].named_parameters()}
    specs = llava_next.param_specs(train_driver.sizes(cell.config))
    assert tree == {n: tuple(s) for n, s, _ in specs}
    assert sum(p for s in tree.values() for p in [torch.Size(s).numel()]) \
        == 3_191_385_088


def test_the_layout_of_a_672_pixel_image():
    cell = harness.load_cell(CELL)
    assert train_vlm.layout(cell) == {
        "tiles": 5, "grid": (2, 2), "side": 24, "patches": 576,
        "positions": 2928, "text": 1168}
    bad = harness.load_cell(CELL)
    bad.traffic = dict(bad.traffic, image_px=[336, 672])
    with pytest.raises(harness.BenchError):
        train_vlm.layout(bad)


def test_counts_of_the_cell():
    m = harness.load_cell(CELL).config["model"]
    n = vlm.vlm_param_counts(m)
    assert n == {"decoder": 2_879_492_096, "head": 32_000 * 4096,
                 "tower": 290_909_184, "projector": 20_979_712}
    # the head over the 2 x 1,168 text positions alone
    flops = vlm.vlm_train_flops(m, 8192, 2336, 10)
    assert flops == 6 * ((n["decoder"] - n["head"]) * 8192
                         + n["head"] * 2336 + n["tower"] * 577 * 10
                         + n["projector"] * 576 * 10)
    assert 147e12 < flops < 148e12
    assert vlm.attention_shapes(m, 2, 4096, 10) == {
        "decoder": (2, 32, 8, 4096, 128, True),
        "tower": (10, 16, 16, 577, 64, False)}


def test_weights_start_where_the_reference_says():
    cell = vlm_cell()
    m = train_driver.sizes(cell.config)
    specs = llava_next.param_specs(m)
    got = llava_next.make_params(7, specs, "cpu")
    for name in llava_next.ONES:
        assert torch.equal(got[name], torch.ones_like(got[name]))
    i = [s[0] for s in specs].index("vision.patch_embed")
    assert torch.equal(got["vision.patch_embed"],
                       llava_next.start_leaf(7, i, specs[i], "cpu"))
    _, params, _ = train_vlm.build(cell, 7, CPU)
    for name, p in params.named_parameters():
        assert torch.equal(p.detach(), got[name]), name


def test_sound_run_is_correct():
    assert line(vlm_cell(compute_dtype="float32"), seconds=0.3)["correct"] \
        is True


@pytest.mark.parametrize("kind", sorted(train_vlm.FAULTS))
def test_planted_fault_is_caught(kind):
    with train_vlm.planted(kind):
        out = line(vlm_cell(compute_dtype="float32"), seconds=0.3)
    assert out["correct"] is False
    assert out["checks"]["grad_err"]["value"] > \
        out["checks"]["grad_err"]["limit"]


def test_planted_is_undone():
    from repro_torch.models import lm, vision
    before = (vision.project, vision.pack, lm._layers)
    for kind in train_vlm.FAULTS:
        with train_vlm.planted(kind):
            pass
    assert (vision.project, vision.pack, lm._layers) == before


# --------------------------------------------------------------------------
# the readers
# --------------------------------------------------------------------------

def _leaf(e) -> bool:
    return e.name.startswith("aten::") and not e.cpu_children


class _Op:
    """A traced op whose CPU time, if it is a leaf ATen op, plays its
    device time."""

    def __init__(self, e):
        self._e = e

    def __getattr__(self, name):
        return getattr(self._e, name)

    @property
    def self_device_time_total(self):
        return self._e.self_cpu_time_total if _leaf(self._e) else 0


def _as_device(prof):
    prof.ops = [_Op(e) for e in prof.ops]
    prof.kernels = sorted(
        (e.name, max(e.time_range.start, prof.w0),
         min(e.time_range.end, prof.w1))
        for e in prof.ops if _leaf(e))
    prof.busy = harness._union([(a, b) for _, a, b in prof.kernels])
    prof.busy_s = sum(b - a for a, b in prof.busy) / 1e6
    return prof


@pytest.fixture(scope="module")
def traced():
    cell = vlm_cell()
    trace.reset_counters()
    out = train_vlm.run(cell, seed=2 ** 31 + 3, seconds=0.3, trace=True,
                        device=CPU, clock_zero=time.perf_counter())
    view = harness.TraceView(cell, out.window, _as_device(out.window.profile))
    got = {n: harness.metric_reader(n)(view) for n in (
        "vision_share", "train_mfu.vlm", "flash_fwd_roofline.vlm",
        "flash_bwd_roofline.vlm", "optim_share")}
    counted = trace.counters()
    trace.reset_counters()
    return got, counted, out.window.units


def test_vision_share_reads_a_part_of_the_step(traced):
    got, _, _ = traced
    assert 0.0 < got["vision_share"] < 100.0
    assert got["vision_share"] + got["optim_share"] < 100.0


def test_train_mfu_vlm_counts_the_window_tiles(traced):
    got, counted, units = traced
    # 2 images of 5 tiles and 24 positions a step
    assert counted.get("vision.tiles") == 10 * units
    assert counted.get("vision.positions") == 48 * units
    assert got["train_mfu.vlm"] > 0.0


def test_flash_readers_read_nothing_without_the_kernels(traced):
    got, _, _ = traced
    assert got["flash_fwd_roofline.vlm"] is None
    assert got["flash_bwd_roofline.vlm"] is None


class _FakeProfile:
    """``n_dec`` and ``n_tower`` launches of each flash kernel, each of
    ``ms``; the ``vision.layer`` ranges hold ``n_tower`` flash forwards
    and backward nodes, each with a runtime call under it that the
    profiler also tied the kernel to (which must not count)."""

    def __init__(self, n_dec, n_tower, ms):
        self.n_dec, self.n_tower, self.ms = n_dec, n_tower, ms

    def kernel_s(self, pattern):
        n = self.n_dec + self.n_tower
        return n * self.ms / 1e3, n

    def range_ops(self, name):
        assert name == "vision.layer"
        out = []
        for _ in range(self.n_tower):
            for op in ("_FlashAttention", "_FlashAttentionBackward"):
                e = SimpleNamespace(name=op, cpu_parent=None)
                call = SimpleNamespace(name="cudaLaunchKernel", cpu_parent=e)
                full = SimpleNamespace(name="_FlashAttention",
                                       cpu_parent=call)
                out += [e, call, full]
        return out


def _fake_view(n_dec, n_tower, ms):
    cell = harness.load_cell(CELL)
    return harness.TraceView(cell, None, _FakeProfile(n_dec, n_tower, ms))


def test_flash_rooflines_sum_each_launch_at_its_own_shape():
    dec = (2, 32, 8, 4096, 128, True)
    tower = (10, 16, 16, 577, 64, False)
    fwd = harness.metric_reader("flash_fwd_roofline.vlm")(
        _fake_view(32, 46, 0.5))
    want = (32 * flash.flash_fwd_bound_ms(*dec, None, 2)[0]
            + 46 * flash.flash_fwd_bound_ms(*tower, None, 2)[0]) / (78 * 0.5)
    assert fwd == pytest.approx(100 * want)
    bwd = harness.metric_reader("flash_bwd_roofline.vlm")(
        _fake_view(16, 23, 1.0))
    d, t = (flash.flash_bwd_bound_ms(*s, None, 2) for s in (dec, tower))
    least = sum(16 * d[p][0] + 23 * t[p][0] for p in ("dkv", "dq"))
    assert bwd == pytest.approx(100 * least / (2 * 39 * 1.0))


@pytest.mark.parametrize("n_dec, n_tower", [(32, 0), (0, 46)])
def test_flash_rooflines_need_both_kinds_of_launch(n_dec, n_tower):
    view = _fake_view(n_dec, n_tower, 0.5)
    for name in ("flash_fwd_roofline.vlm", "flash_bwd_roofline.vlm"):
        assert harness.metric_reader(name)(view) is None
