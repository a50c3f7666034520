"""llava-next-mistral-7b with its real vision tower in the port
(``llava-next-mistral-7b-tower``: a ``VLMConfig``, ``models/vision.py``)
against the benchmark's plain reference (``lpfbench/reference/
llava_next.py``, plain float32 PyTorch) on the CPU.

At the tower smoke config (decoder d 128, 2 layers, 4 heads over 2 kv
heads of 32; tower d 64, 2 run layers of 3, 4 heads of 16, 28-px tiles of
14-px patches: 5 tiles and 24 positions an image) with seeded random
weights, every leaf moved off its initial value (biases 0 and LayerNorm
scales 1 would hide a wrong bias or scale), the logits, the loss and
every leaf's gradient are held to the reference's:

* f32 compute: relative errors below 1e-5 (logits, a leaf's gradient,
  each the largest error over the largest value) and 1e-6 (loss):
  float32 rounding of the same arithmetic in another order (read: 1.5e-6
  at most, the loss equal);
* bf16 compute: below 0.03 (logits), 2e-3 (loss) and 0.06 (a leaf's
  gradient, L2 error over the reference's norm): the rounding of bf16
  operands over two layers of tower and decoder (read: 0.011, 4.3e-4 and
  0.028 at most).

The key bias's gradient is zero by symmetry (adding one vector to every
key moves no softmax), so that leaf is held in absolute terms only.

Besides: where anyres packing puts each tile's patch and the newline;
the patch embedding as the convolution it stands for; the ``vision.*``
counters at the published shapes on meta tensors; the spans under the
profiler, and their ranges' autograd nodes; the training launcher; the
data stream's pixels; and that the stub config stays as it was.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from lpfbench.reference import llava_next as ref
from repro_torch.configs import ARCHS, VARIANTS, get_config
from repro_torch.core import trace
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.launch import train as train_mod
from repro_torch.models import (Runtime, cast_params, count_params, forward,
                                init_params, load_params, loss_fn, vision)
from repro_torch.models import lm
from repro_torch.models.config import VisionCfg, VLMConfig
from repro_torch.runtime.train_step import build_train_step

ARCH = "llava-next-mistral-7b"
TOWER = "llava-next-mistral-7b-tower"
CPU = Runtime("cpu")
ZERO_BY_SYMMETRY = "vision.layers.b0.attn.bk"


def smoke(**kw):
    return dataclasses.replace(get_config(TOWER, smoke=True), **kw)


def moved_params(cfg, seed=0):
    """The port's tree of ``seed`` with every leaf moved by N(0, 0.1)
    (relative to a matrix's own scale)."""
    params = init_params(seed, cfg, device="cpu", trainable=True)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for _, p in params.named_parameters():
            scale = p.std().item() if p.ndim > 1 else 1.0
            p.add_(0.1 * scale * torch.randn(p.shape, generator=g))
    return params


def batch_of(cfg, seed, B=2, S=20):
    g = torch.Generator().manual_seed(seed)
    v = cfg.vision
    return {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g),
            "labels": torch.randint(0, cfg.vocab, (B, S), generator=g),
            "pixels": torch.randn(B, v.n_tiles, 3, v.image_size,
                                  v.image_size, generator=g)}


def rel_max(a, b):
    return float((a - b).abs().max() / b.abs().max())


def rel_l2(a, b):
    return float((a - b).norm() / b.norm())


# --------------------------------------------------------------------------
# the configs
# --------------------------------------------------------------------------

def test_stub_config_is_untouched_and_the_tower_is_a_variant():
    stub = get_config(ARCH)
    assert stub.vision is None and type(stub).__name__ == "ModelConfig"
    assert "vision" not in dataclasses.asdict(stub)
    assert TOWER in VARIANTS and TOWER not in ARCHS and len(ARCHS) == 10
    full = get_config(TOWER)
    assert isinstance(full, VLMConfig) and full.vision == VisionCfg()
    # the backbone is the stub's, field for field, but the stub prefix
    for f in dataclasses.fields(stub):
        if f.name not in ("name", "stub_prefix"):
            assert getattr(full, f.name) == getattr(stub, f.name), f.name
    assert full.stub_prefix == 0


@pytest.mark.parametrize("smoke_cfg", [False, True])
def test_vision_layout(smoke_cfg):
    v = get_config(TOWER, smoke=smoke_cfg).vision
    want = (23, 576, 2928) if not smoke_cfg else (2, 4, 24)
    assert (v.run_layers, v.n_patches, v.n_positions) == want
    assert v.n_tiles == 5


def test_parameter_counts_hold_23_tower_layers():
    full = get_config(TOWER)
    layers = {n: tuple(p.shape) for n, p in init_params(
        0, full, device="meta").named_parameters()
        if n.startswith("vision.layers.")}
    assert {s[0] for s in layers.values()} == {23}
    assert layers["vision.layers.b0.attn.bo"] == (23, 1024)
    tower = count_params(full) - count_params(get_config(ARCH))
    # tower 290,909,184, projector 20,979,712, newline 4,096
    assert tower == 311_892_992
    cut = dataclasses.replace(full, groups=(dataclasses.replace(
        full.groups[0], repeats=12),))
    assert count_params(cut) == 3_191_385_088       # the benchmark's cut


def test_reference_specs_are_the_ports_tree():
    for cfg in (smoke(), get_config(TOWER)):
        m = ref.port_sizes(cfg)
        want = {n: tuple(s) for n, s, _ in ref.param_specs(m)}
        got = {n: tuple(p.shape) for n, p in init_params(
            0, cfg, device="meta").named_parameters()}
        assert got == want


# --------------------------------------------------------------------------
# the port against the plain reference
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def moved():
    return moved_params(smoke())


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["blocked", "flash"])
def test_logits_match_the_reference(moved, impl, compute):
    cfg = smoke(attn_impl=impl, compute_dtype=compute)
    b = batch_of(cfg, 3)
    got = forward(moved, b, cfg, CPU)
    assert got.shape == (2, 20, cfg.vocab_padded)     # text positions only
    flat = {n: p.detach() for n, p in moved.named_parameters()}
    with torch.no_grad():
        want = ref.logits(flat, b, ref.port_sizes(cfg))
    bar = 1e-5 if compute == "float32" else 0.03
    assert rel_max(got[..., :cfg.vocab], want) < bar


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["blocked", "flash"])
def test_loss_and_every_gradient_match_the_reference(moved, impl, compute):
    cfg = smoke(attn_impl=impl, compute_dtype=compute)
    b = batch_of(cfg, 4)
    loss = loss_fn(moved, b, cfg, CPU)
    names = [n for n, _ in moved.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss,
                                                list(moved.parameters()))))
    flat = {n: p.detach().clone().requires_grad_()
            for n, p in moved.named_parameters()}
    want_loss = ref.loss(flat, {"tokens": b["tokens"],
                                "pixels": b["pixels"]}, b["labels"],
                         ref.port_sizes(cfg))
    want = dict(zip(names, torch.autograd.grad(want_loss,
                                               [flat[n] for n in names])))
    f32 = compute == "float32"
    assert abs(loss.item() - want_loss.item()) < \
        (1e-6 if f32 else 2e-3) * want_loss.item()
    med = float(np.median([w.norm().item() for w in want.values()]))
    for name in names:
        if name == ZERO_BY_SYMMETRY:
            assert want[name].norm() < 1e-4 * med
            assert grads[name].norm() < 1e-2 * med
            continue
        err = rel_max(grads[name], want[name]) if f32 \
            else rel_l2(grads[name], want[name])
        assert err < (1e-5 if f32 else 0.06), (name, err)


def test_the_image_is_read_and_comes_first(moved):
    cfg = smoke(compute_dtype="float32")
    b = batch_of(cfg, 5)
    a = forward(moved, b, cfg, CPU)
    rolled = dict(b, pixels=b["pixels"].roll(1, dims=0))
    assert rel_max(forward(moved, rolled, cfg, CPU), a) > 1e-2
    # each sample with its own image: the rolled batch, rolled back
    both = {k: v.roll(1, dims=0) for k, v in b.items()}
    assert rel_max(forward(moved, both, cfg, CPU).roll(-1, dims=0), a) \
        < 1e-5


# --------------------------------------------------------------------------
# the frontend's pieces at the published shapes
# --------------------------------------------------------------------------

def test_pack_puts_each_patch_and_newline_where_anyres_does():
    v = VisionCfg()
    B, T, P, s = 2, v.n_tiles, v.n_patches, v.side
    b, t, p = torch.meshgrid(torch.arange(B), torch.arange(T),
                             torch.arange(P), indexing="ij")
    f = torch.stack([b, t, p], dim=-1).float()           # [B, T, P, 3]
    out = vision.pack(f, torch.full((3,), -1.0), v)
    assert out.shape == (B, 2928, 3)
    for bi in range(B):
        assert torch.equal(out[bi, :P], f[bi, 0])          # the base tile
        for row in range(2 * s):
            start = P + row * (2 * s + 1)
            assert out[bi, start + 2 * s].tolist() == [-1.0] * 3
            for col in range(2 * s):
                tile = 1 + (row // s) * 2 + col // s
                patch = (row % s) * s + col % s
                assert out[bi, start + col].tolist() == [bi, tile, patch]


def test_patch_embedding_is_the_stride_14_convolution():
    g = torch.Generator().manual_seed(0)
    px = torch.randn(3, 3, 336, 336, generator=g)
    w = torch.randn(8, 3, 14, 14, generator=g)          # [out, c, kh, kw]
    got = vision.patchify(px, 14) @ w.reshape(8, -1).T
    want = F.conv2d(px, w, stride=14).flatten(2).transpose(1, 2)
    assert got.shape == (3, 576, 8)
    assert rel_max(got, want) < 1e-5


@pytest.mark.parametrize("B", [1, 2])
def test_counters_at_the_published_shapes_on_meta(B):
    cfg = dataclasses.replace(get_config(TOWER), attn_impl="blocked")
    vp = init_params(0, cfg, device="meta").tree()["vision"]
    pixels = torch.empty(B, 5, 3, 336, 336, device="meta")
    trace.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        with torch.no_grad():
            out = lm._image_prefix(vp, pixels, cfg, Runtime("meta"),
                                   torch.bfloat16)
    assert out.shape == (B, 2928, 4096) and out.dtype == torch.bfloat16
    assert trace.counters() == {"vision.tiles": 5 * B,
                                "vision.positions": 2928 * B}
    trace.reset_counters()


# --------------------------------------------------------------------------
# spans and the training path
# --------------------------------------------------------------------------

def _span_parents(prof):
    out = []
    for e in prof.events():
        if not e.is_user_annotation:
            continue
        up = e.cpu_parent
        while up is not None and not up.is_user_annotation:
            up = up.cpu_parent
        out.append((e.name, up.name if up is not None else None))
    return out


@pytest.mark.parametrize("remat", ["full", "none"])
def test_spans_and_counters_of_a_train_step(remat):
    cfg = smoke(remat=remat)
    ts = build_train_step(cfg, device="cpu", donate=True)
    params, opt = ts.init_fn(0)
    b = batch_of(cfg, 6)
    trace.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ts.step_fn(params, opt, b)
    spans = _span_parents(prof)
    assert spans.count(("vision", "train.forward")) == 1
    for name in ("vision.tower", "vision.project", "vision.pack"):
        assert spans.count((name, "vision")) == 1, name
    layers = [p for n, p in spans if n == "vision.layer"]
    run = cfg.vision.run_layers
    assert layers.count("vision.tower") == run
    # the remat recompute enters each layer's span again, in the backward
    assert len(layers) == run * (2 if remat == "full" else 1)
    assert trace.counters() == {"vision.tiles": 10, "vision.positions": 48}
    trace.reset_counters()


def test_the_ranges_tie_the_frontends_backward_nodes():
    """Under the benchmark's window, the ``vision`` and ``vision.layer``
    ranges own autograd nodes: the frontend's backward is readable."""
    from lpfbench import harness
    cfg = smoke()
    params = init_params(0, cfg, device="cpu", trainable=True)
    b = batch_of(cfg, 7)
    with harness.Window(time.perf_counter(), 60.0, torch.device("cpu"),
                        trace=True) as w:
        loss_fn(params, b, cfg, CPU).backward()
    for name in (vision.VISION_RANGE, vision.LAYER_RANGE):
        ops = w.profile.range_ops(name)
        nodes = [e.name for e in ops if e.name.startswith(
            "autograd::engine::evaluate_function")]
        assert any("MmBackward" in n for n in nodes), name
    # the recompute's products are the layer range's
    mms = [e for e in w.profile.range_ops(vision.LAYER_RANGE)
           if e.name == "aten::mm"]
    assert len(mms) >= 2 * 6 * cfg.vision.run_layers


def test_three_train_steps_move_every_leaf():
    cfg = smoke()
    ts = build_train_step(cfg, device="cpu", donate=True)
    params, opt = ts.init_fn(1)
    start = {n: p.detach().clone() for n, p in params.named_parameters()}
    losses = []
    for i in range(3):
        params, opt, met = ts.step_fn(params, opt, batch_of(cfg, 10 + i))
        losses.append(float(met["loss"]))
    assert all(np.isfinite(losses))
    for n, p in params.named_parameters():
        assert not torch.equal(p.detach(), start[n]), n


def test_load_params_equals_cast_of_init():
    cfg = smoke()
    want = dict(cast_params(init_params(3, cfg, device="cpu"),
                            cfg).named_parameters())
    got = dict(load_params(3, cfg, device="cpu").named_parameters())
    assert want.keys() == got.keys()
    for name, t in want.items():
        assert got[name].dtype == t.dtype and torch.equal(got[name], t), name
    assert got["vision.layers.b0.attn.bq"].dtype == torch.float32
    assert got["vision.layers.b0.attn.wq"].dtype == torch.bfloat16


def test_stream_carries_pixels_for_the_tower():
    cfg = smoke()
    dc = DataConfig(vocab=cfg.vocab, seq_len=12, global_batch=3, seed=4)
    a = SyntheticStream(dc, cfg).batch(2)
    assert a.keys() == {"tokens", "labels", "pixels"}
    assert a["pixels"].shape == (3, 5, 3, 28, 28)
    assert a["pixels"].dtype == np.float32
    assert np.array_equal(a["pixels"], SyntheticStream(dc, cfg).batch(2)
                          ["pixels"])
    stub = SyntheticStream(dc, get_config(ARCH, smoke=True)).batch(2)
    assert stub.keys() == {"tokens", "labels", "embeds"}


def test_train_launcher_runs_the_tower_on_cpu(capsys):
    out = train_mod.main(["--arch", TOWER, "--device", "cpu", "--steps", "2",
                          "--batch", "2", "--seq", "16"])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert TOWER + "-smoke" in capsys.readouterr().out
