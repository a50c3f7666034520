"""Parity of the port's llama3.2-1b training path with the JAX reference on
the CPU, at the smoke config (2 layers, d 128, 4 heads over 2 kv heads,
head dim 32, vocab 512), with the JAX package's ``init_params`` tree
carried across by ``params_from_jax``.

Bars (max |port - jax| / max |jax|, per value or per gradient leaf):
* ``loss_fn`` and its gradients, ``compute_dtype="float32"``: loss 1e-5,
  every gradient leaf 1e-4 (both run f32 math; measured 2e-7 and 1.5e-6);
* the same in bf16: loss 2e-3, every leaf 0.08 (the JAX package's own bf16
  bar, ``tests/test_models_smoke.py``), global norm 1e-2 (the two
  frameworks round bf16 at different places; measured 3e-4, 1.9e-2 on the
  tied embedding, 1e-4);
* ``adamw_update`` and ``warmup_cosine``: 1e-6 (f32 against f32; JAX
  evaluates the schedule in f32, the port in f64);
* ``SyntheticStream`` batches: bit-identical;
* three ``build_train_step`` steps against JAX's on a (1, 1) mesh from one
  state, in f32: losses 1e-5, parameters 1e-4.
Where the JAX model reaches the Pallas kernels (``attn_impl="flash"``)
they run in interpret mode, as the JAX package's own tests run them.

The rest is the port alone: the ports of ``tests/test_train_integration.py``
(loss decrease, checkpoint-resume bit-exactness, gradient accumulation,
``steps_per_call``), the remat modes, the checkpoint store, the
``StepSupervisor`` and the launcher.
"""

import dataclasses
import errno
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import compat
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticStream as JaxStream
from repro.models import Runtime as JaxRuntime
from repro.models import count_params as jax_count_params
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro.runtime.train_step import build_train_step as jax_build_train_step
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step, restore,
                                    save)
from repro_torch.configs import get_config
from repro_torch.core import (CompressSpec, LPFCapacityError, LPFFatalError,
                              SyncAttributes)
from repro_torch.core.faultpoints import InjectedFault
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.interop import (opt_state_from_jax, params_from_jax,
                                 params_to_numpy)
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import (ParamTree, Runtime, count_params,
                                init_params, loss_fn, model_flops)
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               global_norm, warmup_cosine)
from repro_torch.runtime.monitor import StepVerdict
from repro_torch.runtime.train_loop import (StepSupervisor, TrainLoopConfig,
                                            train_loop)
from repro_torch.runtime.train_step import TrainStep, build_train_step

ARCH = "llama3.2-1b"
ROOT = Path(__file__).resolve().parents[1]
CPU = Runtime("cpu")


def rel(a, ref):
    a = np.asarray(a, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(a - ref).max() / (np.abs(ref).max() + 1e-9))


def configs(**kw):
    """The smoke config in both packages, with the same replacements."""
    return (dataclasses.replace(jax_get_config(ARCH, smoke=True), **kw),
            dataclasses.replace(get_config(ARCH, smoke=True), **kw))


def flat(tree, prefix=""):
    """{dotted name: numpy leaf} of a nested dict (JAX or port)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(
                v.detach().float() if isinstance(v, torch.Tensor) else v,
                np.float32)
    return out


@pytest.fixture(scope="module")
def jax_tree():
    jcfg, _ = configs()
    return jax.tree.map(np.asarray,
                        jax_init_params(jax.random.PRNGKey(0), jcfg))


def lm_batch(seed, B=2, S=64, vocab=512):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1),
                                                dtype=np.int32)
    labels = toks[:, 1:].copy()
    labels[0, -5:] = -1                      # masked labels
    return {"tokens": toks[:, :-1], "labels": labels}


# --------------------------------------------------------------------------
# the loss and its gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["blocked", "flash"])
def test_loss_and_gradients_match_jax(jax_tree, impl, compute):
    jcfg, cfg = configs(attn_impl=impl, compute_dtype=compute)
    batch = lm_batch(1)
    jloss, jgrads = jax.value_and_grad(lambda p: jax_loss_fn(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg,
        JaxRuntime()))(jax.tree.map(jnp.asarray, jax_tree))
    params = params_from_jax(jax_tree, device="cpu", trainable=True)
    fa_kernel.flash_attention_bwd_dkv.launches = 0
    loss = loss_fn(params, batch, cfg, CPU)
    names = [n for n, _ in params.named_parameters()]
    grads = torch.autograd.grad(loss, list(params.parameters()))
    assert fa_kernel.flash_attention_bwd_dkv.launches == 0
    want = flat(jax.tree.map(np.asarray, jgrads))
    assert set(names) == set(want)
    f32 = compute == "float32"
    assert abs(loss.item() - float(jloss)) / abs(float(jloss)) < (
        1e-5 if f32 else 2e-3)
    for name, g in zip(names, grads):
        assert g.dtype == torch.float32
        assert rel(g, want[name]) < (1e-4 if f32 else 0.08), name
    gn = global_norm(dict(zip(names, grads))).item()
    gn_jax = float(np.sqrt(sum(np.sum(g ** 2) for g in want.values())))
    assert abs(gn - gn_jax) / gn_jax < (1e-5 if f32 else 1e-2)


def test_remat_modes_give_the_same_gradients():
    """remat full / dots / none recompute the same numbers."""
    batch = lm_batch(2, S=32)
    results = []
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(get_config(ARCH, smoke=True), remat=remat)
        params = init_params(0, cfg, device="cpu", trainable=True)
        loss = loss_fn(params, batch, cfg, CPU)
        results.append((loss, torch.autograd.grad(
            loss, list(params.parameters()))))
    for loss, grads in results[1:]:
        assert torch.equal(loss, results[0][0])
        for a, b in zip(grads, results[0][1]):
            assert torch.equal(a, b)


def test_loss_masks_labels_and_padded_vocab():
    """labels -1 drop out of the mean; padded vocab columns never win."""
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), vocab=500)
    params = init_params(0, cfg, device="cpu", trainable=True)
    batch = lm_batch(3, S=16, vocab=500)
    full = loss_fn(params, batch, cfg, CPU)
    torch.autograd.grad(full, list(params.parameters()))   # differentiable
    only = {"tokens": batch["tokens"], "labels": batch["labels"].copy()}
    only["labels"][1] = -1
    one = loss_fn(params, {"tokens": batch["tokens"][:1],
                           "labels": batch["labels"][:1]}, cfg, CPU)
    assert torch.allclose(loss_fn(params, only, cfg, CPU), one)
    none = {"tokens": batch["tokens"],
            "labels": np.full_like(batch["labels"], -1)}
    assert loss_fn(params, none, cfg, CPU).item() == 0.0


@pytest.mark.parametrize("smoke", [True, False])
def test_count_params_and_model_flops_match_jax(smoke):
    jcfg = jax_get_config(ARCH, smoke=smoke)
    cfg = get_config(ARCH, smoke=smoke)
    assert count_params(cfg) == jax_count_params(jcfg)
    if not smoke:
        assert count_params(cfg) == 1_235_814_400
    assert model_flops(cfg, 8192) == 6.0 * count_params(cfg) * 8192


# --------------------------------------------------------------------------
# optimizer, schedule, data
# --------------------------------------------------------------------------

def test_adamw_update_matches_jax_with_stacked_norm_decay(jax_tree):
    """The same numpy gradients and state through both optimizers.  The
    norms get random values, so weight decay shows: the stacked block norm
    ``dec_body.b0.ln1.w`` ([2, 128], ndim 2) is decayed as in JAX; the
    unstacked ``final_norm.w`` ([128]) is not."""
    rng = np.random.default_rng(5)
    params = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), jax_tree)
    grads = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), jax_tree)
    state = {"m": jax.tree.map(lambda a: 0.1 * a, grads),
             "v": jax.tree.map(lambda a: 0.01 * a * a, grads),
             "step": np.int32(3)}
    jcfg = JaxAdamWConfig(lr=jax_warmup_cosine(1e-2, 2, 10))
    cfg = AdamWConfig(lr=warmup_cosine(1e-2, 2, 10))
    jp, js, jm = jax_adamw_update(
        jax.tree.map(jnp.asarray, grads),
        jax.tree.map(jnp.asarray, state), jax.tree.map(jnp.asarray, params),
        jcfg)
    tp = params_from_jax(params, device="cpu").tree()
    tg = params_from_jax(grads, device="cpu").tree()
    ts = opt_state_from_jax(state, device="cpu")
    p, s, m = adamw_update(tg, ts, tp, cfg)
    assert s["step"] == 4 == int(js["step"])
    assert abs(m["grad_norm"].item() - float(jm["grad_norm"])) < 1e-3
    assert abs(m["lr"] - float(jm["lr"])) < 1e-9
    for got, want in ((p, jp), (s["m"], js["m"]), (s["v"], js["v"])):
        want = flat(jax.tree.map(np.asarray, want))
        for name, x in flat(got).items():
            assert np.abs(x - want[name]).max() < 1e-6, name
    # arguments untouched (functional), and the decay rule as stored
    assert np.array_equal(flat(tp)["dec_body.b0.ln1.w"],
                          params["dec_body"]["b0"]["ln1"]["w"])
    zero_g = {k: torch.zeros_like(v) for k, v in flat_tensors(tp).items()}
    p0, _, _ = adamw_update(unflat(zero_g), adamw_init(tp, cfg), tp, cfg)
    lr = warmup_cosine(1e-2, 2, 10)(1)
    ln1 = params["dec_body"]["b0"]["ln1"]["w"]
    assert np.allclose(flat(p0)["dec_body.b0.ln1.w"], ln1 * (1 - lr * 0.1),
                       atol=1e-6)
    assert np.array_equal(flat(p0)["final_norm.w"],
                          params["final_norm"]["w"])


def flat_tensors(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(flat_tensors(v, f"{prefix}{k}.") if isinstance(v, dict)
                   else {prefix + k: v})
    return out


def unflat(d):
    out = {}
    for name, v in d.items():
        *path, leaf = name.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def test_warmup_cosine_matches_jax():
    jlr = jax_warmup_cosine(3e-3, 10, 100)
    lr = warmup_cosine(3e-3, 10, 100)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        assert abs(lr(step) - float(jlr(jnp.asarray(step)))) < 1e-9, step
    assert lr(0) == 0.0 and lr(10) == pytest.approx(3e-3)
    assert lr(100) == pytest.approx(3e-4)


def test_synthetic_stream_is_bit_identical_to_jax():
    jcfg, _ = configs()
    jstream = JaxStream(JaxDataConfig(vocab=512, seq_len=48, global_batch=3,
                                      seed=4), jcfg)
    stream = SyntheticStream(DataConfig(vocab=512, seq_len=48,
                                        global_batch=3, seed=4))
    for step in range(4):
        a, b = stream.batch(step), jstream.batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    assert stream.state(3) == jstream.state(3)


# --------------------------------------------------------------------------
# train steps against JAX
# --------------------------------------------------------------------------

def test_three_train_steps_match_jax(jax_tree):
    jcfg, cfg = configs(compute_dtype="float32", vocab=256)
    jparams = jax.tree.map(jnp.asarray, jax_init_params(
        jax.random.PRNGKey(1), jcfg))
    jopt = jax_adamw_init(jparams)
    jts = jax_build_train_step(jcfg, compat.make_mesh((1, 1), ("data",
                                                               "model")),
                               opt_cfg=JaxAdamWConfig(lr=1e-3),
                               donate=False)
    ts = build_train_step(cfg, opt_cfg=AdamWConfig(lr=1e-3), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             device="cpu", trainable=True)
    opt = opt_state_from_jax(jax.tree.map(np.asarray, jopt), device="cpu")
    stream = SyntheticStream(DataConfig(vocab=256, seq_len=32,
                                        global_batch=4))
    for step in range(3):
        b = stream.batch(step)
        jparams, jopt, jm = jts.step_fn(
            jparams, jopt, {k: jnp.asarray(v) for k, v in b.items()})
        params, opt, m = ts.step_fn(params, opt, b)
        assert abs(m["loss"].item() - float(jm["loss"])) < 1e-5 * abs(
            float(jm["loss"]))
    assert opt["step"] == 3 and isinstance(params, ParamTree)
    assert all(p.requires_grad for p in params.parameters())
    want = flat(jax.tree.map(np.asarray, jparams))
    for name, x in flat(params.tree()).items():
        assert np.abs(x - want[name]).max() < 1e-4, name


# --------------------------------------------------------------------------
# the ports of tests/test_train_integration.py (port alone)
# --------------------------------------------------------------------------

def tiny_cfg(**kw):
    return dataclasses.replace(get_config(ARCH, smoke=True), vocab=256, **kw)


def stream_for(cfg, B=8, S=32):
    return SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=S,
                                      global_batch=B, seed=0))


def test_train_loss_decreases():
    cfg = tiny_cfg()
    ts = build_train_step(cfg, opt_cfg=AdamWConfig(lr=3e-3), device="cpu")
    out = train_loop(ts, stream_for(cfg),
                     TrainLoopConfig(steps=30, ckpt_dir=None))
    first = np.mean(out["losses"][:5])
    last = np.mean(out["losses"][-5:])
    assert np.isfinite(last)
    assert last < first - 0.2, (first, last)


def test_checkpoint_resume_bitexact(tmp_path):
    cfg = tiny_cfg()
    ts = build_train_step(cfg, opt_cfg=AdamWConfig(lr=1e-3), device="cpu")
    stream = stream_for(cfg)
    # run 1: 10 steps with a checkpoint at 5
    out_a = train_loop(ts, stream, TrainLoopConfig(
        steps=10, ckpt_dir=str(tmp_path / "a"), ckpt_every=5))
    # restart from the step-10 checkpoint: no step runs
    out_b = train_loop(ts, stream, TrainLoopConfig(
        steps=10, ckpt_dir=str(tmp_path / "a"), ckpt_every=100))
    assert out_b["losses"] == []
    # drop it and resume from step 5
    import shutil
    shutil.rmtree(tmp_path / "a" / "step_10")
    out_c = train_loop(ts, stream, TrainLoopConfig(
        steps=10, ckpt_dir=str(tmp_path / "a"), ckpt_every=100))
    assert out_a["losses"][5:] == out_c["losses"]
    for a, c in zip(out_a["params"].parameters(),
                    out_c["params"].parameters()):
        assert torch.equal(a, c)
    assert out_c["opt"]["step"] == 10


def test_grad_accumulation_equivalence():
    """k-microbatch accumulation == single big batch (same grads step)."""
    cfg = tiny_cfg()
    ts1 = build_train_step(cfg, opt_cfg=AdamWConfig(lr=1e-3), grad_accum=1,
                           device="cpu")
    ts4 = build_train_step(cfg, opt_cfg=AdamWConfig(lr=1e-3), grad_accum=4,
                           device="cpu")
    batch = stream_for(cfg).batch(0)
    p1, _, m1 = ts1.step_fn(*ts1.init_fn(0), batch)
    p4, _, m4 = ts4.step_fn(*ts4.init_fn(0), batch)
    assert abs(m1["loss"].item() - m4["loss"].item()) < 5e-3
    for a, b in zip(p1.parameters(), p4.parameters()):
        assert (a - b).abs().max().item() < 5e-3


def test_steps_per_call_matches_iterated_single_steps():
    cfg = tiny_cfg()
    ts1 = build_train_step(cfg, opt_cfg=AdamWConfig(lr=1e-3), device="cpu")
    ts3 = build_train_step(cfg, opt_cfg=AdamWConfig(lr=1e-3),
                           steps_per_call=3, device="cpu")
    stream = stream_for(cfg)
    batches = [stream.batch(i) for i in range(3)]
    p, o = ts1.init_fn(0)
    losses = []
    for b in batches:
        p, o, m = ts1.step_fn(p, o, b)
        losses.append(m["loss"].item())
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    p3, o3, metrics = ts3.step_fn(*ts3.init_fn(0), stacked)
    assert metrics["loss"].shape == (3,) and o3["step"] == 3
    np.testing.assert_allclose(metrics["loss"].numpy(), losses, atol=5e-3)
    for a, b in zip(p.parameters(), p3.parameters()):
        assert (a - b).abs().max().item() < 5e-3


def test_one_pod_lpf_step_is_the_plain_step():
    """One card without a mesh, or a mesh of one pod, is one pod: the
    ``lpf`` step is the plain step and ledgers nothing; sync attributes
    are taken (they act only across pods)."""
    cfg = tiny_cfg()
    b = stream_for(cfg, B=2, S=8).batch(0)
    plain = build_train_step(cfg, device="cpu")
    want = plain.step_fn(*plain.init_fn(0), b)
    attrs = SyncAttributes(compress=CompressSpec(bits=8))
    for mesh in (None, make_mesh((1, 1)), make_mesh((1, 1, 1))):
        ts = build_train_step(cfg, mesh, grad_sync="lpf", sync_attrs=attrs,
                              device="cpu")
        got = ts.step_fn(*ts.init_fn(0), b)
        assert torch.equal(got[2]["loss"], want[2]["loss"])
        for x, y in zip(got[0].parameters(), want[0].parameters()):
            assert torch.equal(x, y)
        assert not ts.ledger.records


#: the plain step the meshes of the next test are held to
_PLAIN = []


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2, 1), (1, 1, 2)])
def test_device_axes_build_the_plain_step(shape):
    """A data or model axis above 1 is a virtual shard: ``build_train_step``
    takes it, and for a dense model the step is the plain one, bit for
    bit (the MoE and decode blocks that shards change are held to JAX in
    ``tests/test_torch_mesh.py``)."""
    cfg = tiny_cfg()
    b = stream_for(cfg, B=4, S=8).batch(0)
    if not _PLAIN:
        plain = build_train_step(cfg, device="cpu")
        _PLAIN.append(plain.step_fn(*plain.init_fn(0), b))
    want = _PLAIN[0]
    ts = build_train_step(cfg, make_mesh(shape), device="cpu")
    assert ts.rt.distributed and ts.rt.mesh.shape == make_mesh(shape).shape
    got = ts.step_fn(*ts.init_fn(0), b)
    assert torch.equal(got[2]["loss"], want[2]["loss"])
    for x, y in zip(got[0].parameters(), want[0].parameters()):
        assert torch.equal(x, y)


def test_train_launcher_takes_device_axes(capsys):
    from repro_torch.launch import train
    for mesh in ("2x1", "1x2x1"):
        out = train.main(["--device", "cpu", "--steps", "1", "--batch", "2",
                          "--seq", "16", "--mesh", mesh])
        assert len(out["losses"]) == 1 and np.isfinite(out["final_loss"])


# --------------------------------------------------------------------------
# checkpoint store
# --------------------------------------------------------------------------

def test_checkpoint_round_trip_manifest_and_meta_restore(tmp_path):
    cfg = tiny_cfg()
    ts = build_train_step(cfg, device="cpu")
    params, opt = ts.init_fn(3)
    opt = dict(opt, step=7)
    extra = {"bf16": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)}
    path = save(str(tmp_path), 7, (params, opt, extra), meta={"x": 1})
    manifest = json.loads(Path(path, "manifest.json").read_text())
    names = [e["name"] for e in manifest["leaves"]]
    assert {"0/embed", "0/dec_body/b0/attn/wq", "0/final_norm/w",
            "1/m/embed", "1/v/embed", "1/step", "2/bf16"} <= set(names)
    assert {e["dtype"] for e in manifest["leaves"]} >= {"float32",
                                                        "bfloat16", "int"}
    assert manifest["meta"] == {"x": 1}
    like = ts.like_fn() + ({"bf16": torch.empty(2, 3, dtype=torch.bfloat16,
                                                device="meta")},)
    with pytest.raises(ValueError, match="device="):
        restore(str(tmp_path), 7, like)
    p2, o2, e2 = restore(str(tmp_path), 7, like, device="cpu")
    assert isinstance(p2, ParamTree) and all(
        p.requires_grad for p in p2.parameters())
    for a, b in zip(params.parameters(), p2.parameters()):
        assert torch.equal(a, b)
    assert o2["step"] == 7 and torch.equal(e2["bf16"], extra["bf16"])
    with pytest.raises(ValueError, match="mismatch"):
        restore(str(tmp_path), 7, (params,), device="cpu")


def test_async_checkpointer_keep_and_tmp_sweep(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, ".tmp_step_99"))       # a crash's leftover
    ckpt = AsyncCheckpointer(d, keep=2)
    assert ckpt.restore_latest({"w": torch.zeros(2)}) == (None, None)
    for s in (1, 2, 3):
        ckpt.save(s, {"w": torch.full((2,), float(s))})
    ckpt.wait()
    assert sorted(os.listdir(d)) == ["step_2", "step_3"]
    step, state = ckpt.restore_latest({"w": torch.zeros(2)})
    assert step == 3 and state["w"].tolist() == [3.0, 3.0]
    # keep=0 keeps none (the reference's fix: not steps[:-0])
    ckpt0 = AsyncCheckpointer(d, keep=0)
    ckpt0.save(4, {"w": torch.zeros(2)})
    ckpt0.wait()
    assert latest_step(d) is None
    with pytest.raises(ValueError, match="keep"):
        AsyncCheckpointer(d, keep=-1)


# --------------------------------------------------------------------------
# supervision
# --------------------------------------------------------------------------

def test_supervisor_retry_propagate_and_bound():
    sup = StepSupervisor(max_restarts=2, backoff=0.0)
    assert sup.on_error(3, OSError(errno.EIO, "blip")) is True
    assert sup.on_error(5, InjectedFault("seam")) is True
    # budget exhausted: the third transient propagates
    assert sup.on_error(7, OSError(errno.EIO, "blip")) is False
    assert [(a.kind, a.action) for a in sup.anomalies] == [
        ("transient", "restore"), ("transient", "restore"),
        ("transient", "propagate")]
    sup = StepSupervisor(max_restarts=5, backoff=0.0, anomaly_cap=2)
    assert sup.on_error(0, LPFFatalError("contract")) is False
    assert sup.on_error(1, LPFCapacityError("full")) is False
    assert sup.on_error(2, ValueError("unclassified")) is False
    assert sup.restarts == 0 and len(sup.anomalies) == 2
    sup.on_verdict(StepVerdict(4, 9.0, 8.0, True, "skip_sync"))
    assert sup.anomalies[-1].action == "skip_sync"


class _FakeStream:
    def batch(self, step):
        return {"x": np.full((2,), float(step), np.float32)}

    def state(self, step):
        return {"step": step}


def _fake_train_step(fail_at=(), taken=None, error=None):
    """A TrainStep whose step fails at the given steps (once each)."""
    pending = set(fail_at)

    def step_fn(params, opt, batch):
        step = int(batch["x"][0])
        if taken is not None:
            taken.append(step)
        if step in pending:
            pending.discard(step)
            raise error or OSError(errno.EIO, f"transient at step {step}")
        params = {"w": params["w"] + batch["x"]}
        return params, opt, {"loss": params["w"].sum()}

    return TrainStep(
        step_fn=step_fn,
        init_fn=lambda key: ({"w": torch.zeros(2)}, {"m": torch.zeros(2)}),
        like_fn=lambda: ({"w": torch.empty(2, device="meta")},
                         {"m": torch.empty(2, device="meta")}),
        rt=CPU)


def test_train_loop_restores_from_checkpoint_on_transient(tmp_path):
    taken = []
    out = train_loop(_fake_train_step(fail_at=(5,), taken=taken),
                     _FakeStream(),
                     TrainLoopConfig(steps=8, ckpt_dir=str(tmp_path),
                                     ckpt_every=2, restart_backoff=0.0))
    assert out["restarts"] == 1
    # rolled back to the newest published checkpoint (step 4), re-ran 4, 5
    assert taken == [0, 1, 2, 3, 4, 5, 4, 5, 6, 7]
    clean = train_loop(_fake_train_step(), _FakeStream(),
                       TrainLoopConfig(steps=8))
    assert out["losses"] == clean["losses"]
    with pytest.raises(OSError):
        train_loop(_fake_train_step(fail_at=(2, 3, 4)), _FakeStream(),
                   TrainLoopConfig(steps=8, ckpt_dir=str(tmp_path / "b"),
                                   ckpt_every=2, restart_backoff=0.0))
    with pytest.raises(LPFFatalError):
        train_loop(_fake_train_step(fail_at=(1,),
                                    error=LPFFatalError("contract")),
                   _FakeStream(), TrainLoopConfig(steps=4, max_restarts=5))


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

def test_train_launcher_on_cpu_exits_0():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--device", "cpu", "--steps", "3"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "final loss" in res.stdout and "on cpu" in res.stdout
