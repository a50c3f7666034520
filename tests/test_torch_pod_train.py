"""The port's pod training step and local SGD against the JAX package's on
the CPU (``repro_torch.runtime.train_step``'s pod path,
``runtime.train_loop``'s ``sync_every``, ``launch.train``'s ``--mesh``,
``--grad-sync lpf``, ``--compress`` and ``--sync-every``).

The llama3.2-1b smoke config at vocab 256 in f32, over a ``2x1x1`` mesh:
two pods as virtual processes on the CPU in the port, two host devices in
JAX (and once JAX's ``(2, 2, 2)`` mesh, whose data and model axes only
re-lay the same arithmetic).  The same weights (JAX's, carried over as
numpy) and the same batches go through both:

* one and two pod steps (``rs+ag``) at the bars of
  ``tests/test_torch_train.py``'s step parity: loss within 1e-5
  relative, every parameter within 1e-4; the ledger field for field;
* the bucketed-overlap step within JAX's 1e-4 of the flat one, its ledger
  the JAX package's record for record (the same per-layer buckets);
* the compressed int16 ring's step: loss and ledger as JAX's, parameters
  within the first AdamW step's reach of a quantum flip;
* ``grad_sync="gspmd"`` on a pod mesh is the plain step over the whole
  batch, as JAX's; for an MoE model (granite-moe-3b-a800m's smoke
  config) under the mesh's runtime, so its capacity is per ``(pod,
  data)`` shard as in JAX's GSPMD step, and not the whole batch's;
* the local-SGD loop's losses against JAX's, its ledger grown only on
  the synced step's first trace;
* the launcher's flags: its steps donate their state, as JAX's do, and
  a data or model axis above 1 runs as virtual shards (a dense model's
  step is the one of the mesh's pods alone).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import CompressSpec as JCompress
from repro.core import SyncAttributes as JAttrs
from repro.core import compat
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticStream as JaxStream
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.runtime.train_loop import TrainLoopConfig as JaxLoopConfig
from repro.runtime.train_loop import train_loop as jax_train_loop
from repro.runtime.train_step import build_train_step as jax_build_train_step
from repro_torch.configs import get_config
from repro_torch.core import CompressSpec, SyncAttributes
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.interop import opt_state_from_jax, params_from_jax
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.train_loop import TrainLoopConfig, train_loop
from repro_torch.runtime.train_step import build_train_step

ARCH = "llama3.2-1b"
LR = 1e-3
B, S = 4, 32


def configs():
    kw = dict(vocab=256, compute_dtype="float32")
    return (dataclasses.replace(jax_get_config(ARCH, smoke=True), **kw),
            dataclasses.replace(get_config(ARCH, smoke=True), **kw))


def jmesh(shape=(2, 1, 1)):
    n = int(np.prod(shape))
    return compat.make_mesh(shape, ("pod", "data", "model"),
                            devices=jax.devices()[:n])


def batches(n):
    stream = SyntheticStream(DataConfig(vocab=256, seq_len=S,
                                        global_batch=B))
    return [stream.batch(i) for i in range(n)]


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(
                v.detach().float() if isinstance(v, torch.Tensor) else v,
                np.float32)
    return out


def records(ledger):
    return [dataclasses.asdict(r) for r in ledger.records]


def jax_steps(n, mesh=None, grad_sync="lpf", attrs=None, **kw):
    """``n`` JAX steps from the seed-0 weights: (initial params, initial
    opt, per-step metrics, final params, ledger records)."""
    jcfg, _ = configs()
    jts = jax_build_train_step(
        jcfg, jmesh() if mesh is None else mesh,
        opt_cfg=JaxAdamWConfig(lr=LR), grad_sync=grad_sync,
        sync_attrs=attrs or JAttrs(), donate=False, **kw)
    p0, o0 = jts.init_fn(jax.random.PRNGKey(0))
    init = (jax.tree.map(np.asarray, p0), jax.tree.map(np.asarray, o0))
    p, o, ms = p0, o0, []
    for b in batches(n):
        p, o, m = jts.step_fn(p, o, {k: jnp.asarray(v)
                                     for k, v in b.items()})
        ms.append({k: float(v) for k, v in m.items()})
    return init, ms, flat(jax.tree.map(np.asarray, p)), records(jts.ledger)


def port_steps(n, init, mesh=(2, 1, 1), grad_sync="lpf", attrs=None,
               **kw):
    _, cfg = configs()
    ts = build_train_step(cfg, make_mesh(mesh), opt_cfg=AdamWConfig(lr=LR),
                          grad_sync=grad_sync,
                          sync_attrs=attrs or SyncAttributes(),
                          device="cpu", **kw)
    p = params_from_jax(init[0], device="cpu", trainable=True)
    o = opt_state_from_jax(init[1], device="cpu")
    ms = []
    for b in batches(n):
        p, o, m = ts.step_fn(p, o, b)
        ms.append({k: float(v) for k, v in m.items()})
    return ms, flat(p.tree()), records(ts.ledger)


@pytest.fixture(scope="module")
def jax_runs():
    return {"rs+ag": jax_steps(2),
            "pdm": jax_steps(1, mesh=jmesh((2, 2, 2))),
            "bucketed": jax_steps(1, grad_bucket_bytes=1 << 14),
            "int16": jax_steps(1, attrs=JAttrs(
                compress=JCompress(bits=8))),
            "gspmd": jax_steps(1, grad_sync="gspmd")}


def assert_steps_match(ms, params, jms, jparams, loss_rel=1e-5,
                       param_abs=1e-4):
    assert len(ms) == len(jms)
    for m, jm in zip(ms, jms):
        assert abs(m["loss"] - jm["loss"]) < loss_rel * abs(jm["loss"])
        assert abs(m["grad_norm"] - jm["grad_norm"]) < \
            1e-4 * jm["grad_norm"]
    assert params.keys() == jparams.keys()
    for name, x in params.items():
        assert np.abs(x - jparams[name]).max() < param_abs, name


@pytest.mark.parametrize("n", [1, 2])
def test_pod_steps_match_jax(jax_runs, n):
    init, jms, jparams, jrecs = jax_runs["rs+ag"]
    ms, params, recs = port_steps(n, init)
    if n == 2:
        assert_steps_match(ms, params, jms, jparams)
    else:
        assert abs(ms[0]["loss"] - jms[0]["loss"]) < 1e-5 * jms[0]["loss"]
    # JAX ledgers while tracing: one record, however many steps ran
    assert recs == jrecs
    assert [(r["method"], r["rounds"]) for r in recs] == [("rs+ag", 2)]


def test_pod_step_matches_jax_on_the_pdm_mesh(jax_runs):
    """JAX's (2, 2, 2) mesh lays data and model axes over the same pod
    arithmetic: the port's 2x1x1 pods agree with it too."""
    init, jms, jparams, jrecs = jax_runs["pdm"]
    ms, params, recs = port_steps(1, init)
    assert_steps_match(ms, params, jms, jparams)
    assert recs == jrecs


def test_bucketed_overlap_step_matches_flat_and_jax(jax_runs):
    init, jms, jparams, jrecs = jax_runs["bucketed"]
    ms, params, recs = port_steps(1, init, grad_bucket_bytes=1 << 14)
    assert recs == jrecs
    assert len(recs) > 3 and all(
        r["method"] == "bucketed_overlap" or r["method"].startswith(
            "overlap[") for r in recs)
    assert sum(r["wire_bytes"] for r in recs) > 0
    assert_steps_match(ms, params, jms, jparams)
    flat_ms, flat_params, _ = port_steps(1, init)
    assert abs(ms[0]["loss"] - flat_ms[0]["loss"]) < 1e-5
    for name, x in params.items():
        assert np.abs(x - flat_params[name]).max() < 1e-4, name


@pytest.mark.parametrize("method", ["bucketed", "bucketed_fenced"])
def test_in_order_bucket_methods_match_overlap(jax_runs, method):
    init = jax_runs["bucketed"][0]
    ms, params, recs = port_steps(1, init, grad_bucket_bytes=1 << 14,
                                  grad_sync_method=method)
    ovl_ms, ovl_params, ovl_recs = port_steps(1, init,
                                              grad_bucket_bytes=1 << 14)
    assert all(r["method"] == method and r["rounds"] == 2 for r in recs)
    assert len(ovl_recs) == len(recs) + 1
    assert ms == ovl_ms
    for name, x in params.items():
        np.testing.assert_array_equal(x, ovl_params[name])


def test_compressed_step_matches_jax(jax_runs):
    init, jms, jparams, jrecs = jax_runs["int16"]
    ms, params, recs = port_steps(1, init, attrs=SyncAttributes(
        compress=CompressSpec(bits=8)))
    assert recs == jrecs
    assert [r["method"] for r in recs] == ["ring+int16"]
    assert abs(ms[0]["loss"] - jms[0]["loss"]) < 1e-5 * jms[0]["loss"]
    assert abs(ms[0]["grad_norm"] - jms[0]["grad_norm"]) < \
        1e-3 * jms[0]["grad_norm"]
    # a gradient a hair from a rounding boundary may take the next int16
    # step in one package: at AdamW's first step that moves its parameter
    # by at most 2 lr; every other parameter is within the step bar
    diffs = np.concatenate([np.abs(x - jparams[n]).ravel()
                            for n, x in params.items()])
    assert diffs.max() <= 2 * LR + 1e-6
    assert (diffs > 1e-4).mean() < 1e-3


def test_compress_refuses_the_reduce_scatter_methods():
    _, cfg = configs()
    ts = build_train_step(cfg, make_mesh((2, 1, 1)), grad_sync="lpf",
                          grad_sync_method="rs+ag", device="cpu",
                          sync_attrs=SyncAttributes(
                              compress=CompressSpec(bits=8)))
    with pytest.raises(ValueError, match="quantised"):
        ts.step_fn(*ts.init_fn(0), batches(1)[0])


def test_gspmd_on_a_pod_mesh_is_the_plain_step(jax_runs):
    init, jms, jparams, jrecs = jax_runs["gspmd"]
    ms, params, recs = port_steps(1, init, grad_sync="gspmd")
    assert_steps_match(ms, params, jms, jparams)
    assert recs == jrecs == []
    plain_ms, plain_params, _ = port_steps(1, init, mesh=(1, 1),
                                           grad_sync="gspmd")
    assert ms == plain_ms
    for name, x in params.items():
        np.testing.assert_array_equal(x, plain_params[name])


def test_grad_accum_inside_a_pod_matches_jax():
    init, jms, jparams, jrecs = jax_steps(1, grad_accum=2)
    ms, params, recs = port_steps(1, init, grad_accum=2)
    assert_steps_match(ms, params, jms, jparams)
    assert recs == jrecs


def test_pod_step_donates_in_place(jax_runs):
    init = jax_runs["rs+ag"][0]
    _, cfg = configs()
    ts = build_train_step(cfg, make_mesh((2, 1, 1)), grad_sync="lpf",
                          opt_cfg=AdamWConfig(lr=LR), donate=True,
                          device="cpu")
    p = params_from_jax(init[0], device="cpu", trainable=True)
    o = opt_state_from_jax(init[1], device="cpu")
    ptrs = [t.data_ptr() for t in p.parameters()]
    p2, o2, _ = ts.step_fn(p, o, batches(1)[0])
    assert [t.data_ptr() for t in p2.parameters()] == ptrs
    ms, params, _ = port_steps(1, init)
    for name, x in flat(p2.tree()).items():
        assert np.abs(x - params[name]).max() < 1e-6, name


def test_local_sgd_loop_matches_jax():
    jcfg, cfg = configs()
    steps, every = 4, 2
    jts = jax_build_train_step(jcfg, jmesh(), opt_cfg=JaxAdamWConfig(lr=LR),
                               grad_sync="lpf")
    jts_local = jax_build_train_step(jcfg, jmesh(),
                                     opt_cfg=JaxAdamWConfig(lr=LR),
                                     grad_sync="gspmd")
    jstream = JaxStream(JaxDataConfig(vocab=256, seq_len=S, global_batch=B,
                                      seed=0), jcfg)
    jout = jax_train_loop(jts, jstream, JaxLoopConfig(
        steps=steps, sync_every=every), step_fn_nosync=jts_local.step_fn)
    p0, o0 = jts.init_fn(jax.random.PRNGKey(0))
    init = (jax.tree.map(np.asarray, p0), jax.tree.map(np.asarray, o0))

    def port_ts(grad_sync):
        ts = build_train_step(cfg, make_mesh((2, 1, 1)),
                              opt_cfg=AdamWConfig(lr=LR),
                              grad_sync=grad_sync, device="cpu")
        return dataclasses.replace(ts, init_fn=lambda key: (
            params_from_jax(init[0], device="cpu", trainable=True),
            opt_state_from_jax(init[1], device="cpu")))

    ts, ts_local = port_ts("lpf"), port_ts("gspmd")
    stream = SyntheticStream(DataConfig(vocab=256, seq_len=S,
                                        global_batch=B, seed=0), cfg)
    seen = []
    out = train_loop(ts, stream, TrainLoopConfig(steps=steps,
                                                 sync_every=every),
                     step_fn_nosync=ts_local.step_fn,
                     on_step=lambda step, loss, v: seen.append(
                         len(ts.ledger.records)))
    np.testing.assert_allclose(out["losses"], jout["losses"], rtol=1e-5)
    # steps 1 and 3 sync; only the first synced step's trace ledgers
    assert seen == [0, 1, 1, 1]
    assert records(ts.ledger) == records(jts.ledger)
    assert not ts_local.ledger.records


#: the pods-only steps the data and model axes are held to, by pod count
_PODS_ONLY = {}


@pytest.mark.parametrize("shape", [(1, 2, 1), (2, 1, 2), (2, 1), (1, 2)])
def test_a_data_or_model_axis_keeps_a_dense_step(jax_runs, shape):
    """A data or model axis is a virtual shard, a layout for a dense
    model: the ``lpf`` step on the mesh is the one of its pods alone (the
    ``(2, 1, 1)`` pod step, or the plain step), bit for bit."""
    init = jax_runs["rs+ag"][0]
    pods = shape[0] if len(shape) == 3 else 1
    ms, params, recs = port_steps(1, init, mesh=shape)
    if pods not in _PODS_ONLY:
        _PODS_ONLY[pods] = port_steps(1, init, mesh=(pods, 1, 1))
    want_ms, want_params, want_recs = _PODS_ONLY[pods]
    assert ms == want_ms and recs == want_recs
    for name, x in params.items():
        np.testing.assert_array_equal(x, want_params[name])


def granite_configs():
    kw = dict(vocab=256, compute_dtype="float32")
    arch = "granite-moe-3b-a800m"
    return (dataclasses.replace(jax_get_config(arch, smoke=True), **kw),
            dataclasses.replace(get_config(arch, smoke=True), **kw))


def test_gspmd_moe_step_on_a_pod_mesh_matches_jax():
    """JAX's GSPMD step on a pod mesh runs the MoE block under the mesh
    (``moe_apply``, capacity per ``(pod, data)`` shard); the port's plain
    step does too, and differs from the one-device step's capacity over
    the whole batch by more than the bar."""
    jcfg, cfg = granite_configs()
    jts = jax_build_train_step(jcfg, jmesh((2, 1, 1)),
                               opt_cfg=JaxAdamWConfig(lr=LR),
                               grad_sync="gspmd", donate=False)
    p0, o0 = jts.init_fn(jax.random.PRNGKey(0))
    init = (jax.tree.map(np.asarray, p0), jax.tree.map(np.asarray, o0))
    b = batches(1)[0]
    _p, _o, jm = jts.step_fn(p0, o0, {k: jnp.asarray(v)
                                      for k, v in b.items()})
    losses = {}
    for shape in ((2, 1, 1), None):
        ts = build_train_step(cfg, None if shape is None else
                              make_mesh(shape), opt_cfg=AdamWConfig(lr=LR),
                              grad_sync="gspmd", device="cpu")
        _p, _o, m = ts.step_fn(
            params_from_jax(init[0], device="cpu", trainable=True),
            opt_state_from_jax(init[1], device="cpu"), b)
        losses[shape] = m
    want = float(jm["loss"])
    assert abs(float(losses[(2, 1, 1)]["loss"]) - want) < 1e-5 * want
    assert abs(float(losses[(2, 1, 1)]["grad_norm"]) - float(
        jm["grad_norm"])) < 1e-4 * float(jm["grad_norm"])
    # the control: one device's capacity over the whole batch
    assert abs(float(losses[None]["loss"]) - want) > 1e-5 * want


def test_train_launcher_donates_both_steps(monkeypatch, capsys):
    """Both of the launcher's steps donate their state, as JAX's
    launcher's do, and a donated step updates the parameters in place."""
    from repro_torch.launch import train
    built = []

    def spy(*args, **kw):
        ts = build_train_step(*args, **kw)
        built.append((kw, ts))
        return ts

    monkeypatch.setattr(train, "build_train_step", spy)
    train.main(["--device", "cpu", "--mesh", "2x1x1", "--grad-sync", "lpf",
                "--sync-every", "2", "--steps", "1", "--batch", "4",
                "--seq", "16"])
    assert [kw["donate"] for kw, _ in built] == [True, True]
    assert [kw["grad_sync"] for kw, _ in built] == ["lpf", "gspmd"]
    for _kw, ts in built:
        params, opt = ts.init_fn(0)
        before = [p.detach().clone() for p in params.parameters()]
        ptrs = [p.data_ptr() for p in params.parameters()]
        new, _o, _m = ts.step_fn(params, opt, batches(1)[0])
        assert [p.data_ptr() for p in new.parameters()] == ptrs
        assert any(not torch.equal(a, b) for a, b in zip(
            before, new.parameters()))


@pytest.mark.parametrize("flags", [[], ["--compress"],
                                   ["--sync-every", "2"]])
def test_train_launcher_runs_pods(flags, capsys):
    from repro_torch.launch import train
    out = train.main(["--device", "cpu", "--mesh", "2x1x1", "--grad-sync",
                      "lpf", "--steps", "3", "--batch", "4", "--seq", "16",
                      *flags])
    text = capsys.readouterr().out
    assert len(out["losses"]) == 3 and np.isfinite(out["final_loss"])
    assert "LPF superstep ledger" in text
    method = "ring+int16" if flags == ["--compress"] else "rs+ag"
    assert f"pod_allreduce[x2]           {method}" in text


@pytest.mark.parametrize("mesh", ["1x2x1", "1x1x2", "2x1"])
def test_train_launcher_runs_device_axes(mesh, capsys):
    from repro_torch.launch import train
    out = train.main(["--device", "cpu", "--mesh", mesh, "--steps", "1",
                      "--batch", "4", "--seq", "16"])
    assert len(out["losses"]) == 1 and np.isfinite(out["final_loss"])
