"""The port's cross-pod gradient sync (``repro_torch.bsp.pod_sync``,
``repro_torch.bsp.grad_sync``) against the JAX package's on the CPU.

The JAX side runs on the conftest's host devices: a ``(q,)`` mesh over
the ``pod`` axis, each device one pod.  The port holds the ``q`` pods as
virtual processes, every pod-varying leaf stacked ``[q, ...]``.  The same
numpy inputs, drawn from a seed, go through both:

* ``bucketize`` and its validation, ``bucket_staleness``;
* ``pod_allreduce`` for every method at q = 2 and 4 on pod-varying
  trees: values bit-equal at q = 2 (one f32 sum a value) and within 1e-6
  relative at q = 4 (the pods' sum in another order), the ledger field
  for field; the compressed int16 ring within JAX's 0.05 of the exact
  mean (and equal to JAX's rounding);
* ``build_cross_pod_sync`` flat, bucketed and stale: the ``bucket_sync``
  program's canonical order, signature, optimized schedule and ledger
  exactly, and its values;
* ``lpf_bucketed_allreduce``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.bsp.grad_sync as jgs
from repro.bsp import pod_sync as jpod
from repro.core import (CompressSpec as JCompress, CostLedger as JLedger,
                        SyncAttributes as JAttrs, compat, machine as jmachine)
from repro_torch import core as tlpf
from repro_torch.bsp import grad_sync as tgs
from repro_torch.bsp import pod_sync as tpod
from repro_torch.interop import hardware_from_fields
from repro_torch.launch.mesh import make_mesh

SEED = 0
def tpu_vp(kind):
    """The JAX package's TPU v5e fields as the port's hardware, its
    virtual-process link the TPU's ``kind`` link: the machine a JAX
    context probes over a ``pod`` (DCN) or ``x`` (ICI) axis."""
    hw = hardware_from_fields(dataclasses.asdict(jmachine.TPU_V5E))
    return dataclasses.replace(hw, links={**hw.links, "vp": hw.links[kind]})


TPU_DCN = tpu_vp("dcn")


def pod_tree(q, seed=SEED, zero=True, bf16=True):
    """A pod-varying tree ([q, ...] leaves) with dict keys out of sorted
    order, a list of layers, a per-pod scalar, a bf16 leaf and a
    zero-byte leaf."""
    rng = np.random.default_rng([seed, q])
    f = lambda *s: rng.standard_normal((q,) + s).astype(np.float32)
    tree = {"z_head": f(24), "layers": [{"w": f(8, 6), "b": f(6)}
                                        for _ in range(3)],
            "a_scale": f(), "emb": f(5, 7)}
    if bf16:
        tree["norm"] = f(9).astype(jnp.bfloat16)
    if zero:
        tree["empty"] = np.zeros((q, 0), np.float32)
    return tree


def to_torch(tree):
    return jax.tree.map(
        lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
            torch.bfloat16) if a.dtype == jnp.bfloat16
        else torch.from_numpy(np.array(a)), tree)


def to_np(tree):
    return jax.tree.map(lambda t: t.float().numpy() if isinstance(
        t, torch.Tensor) else np.asarray(t, np.float32), tree,
        is_leaf=lambda t: isinstance(t, torch.Tensor))


def pod_mesh(q, axis="pod"):
    return compat.make_mesh((q,), (axis,), devices=jax.devices()[:q])


def jax_pod_allreduce(tree, q, **kw):
    """The JAX package's ``pod_allreduce`` inside a shard_map manual over
    the pod axis; returns (stacked result, ledger)."""
    ledger = JLedger()
    specs = jax.tree.map(lambda _: P("pod"), tree)

    def body(t):
        t = jax.tree.map(lambda l: l[0], t)
        out = jpod.pod_allreduce(t, q, "pod", ledger=ledger, **kw)
        return jax.tree.map(lambda l: l[None], out)

    fn = jax.jit(compat.shard_map(body, mesh=pod_mesh(q), in_specs=(specs,),
                                  out_specs=specs, check_vma=False))
    out = fn(jax.tree.map(jnp.asarray, tree))
    return jax.tree.map(lambda a: np.asarray(a, np.float32), out), ledger


def records(ledger):
    return [dataclasses.asdict(r) for r in ledger.records]


# -- bucketize, bucket_staleness ---------------------------------------------

BUCKET_CASES = [([256] * 4, 512), ([256] * 4, None), ([256] * 4, 1),
                ([100, 900, 100], 512), ([100, 100, 900], 512), ([], 512),
                ([0, 256, 0, 256, 0], 512), ([4, 0, 0], None),
                ([40, 24, 32, 8, 16, 4], 48)]


@pytest.mark.parametrize("sizes,bucket", BUCKET_CASES)
def test_bucketize_matches_jax(sizes, bucket):
    assert tpod.bucketize(sizes, bucket) == jpod.bucketize(sizes, bucket)


@pytest.mark.parametrize("sizes,bucket,match", [
    ([256], 0, "bucket_bytes"), ([256], -4, "bucket_bytes"),
    ([256, -1], 512, "negative")])
def test_bucketize_validation_matches_jax(sizes, bucket, match):
    for mod in (tpod, jpod):
        with pytest.raises(ValueError, match=match) as err:
            mod.bucketize(sizes, bucket)
        if mod is tpod:
            port_msg = str(err.value)
    with pytest.raises(ValueError) as jerr:
        jpod.bucketize(sizes, bucket)
    assert port_msg == str(jerr.value)


@pytest.mark.parametrize("n,stale", [(3, 2), (1, 4), (0, 4), (3, 0),
                                     (5, 3), (2, -1)])
def test_bucket_staleness_matches_jax(n, stale):
    assert tgs.bucket_staleness(n, stale) == jgs.bucket_staleness(n, stale)


def test_tree_flatten_follows_jax_order():
    tree = pod_tree(2)
    leaves, spec = tpod.tree_flatten(to_torch(tree))
    jleaves = jax.tree_util.tree_leaves(tree)
    assert [tuple(l.shape) for l in leaves] == [l.shape for l in jleaves]
    for a, b in zip(leaves, jleaves):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
    back = tpod.tree_unflatten(spec, leaves)
    assert list(back) == list(to_torch(tree))


# -- pod_allreduce ------------------------------------------------------------

METHODS = [("rs+ag", None), ("bucketed", 512), ("bucketed", 1),
           ("bucketed", None), ("bucketed_fenced", 512),
           ("bucketed_overlap", 512), ("bucketed_overlap", 1),
           ("ring", None), ("auto", None), ("auto", 256)]


@pytest.fixture(scope="module")
def jax_runs():
    """Every (method, bucket, q, mean) case through the JAX package once."""
    out = {}
    for q in (2, 4):
        for method, bucket in METHODS:
            for mean in (True, False):
                out[(method, bucket, q, mean)] = jax_pod_allreduce(
                    pod_tree(q), q, method=method, bucket_bytes=bucket,
                    mean=mean)
        for method in ("ring", "auto"):
            out[("int16", method, q)] = jax_pod_allreduce(
                pod_tree(q, zero=False), q, method=method, mean=True,
                attrs=JAttrs(compress=JCompress(bits=8)))
    return out


def assert_close_tree(got, want, q):
    gl, wl = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert g.shape == w.shape
        if q == 2:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6 * (
                np.abs(w).max() if w.size else 0))


@pytest.mark.parametrize("mean", [True, False])
@pytest.mark.parametrize("q", [2, 4])
@pytest.mark.parametrize("method,bucket", METHODS)
def test_pod_allreduce_matches_jax(jax_runs, method, bucket, q, mean):
    want, jledger = jax_runs[(method, bucket, q, mean)]
    tree = pod_tree(q)
    ledger = tlpf.CostLedger()
    out = tpod.pod_allreduce(to_torch(tree), q, "pod", ledger=ledger,
                             method=method, bucket_bytes=bucket, mean=mean)
    assert records(ledger) == records(jledger)
    got = to_np(out)
    assert_close_tree(got, want, q)
    # every pod holds the same result, in its leaf's dtype
    flat_in = jax.tree_util.tree_leaves(to_torch(tree))
    for l, l_in in zip(tpod.tree_flatten(out)[0], tpod.tree_flatten(
            to_torch(tree))[0]):
        assert l.dtype == l_in.dtype and l.shape == l_in.shape
        assert (l == l[:1]).all()
    assert len(flat_in) == len(tpod.tree_flatten(out)[0])


@pytest.mark.parametrize("q", [2, 4])
@pytest.mark.parametrize("method", ["ring", "auto"])
def test_compressed_ring_matches_jax(jax_runs, method, q):
    want, jledger = jax_runs[("int16", method, q)]
    tree = pod_tree(q, zero=False)
    ledger = tlpf.CostLedger()
    attrs = tlpf.SyncAttributes(compress=tlpf.CompressSpec(bits=8))
    out = to_np(tpod.pod_allreduce(to_torch(tree), q, ledger=ledger,
                                   method=method, attrs=attrs))
    assert records(ledger) == records(jledger)
    assert [r["method"] for r in records(ledger)] == ["ring+int16"]
    assert_close_tree(out, want, q)
    # within JAX's own 0.05 of the exact mean
    exact = to_np(tpod.pod_allreduce(to_torch(tree), q, method="ring"))
    for g, e in zip(jax.tree_util.tree_leaves(out),
                    jax.tree_util.tree_leaves(exact)):
        assert np.abs(g - e).max() <= 0.05 * np.abs(e).max() + 1e-6


@pytest.mark.parametrize("method,attrs", [
    ("nope", None), ("rs+ag", "int16"), ("bucketed", "int16"),
    ("bucketed_fenced", "int16"), ("bucketed_overlap", "int16")])
def test_pod_allreduce_errors_match_jax(method, attrs):
    tree = pod_tree(2)
    kw = dict(method=method, bucket_bytes=512)
    jkw, tkw = dict(kw), dict(kw)
    if attrs:
        jkw["attrs"] = JAttrs(compress=JCompress(bits=8))
        tkw["attrs"] = tlpf.SyncAttributes(
            compress=tlpf.CompressSpec(bits=8))
    with pytest.raises(ValueError) as jerr:
        jax_pod_allreduce(tree, 2, **jkw)
    with pytest.raises(ValueError) as terr:
        tpod.pod_allreduce(to_torch(tree), 2, **tkw)
    assert str(terr.value) == str(jerr.value)


def test_pod_allreduce_overlap_ledger_order():
    """``bucketed_overlap`` ledgers [rs_B-1][ag_k||rs_k-1]...[ag_0]: the
    last bucket first, overlap groups priced by ``overlap_cost``."""
    ledger = tlpf.CostLedger()
    grads = {"layer0": torch.arange(256.0).expand(8, 256),
             "layer1": torch.arange(64.0).expand(8, 64)}
    out = tpod.pod_allreduce(grads, 8, ledger=ledger,
                             method="bucketed_overlap", bucket_bytes=1024)
    labels = [r.label for r in ledger.records]
    assert labels[0].startswith("pod_allreduce.b1.rs")
    assert labels[1] == "pod_allreduce.b1.ag[x8]||pod_allreduce.b0.rs[x8]"
    assert labels[-1].startswith("pod_allreduce.b0.ag")
    assert ledger.records[1].method.startswith("overlap[")
    for k, v in grads.items():
        assert torch.equal(out[k], v)


def test_one_pod_is_the_identity():
    tree = to_torch(pod_tree(1))
    assert tpod.pod_allreduce(tree, 1) is tree


def test_pod_allreduce_refuses_unstacked_leaves():
    with pytest.raises(tlpf.LPFFatalError, match=r"\[q, \.\.\.\]"):
        tpod.pod_allreduce({"w": torch.zeros(3, 4)}, 2)


# -- build_cross_pod_sync -------------------------------------------------------

SYNC_CASES = {"flat": (None, 0, 0), "bucketed": (1, 0, 0),
              "bucketed_64": (64, 0, 0), "stale_off": (1, 2, 1),
              "stale_on": (1, 2, 2)}


def sync_grads(q=2):
    rng = np.random.default_rng([SEED, 7, q])
    return {"a": rng.standard_normal((q, 1, 8)).astype(np.float32),
            "b": rng.standard_normal((q, 1, 4)).astype(np.float32) + 100,
            "c": rng.standard_normal((q, 1, 2)).astype(np.float32) - 7,
            "d": rng.standard_normal((q, 1, 9)).astype(np.float32)}


def spy_hook(module, monkeypatch, **extra):
    """Record the contexts ``module.hook`` creates; ``extra`` keywords go
    to every call (the port's ``hardware=`` to price as the JAX side)."""
    ctxs = []
    real = module.hook

    def hook(*args, **kw):
        spmd = args[1]

        def wrapped(ctx, s, p, a):
            ctxs.append(ctx)
            return spmd(ctx, s, p, a)
        return real(args[0], wrapped, *args[2:], **kw, **extra)

    monkeypatch.setattr(module, "hook", hook)
    return ctxs


@pytest.fixture(scope="module")
def jax_syncs():
    """Each SYNC_CASES case through the JAX package's sync on the (2, 2, 2)
    mesh: values, the hook context's ledger, last program and trace."""
    from repro.core import global_program_cache
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        ctxs = spy_hook(jgs, mp)
        mesh = compat.make_mesh((2, 2, 2), ("pod", "data", "model"))
        grads = sync_grads()
        for name, (bucket, stale, step) in SYNC_CASES.items():
            global_program_cache().clear()
            specs = {k: P("pod") for k in grads}
            sync = jgs.build_cross_pod_sync(
                mesh, specs, pod_axis="pod", mean=True, bucket_bytes=bucket,
                attrs=JAttrs(stale=stale))
            ctxs.clear()
            val = jax.jit(lambda g: sync(g, step=step))(
                {k: jnp.asarray(v[:, 0]) for k, v in grads.items()})
            ctx = ctxs[0]
            out[name] = ({k: np.asarray(v) for k, v in val.items()},
                         records(ctx.ledger), ctx.last_program)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("name", sorted(SYNC_CASES))
def test_cross_pod_sync_matches_jax(jax_syncs, name, monkeypatch):
    bucket, stale, step = SYNC_CASES[name]
    want, jrecs, jprog_ = jax_syncs[name]
    ctxs = spy_hook(tgs, monkeypatch, hardware=TPU_DCN)
    sync = tgs.build_cross_pod_sync(
        make_mesh((2, 1, 1)), None, pod_axis="pod", mean=True,
        bucket_bytes=bucket, attrs=tlpf.SyncAttributes(stale=stale))
    grads = {k: torch.from_numpy(v) for k, v in sync_grads().items()}
    got = sync(grads, step=step)
    ctx = ctxs[0]
    assert records(ctx.ledger) == jrecs
    tp = ctx.last_program
    for f in ("p", "n_recorded", "n_coalesced", "n_eliminated", "n_merged",
              "overlap_groups", "n_overlapped", "n_rewritten", "n_hoisted",
              "canonical"):
        assert getattr(tp, f) == getattr(jprog_, f), f
    assert tp.groups() == jprog_.groups()
    for a, b in zip(tp.steps, jprog_.steps):
        assert (a.table, a.label, a.merged_from) == \
            (b.table, b.label, b.merged_from)
        assert dataclasses.asdict(a.plan) == dataclasses.asdict(b.plan)
    for k in grads:
        np.testing.assert_array_equal(got[k][:, 0].numpy(), want[k])
    # stale buckets keep their pod-local gradients; fresh ones average
    synced = [k for k in grads if not torch.equal(got[k], grads[k])]
    if name == "stale_off":
        assert synced == ["d"]
    else:
        assert sorted(synced) == sorted(grads)


def test_cross_pod_sync_is_the_identity_without_pods():
    grads = {"a": torch.ones(1, 4)}
    for mesh in (make_mesh((1, 1)), make_mesh((1, 1, 1)), make_mesh((1, 2)),
                 make_mesh((1, 2, 2)), None):
        assert tgs.build_cross_pod_sync(mesh, None)(grads) is grads


@pytest.mark.parametrize("name", sorted(SYNC_CASES))
def test_cross_pod_sync_of_a_data_mesh_matches_jax(jax_syncs, name,
                                                   monkeypatch):
    """The port's (2, 2, 2) and (2, 2, 1) meshes sync over their 2 pods
    (the data and model axes are virtual shards the sync does not read):
    values and ledger JAX's on its (2, 2, 2) mesh."""
    bucket, stale, step = SYNC_CASES[name]
    want, jrecs, _ = jax_syncs[name]
    ctxs = spy_hook(tgs, monkeypatch, hardware=TPU_DCN)
    grads = {k: torch.from_numpy(v) for k, v in sync_grads().items()}
    for shape in ((2, 2, 2), (2, 2, 1)):
        ctxs.clear()
        sync = tgs.build_cross_pod_sync(
            make_mesh(shape), None, pod_axis="pod", mean=True,
            bucket_bytes=bucket, attrs=tlpf.SyncAttributes(stale=stale))
        got = sync(grads, step=step)
        assert records(ctxs[0].ledger) == jrecs
        for k in grads:
            np.testing.assert_array_equal(got[k][:, 0].numpy(), want[k])


# -- lpf_bucketed_allreduce, lpf_allreduce ----------------------------------------

@pytest.mark.parametrize("mean", [True, False])
def test_lpf_bucketed_allreduce_matches_jax(mean):
    from repro import core as jlpf
    p, n, bucket = 8, 40, 16
    x = np.random.default_rng([SEED, 9]).standard_normal(
        (p, n)).astype(np.float32)

    def jspmd(ctx, s, p_, xs):
        return jpod.lpf_bucketed_allreduce(ctx, xs.reshape(-1), bucket,
                                           mean=mean)

    want, jledger = jlpf.exec_(pod_mesh(p, "x"), jspmd, jnp.asarray(x),
                               in_specs=P("x"), out_specs=P("x"),
                               return_ledger=True)
    want = np.asarray(want).reshape(p, n)
    got, ledger = tlpf.exec_(
        p, lambda ctx, s, p_, xs: tpod.lpf_bucketed_allreduce(
            ctx, xs, bucket, mean=mean), torch.from_numpy(x), device="cpu",
        hardware=tpu_vp("ici"), return_ledger=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert records(ledger) == records(jledger)
    # each read inside the recording flushes its bucket's cone alone: the
    # three buckets run as six plain supersteps in both packages
    assert [r.method for r in ledger.records] == ["fused_rs",
                                                  "fused_ag"] * 3
    with pytest.raises(ValueError, match="bucket_elems"):
        tlpf.exec_(p, lambda ctx, s, p_, xs: tpod.lpf_bucketed_allreduce(
            ctx, xs, 0), torch.from_numpy(x), device="cpu")


def test_lpf_allreduce_means_over_processes():
    x = torch.arange(24.0).reshape(4, 6)
    out = tlpf.exec_(4, lambda ctx, s, p, a: tgs.lpf_allreduce(
        ctx, a, mean=True), x, device="cpu")
    assert torch.equal(out, x.mean(0, keepdim=True).expand(4, 6))


# -- the virtual mesh, the stream helper on the CPU ------------------------------

@pytest.mark.parametrize("shape", [(8,), (4, 2), (2, 2, 2), (1, 2, 2, 2)])
def test_make_mesh_names_axes_as_jax(shape):
    from repro.launch import mesh as jmesh
    from repro_torch.launch import mesh as tmesh
    j, t = jmesh.make_mesh(shape), tmesh.make_mesh(shape)
    assert t.axis_names == tuple(j.axis_names)
    assert t.shape == dict(j.shape)
    assert tmesh.dp_axes_of(t) == jmesh.dp_axes_of(j)
    assert tmesh.model_axis_of(t) == jmesh.model_axis_of(j)


def test_production_mesh_is_a_shape_of_virtual_shards():
    """The production layout is a shape: its 2 pods are virtual
    processes and its data and model axes virtual shards."""
    from repro_torch.launch import mesh as tmesh
    for multi, want, pods in ((False, {"data": 16, "model": 16}, 1),
                              (True, {"pod": 2, "data": 16, "model": 16},
                               2)):
        m = tmesh.make_production_mesh(multi_pod=multi)
        assert m.shape == want
        assert tmesh.virtual_pods(m) == pods
        assert tmesh.mesh_shards(m, tmesh.dp_axes_of(m)) == 16 * pods
        assert tmesh.mesh_shards(m, m.axis_names) == 256 * pods
    assert tmesh.virtual_pods(make_mesh((4, 1, 1))) == 4
    assert tmesh.virtual_pods(make_mesh((4, 2, 2))) == 4
    assert tmesh.virtual_pods(make_mesh((8,), ("x",))) == 1
    assert tmesh.virtual_pods(None) == 1
    with pytest.raises(tlpf.LPFFatalError, match="repeat"):
        make_mesh((2, 2), ("pod", "pod"))


def test_fork_streams_stays_on_the_cpu_stream():
    from repro_torch.core import sync as tsync
    with tsync.fork_streams("cpu", 3) as streams:
        assert streams == [None, None, None]
    with tsync.on_stream(None):
        pass
    assert tsync._STREAM_POOLS == {} or all(
        d.type == "cuda" for d in tsync._STREAM_POOLS)


@pytest.mark.parametrize("method", ["rs+ag", "bucketed_overlap", "ring"])
def test_pod_allreduce_results_die_with_their_last_reference(method):
    """No reference cycle holds a sync's output (a full-width gradient
    tree's wire is 9.9 GB): it is freed the moment the caller drops it,
    without the cyclic collector."""
    import gc
    import weakref
    tree = to_torch(pod_tree(2))
    gc.disable()
    try:
        out = tpod.pod_allreduce(tree, 2, method=method, bucket_bytes=512)
        alive = weakref.ref(out["layers"][1]["w"])
        del out
        assert alive() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("method,compress", [
    ("rs+ag", False), ("bucketed", False), ("bucketed_overlap", False),
    ("ring", False), ("ring", True)])
def test_pod_allreduce_rows_are_one_view(method, compress):
    """Every pod's row of a result is the same memory (a stride-0 view):
    the sync holds one copy of the reduced tree, not q of them (at
    llama3.2-1b's width the copy would be 9.9 GB)."""
    attrs = tlpf.SyncAttributes(compress=tlpf.CompressSpec(bits=8)) \
        if compress else tlpf.LPF_SYNC_DEFAULT
    out = tpod.pod_allreduce(to_torch(pod_tree(2, zero=False)), 2,
                             method=method, bucket_bytes=512, attrs=attrs)
    for leaf in tpod.tree_flatten(out)[0]:
        assert leaf.shape[0] == 2 and leaf.stride(0) == 0, leaf.shape
