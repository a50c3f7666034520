"""Parity of the port's graphs, PageRank and ``compile_loop``
(``repro_torch.algorithms``, ``LPFContext.compile_loop``) with the JAX
package on the CPU.

The graph constructors must give the JAX package's edge lists and shard
arrays exactly; PageRank holds the JAX tests' bars against the dense
float64 oracle, takes the same iteration count as the JAX run, and
ledgers the same supersteps field by field.  JAX runs on the 8-device CPU
mesh, the port over p = 8 virtual processes with ``device="cpu"``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import core as jlpf
from repro.algorithms import graphs as jgraphs
from repro.algorithms import pagerank as jpr
from repro_torch import core as tlpf
from repro_torch.algorithms import graphs as tgraphs
from repro_torch.algorithms import pagerank as tpr
from repro_torch.interop import graph_from_fields, hardware_from_fields

P8 = 8


# ---------------------------------------------------------------------------
# graphs: the same edge lists and shard arrays
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m,seed,chunk", [
    (64, 200, 5, tgraphs.CHUNK_ROWS), (128, 400, 3, tgraphs.CHUNK_ROWS),
    (256, 1500, 42, 37), (1024, 8000, 1, 1000), (512, 6000, 7, 64),
    (4096, 40000, 2, tgraphs.CHUNK_ROWS)])
def test_rmat_graph_matches_jax(monkeypatch, n, m, seed, chunk):
    """The first m distinct non-loop edges of the choice stream, drawn in
    chunks of any size, are the JAX package's edge list."""
    want = jgraphs.rmat_graph(n, m, seed)
    monkeypatch.setattr(tgraphs, "CHUNK_ROWS", chunk)
    got = tgraphs.rmat_graph(n, m, seed)
    assert got.dtype == want.dtype and got.shape == want.shape == (m, 2)
    np.testing.assert_array_equal(got, want)


def test_rmat_chunk_is_the_choice_stream():
    """A chunk's quadrants are ``Generator.choice(4, p=...)``'s draws,
    and the stream does not depend on how many rows one call takes."""
    probs = np.array([0.57, 0.19, 0.19, 0.05])
    cdf = probs.cumsum()
    cdf /= cdf[-1]
    quad = np.random.default_rng(9).choice(4, size=(300, 6), p=probs)
    w = 1 << np.arange(5, -1, -1)
    src, dst = (quad >= 2) @ w, (quad % 2) @ w
    keep = src != dst
    rng = np.random.default_rng(9)
    keys = np.concatenate([tgraphs._rmat_chunk(rng, r, 6, cdf)
                           for r in (1, 120, 179)])
    np.testing.assert_array_equal(keys, (src[keep] << 6) | dst[keep])


@pytest.mark.parametrize("n,band", [(64, 3), (100, 1), (32, 2)])
def test_banded_graph_matches_jax(n, band):
    np.testing.assert_array_equal(tgraphs.banded_graph(n, band),
                                  jgraphs.banded_graph(n, band))


def graph_fields_equal(jg, tg):
    for f in dataclasses.fields(jg):
        a, b = getattr(jg, f.name), getattr(tg, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("graph,p", [
    ("banded", 8), ("banded", 4), ("rmat128", 8), ("rmat128", 1),
    ("rmat1024", 8), ("rmat1024", 16)])
def test_partition_graph_matches_jax(graph, p):
    edges, n = {"banded": (jgraphs.banded_graph(64, 3), 64),
                "rmat128": (jgraphs.rmat_graph(128, 400, seed=3), 128),
                "rmat1024": (jgraphs.rmat_graph(1024, 9000, seed=4), 1024),
                }[graph]
    jg = jgraphs.partition_graph(edges, n, p)
    tg = tgraphs.partition_graph(edges, n, p)
    graph_fields_equal(jg, tg)
    assert tg.h_bytes() == jg.h_bytes()
    graph_fields_equal(jg, graph_from_fields(dataclasses.asdict(jg)))


# ---------------------------------------------------------------------------
# PageRank against the JAX package and the oracles
# ---------------------------------------------------------------------------

def jax_pagerank_with_ledger(mesh8, g, **kw):
    """``repro.algorithms.lpf_pagerank``'s body, with its ledger."""
    args = {k: jnp.asarray(getattr(g, k)) for k in tpr.SHARD_KEYS}

    def spmd(ctx, s, p, a):
        shard = {k: v.reshape(v.shape[1:]) for k, v in a.items()}
        return jpr.pagerank_spmd(ctx, g, shard, **kw)

    (r, iters, res), led = jlpf.exec_(
        mesh8, spmd, args, in_specs={k: P("x") for k in args},
        out_specs=(P("x"), P(), P()), return_ledger=True)
    return np.asarray(r).reshape(-1), int(iters), float(res), led


GRAPHS = {
    "banded": lambda: (jgraphs.banded_graph(64, 3), 64, {}, 1e-5, False),
    "rmat": lambda: (jgraphs.rmat_graph(128, 400, seed=3), 128,
                     {"max_iter": 300}, 1e-3, True),
    "rmat_skewed": lambda: (jgraphs.rmat_graph(256, 900, seed=11, a=0.7,
                                               b=0.1, c=0.1), 256,
                            {"max_iter": 300}, 1e-3, True),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_pagerank_matches_jax_and_oracle(mesh8, name):
    """The JAX tests' bars against the dense oracle (1e-5 absolute on the
    banded graph, 1e-3 relative on R-MAT), rank mass 1 within 1e-4, the
    JAX run's iteration count, and its ledger field by field."""
    edges, n, kw, bar, relative = GRAPHS[name]()
    jg = jgraphs.partition_graph(edges, n, P8)
    rj, ij, _, jled = jax_pagerank_with_ledger(mesh8, jg, tol=1e-7, **kw)
    r, iters, res, tled = tpr.lpf_pagerank(
        P8, graph_from_fields(dataclasses.asdict(jg)), tol=1e-7,
        device="cpu", return_ledger=True, **kw)
    r = r.numpy()
    ref, _ = jpr.reference_pagerank(edges, n, tol=1e-12)
    err = np.abs(r - ref).max() / (ref.max() if relative else 1.0)
    assert err < bar
    assert abs(r.sum() - 1.0) < 1e-4
    assert iters == ij and iters < kw.get("max_iter", 200)
    assert res <= 1e-7 or iters == 1
    np.testing.assert_allclose(r, rj, rtol=1e-5, atol=1e-7)
    assert [dataclasses.asdict(x) for x in jled.records] == \
        [dataclasses.asdict(x) for x in tled.records]
    assert [x.label for x in tled.records] == [
        "pr.init.rs", "pr.init.ag", "pr.halo", "pr.reduce.rs",
        "pr.reduce.ag"]
    assert tled.records[2].method == "direct"
    assert tled.records[2].h_bytes == jg.h_bytes()
    jm = jlpf.probe({"x": P8}, jlpf.TPU_V5E)
    tm = tlpf.probe({"x": P8}, hardware_from_fields(
        dataclasses.asdict(jlpf.TPU_V5E)))
    assert jled.predicted_seconds(jm) == tled.predicted_seconds(tm)


def test_pagerank_h_bytes_static():
    edges = tgraphs.rmat_graph(128, 400, seed=3)
    g = tgraphs.partition_graph(edges, 128, P8)
    # the halo plan is static: its h-relation does not depend on values
    assert g.h_bytes() > 0
    assert g.halo_max >= max(c for (_, _, _, _, c) in g.msgs)


def test_pagerank_through_hook_matches_exec():
    """Algorithm 3's recipe: a host function that already holds the shards
    hooks the unmodified PageRank; the ranks are the lpf_pagerank run's."""
    edges = tgraphs.rmat_graph(256, 1500, seed=42)
    g = tgraphs.partition_graph(edges, 256, P8)
    r, iters, res = tpr.lpf_pagerank(P8, g, tol=1e-7, max_iter=150,
                                     device="cpu")
    shards = tpr.shard_tensors(g, device="cpu")

    def host_analytics(args):
        local_nnz = (args["vals"] > 0).sum(1)

        def spmd(ctx, s, p, a):
            return tpr.pagerank_spmd(ctx, g, a, tol=1e-7, max_iter=150)

        out = tlpf.hook(P8, spmd, args, device="cpu")
        return out, local_nnz

    (rh, ih, resh), nnz = host_analytics(shards)
    assert ih == iters and float(resh[0]) == res
    np.testing.assert_array_equal(rh.reshape(-1).numpy(), r.numpy())
    assert int(nnz.sum()) == len(edges)


def test_spmv_roundtrip_matches_dense_and_jax(mesh8):
    """One halo exchange + the local SpMV equals the dense A @ r, and the
    JAX package's segment sum."""
    n, p = 64, P8
    edges = jgraphs.rmat_graph(n, 200, seed=5)
    g = jgraphs.partition_graph(edges, n, p)
    r0 = np.random.default_rng(0).random(n).astype(np.float32)
    A = np.zeros((n, n), np.float32)
    outdeg = np.bincount(edges[:, 0], minlength=n)
    for s, d in edges:
        A[d, s] = 1.0 / outdeg[s]
    want = A @ r0

    args = {k: jnp.asarray(getattr(g, k)) for k in
            ("row_ids", "col_ext", "vals", "pack_idx")}
    args["r"] = jnp.asarray(r0.reshape(p, -1))

    def jspmd(ctx, s, pp, a):
        rl = a["r"].reshape(a["r"].shape[1:])
        halo = jpr._halo_exchange(ctx, g, rl, jlpf.LPF_SYNC_DEFAULT,
                                  a["pack_idx"].reshape(-1))
        x_ext = jnp.concatenate([rl, halo])
        contrib = a["vals"].reshape(-1) * x_ext[a["col_ext"].reshape(-1)]
        return jax.ops.segment_sum(contrib, a["row_ids"].reshape(-1),
                                   num_segments=g.rows + 1)[:g.rows]

    jout = np.asarray(jlpf.exec_(mesh8, jspmd, args,
                                 in_specs={k: P("x") for k in args},
                                 out_specs=P("x"))).reshape(-1)
    tg = graph_from_fields(dataclasses.asdict(g))
    shard = tpr.shard_tensors(tg, device="cpu")

    def tspmd(ctx, s, pp, a):
        rl = torch.from_numpy(r0.reshape(p, -1))
        halo = tpr._halo_exchange(ctx, tg, rl, tlpf.LPF_SYNC_DEFAULT,
                                  a["pack_idx"])
        return tpr._SpMV(tg, a)(torch.cat([rl, halo], dim=1))

    tout = tlpf.exec_(p, tspmd, shard, device="cpu").reshape(-1).numpy()
    np.testing.assert_allclose(tout, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tout, jout, rtol=1e-6, atol=1e-7)


def test_dataflow_baseline_matches_jax():
    """The 'pure Spark' baseline reproduces SparkPageRank semantics: ranks
    sum to ~n only when there are no dangling nodes; the JAX package's
    values within f32 rounding."""
    edges = jgraphs.banded_graph(32, 2)
    r = tpr.dataflow_pagerank(edges, 32, iters=20, device="cpu").numpy()
    assert abs(r.sum() - 32.0) < 1e-2
    edges = jgraphs.rmat_graph(128, 400, seed=3)
    np.testing.assert_allclose(
        tpr.dataflow_pagerank(edges, 128, iters=20, device="cpu").numpy(),
        jpr.dataflow_pagerank(edges, 128, iters=20), rtol=1e-5)


def test_sparse_oracle_matches_dense_oracle():
    edges = jgraphs.rmat_graph(128, 400, seed=3)
    ref, it = jpr.reference_pagerank(edges, 128, tol=1e-12)
    got, it2 = tpr.sparse_reference_pagerank(edges, 128, tol=1e-12,
                                             device="cpu")
    assert it2 == it
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-15)


# ---------------------------------------------------------------------------
# compile_loop (tests/test_compiled_program.py, against the JAX package)
# ---------------------------------------------------------------------------

def ring_body(xp_zeros):
    def body(c2, carry):
        c2.resize_memory_register(2)
        c2.resize_message_queue(c2.p)
        a = c2.register_global("a", carry)
        b = c2.register_global("b", xp_zeros(carry))
        c2.put(a, b, to=lambda s_: (s_ + 1) % c2.p, size=4)
        c2.sync(label="shift")
        out = c2.value(b)
        c2.deregister(a)
        c2.deregister(b)
        return out
    return body


def test_compile_loop_counted_with_collect(mesh8):
    """4 counted iterations of a one-superstep ring shift: the final
    value, the stacked collects and the once-ledgered body equal the JAX
    package's scan."""
    def jwrapped(ctx, s, p, _):
        final, ys = ctx.compile_loop(ring_body(jnp.zeros_like),
                                     jnp.arange(4.0) + ctx.pid, n_iters=4,
                                     label="ring", collect=lambda c: c[:1])
        return final, ys

    (jfinal, jys), jled = jlpf.exec_(mesh8, jwrapped, None,
                                     out_specs=(P("x"), P(None, "x")),
                                     return_ledger=True)

    def twrapped(ctx, s, p, _):
        return ctx.compile_loop(ring_body(torch.zeros_like),
                                torch.arange(4.0) + ctx.pid, n_iters=4,
                                label="ring", collect=lambda c: c[:, :1])

    (tfinal, tys), tled = tlpf.exec_(P8, twrapped, None, device="cpu",
                                     return_ledger=True)
    np.testing.assert_array_equal(np.asarray(jfinal).reshape(8, 4),
                                  tfinal.numpy())
    np.testing.assert_array_equal(np.asarray(jys).reshape(4, 8),
                                  tys.reshape(4, 8).numpy())
    for d in range(8):
        np.testing.assert_array_equal(tys[:, d, 0].numpy(),
                                      [(d - k - 1) % 8 for k in range(4)])
    assert [dataclasses.asdict(r) for r in jled.records] == \
        [dataclasses.asdict(r) for r in tled.records]
    assert len(tled.records) == 1 and tled.records[0].label == "shift"


def test_compile_loop_while_matches_python_loop_and_jax(mesh8):
    """A cond-driven loop equals the same body iterated by hand, and the
    JAX package's while loop."""
    def make_body(xp_zeros):
        ring = ring_body(xp_zeros)

        def body(c2, carry):
            v, it = carry
            return ring(c2, v) + 1.0, it + 1
        return body

    def jwrapped(ctx, s, p, _):
        v, it = ctx.compile_loop(
            make_body(jnp.zeros_like),
            (jnp.arange(4.0) + ctx.pid, jnp.zeros((), jnp.int32)),
            cond=lambda c: c[1] < 3, label="w")
        return v

    jv = np.asarray(jlpf.exec_(mesh8, jwrapped, None,
                               out_specs=P("x"))).reshape(8, 4)

    def trun(use_loop):
        def twrapped(ctx, s, p, _):
            v0 = (torch.arange(4.0) + ctx.pid, 0)
            if use_loop:
                v, it = ctx.compile_loop(make_body(torch.zeros_like), v0,
                                         cond=lambda c: c[1] < 3, label="w")
            else:
                v, it = v0
                for _ in range(3):
                    v, it = make_body(torch.zeros_like)(ctx, (v, it))
            assert it == 3
            return v
        return tlpf.exec_(P8, twrapped, None, device="cpu").numpy()

    np.testing.assert_array_equal(trun(True), trun(False))
    np.testing.assert_array_equal(trun(True), jv)


@pytest.mark.parametrize("bad", ["both", "collect_while"])
def test_compile_loop_argument_validation(mesh8, bad):
    """Exactly one of n_iters/cond, and collect only with n_iters: both
    packages refuse alike."""
    kw = {"both": dict(n_iters=2, cond=lambda c: True),
          "collect_while": dict(cond=lambda c: True,
                                collect=lambda c: c)}[bad]

    def jwrapped(ctx, s, p, _):
        ctx.compile_loop(lambda c2, c: c, jnp.zeros(1), **kw)
        return jnp.zeros(1)

    with pytest.raises(jlpf.LPFFatalError) as je:
        jlpf.exec_(mesh8, jwrapped, None)
    ctx = tlpf.LPFContext(P8, device="cpu")
    with pytest.raises(tlpf.LPFFatalError) as te:
        ctx.compile_loop(lambda c2, c: c, torch.zeros(P8, 1), **kw)
    assert str(te.value).split(":")[0] == str(je.value).split(":")[0]
    assert not ctx.ledger.records
