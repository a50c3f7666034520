"""The rest of ``tests/test_lpf_core.py`` on the port: the twelve
primitives' semantics, each SPMD function run through both packages'
``exec_`` on the same inputs (the JAX package on 8 host devices, the
port over 8 virtual processes on the CPU), with values and ledgers
compared exactly (the compressed superstep to its int8 wire's bar), and
the same errors raised.

``B`` is the array backend an SPMD body builds its slot values with, so
one body serves both packages: in JAX a process's value is its own
array and ``pid`` a scalar; in the port values are stacked ``[p, ...]``
and ``pid`` is ``[p, 1]``, so the same expression broadcasts to every
process's row.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import core as jlpf
from repro.bsp import pad_to as jpad_to
from repro.core import machine as jmachine
from repro_torch import core as tlpf
from repro_torch.bsp import pad_to as tpad_to
from repro_torch.interop import hardware_from_fields

P8 = 8


def _tpu_vp():
    """TPU v5e as a port hardware model whose ``"vp"`` link is its
    ``"ici"`` link: the machine the JAX package's default ``exec_`` probes
    over one ``"x"`` axis."""
    hw = hardware_from_fields(dataclasses.asdict(jmachine.TPU_V5E))
    return dataclasses.replace(hw, links={**hw.links,
                                          "vp": hw.links["ici"]})


class JB:
    """The JAX package's backend: per-process values."""
    jax = True

    @staticmethod
    def pid(ctx):
        return ctx.pid.astype(jnp.float32)

    @staticmethod
    def arange(ctx, a, b=None):
        return jnp.arange(float(a)) if b is None else \
            jnp.arange(float(a), float(b))

    @staticmethod
    def full(ctx, n, v):
        return jnp.full(n, float(v))

    @staticmethod
    def zeros(ctx, n):
        return jnp.zeros(n)

    @staticmethod
    def linspace(ctx, a, b, n):
        return jnp.linspace(a, b, n)

    @staticmethod
    def code(ctx, v):
        return jnp.full((1,), v, jnp.int32)


class TB:
    """The port's backend: values stacked over the process axis."""
    jax = False

    @staticmethod
    def pid(ctx):
        return ctx.pid.to(torch.float32)

    @staticmethod
    def arange(ctx, a, b=None):
        t = torch.arange(float(a)) if b is None else \
            torch.arange(float(a), float(b))
        return ctx.replicate(t)

    @staticmethod
    def full(ctx, n, v):
        return ctx.replicate(torch.full((n,), float(v)))

    @staticmethod
    def zeros(ctx, n):
        return ctx.replicate(torch.zeros(n))

    @staticmethod
    def linspace(ctx, a, b, n):
        # the JAX package's f32 linspace, bit for bit
        return ctx.replicate(torch.from_numpy(
            np.array(jnp.linspace(a, b, n))))

    @staticmethod
    def code(ctx, v):
        return ctx.replicate(torch.full((1,), v, dtype=torch.int32))


def run_both(mesh8, body):
    """``body(B, ctx, p)`` through both packages' ``exec_``; returns
    (jax values ``[8, n]``, port values ``[8, n]``, jax ledger, port
    ledger) as numpy arrays and field dicts."""
    jout, jled = jlpf.exec_(mesh8, lambda ctx, s, p, _: body(JB, ctx, p),
                            None, out_specs=P("x"), return_ledger=True)
    tout, tled = tlpf.exec_(P8, lambda ctx, s, p, _: body(TB, ctx, p),
                            None, device="cpu", hardware=_tpu_vp(),
                            return_ledger=True)
    jv = np.asarray(jout).reshape(P8, -1)
    tv = tout.cpu().numpy().reshape(P8, -1)
    return (jv, tv, [dataclasses.asdict(r) for r in jled.records],
            [dataclasses.asdict(r) for r in tled.records])


def assert_same(mesh8, body):
    jv, tv, jl, tl = run_both(mesh8, body)
    assert tv.dtype == jv.dtype and tv.shape == jv.shape
    np.testing.assert_array_equal(tv, jv)
    assert tl == jl
    return tv, tl


def raises_in_both(mesh8, body, exc_j, exc_t):
    with pytest.raises(exc_j):
        jlpf.exec_(mesh8, lambda ctx, s, p, _: body(JB, ctx, p), None,
                   out_specs=P("x"))
    with pytest.raises(exc_t):
        tlpf.exec_(P8, lambda ctx, s, p, _: body(TB, ctx, p), None,
                   device="cpu")


# ---------------------------------------------------------------------------
# put / get / sync
# ---------------------------------------------------------------------------

def test_put_shift(mesh8):
    def body(B, ctx, p):
        ctx.resize_memory_register(2)
        ctx.resize_message_queue(p)
        src = ctx.register_global("src", B.arange(ctx, 4) + 10.0 * B.pid(ctx))
        dst = ctx.register_global("dst", B.zeros(ctx, 4))
        ctx.put(src, dst, to=lambda s: (s + 1) % p, size=4)
        ctx.sync()
        return ctx.tensor(dst)

    out, _ = assert_same(mesh8, body)
    want = np.stack([np.arange(4.0) + 10.0 * ((i - 1) % 8)
                     for i in range(8)])
    np.testing.assert_allclose(out, want)


def test_get_neighbour(mesh8):
    def body(B, ctx, p):
        ctx.resize_memory_register(2)
        ctx.resize_message_queue(p)
        src = ctx.register_global("src", B.full(ctx, 3, 1.0) * B.pid(ctx))
        dst = ctx.register_global("dst", B.zeros(ctx, 3))
        ctx.get(src, dst, frm=lambda s: (s + 2) % p, size=3)
        ctx.sync()
        return ctx.tensor(dst)

    out, _ = assert_same(mesh8, body)
    np.testing.assert_allclose(
        out, np.stack([np.full(3, (i + 2) % 8.0) for i in range(8)]))


def test_offsets_and_partial_sizes(mesh8):
    def body(B, ctx, p):
        ctx.resize_memory_register(2)
        ctx.resize_message_queue(p)
        src = ctx.register_global("src", B.arange(ctx, 8)
                                  + 100.0 * B.pid(ctx))
        dst = ctx.register_global("dst", B.full(ctx, 8, -1.0))
        ctx.put(src, dst, to=lambda s: (s + 1) % p, src_off=2, dst_off=1,
                size=3)
        ctx.sync()
        return ctx.tensor(dst)

    out, _ = assert_same(mesh8, body)
    for i in range(8):
        want = np.full(8, -1.0)
        want[1:4] = np.arange(2.0, 5.0) + 100.0 * ((i - 1) % 8)
        np.testing.assert_allclose(out[i], want)


def test_crcw_highest_pid_wins(mesh8):
    def body(B, ctx, p):
        ctx.resize_memory_register(2)
        ctx.resize_message_queue(p)
        mine = ctx.register_global("m", B.full(ctx, 2, 1.0) * B.pid(ctx))
        tgt = ctx.register_global("t", B.full(ctx, 2, -1.0))
        ctx.put(mine, tgt, to=0, size=2)
        ctx.sync()
        return ctx.tensor(tgt)

    out, _ = assert_same(mesh8, body)
    assert out[0, 0] == 7.0               # arbitrary-CRCW: last writer wins
    assert (out[1:] == -1.0).all()        # non-targets untouched


def test_reads_observe_pre_sync_values(mesh8):
    def body(B, ctx, p):
        ctx.resize_memory_register(1)
        ctx.resize_message_queue(p)
        buf = ctx.register_global("b", B.full(ctx, 2, 1.0) * B.pid(ctx))
        ctx.put(buf, buf, to=lambda s: (s + 1) % p, size=2)
        ctx.sync()
        return ctx.tensor(buf)

    out, _ = assert_same(mesh8, body)
    np.testing.assert_allclose(out[:, 0], [(i - 1) % 8 for i in range(8)])


# ---------------------------------------------------------------------------
# methods: bruck / valiant / fused equivalence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["direct", "bruck"])
def test_methods_agree_on_permutation(mesh8, method):
    def body(B, ctx, p):
        ctx.resize_memory_register(2)
        ctx.resize_message_queue(p)
        src = ctx.register_global("src", B.arange(ctx, 4) + 10.0 * B.pid(ctx))
        dst = ctx.register_global("dst", B.zeros(ctx, 4))
        ctx.put(src, dst, to=lambda s: (s * 3 + 1) % p, size=4)
        attrs = (jlpf if B.jax else tlpf).SyncAttributes(method=method)
        ctx.sync(attrs)
        return ctx.tensor(dst)

    out, led = assert_same(mesh8, body)
    inv = {(3 * s + 1) % 8: s for s in range(8)}
    want = np.stack([np.arange(4.0) + 10.0 * inv[i] for i in range(8)])
    np.testing.assert_allclose(out, want)
    assert led[0]["method"] == method


def test_valiant_routing(mesh8):
    def body(B, ctx, p):
        ctx.resize_memory_register(3)
        ctx.resize_message_queue(4 * p, valiant_payload=64)
        src = ctx.register_global("src", B.arange(ctx, 4) + 10.0 * B.pid(ctx))
        dst = ctx.register_global("dst", B.zeros(ctx, 4))
        ctx.put(src, dst, to=lambda s: (s + 5) % p, size=4)
        ctx.sync((jlpf if B.jax else tlpf).SyncAttributes(method="valiant"))
        return ctx.tensor(dst)

    out, led = assert_same(mesh8, body)
    want = np.stack([np.arange(4.0) + 10.0 * ((i - 5) % 8)
                     for i in range(8)])
    np.testing.assert_allclose(out, want)
    assert led[0]["method"] == "valiant"


def test_fused_total_exchange_detection(mesh8):
    def body(B, ctx, p):
        w = 2
        ctx.resize_memory_register(2)
        ctx.resize_message_queue(p * p)
        src = ctx.register_global("src", B.arange(ctx, p * w)
                                  + 100.0 * B.pid(ctx))
        dst = ctx.register_global("dst", B.zeros(ctx, p * w))
        ctx.put_msgs([(s_, d, src, d * w, dst, s_ * w, w)
                      for s_ in range(p) for d in range(p)])
        ctx.sync(label="a2a")
        return ctx.tensor(dst)

    out, led = assert_same(mesh8, body)
    assert led[0]["method"] == "fused" and led[0]["rounds"] == 1
    want = np.stack([np.concatenate(
        [np.arange(d * 2, d * 2 + 2) + 100.0 * s for s in range(8)])
        for d in range(8)])
    np.testing.assert_allclose(out, want)


# ---------------------------------------------------------------------------
# capacity / errors (mitigable before side effects)
# ---------------------------------------------------------------------------

def test_queue_capacity_mitigable(mesh8):
    def body(B, ctx, p):
        ctx.resize_memory_register(2)
        ctx.resize_message_queue(2)          # deliberately too small
        src = ctx.register_global("src", B.zeros(ctx, 4))
        dst = ctx.register_global("dst", B.zeros(ctx, 4))
        err = jlpf.LPFCapacityError if B.jax else tlpf.LPFCapacityError
        try:
            ctx.put(src, dst, to=lambda s: (s + 1) % p, size=4)  # p msgs
            code = 0
        except err:
            # mitigate: grow the queue and retry — no side effects happened
            ctx.resize_message_queue(p)
            ctx.put(src, dst, to=lambda s: (s + 1) % p, size=4)
            code = 1
        ctx.sync()
        return B.code(ctx, code)

    out, _ = assert_same(mesh8, body)
    assert (out == 1).all()


def test_register_capacity(mesh8):
    def body(B, ctx, p):
        ctx.resize_memory_register(1)
        ctx.register_global("a", B.zeros(ctx, 2))
        err = jlpf.LPFCapacityError if B.jax else tlpf.LPFCapacityError
        try:
            ctx.register_global("b", B.zeros(ctx, 2))
            return B.code(ctx, 0)
        except err:
            return B.code(ctx, 1)

    out, _ = assert_same(mesh8, body)
    assert (out == 1).all()


def test_oob_message_fatal(mesh8):
    def body(B, ctx, p):
        ctx.resize_memory_register(2)
        ctx.resize_message_queue(p)
        src = ctx.register_global("src", B.zeros(ctx, 4))
        dst = ctx.register_global("dst", B.zeros(ctx, 2))
        ctx.put(src, dst, to=0, size=4)   # dst too small
        ctx.sync()
        return B.zeros(ctx, 1)

    raises_in_both(mesh8, body, jlpf.LPFFatalError, tlpf.LPFFatalError)


def test_local_slot_semantics(mesh8):
    """put FROM a local slot is legal (Algorithm 2's error broadcast);
    put INTO a local slot (remotely referred) is fatal."""
    def ok(B, ctx, p):
        ctx.resize_memory_register(2)
        ctx.resize_message_queue(p)
        src = ctx.register_local("src", B.full(ctx, 4, 1.0) * B.pid(ctx))
        dst = ctx.register_global("dst", B.zeros(ctx, 4))
        ctx.put(src, dst, to=lambda s: (s + 1) % p, size=4)
        ctx.sync()
        return ctx.tensor(dst)

    out, _ = assert_same(mesh8, ok)
    np.testing.assert_allclose(out[:, 0], [(i - 1) % 8 for i in range(8)])

    def bad(B, ctx, p):
        ctx.resize_memory_register(2)
        ctx.resize_message_queue(p)
        src = ctx.register_global("src", B.zeros(ctx, 4))
        dst = ctx.register_local("dst", B.zeros(ctx, 4))
        ctx.put(src, dst, to=lambda s: (s + 1) % p, size=4)
        ctx.sync()
        return B.zeros(ctx, 1)

    raises_in_both(mesh8, bad, jlpf.LPFFatalError, tlpf.LPFFatalError)


# ---------------------------------------------------------------------------
# probe / ledger / compliance accounting
# ---------------------------------------------------------------------------

def test_probe_table():
    hw = hardware_from_fields(dataclasses.asdict(jmachine.TPU_V5E))
    for axes in ({"data": 16, "model": 16}, {"pod": 2, "data": 16,
                                              "model": 16}):
        t, j = tlpf.probe(axes, hw), jlpf.probe(axes, jlpf.TPU_V5E)
        assert (t.p, t.g, t.l, t.r) == (j.p, j.g, j.l, j.r)
    m = tlpf.probe({"data": 16, "model": 16}, hw)
    assert m.p == 256 and m.g > 0 and m.l > 0
    assert m.t_comm(1e6) > m.t_comm(0)
    m2 = tlpf.probe({"pod": 2, "data": 16, "model": 16}, hw)
    assert m2.g > m.g * 0.9   # DCN-dominated g is never better than ICI


def test_ledger_h_relation(mesh8):
    def body(B, ctx, p):
        ctx.resize_memory_register(2)
        ctx.resize_message_queue(p)
        src = ctx.register_global("src", B.zeros(ctx, 10))
        dst = ctx.register_global("dst", B.zeros(ctx, 10))
        ctx.put(src, dst, to=lambda s: (s + 1) % p, size=10)
        ctx.sync(label="shift10")
        return ctx.tensor(dst)

    _, led = assert_same(mesh8, body)
    (rec,) = led
    assert rec["h_bytes"] == 10 * 4      # 10 f32 sent == received per pid
    assert rec["n_msgs"] == 8 and rec["rounds"] == 1


def test_compressed_sync_wire_bytes(mesh8):
    def body(B, ctx, p):
        ctx.resize_memory_register(2)
        ctx.resize_message_queue(p)
        src = ctx.register_global("src", B.linspace(ctx, -1, 1, 16))
        dst = ctx.register_global("dst", B.zeros(ctx, 16))
        ctx.put(src, dst, to=lambda s: (s + 1) % p, size=16)
        mod = jlpf if B.jax else tlpf
        ctx.sync(mod.SyncAttributes(compress=mod.CompressSpec(bits=8)))
        return ctx.tensor(dst)

    jv, tv, jl, tl = run_both(mesh8, body)
    assert tl == jl
    # the int8 wire: the same codes, dequantised within one f32 ulp of 1
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tv[0], np.linspace(-1, 1, 16), atol=0.02)
    assert tl[0]["wire_bytes"] < tl[0]["h_bytes"] / 2


def test_rehook_pristine_context(mesh8):
    def sub(B):
        def spmd(ctx, s, p, args):
            ctx.resize_memory_register(1)
            ctx.resize_message_queue(p)
            src = ctx.register_global("v", B.full(ctx, 1, 1.0) * B.pid(ctx))
            ctx.put(src, src, to=lambda s: (s + 1) % p, size=1)
            ctx.sync()
            return ctx.tensor(src)
        return spmd

    def body(B, ctx, p):
        ctx.resize_memory_register(1)
        ctx.register_global("outer", B.zeros(ctx, 1))
        inner = (jlpf if B.jax else tlpf).rehook(ctx, sub(B))
        assert ctx.registry.n_active == 1  # outer context untouched
        return inner

    out, _ = assert_same(mesh8, body)
    np.testing.assert_allclose(out.reshape(-1),
                               [(i - 1) % 8 for i in range(8)])


def test_valiant_scratch_resize_does_not_leak_slots():
    """Re-provisioning the Valiant scratch replaces the old slot, in both
    packages, instead of leaking a registration per call."""
    jctx = jlpf.LPFContext(())
    tctx = tlpf.LPFContext(P8, device="cpu")
    for ctx, zeros in ((jctx, lambda: jnp.zeros(4)),
                       (tctx, lambda: tctx.replicate(torch.zeros(4)))):
        ctx.resize_message_queue(4, valiant_payload=32)
        baseline = ctx.registry.n_active
        for _ in range(5):
            ctx.resize_message_queue(4, valiant_payload=64)
        assert ctx.registry.n_active == baseline
        assert ctx._scratch is not None and ctx._scratch.size == 64
        ctx.resize_memory_register(1)
        slot = ctx.register_global("user", zeros())
        ctx.resize_message_queue(4, valiant_payload=16)
        assert tuple(ctx.registry.value(slot).shape)[-1] == 4
    assert jctx.registry.n_active == tctx.registry.n_active


def test_pad_to_validation():
    """``pad_to`` pads each process's row as the JAX package pads one
    process's vector, and refuses what it refuses."""
    x = np.arange(8.0, dtype=np.float32).reshape(2, 4)
    padded = tpad_to(torch.from_numpy(x), 6)
    for i in range(2):
        np.testing.assert_array_equal(padded[i].numpy(),
                                      np.asarray(jpad_to(jnp.asarray(x[i]),
                                                         6)))
    t = torch.from_numpy(x)
    assert tpad_to(t, 4) is t
    with pytest.raises(tlpf.LPFFatalError):       # cannot shrink
        tpad_to(t, 3)
    with pytest.raises(jlpf.LPFFatalError):
        jpad_to(jnp.asarray(x[0]), 3)
    with pytest.raises(tlpf.LPFFatalError):       # stacked [p, w] only
        tpad_to(torch.zeros(8), 8)


@pytest.mark.parametrize("chain", [False, True])
def test_sequential_root_context(chain):
    """p = 1: puts are memcpys; chained puts in one superstep (a->b,
    b->c) deliver b's PRE-superstep contents, in both packages."""
    jctx = jlpf.LPFContext(())
    tctx = tlpf.LPFContext(1, device="cpu")
    outs = []
    for ctx, arr in ((jctx, lambda v: jnp.asarray(v, jnp.float32)),
                     (tctx, lambda v: torch.tensor(
                         np.asarray(v, np.float32))[None])):
        ctx.resize_memory_register(3)
        ctx.resize_message_queue(4)
        a = ctx.register_global("a", arr(np.arange(1.0, 5.0)))
        b = ctx.register_global("b", arr(np.full(4, 7.0)))
        c = ctx.register_global("c", arr(np.zeros(4)))
        ctx.put(a, b, to=0, size=4)
        if chain:
            ctx.put(b, c, to=0, size=4)
        ctx.sync()
        outs.append([np.asarray(ctx.tensor(s)).reshape(-1)
                     for s in (a, b, c)])
    for j, t in zip(*outs):
        np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(outs[1][1], np.arange(1.0, 5.0))
    np.testing.assert_array_equal(outs[1][2], 7.0 if chain else 0.0)
