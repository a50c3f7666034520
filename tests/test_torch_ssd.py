"""Parity of the port's SSD scan with the JAX reference on the CPU.

* ``ssd_scan_plain`` (what ``ops.ssd`` runs for a CPU tensor, and what
  ``chip_smoke.py`` holds the CUDA kernel against on the card) against the
  JAX kernel ``ssd_scan`` in Pallas interpret mode, y and the final state,
  at the JAX kernel tests' sweep (``tests/test_kernels.py``) and their bar:
  max |port - jax| / max |jax| below 1e-4;
* ``ssd_ref`` / ``ssd_step`` against the JAX oracle (1e-5);
* chunk invariance, and the ragged tail (S 200, chunk 64) against the JAX
  oracle;
* ``ops.ssd`` gradients against ``jax.vjp`` of the JAX ``ops.ssd`` (5e-4,
  the reference's gradient bar), also at a ragged S against the JAX
  oracle's VJP, and a check that the backward runs the chunked plain
  version and never the sequential oracle;
* the dispatch and the CUDA wrapper's refusals and grid plan, and a
  planted fault that shows the 1e-4 bar has teeth;
* ``ssd_scan_passes`` (the CUDA kernel's chunk-parallel passes) against
  the JAX kernel on the sweep (1e-4), at a ragged S against the JAX
  oracle, and its entering states against the oracle's state at each
  chunk boundary; the same passes with every product split into three
  TF32 products (``split_tf32_mm``, as the kernel's tensor cores take
  them) within 1e-4 of the JAX kernel, where one TF32 product misses; the
  same split into bf16 parts (``split_bf16_mm``, the arithmetic the
  bound of ``chip_smoke.py`` assumes) within 1e-4 too, for f32 and bf16
  inputs, where one bf16 product misses.

The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.kernel import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_scan.ops import ssd as jax_ssd
from repro.kernels.ssd_scan.ref import ssd_ref as jax_ssd_ref
from repro.kernels.ssd_scan.ref import ssd_step as jax_ssd_step
from repro_torch.core import LPFFatalError
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref

# B, S, H, P, G, N, chunk (the JAX kernel tests' sweep)
SSD_SWEEP = [
    (1, 64, 2, 16, 1, 16, 16),
    (2, 128, 4, 32, 2, 32, 32),
    (1, 256, 2, 16, 1, 64, 64),
    (1, 128, 4, 16, 1, 16, 128),    # chunk == S
]
BAR = 1e-4


def inputs(seed, B, S, H, P, G, N):
    """x, dt, a, b, c as the JAX kernel tests draw them."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, P)).astype(np.float32),
            rng.uniform(0.001, 0.1, (B, S, H)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (H,)).astype(np.float32),
            rng.standard_normal((B, S, G, N)).astype(np.float32),
            rng.standard_normal((B, S, G, N)).astype(np.float32))


def rel(a, ref):
    a = np.asarray(a, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(a - ref).max() / (np.abs(ref).max() + 1e-9))


def torch_args(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", SSD_SWEEP)
def test_plain_version_matches_jax_kernel(B, S, H, P, G, N, chunk):
    arrays = inputs(S + N + chunk, B, S, H, P, G, N)
    want_y, want_st = jax_ssd_scan(*map(jnp.asarray, arrays), chunk=chunk,
                                   interpret=True)
    y, st = ssd_ref.ssd_scan_plain(*torch_args(arrays), chunk=chunk)
    assert y.shape == (B, S, H, P) and y.dtype == torch.float32
    assert st.shape == (B, H, N, P) and st.dtype == torch.float32
    assert rel(y, want_y) < BAR
    assert rel(st, want_st) < BAR


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", SSD_SWEEP)
def test_oracle_matches_jax(B, S, H, P, G, N, chunk):
    arrays = inputs(S + N, B, S, H, P, G, N)
    want_y, want_st = jax_ssd_ref(*map(jnp.asarray, arrays))
    y, st = ssd_ref.ssd_ref(*torch_args(arrays))
    assert rel(y, want_y) < 1e-5
    assert rel(st, want_st) < 1e-5


def test_step_matches_jax():
    x, dt, a, b, c = inputs(3, 1, 1, 4, 16, 2, 8)
    state = np.random.default_rng(4).standard_normal(
        (4, 8, 16)).astype(np.float32)
    args = (state, x[0, 0], dt[0, 0], a, b[0, 0], c[0, 0])
    want_st, want_y = jax_ssd_step(*map(jnp.asarray, args))
    st, y = ssd_ref.ssd_step(*torch_args(args))
    assert rel(st, want_st) < 1e-5
    assert rel(y, want_y) < 1e-5


def test_chunk_invariance():
    """The chunk length is an implementation detail: results agree."""
    args = torch_args(inputs(7, 1, 128, 2, 16, 1, 32))
    y16, st16 = ssd_ref.ssd_scan_plain(*args, chunk=16)
    y64, st64 = ssd_ref.ssd_scan_plain(*args, chunk=64)
    assert (y16 - y64).abs().max().item() < BAR
    assert rel(st16, st64) < BAR


def test_ragged_tail_matches_jax_oracle():
    """S 200 with chunk 64: the last chunk holds 8 rows.  The plain
    version masks the tail (x = 0, dt = 0 past S) and agrees with the JAX
    oracle.  It is held against the oracle and not the JAX kernel: the
    TPU kernel's grid is cdiv(S, L) with no mask, so it reads past the end
    there (ROADMAP C)."""
    arrays = inputs(8, 2, 200, 2, 16, 1, 16)
    want_y, want_st = jax_ssd_ref(*map(jnp.asarray, arrays))
    y, st = ssd_ref.ssd_scan_plain(*torch_args(arrays), chunk=64)
    assert y.shape == (2, 200, 2, 16)
    assert rel(y, want_y) < BAR
    assert rel(st, want_st) < BAR


def test_bf16_inputs_keep_f32_arithmetic():
    """bf16 x, b, c: y comes back in bf16, the state in f32, both from f32
    arithmetic (the kernel's contract; the CPU path is its plain
    version)."""
    x, dt, a, b, c = torch_args(inputs(9, 1, 96, 2, 16, 1, 16))
    xb, bb, cb = (t.to(torch.bfloat16) for t in (x, b, c))
    y, st = ssd_ref.ssd_scan_plain(xb, dt, a, bb, cb, chunk=32)
    y32, st32 = ssd_ref.ssd_scan_plain(xb.float(), dt, a, bb.float(),
                                       cb.float(), chunk=32)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    assert torch.equal(y, y32.to(torch.bfloat16))
    assert torch.equal(st, st32)


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (1, 64, 2, 16, 1, 16, 16),
    (2, 48, 4, 16, 2, 8, 16),
])
def test_gradients_match_jax(B, S, H, P, G, N, chunk):
    """ops.ssd's backward (autograd of the chunked plain version) against
    jax.vjp of the JAX custom_vjp (the oracle's VJP), for a random
    cotangent."""
    arrays = inputs(11, B, S, H, P, G, N)
    dy = np.random.default_rng(12).standard_normal(
        (B, S, H, P)).astype(np.float32)
    _, vjp = jax.vjp(lambda *ops: jax_ssd(*ops, chunk=chunk,
                                          interpret=True),
                     *map(jnp.asarray, arrays))
    want = vjp(jnp.asarray(dy))
    args = [t.requires_grad_() for t in torch_args(arrays)]
    y = ssd_ops.ssd(*args, chunk=chunk)
    got = torch.autograd.grad(y, args, torch.from_numpy(dy))
    for name, g, w in zip(("x", "dt", "a", "b", "c"), got, want):
        assert g.shape == w.shape, name
        assert rel(g, w) < 5e-4, name


@pytest.mark.parametrize("S,chunk", [(200, 64), (72, 32)])
def test_gradients_match_jax_at_ragged_s(S, chunk):
    """At an S that is not a multiple of the chunk, ops.ssd's backward (the
    chunked plain version, its tail masked) against jax.vjp of the JAX
    oracle at 5e-4.  The oracle and not the JAX kernel's custom_vjp: the
    TPU kernel's forward reads past the end there (ROADMAP C)."""
    arrays = inputs(21 + S, 2, S, 4, 16, 2, 16)
    dy = np.random.default_rng(22).standard_normal(
        (2, S, 4, 16)).astype(np.float32)
    _, vjp = jax.vjp(lambda *ops: jax_ssd_ref(*ops)[0],
                     *map(jnp.asarray, arrays))
    want = vjp(jnp.asarray(dy))
    args = [t.requires_grad_() for t in torch_args(arrays)]
    y = ssd_ops.ssd(*args, chunk=chunk)
    got = torch.autograd.grad(y, args, torch.from_numpy(dy))
    for name, g, w in zip(("x", "dt", "a", "b", "c"), got, want):
        assert g.shape == w.shape, name
        assert rel(g, w) < 5e-4, name


def test_backward_does_not_run_the_oracle(monkeypatch):
    """The backward differentiates ssd_scan_plain at the forward's chunk:
    with ssd_ref patched to raise, forward and backward still run, and
    they call the plain version twice (forward, then the recomputation the
    backward differentiates), the second time with the same chunk."""
    def refuse(*args, **kwargs):
        raise AssertionError("ops.ssd reached the sequential oracle")

    calls = []
    plain = ssd_ref.ssd_scan_plain

    def spy(*args, chunk=128):
        calls.append(chunk)
        return plain(*args, chunk=chunk)

    monkeypatch.setattr(ssd_ref, "ssd_ref", refuse)
    monkeypatch.setattr(ssd_ref, "ssd_scan_plain", spy)
    args = [t.requires_grad_()
            for t in torch_args(inputs(23, 1, 80, 2, 16, 1, 16))]
    y = ssd_ops.ssd(*args, chunk=32)
    grads = torch.autograd.grad(y.square().sum(), args)
    assert calls == [32, 32]
    assert all(torch.isfinite(g).all() for g in grads)


def test_cpu_tensor_takes_the_plain_version():
    args = torch_args(inputs(13, 1, 64, 2, 16, 1, 16))
    before = ssd_kernel.ssd_scan.launches
    y = ssd_ops.ssd(*args, chunk=16)
    assert ssd_kernel.ssd_scan.launches == before
    want, _ = ssd_ref.ssd_scan_plain(*args, chunk=16)
    assert torch.equal(y, want)


def test_kernel_wrapper_refuses_what_it_does_not_take():
    """Every refusal but the device shows without a card; a CPU tensor is
    refused last, never handed to the plain version."""
    x, dt, a, b, c = torch_args(inputs(14, 1, 64, 2, 16, 1, 16))
    with pytest.raises(LPFFatalError, match="CUDA tensors"):
        ssd_kernel.ssd_scan(x, dt, a, b, c)
    with pytest.raises(LPFFatalError, match="float32 or bfloat16"):
        ssd_kernel.ssd_scan(x.half(), dt, a, b.half(), c.half())
    with pytest.raises(LPFFatalError, match="one dtype"):
        ssd_kernel.ssd_scan(x, dt, a, b.to(torch.bfloat16), c)
    with pytest.raises(LPFFatalError, match="float32 dt"):
        ssd_kernel.ssd_scan(x, dt.double(), a, b, c)
    with pytest.raises(LPFFatalError, match="unit stride"):
        ssd_kernel.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3),
                            dt, a, b, c)
    with pytest.raises(LPFFatalError, match="1 to 128"):
        ssd_kernel.ssd_scan(*torch_args(inputs(15, 1, 256, 2, 16, 1, 16)),
                            chunk=256)
    with pytest.raises(LPFFatalError, match="multiple of 4 up to 128"):
        ssd_kernel.ssd_scan(*torch_args(inputs(16, 1, 64, 2, 16, 1, 136)))
    with pytest.raises(LPFFatalError, match="multiple of 16"):
        ssd_kernel.ssd_scan(*torch_args(inputs(17, 1, 64, 2, 24, 1, 16)))
    with pytest.raises(LPFFatalError, match="G dividing H"):
        ssd_kernel.ssd_scan(*torch_args(inputs(18, 1, 64, 3, 16, 2, 16)))


def test_grid_plan_fills_the_card():
    """Passes A and C take one block per (b, chunk, head, 64 columns of P):
    1,536 blocks at the prefill's main shape (96 before the passes) and
    3,072 at B 1 x S 16384; C B^T takes one block per (b, chunk, group,
    pair of row tiles q and Lp/16 - 1 - q)."""
    plan = ssd_kernel.grid_plan(4, 2048, 24, 64, 1, 128, 128)
    assert (plan.L, plan.Lp, plan.Np, plan.nc, plan.p_slices) == (
        128, 128, 128, 16, 1)
    assert plan.blocks == {"ssd_cb": 256, "ssd_chunk_state": 1536,
                           "ssd_state_pass": 768, "ssd_chunk_scan": 1536}
    # cum, cb and the states: 12.6 MB of states, 4.2 MB of cb
    assert plan.scratch_bytes == 4 * (4 * 24 * 16 * 128
                                      + 4 * 16 * 128 * 128
                                      + 4 * 16 * 24 * 128 * 64)
    long = ssd_kernel.grid_plan(1, 16384, 24, 64, 1, 128, 128)
    assert long.blocks["ssd_chunk_scan"] == 3072 and long.nc == 128
    # padding: L 77 to 80 rows, N 20 to 32, P 128 in two slices of 64
    odd = ssd_kernel.grid_plan(2, 77, 4, 128, 2, 20, 128)
    assert (odd.Lp, odd.Np, odd.nc, odd.p_slices) == (80, 32, 1, 2)
    assert odd.blocks["ssd_chunk_scan"] == 2 * 1 * 4 * 2
    assert odd.blocks["ssd_cb"] == 2 * 1 * 2 * 3     # row-tile pairs
    assert ssd_kernel.PASSES == ("ssd_cb", "ssd_chunk_state",
                                 "ssd_state_pass", "ssd_chunk_scan")


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", SSD_SWEEP)
def test_passes_match_jax_kernel(B, S, H, P, G, N, chunk):
    """The kernel's passes compute the TPU kernel's function."""
    arrays = inputs(S + N + chunk, B, S, H, P, G, N)
    want_y, want_st = jax_ssd_scan(*map(jnp.asarray, arrays), chunk=chunk,
                                   interpret=True)
    got = ssd_ref.ssd_scan_passes(*torch_args(arrays), chunk=chunk)
    L = min(chunk, S)
    assert got.y.shape == (B, S, H, P) and got.y.dtype == torch.float32
    assert got.cum.shape == (B, H, S // L, L)
    assert got.cb.shape == (B, S // L, G, L, L)
    assert got.states.shape == (B, S // L, H, N, P)
    assert rel(got.y, want_y) < BAR
    assert rel(got.final_state, want_st) < BAR


def test_passes_at_ragged_s_match_jax_oracle():
    arrays = inputs(24, 2, 200, 4, 16, 2, 16)
    want_y, want_st = jax_ssd_ref(*map(jnp.asarray, arrays))
    got = ssd_ref.ssd_scan_passes(*torch_args(arrays), chunk=64)
    assert got.y.shape == (2, 200, 4, 16)
    assert rel(got.y, want_y) < BAR
    assert rel(got.final_state, want_st) < BAR


@pytest.mark.parametrize("S,chunk", [(128, 32), (200, 64)])
def test_passes_entering_states_match_oracle(S, chunk):
    """Pass B's output, the state entering chunk k, is the sequential
    oracle's state after the first k L positions; its cb is C B^T on and
    below the diagonal and zero above."""
    arrays = inputs(25 + S, 1, S, 4, 16, 2, 16)
    got = ssd_ref.ssd_scan_passes(*torch_args(arrays), chunk=chunk)
    assert not got.states[:, 0].any()
    for k in range(1, got.states.shape[1]):
        _, want = jax_ssd_ref(*(jnp.asarray(a[:, :k * chunk]) if a.ndim > 1
                                else jnp.asarray(a) for a in arrays))
        assert rel(got.states[:, k], want) < BAR, k
    b, c = torch_args(arrays[3:])
    cb = torch.einsum("bign,bjgn->bgij", c[:, :chunk], b[:, :chunk])
    assert torch.allclose(got.cb[:, 0], cb.tril(), atol=1e-5)


def test_tf32_round_is_round_to_nearest_ties_away():
    """cvt.rna.tf32.f32 keeps 10 mantissa bits, rounding ties away from
    zero; the low 13 bits of the result are 0."""
    ulp = 2.0 ** -10
    v = torch.tensor([1.0, 1 + ulp / 2, 1 + 3 * ulp / 2, -(1 + ulp / 2),
                      1 + ulp / 4, 1 + 3 * ulp / 4, -7.5])
    want = torch.tensor([1.0, 1 + ulp, 1 + 2 * ulp, -(1 + ulp), 1.0,
                         1 + ulp, -7.5])
    got = ssd_ref.tf32_round(v)
    assert torch.equal(got, want)
    rng = np.random.default_rng(26)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    hi = ssd_ref.tf32_round(x)
    lo = ssd_ref.tf32_round(x - hi)
    assert (hi.view(torch.int32) & 0x1FFF == 0).all()
    assert ((x - hi).abs() <= x.abs() * 2.0 ** -11).all()
    assert ((x - hi - lo).abs() <= x.abs() * 2.0 ** -21).all()


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", SSD_SWEEP + [
    (1, 2048, 1, 64, 1, 128, 128)])
def test_split_tf32_passes_hold_the_bar(B, S, H, P, G, N, chunk):
    """The kernel's products split into three TF32 products each hold the
    1e-4 bar against the JAX kernel: on the sweep, and on one (b, h) of
    the prefill's main shape (S 2048, N 128, P 64), where one TF32
    product a pair misses it (about 4e-4), which shows the bar's teeth."""
    arrays = inputs(27 + S, B, S, H, P, G, N)
    want_y, want_st = jax_ssd_scan(*map(jnp.asarray, arrays), chunk=chunk,
                                   interpret=True)
    split3 = ssd_ref.ssd_scan_passes(
        *torch_args(arrays), chunk=chunk,
        mm=functools.partial(ssd_ref.split_tf32_mm, products=3))
    assert rel(split3.y, want_y) < BAR
    assert rel(split3.final_state, want_st) < BAR
    if S == 2048:
        one = ssd_ref.ssd_scan_passes(
            *torch_args(arrays), chunk=chunk,
            mm=functools.partial(ssd_ref.split_tf32_mm, products=1))
        assert rel(one.y, want_y) > 2 * BAR
        assert rel(split3.y, want_y) < BAR / 50


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", SSD_SWEEP + [
    (1, 2048, 1, 64, 1, 128, 128)])
@pytest.mark.parametrize("bf16_inputs", [False, True])
def test_split_bf16_passes_hold_the_bar(B, S, H, P, G, N, chunk,
                                        bf16_inputs):
    """Every product split into bf16 parts (three bf16 products for two
    f32 operands, two where one operand is bf16, one for C B^T of bf16
    inputs) holds the 1e-4 bar against the JAX kernel: the fastest
    arithmetic known to hold it, whose rate ``chip_smoke.py``'s bound
    takes.  On one (b, h) of the prefill's main shape one bf16 product a
    pair misses the bar by far."""
    arrays = list(inputs(28 + S, B, S, H, P, G, N))
    if bf16_inputs:
        for i in (0, 3, 4):
            arrays[i] = np.asarray(torch.from_numpy(arrays[i]).to(
                torch.bfloat16).float())
    want_y, want_st = jax_ssd_scan(*map(jnp.asarray, arrays), chunk=chunk,
                                   interpret=True)
    split3 = ssd_ref.ssd_scan_passes(
        *torch_args(arrays), chunk=chunk,
        mm=functools.partial(ssd_ref.split_bf16_mm, products=3))
    assert rel(split3.y, want_y) < BAR
    assert rel(split3.final_state, want_st) < BAR
    if S == 2048:
        one = ssd_ref.ssd_scan_passes(
            *torch_args(arrays), chunk=chunk,
            mm=functools.partial(ssd_ref.split_bf16_mm, products=1))
        assert rel(one.y, want_y) > 10 * BAR


def test_bar_catches_a_missing_state_decay():
    """The 1e-4 bar has teeth: a copy of the plain version that leaves
    exp(cum_L) out of the carried state misses the JAX kernel by orders of
    magnitude on a sweep shape, where the plain version itself passes."""
    src = inspect.getsource(ssd_ref.ssd_scan_plain)
    decay = "torch.exp(cl)[..., None, None] * state"
    assert src.count(decay) == 1
    scope = dict(vars(ssd_ref))
    exec(src.replace(decay, "state"), scope)
    broken = scope["ssd_scan_plain"]
    arrays = inputs(19, 2, 128, 4, 32, 2, 32)
    want_y, want_st = jax_ssd_scan(*map(jnp.asarray, arrays), chunk=32,
                                   interpret=True)
    y, st = ssd_ref.ssd_scan_plain(*torch_args(arrays), chunk=32)
    y_bad, st_bad = broken(*torch_args(arrays), chunk=32)
    assert rel(y, want_y) < BAR and rel(st, want_st) < BAR
    assert rel(y_bad, want_y) > 100 * BAR
    assert rel(st_bad, want_st) > 100 * BAR
