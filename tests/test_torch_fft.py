"""Parity of the port's FFT path with the JAX reference on the CPU.

* ``fft_stage``: the port's plain PyTorch version (what ``ops.fft`` runs
  for a CPU tensor) against the JAX kernel in Pallas interpret mode and
  ``np.fft``, at the JAX kernel tests' shapes and bars; the CUDA kernel's
  four-step decomposition (``ref.four_step`` over ``kernel.pass_plan``)
  the same way for n = 2^1 ... 2^16, its three-pass algebra at small n,
  and the pass plan against the card's shared memory;
* ``bsp_fft``: the port over p = 8 virtual processes (``device="cpu"``)
  against JAX ``bsp_fft`` on the 8-device CPU mesh, ordered and
  unordered, ``use_kernel`` True and False, forward and inverse — values
  and ledgers field by field, including predicted seconds on one machine;
* complex128: full precision without the kernel, a refusal with it.

The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jlpf
from repro.algorithms import bsp_fft as jax_bsp_fft
from repro.kernels.fft_stage import ops as jax_fft_ops
from repro_torch import core as tlpf
from repro_torch.algorithms import bsp_fft, bsp_fft_spmd, fft_h_bytes
from repro_torch.interop import (cyclic_gather, cyclic_scatter,
                                 hardware_from_fields, unordered_to_natural)
from repro_torch.kernels.fft_stage import kernel as fft_kernel
from repro_torch.kernels.fft_stage import ops as fft_ops
from repro_torch.kernels.fft_stage import ref as fft_ref

#: both ledgers are priced on the reference's machine model
TPU_FIELDS = dataclasses.asdict(jlpf.TPU_V5E)


def cinput(seed, shape, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def rel(a, ref):
    return np.abs(np.asarray(a) - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("batch,n", [(1, 64), (4, 256), (8, 1024),
                                     (3, 4096)])
def test_fft_stage_plain_matches_jax_kernel(batch, n):
    x = cinput(batch * n, (batch, n))
    ref = np.fft.fft(x)
    y = fft_ops.fft(torch.from_numpy(x)).numpy()
    yj = np.asarray(jax_fft_ops.fft(jnp.asarray(x), interpret=True))
    assert y.dtype == np.complex64
    assert rel(y, ref) < 1e-5
    assert rel(y, yj.astype(np.complex128)) < 1e-5
    xi = fft_ops.ifft(torch.from_numpy(ref.astype(np.complex64))).numpy()
    xj = np.asarray(jax_fft_ops.ifft(jnp.asarray(ref), interpret=True))
    assert np.abs(xi - x).max() < 1e-4
    assert np.abs(xi - xj).max() < 1e-4


@pytest.mark.parametrize("bits", range(1, 17))
def test_four_step_matches_jax_kernel(bits):
    """The CUDA kernel's decomposition (``ref.four_step`` over
    ``pass_plan(n)``: one pass up to 2^12, two beyond) against the JAX
    kernel in interpret mode and ``np.fft`` in complex128, at the JAX
    kernel tests' bars."""
    n = 1 << bits
    plan = fft_kernel.pass_plan(n)
    assert len(plan) == (1 if n <= 1 << 12 else 2)
    batch = 2
    x = cinput(bits, (batch, n))
    ref = np.fft.fft(x.astype(np.complex128))
    y = fft_ref.four_step(torch.from_numpy(x), plan).numpy()
    yj = np.asarray(jax_fft_ops.fft(jnp.asarray(x), interpret=True))
    assert y.dtype == np.complex64
    assert rel(y, ref) < 1e-5
    assert rel(y, yj.astype(np.complex128)) < 1e-5
    xi = fft_ref.four_step(torch.from_numpy(ref.astype(np.complex64)), plan,
                           inverse=True).numpy()
    xj = np.asarray(jax_fft_ops.ifft(jnp.asarray(ref), interpret=True))
    assert np.abs(xi - x).max() < 1e-4
    assert np.abs(xi - xj).max() < 1e-4


@pytest.mark.parametrize("bits", range(5, 13))
def test_four_step_three_passes_at_small_n(bits):
    """The same algebra with sub-transforms of at most 16 points, so that
    n = 2^9 ... 2^12 takes three passes (a middle col pass and the row
    pass's digit-reversed store) as n > 2^22 does on the card."""
    n = 1 << bits
    plan = fft_kernel.pass_plan(n, max_t=16)
    assert len(plan) == 1 + (n > fft_kernel.ONE_PASS * 16) + (n > 256)
    x = cinput(bits + 100, (3, n))
    ref = np.fft.fft(x.astype(np.complex128))
    y = fft_ref.four_step(torch.from_numpy(x), plan).numpy()
    assert rel(y, ref) < 1e-5
    xi = fft_ref.four_step(torch.from_numpy(ref.astype(np.complex64)), plan,
                           inverse=True).numpy()
    assert np.abs(xi - x).max() < 1e-4


def test_pass_plan_fits_the_card():
    """Two passes at the main path's 2^21 with C >= 4; no plan from 2^1 to
    2^33 asks a block for more than 227 KB of shared memory, and every
    plan keeps 8192-point tiles, factors whose product is n and, with more
    than one pass, runs of C >= 4."""
    main = fft_kernel.pass_plan(1 << 21)
    assert [(p.kind, p.t) for p in main] == [("col", 1 << 10),
                                             ("row", 1 << 11)]
    for bits in range(1, 34):
        n = 1 << bits
        plan = fft_kernel.pass_plan(n)
        assert len(plan) == 1 + (n > 1 << 12) + (n > 1 << 22)
        assert math.prod(p.t for p in plan) == n
        for p in plan:
            assert p.smem_bytes <= fft_kernel.SMEM_LIMIT
            assert p.c * p.t == fft_kernel.TILE
            assert p.seq == 0 or p.seq >= p.t + p.t // 16
            if len(plan) > 1:
                assert p.c >= 4
    with pytest.raises(tlpf.LPFFatalError, match="power-of-two"):
        fft_kernel.pass_plan(3 << 10)
    with pytest.raises(tlpf.LPFFatalError, match="3 passes"):
        fft_kernel.pass_plan(1 << 34)


def _ledger_rows(ledger):
    return [dataclasses.asdict(r) for r in ledger.records]


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("n", [1 << 10, 1 << 12, 1 << 14])
def test_bsp_fft_matches_jax(mesh8, n, ordered, use_kernel):
    x = cinput(n, n)
    ref = np.fft.fft(x.astype(np.complex128))
    yj, lj = jax_bsp_fft(mesh8, jnp.asarray(x), ordered=ordered,
                         use_kernel=use_kernel, return_ledger=True)
    yt, lt = bsp_fft(torch.from_numpy(x), p=8, ordered=ordered,
                     use_kernel=use_kernel, device="cpu", return_ledger=True)
    yt = yt.numpy()
    assert yt.shape == (n,) and yt.dtype == np.complex64
    assert rel(yt, ref) < 2e-4
    assert rel(yt, np.asarray(yj).astype(np.complex128)) < 2e-4
    assert _ledger_rows(lj) == _ledger_rows(lt)
    assert [(r.label, r.method, r.rounds) for r in lt.records] == \
        [("fft.redistribute", "fused", 1)] + (
            [("fft.reorder", "fused", 1)] if ordered else [])
    assert lt.h_bytes == fft_h_bytes(n, 8, ordered)
    jm = jlpf.probe({"x": 8}, jlpf.TPU_V5E)
    tm = tlpf.probe({"x": 8}, hardware_from_fields(TPU_FIELDS))
    assert [r.predicted_seconds(jm) for r in lj.records] == \
        [r.predicted_seconds(tm) for r in lt.records]


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("n", [1 << 10, 1 << 12, 1 << 14])
def test_bsp_fft_inverse_matches_jax(mesh8, n, use_kernel):
    x = cinput(n + 1, n)
    y = np.fft.fft(x).astype(np.complex64)
    xj, lj = jax_bsp_fft(mesh8, jnp.asarray(y), inverse=True,
                         use_kernel=use_kernel, return_ledger=True)
    xt, lt = bsp_fft(torch.from_numpy(y), p=8, inverse=True,
                     use_kernel=use_kernel, device="cpu", return_ledger=True)
    assert np.abs(xt.numpy() - x).max() < 2e-3
    assert np.abs(xt.numpy() - np.asarray(xj)).max() < 2e-3
    assert _ledger_rows(lj) == _ledger_rows(lt)
    # round trip through the port alone, unordered too
    for ordered in (True, False):
        fwd = bsp_fft(torch.from_numpy(x), p=8, ordered=ordered,
                      use_kernel=use_kernel, device="cpu")
        back = bsp_fft(fwd, p=8, ordered=ordered, use_kernel=use_kernel,
                       inverse=True, device="cpu")
        assert np.abs(back.numpy() - x).max() < 2e-3


def test_spmd_layout_through_interop():
    """The cyclic scatter and the unordered un-shuffle, as plain numpy,
    frame the port's SPMD FFT exactly as the reference's ``bsp_fft`` does."""
    n, p = 1 << 12, 8
    x = cinput(7, n)
    xc = cyclic_scatter(x, p)
    np.testing.assert_array_equal(cyclic_gather(xc), x)
    np.testing.assert_array_equal(xc, x.reshape(n // p, p).T)

    def spmd(ctx, s, pp, xt):
        return bsp_fft_spmd(ctx, xt, n, ordered=False)

    out = tlpf.exec_(p, spmd, torch.from_numpy(xc), device="cpu")
    assert out.shape == (p, n // p)
    y = unordered_to_natural(out.numpy(), p)
    assert rel(y, np.fft.fft(x)) < 2e-4


@pytest.mark.parametrize("ordered", [True, False])
def test_bsp_fft_complex128_h_bytes(ordered):
    n = 1024
    x = cinput(3, n, np.complex128)
    y, ledger = bsp_fft(torch.from_numpy(x), p=8, ordered=ordered,
                        device="cpu", return_ledger=True)
    assert y.dtype == torch.complex128
    assert rel(y.numpy(), np.fft.fft(x)) < 1e-10
    want = fft_h_bytes(n, 8, ordered=ordered, itemsize=16)
    assert ledger.h_bytes == want
    assert want == 2 * fft_h_bytes(n, 8, ordered=ordered, itemsize=8)
    for r in ledger.records:
        assert r.method == "fused" and r.rounds == 1
        assert r.wire_bytes == r.h_bytes


def test_bsp_fft_complex128_precision():
    """n = 2**16 complex128 without the kernel reaches float64-grade
    accuracy (the twiddle is built in float64)."""
    n = 1 << 16
    x = cinput(0, n, np.complex128)
    y = bsp_fft(torch.from_numpy(x), p=8, device="cpu").numpy()
    assert rel(y, np.fft.fft(x)) < 1e-10


def test_complex128_with_kernel_raises():
    """The kernel computes in complex64: complex128 input is refused
    instead of cast down without a word."""
    x = torch.from_numpy(cinput(1, 1024, np.complex128))
    with pytest.raises(TypeError, match="complex64"):
        bsp_fft(x, p=8, use_kernel=True, device="cpu")
    with pytest.raises(TypeError, match="complex64"):
        fft_ops.fft(x)
