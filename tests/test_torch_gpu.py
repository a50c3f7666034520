"""Tests of the port that need an NVIDIA GPU (marker ``gpu``); they skip
where ``torch.cuda.is_available()`` is false.  This file imports no JAX,
so it runs on a machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

The CUDA kernel ``fft_stage`` is held against its plain PyTorch version
on the same inputs (relative error < 1e-5, the JAX kernel tests' bar), and
the FFT path is driven through its entry points on the card.
"""

import numpy as np
import pytest
import torch

from repro_torch import core as tlpf
from repro_torch.algorithms import bsp_fft
from repro_torch.kernels.fft_stage import kernel as fft_kernel
from repro_torch.kernels.fft_stage import ops as fft_ops
from repro_torch.kernels.fft_stage import ref as fft_ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def cinput(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("batch,n", [(1, 2), (1, 64), (4, 256), (8, 1024),
                                     (3, 4096), (2, 1 << 15), (8, 1 << 16)])
@pytest.mark.parametrize("inverse", [False, True])
def test_kernel_matches_plain_version(cuda, batch, n, inverse):
    x = torch.from_numpy(cinput(n, (batch, n))).to(cuda)
    before = fft_kernel.fft_planes.launches
    y = fft_kernel.fft_planes(x, inverse=inverse)
    y_p = fft_ref.stockham(x, inverse=inverse)
    torch.cuda.synchronize()
    assert fft_kernel.fft_planes.launches == before + 1
    err = (y - y_p).abs().max() / y_p.abs().max()
    assert err.item() < 1e-5


def test_ops_materialises_lazy_conjugates(cuda):
    """torch.conj is a lazy view: the kernel must see conjugated data."""
    x = torch.from_numpy(cinput(5, (4, 512))).to(cuda)
    y = fft_ops.fft(torch.conj(x))
    want = fft_ref.stockham(torch.conj(x).resolve_conj())
    assert ((y - want).abs().max() / want.abs().max()).item() < 1e-5
    with pytest.raises(tlpf.LPFFatalError, match="lazy"):
        fft_kernel.fft_planes(torch.conj(x))


@pytest.mark.parametrize("ordered", [True, False])
def test_bsp_fft_on_card(cuda, ordered):
    n = 1 << 16
    x = cinput(11, n)
    fft_kernel.fft_planes.launches = 0
    y, ledger = bsp_fft(torch.from_numpy(x), p=8, ordered=ordered,
                        use_kernel=True, return_ledger=True)
    back = bsp_fft(y, p=8, ordered=ordered, use_kernel=True, inverse=True)
    assert y.is_cuda and fft_kernel.fft_planes.launches == 2
    ref = np.fft.fft(x.astype(np.complex128))
    err = np.abs(y.cpu().numpy() - ref).max() / np.abs(ref).max()
    assert err < 2e-4
    assert (back.cpu() - torch.from_numpy(x)).abs().max().item() < 2e-3
    assert [r.method for r in ledger.records] == \
        ["fused"] * (2 if ordered else 1)


def test_exec_runs_on_card(cuda):
    def spmd(ctx, s, p, _):
        ctx.resize_memory_register(2)
        ctx.resize_message_queue(p)
        a = ctx.register_global("a", torch.arange(4.0, device=ctx.device)
                                + 10 * ctx.pid)
        b = ctx.register_global("b", ctx.replicate(torch.zeros(4)))
        ctx.put(a, b, to=lambda s: (s + 1) % p)
        ctx.sync(label="shift")
        return ctx.value(b)

    out = tlpf.exec_(8, spmd)
    assert out.is_cuda
    want = torch.arange(4.0) + 10 * ((torch.arange(8) - 1) % 8).reshape(-1, 1)
    assert torch.equal(out.cpu(), want)
