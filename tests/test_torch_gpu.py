"""Tests of the port that need an NVIDIA GPU (marker ``gpu``); they skip
where ``torch.cuda.is_available()`` is false.  This file imports no JAX,
so it runs on a machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

The CUDA kernels are held against their plain PyTorch versions on the
same inputs, at the JAX kernel tests' bars: ``fft_stage`` (relative error
< 1e-5) and ``flash_attention_fwd`` (o within 2e-5 in f32 and 2e-2 in
bf16, and in bf16 also each row's error within 2^-6 of the row's largest
|o_plain|; lse within 1e-4).  The FFT path and the llama3.2-1b serving path
(smoke config: prefill and the ``LPFServer`` loop) are driven through their
entry points on the card.
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from repro_torch import core as tlpf
from repro_torch.algorithms import bsp_fft
from repro_torch.kernels import build
from repro_torch.kernels.fft_stage import kernel as fft_kernel
from repro_torch.kernels.fft_stage import ops as fft_ops
from repro_torch.kernels.fft_stage import ref as fft_ref
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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


# the JAX kernel tests' sweep (tests/test_kernels.py), then D = 32 and 128
# in bf16, a ragged non-causal f32 case and a window wide of the tile
FLASH_SWEEP = [
    # B, H, Hkv, S,   D,  causal, window, softcap, dtype
    (1, 2, 2, 128, 64, True, None, None, torch.float32),
    (2, 4, 2, 256, 64, True, None, None, torch.float32),
    (1, 4, 1, 128, 128, False, None, None, torch.float32),
    (1, 2, 2, 256, 64, True, 64, None, torch.float32),
    (1, 2, 2, 128, 64, True, None, 30.0, torch.float32),
    (1, 2, 1, 192, 64, True, None, None, torch.float32),
    (1, 2, 2, 128, 64, True, None, None, torch.bfloat16),
    (2, 4, 2, 100, 32, True, None, None, torch.bfloat16),
    (1, 4, 4, 300, 128, True, 70, 20.0, torch.bfloat16),
    (1, 4, 2, 77, 32, False, None, None, torch.float32),
]


def row_err(o, o_p):
    """Largest |o - o_p| over its row's largest |o_p| (rows along D)."""
    o, o_p = o.float(), o_p.float()
    return ((o - o_p).abs() / o_p.abs().amax(dim=-1, keepdim=True)).max().item()


def qkv(seed, B, H, Hkv, S, D, dtype, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, np.float32))
            .to(device=device, dtype=dtype)
            for shape in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D))]


@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window,softcap,dtype",
                         FLASH_SWEEP)
def test_flash_kernel_matches_plain_version(cuda, B, H, Hkv, S, D, causal,
                                            window, softcap, dtype):
    q, k, v = qkv(S + D, B, H, Hkv, S, D, dtype, cuda)
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = fa_kernel.flash_attention_fwd.launches
    o, lse = fa_kernel.flash_attention_fwd(q, k, v, **kw)
    o_p, lse_p = fa_ref.flash_attention_fwd_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa_kernel.flash_attention_fwd.launches == before + 1
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert lse.shape == (B, H, S, 1)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert (o.float() - o_p.float()).abs().max().item() < tol
    if dtype == torch.bfloat16:
        # row by row: two bf16 ulps of the row's largest |o_plain|
        assert row_err(o, o_p) <= 2.0 ** -6
    assert (lse - lse_p).abs().max().item() < 1e-4
    want = fa_ref.attention_ref(q, k, v, **kw)
    assert (o.float() - want.float()).abs().max().item() < tol


def test_flash_row_bar_catches_a_dropped_pv_tile(cuda, tmp_path, monkeypatch):
    """The bf16 row bar has power at the prefill's shape: a copy of the
    kernel whose last query tile of each head leaves the second-to-last key
    tile out of P V (but not out of l) fails it, and the kernel passes."""
    src = (build.CSRC / "flash_attention_fwd.cu").read_text()
    loop = "for (int j = 0; j < BK / 16; ++j) {"
    assert src.count(loop) == 1
    (tmp_path / "fa.cu").write_text(src.replace(
        loop, "if (kt != hi - 2 || blockIdx.y != 0) " + loop))
    so = tmp_path / "libfa.so"
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                    str(tmp_path / "fa.cu")], check=True, capture_output=True)
    broken = ctypes.CDLL(str(so))
    broken.flash_attention_fwd.argtypes = fa_kernel._ARGTYPES
    broken.flash_attention_fwd.restype = ctypes.c_int

    q, k, v = qkv(7, 4, 32, 8, 2048, 64, torch.bfloat16, cuda)
    o_p, _ = fa_ref.flash_attention_fwd_ref(q, k, v)
    o, _ = fa_kernel.flash_attention_fwd(q, k, v)
    monkeypatch.setattr(fa_kernel, "_lib", lambda: broken)
    o_bad, _ = fa_kernel.flash_attention_fwd(q, k, v)
    good, bad = row_err(o, o_p), row_err(o_bad, o_p)
    print(f"row_err: kernel {good}, dropped P V tile {bad}; max abs err: "
          f"kernel {(o.float() - o_p.float()).abs().max().item()}, dropped "
          f"tile {(o_bad.float() - o_p.float()).abs().max().item()}")
    assert good <= 2.0 ** -6 < bad


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = qkv(1, 1, 2, 2, 64, 64, torch.bfloat16, cuda)
    with pytest.raises(tlpf.LPFFatalError, match="contiguous"):
        fa_kernel.flash_attention_fwd(q.transpose(1, 2), k, v)
    q48, k48, v48 = qkv(1, 1, 2, 2, 64, 48, torch.bfloat16, cuda)
    with pytest.raises(tlpf.LPFFatalError, match="head dims"):
        fa_kernel.flash_attention_fwd(q48, k48, v48)
    with pytest.raises(tlpf.LPFFatalError, match="float32 or bfloat16"):
        fa_kernel.flash_attention_fwd(q.half(), k.half(), v.half())
    with pytest.raises(tlpf.LPFFatalError, match="B3"):
        fa_ops.flash_attention(q.float().requires_grad_(), k.float(),
                               v.float())
    # ops makes the model's swapped [B,S,H,D] views contiguous first
    swapped = q.transpose(1, 2).contiguous().transpose(1, 2)
    assert not swapped.is_contiguous()
    o = fa_ops.flash_attention(swapped, k, v)
    want = fa_ref.attention_ref(q, k, v)
    assert (o.float() - want.float()).abs().max().item() < 2e-2


# --------------------------------------------------------------------------
# the llama3.2-1b serving path at the smoke config
# --------------------------------------------------------------------------

def smoke_cfg(**kw):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("llama3.2-1b", smoke=True), **kw)


def rel(a, ref):
    return ((a.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_smoke_prefill_on_card(cuda, compute):
    import dataclasses
    from repro_torch.models import cast_params, init_params, prefill
    cfg = smoke_cfg(attn_impl="flash", compute_dtype=compute)
    params = cast_params(init_params(0, cfg), cfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 100))
    fa_kernel.flash_attention_fwd.launches = 0
    got = prefill(params, {"tokens": toks}, cfg)
    assert got.is_cuda and fa_kernel.flash_attention_fwd.launches == 2
    want = prefill(params, {"tokens": toks},
                   dataclasses.replace(cfg, attn_impl="reference"))
    assert rel(got[:, :cfg.vocab], want[:, :cfg.vocab]) < (
        1e-4 if compute == "float32" else 2e-2)


def test_smoke_forward_on_card_matches_cpu(cuda):
    """The same weights through the kernel on the card and through its
    plain version on the CPU, in f32."""
    from repro_torch.interop import params_from_jax, params_to_numpy
    from repro_torch.models import Runtime, forward, init_params
    cfg = smoke_cfg(attn_impl="flash", compute_dtype="float32")
    params = init_params(3, cfg)
    cpu = params_from_jax(params_to_numpy(params), device="cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 70))
    got = forward(params, {"tokens": toks}, cfg).cpu()
    want = forward(cpu, {"tokens": toks}, cfg, Runtime("cpu"))
    assert rel(got[..., :cfg.vocab], want[..., :cfg.vocab]) < 1e-4


def test_smoke_teacher_forced_decode_on_card(cuda):
    from repro_torch.models import (cast_params, decode_step, init_caches,
                                    init_params, prefill)
    cfg = smoke_cfg(attn_impl="flash")
    params = cast_params(init_params(0, cfg), cfg)
    toks = torch.from_numpy(
        np.random.default_rng(4).integers(0, cfg.vocab, (1, 24))).to(cuda)
    want = prefill(params, {"tokens": toks}, cfg)
    caches = init_caches(cfg, 1, 24)
    for t in range(24):
        _, logits, caches = decode_step(params, toks[:, t], caches, t, cfg)
    assert rel(logits[:, :cfg.vocab], want[:, :cfg.vocab]) < 0.08


def test_smoke_serve_on_card(cuda):
    from repro_torch.launch.serve import ModelDecodeEngine, serve
    eng = ModelDecodeEngine(smoke_cfg(), [(2, 32), (4, 32)],
                            calibrate_tokens=3)
    assert eng.device.type == "cuda"
    out = serve(eng, requests=8, seed=0, max_tokens=16, check=True,
                verbose=False)
    assert out["completed"] >= 1
    assert out["solo_identical"] == out["completed"]
    assert out["health"]["deadline_misses"] == 0
