"""Tests of the port that need an NVIDIA GPU (marker ``gpu``); they skip
where ``torch.cuda.is_available()`` is false.  This file imports no JAX,
so it runs on a machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

The CUDA kernels are held against their plain PyTorch versions on the
same inputs, at the JAX kernel tests' bars: ``fft_stage`` (relative error
< 1e-5, and < 2e-5 from n = 2^21 on, the bar ``chip_smoke.py`` holds the
main path's rows to), ``flash_attention_fwd`` (o within 2e-5 in f32 and
2e-2 in bf16, and in bf16 also each row's error within 2^-6 of the row's
largest |o_plain|; lse within 1e-4) and the two ``flash_attention_bwd`` kernels
(each gradient within 5e-4 of the largest plain one in f32; in bf16 each
row within 2^-6 of the row's largest |plain|) and ``ssd_scan`` (y and the
final state within 1e-4 of the plain version's largest |value|, and each
of its passes' scratch within 1e-4 of ``ssd_scan_passes``), the forward
also at qwen3-14b's, qwen1.5-110b's, granite-moe-3b-a800m's,
jamba-v0.1-52b's, llava-next-mistral-7b's and whisper-base's prefill
attention (whisper's encoder non-causal at a ragged 1500 keys), the scan
at jamba's shape, the MoE block and deepseek-v3-671b's MLA layer against
the same call on the CPU.  The FFT
path, the llama3.2-1b serving and training paths (smoke config: prefill,
the ``LPFServer`` loop, train steps) and the mamba2-130m serving path
(smoke config) are driven through their entry points on the card; each
bucket's decode step captured as a CUDA graph decodes the eager
per-token path's tokens bit for bit (llama3.2-1b, mamba2-130m,
gemma2-9b, granite-moe-3b-a800m, jamba-v0.1-52b, llava-next-mistral-7b
and deepseek-v3-671b smoke configs; whisper-base's with ``enc_out`` in
the step's own buffer), a failed capture moves its bucket to the
per-token path, and the pure-LPF ``ProgramDecodeEngine`` replays its
captured loop body and equals its per-token fallback.  Every
superstep method, every BSP collective and a small PageRank run on the
card against the same calls on the CPU: bit-equal where no sum is
reordered, else within 1e-6 relative (PageRank within 1e-5, with the
same iteration count and ledger).  A program recorded on the card into a
persistent store warm-starts a fresh cache (a verified disk hit, no
search) and replays bit-equal; the ``compile`` fault seam quarantines a
program from CUDA-graph capture to the dispatched schedule with the same
values and ledger; one granite-moe-3b-a800m train step launches each
flash kernel as many times as it has attention layers (twice the forward
under full remat), and so does one train step of whisper-base,
llava-next-mistral-7b, gemma2-9b and qwen3-14b (smoke depth at their
published head dims), whose backward shapes at full width hold the flash
backward kernels to their plain version; the four examples run on the
card.
"""

import ctypes
import dataclasses
import shutil
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
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref

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


# the JAX kernel tests' shapes, then both sides of each threshold of
# ``pass_plan`` (one pass or two: 2^12 | 2^13; two or three: 2^22 | 2^23),
# the main path's (8, 2^21) and a three-pass row well beyond (2^25)
@pytest.mark.parametrize("batch,n", [
    (1, 2), (1, 64), (4, 256), (8, 1024), (3, 4096), (2, 1 << 12),
    (2, 1 << 13), (2, 1 << 15), (8, 1 << 16), (2, 1 << 21), (8, 1 << 21),
    (1, 1 << 22), (1, 1 << 23), (1, 1 << 25)])
@pytest.mark.parametrize("inverse", [False, True])
def test_kernel_matches_plain_version(cuda, batch, n, inverse):
    x = torch.from_numpy(cinput(n, (batch, n))).to(cuda)
    before = fft_kernel.fft_planes.launches
    launches = fft_kernel.fft_planes.cuda_launches
    y = fft_kernel.fft_planes(x, inverse=inverse)
    y_p = fft_ref.stockham(x, inverse=inverse)
    torch.cuda.synchronize()
    assert fft_kernel.fft_planes.launches == before + 1
    passes = fft_kernel.fft_planes.cuda_launches - launches
    assert passes == len(fft_kernel.pass_plan(n))
    if n == 1 << 21:
        assert passes == 2
    err = (y - y_p).abs().max() / y_p.abs().max()
    assert err.item() < (2e-5 if n >= 1 << 21 else 1e-5)


def broken_fft(tmp_path):
    """A copy of the FFT library whose first pass's epilogue twiddle
    w_n^{j1 k2} has its sign flipped for the last column j1 = A - 1 (the
    line found once)."""
    src = (build.CSRC / "fft_stage.cu").read_text()
    line = "const float2 w0 = twiddle(a * g, lq, p.sgn);"
    assert src.count(line) == 1
    (tmp_path / "fft.cu").write_text(src.replace(
        line, line.replace("p.sgn)", "a == p.a - 1 ? -p.sgn : p.sgn)")))
    so = tmp_path / "libfft.so"
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I",
                    str(build.CSRC), "-o", str(so), str(tmp_path / "fft.cu")],
                   check=True, capture_output=True)
    broken = ctypes.CDLL(str(so))
    broken.fft_stage_pass.argtypes = fft_kernel._ARGTYPES
    broken.fft_stage_pass.restype = ctypes.c_int
    return broken


def test_fft_bar_catches_a_wrong_epilogue_twiddle(cuda, tmp_path,
                                                  monkeypatch):
    """The 2e-5 bar has power at the main path's pass plan: a copy of the
    kernel with one column's pass-1 twiddle conjugated fails it at
    (2, 2^21), and the kernel passes."""
    broken = broken_fft(tmp_path)
    x = torch.from_numpy(cinput(21, (2, 1 << 21))).to(cuda)
    y_p = fft_ref.stockham(x)
    y = fft_kernel.fft_planes(x)
    monkeypatch.setattr(fft_kernel, "_lib", lambda: broken)
    y_bad = fft_kernel.fft_planes(x)
    good = ((y - y_p).abs().max() / y_p.abs().max()).item()
    bad = ((y_bad - y_p).abs().max() / y_p.abs().max()).item()
    print(f"(2, 2^21) rel err: kernel {good}, wrong twiddle {bad}")
    assert good < 2e-5 < bad


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
# in bf16, a ragged non-causal f32 case, a window wide of the tile, the
# bf16 backward's edges, and head dim 256 (gemma2-9b's)
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
    # the bf16 backward's edges: GQA group 4 with B*H > 1 and S ragged
    # across the heads of one tensor map, non-causal, S below one tile, and
    # D 128 with group 8
    (2, 8, 2, 200, 64, True, None, None, torch.bfloat16),
    (1, 4, 2, 256, 64, False, None, None, torch.bfloat16),
    (1, 2, 1, 40, 64, True, None, None, torch.bfloat16),
    (1, 8, 1, 384, 128, True, None, None, torch.bfloat16),
    # D 256: ragged S with GQA, a window with gemma2-9b's soft-cap 50,
    # non-causal with B 2, in bf16 and in f32
    (1, 4, 2, 300, 256, True, None, None, torch.bfloat16),
    (1, 2, 1, 200, 256, True, 64, 50.0, torch.bfloat16),
    (2, 2, 2, 160, 256, False, None, None, torch.bfloat16),
    (1, 2, 2, 130, 256, True, None, None, torch.float32),
    (1, 4, 2, 190, 256, True, 48, 50.0, torch.float32),
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


def broken_fwd(tmp_path, cond):
    """A copy of the forward library whose P V product (the line found
    once) runs only where ``cond`` holds; ``kt - 1`` is the key tile whose
    P it multiplies."""
    src = (build.CSRC / "flash_attention_fwd.cu").read_text()
    line = "hopper::wgmma_rs(o[pn], pa[kk], bv, 1);"
    assert src.count(line) == 1
    (tmp_path / "fa.cu").write_text(src.replace(line, f"if ({cond}) {line}"))
    so = tmp_path / "libfa.so"
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I",
                    str(build.CSRC), "-o", str(so), str(tmp_path / "fa.cu")],
                   check=True, capture_output=True)
    broken = ctypes.CDLL(str(so))
    broken.flash_attention_fwd.argtypes = fa_kernel._ARGTYPES
    broken.flash_attention_fwd.restype = ctypes.c_int
    return broken


def dropped_pv_tile_row_errs(cuda, tmp_path, monkeypatch, shape, **kw):
    """Row errors of the kernel and of a copy whose last query tile of each
    head leaves the second-to-last key tile of the block out of P V (but
    not out of l), against the plain version at ``shape``."""
    broken = broken_fwd(tmp_path, "kt - 1 != hi - 2 || blockIdx.y != 0")
    q, k, v = qkv(7, *shape, torch.bfloat16, cuda)
    o_p, _ = fa_ref.flash_attention_fwd_ref(q, k, v, **kw)
    o, _ = fa_kernel.flash_attention_fwd(q, k, v, **kw)
    monkeypatch.setattr(fa_kernel, "_lib", lambda: broken)
    o_bad, _ = fa_kernel.flash_attention_fwd(q, k, v, **kw)
    good, bad = row_err(o, o_p), row_err(o_bad, o_p)
    print(f"{shape} row_err: kernel {good}, dropped P V tile {bad}; max abs "
          f"err: kernel {(o.float() - o_p.float()).abs().max().item()}, "
          f"dropped tile {(o_bad.float() - o_p.float()).abs().max().item()}")
    return good, bad


def test_flash_row_bar_catches_a_dropped_pv_tile(cuda, tmp_path, monkeypatch):
    """The bf16 row bar has power at the prefill's shape: a copy of the
    kernel whose last query tile of each head leaves the second-to-last key
    tile out of P V (but not out of l) fails it, and the kernel passes."""
    good, bad = dropped_pv_tile_row_errs(cuda, tmp_path, monkeypatch,
                                         (4, 32, 8, 2048, 64))
    assert good <= 2.0 ** -6 < bad


def test_flash_row_bar_catches_a_dropped_pv_tile_at_d256(cuda, tmp_path,
                                                         monkeypatch):
    """The same planted fault at head dim 256 (four N-64 products of P V a
    key tile), gemma2-9b's local layer cut to S 1024: the copy fails the
    row bar, and the kernel passes."""
    good, bad = dropped_pv_tile_row_errs(
        cuda, tmp_path, monkeypatch, (1, 16, 8, 1024, 256), window=512,
        softcap=50.0)
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
    # an input that requires a gradient gets one, through both backward
    # kernels; the backward wrapper refuses CPU tensors
    qg = q.float().requires_grad_()
    before = (fa_kernel.flash_attention_bwd_dkv.launches,
              fa_kernel.flash_attention_bwd_dq.launches)
    fa_ops.flash_attention(qg, k.float(), v.float()).sum().backward()
    assert qg.grad is not None and bool(torch.isfinite(qg.grad).all())
    assert (fa_kernel.flash_attention_bwd_dkv.launches,
            fa_kernel.flash_attention_bwd_dq.launches) == \
        (before[0] + 1, before[1] + 1)
    o, lse = fa_ref.flash_attention_fwd_ref(q.cpu(), k.cpu(), v.cpu())
    with pytest.raises(tlpf.LPFFatalError, match="CUDA tensors"):
        fa_kernel.flash_attention_bwd(q.cpu(), k.cpu(), v.cpu(), o, o, lse)
    # ops makes the model's swapped [B,S,H,D] views contiguous first
    swapped = q.transpose(1, 2).contiguous().transpose(1, 2)
    assert not swapped.is_contiguous()
    o = fa_ops.flash_attention(swapped, k, v)
    want = fa_ref.attention_ref(q, k, v)
    assert (o.float() - want.float()).abs().max().item() < 2e-2


# bf16 gradients row by row: each row of dq, dk, dv within 2^-6 of the
# row's largest |plain| (rounding P and dS to bf16 and the outputs to bf16
# give 2^-7 in a CPU simulation at [1, 8, 2048, 64], Hkv 2)
BWD_ROW_BAR = 2.0 ** -6


def grad_row_err(a, ref):
    """Largest |a - ref| over its row's largest |ref| (rows along D), the
    row's scale floored at 1e-3 of the tensor's largest |ref|: a row whose
    gradient cancels to about 0 (the first query under the causal mask has
    dS = P (dP - delta) = 0) holds only rounding."""
    a, ref = a.float(), ref.float()
    scale = ref.abs().amax(dim=-1, keepdim=True).clamp_min(
        1e-3 * ref.abs().max().item())
    return ((a - ref).abs() / scale).max().item()


def bwd_inputs(seed, B, H, Hkv, S, D, dtype, device, **kw):
    """q, k, v, dO from a seed, and the forward's o and lse (plain)."""
    q, k, v = qkv(seed, B, H, Hkv, S, D, dtype, device)
    do = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (B, H, S, D), np.float32)).to(device=device, dtype=dtype)
    o, lse = fa_ref.flash_attention_fwd_ref(q, k, v, **kw)
    return q, k, v, o, do, lse


def rel_grad(a, ref):
    """The JAX backward test's measure: max |a - ref| / max |ref|."""
    a, ref = a.float(), ref.float()
    return ((a - ref).abs().max() / (ref.abs().max() + 1e-9)).item()


@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window,softcap,dtype",
                         FLASH_SWEEP)
def test_flash_bwd_kernels_match_plain_version(cuda, B, H, Hkv, S, D,
                                               causal, window, softcap,
                                               dtype):
    kw = dict(causal=causal, window=window, softcap=softcap)
    q, k, v, o, do, lse = bwd_inputs(S + D, B, H, Hkv, S, D, dtype, cuda,
                                     **kw)
    before = (fa_kernel.flash_attention_bwd_dkv.launches,
              fa_kernel.flash_attention_bwd_dq.launches)
    got = fa_kernel.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    want = fa_ref.flash_attention_bwd_ref(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert (fa_kernel.flash_attention_bwd_dkv.launches,
            fa_kernel.flash_attention_bwd_dq.launches) == \
        (before[0] + 1, before[1] + 1)
    for name, a, b, x in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert a.dtype == x.dtype and a.shape == x.shape, name
        if dtype == torch.float32:
            assert rel_grad(a, b) < 5e-4, name
        else:
            assert grad_row_err(a, b) <= BWD_ROW_BAR, name
    if dtype == torch.bfloat16:
        want_r = fa_ref.flash_attention_bwd_ref(q, k, v, o, do, lse,
                                                round_p=True, **kw)
        for name, a, b in zip(("dq", "dk", "dv"), got, want_r):
            assert grad_row_err(a, b) <= BWD_ROW_BAR, name


def broken_bwd(tmp_path, line, cond):
    """A copy of the backward library whose source line ``line`` (found
    once) runs only where ``cond`` holds."""
    src = (build.CSRC / "flash_attention_bwd.cu").read_text()
    assert src.count(line) == 1
    (tmp_path / "fa_bwd.cu").write_text(src.replace(line,
                                                    f"if ({cond}) {line}"))
    so = tmp_path / "libfa_bwd.so"
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I",
                    str(build.CSRC), "-o", str(so),
                    str(tmp_path / "fa_bwd.cu")], check=True,
                   capture_output=True)
    broken = ctypes.CDLL(str(so))
    for name, argtypes in fa_kernel._BWD_ARGTYPES.items():
        getattr(broken, name).argtypes = argtypes
        getattr(broken, name).restype = ctypes.c_int
    return broken


def test_flash_bwd_row_bar_catches_a_dropped_ds_tile(cuda, tmp_path,
                                                     monkeypatch):
    """The bf16 row bar has power at the training shape: a copy of the
    dK/dV kernel that skips the dS^T Q product of the diagonal query tile
    of each group's first head fails it, and the kernel passes."""
    broken = broken_bwd(tmp_path, "hopper::wgmma_rs(dk[pn], da[kk], bq, 1);",
                        "qt != lo || hh != 0")
    q, k, v, o, do, lse = bwd_inputs(7, 4, 32, 8, 2048, 64, torch.bfloat16,
                                     cuda)
    want = fa_ref.flash_attention_bwd_ref(q, k, v, o, do, lse)
    got = fa_kernel.flash_attention_bwd(q, k, v, o, do, lse)
    monkeypatch.setattr(fa_kernel, "_bwd_lib", lambda name: broken)
    bad = fa_kernel.flash_attention_bwd(q, k, v, o, do, lse)
    good_dk = grad_row_err(got[1], want[1])
    bad_dk = grad_row_err(bad[1], want[1])
    print(f"dk row_err: kernel {good_dk}, dropped dS tile {bad_dk}")
    assert good_dk <= BWD_ROW_BAR < bad_dk
    assert torch.equal(bad[0], got[0]) and torch.equal(bad[2], got[2])


def test_flash_bwd_row_bar_catches_a_dropped_dq_product(cuda, tmp_path,
                                                        monkeypatch):
    """The dQ twin: a copy of the dQ kernel that skips the dS K product of
    the first 16 keys of each block's last key tile fails the row bar, and
    the kernel passes."""
    broken = broken_bwd(tmp_path, "hopper::wgmma_rs(dq[pn], da[kk], bk, 1);",
                        "kt != hi - 1 || kk != 0")
    q, k, v, o, do, lse = bwd_inputs(7, 4, 32, 8, 2048, 64, torch.bfloat16,
                                     cuda)
    want = fa_ref.flash_attention_bwd_ref(q, k, v, o, do, lse)
    got = fa_kernel.flash_attention_bwd(q, k, v, o, do, lse)
    monkeypatch.setattr(fa_kernel, "_bwd_lib", lambda name: broken)
    bad = fa_kernel.flash_attention_bwd(q, k, v, o, do, lse)
    good_dq = grad_row_err(got[0], want[0])
    bad_dq = grad_row_err(bad[0], want[0])
    print(f"dq row_err: kernel {good_dq}, dropped dS K product {bad_dq}")
    assert good_dq <= BWD_ROW_BAR < bad_dq
    assert torch.equal(bad[1], got[1]) and torch.equal(bad[2], got[2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_gradients_on_card_match_autograd_of_reference(cuda, dtype):
    """ops.flash_attention's gradients (both kernels) against torch
    autograd through attention_ref, GQA with a window and a soft-cap."""
    kw = dict(causal=True, window=40, softcap=25.0)
    q, k, v = qkv(5, 2, 4, 2, 130, 64, dtype, cuda)
    w = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 4, 130, 64), np.float32)).to(cuda)
    grads = []
    for fn in (fa_ops.flash_attention, fa_ref.attention_ref):
        xs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        (fn(*xs, **kw).float() * w).sum().backward()
        grads.append([x.grad for x in xs])
    bar = 5e-4 if dtype == torch.float32 else 2e-2
    for a, b in zip(*grads):
        assert rel_grad(a, b) < bar


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


def test_smoke_train_steps_on_card(cuda):
    """Two train steps of the smoke config through both backward kernels:
    2 launches of each per step, finite losses, the first within 1e-2 of
    the reference-attention loss on the same batch."""
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.models import loss_fn
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train_step import build_train_step
    cfg = smoke_cfg(attn_impl="flash")
    ts = build_train_step(cfg, opt_cfg=AdamWConfig(lr=1e-3))
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=100,
                                        global_batch=2))
    params, opt = ts.init_fn(0)
    batch = {k: torch.from_numpy(v).to(cuda)
             for k, v in stream.batch(0).items()}
    with torch.no_grad():
        want = loss_fn(params, batch, smoke_cfg(attn_impl="reference"),
                       ts.rt).item()
    for fn in (fa_kernel.flash_attention_fwd,
               fa_kernel.flash_attention_bwd_dkv,
               fa_kernel.flash_attention_bwd_dq):
        fn.launches = 0
    losses = []
    for step in range(2):
        batch = {k: torch.from_numpy(v).to(cuda)
                 for k, v in stream.batch(step).items()}
        params, opt, m = ts.step_fn(params, opt, batch)
        losses.append(m["loss"].item())
    assert all(np.isfinite(losses)) and abs(losses[0] - want) < 1e-2 * want
    assert (fa_kernel.flash_attention_fwd.launches,
            fa_kernel.flash_attention_bwd_dkv.launches,
            fa_kernel.flash_attention_bwd_dq.launches) == (8, 4, 4)
    assert all(p.is_cuda for p in params.parameters())


# --------------------------------------------------------------------------
# ssd_scan and the mamba2-130m path
# --------------------------------------------------------------------------

# the JAX kernel tests' sweep, a ragged S and a ragged S with G 2;
# B, S, H, P, G, N, chunk
SSD_SWEEP = [
    (1, 64, 2, 16, 1, 16, 16),
    (2, 128, 4, 32, 2, 32, 32),
    (1, 256, 2, 16, 1, 64, 64),
    (1, 128, 4, 16, 1, 16, 128),
    (1, 200, 2, 16, 1, 16, 64),
    (2, 77, 4, 32, 2, 16, 32),
]


def ssd_inputs(seed, B, S, H, P, G, N, dtype, device):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, S, H, P), np.float32))
    dt = torch.from_numpy(rng.uniform(0.001, 0.1, (B, S, H)).astype(
        np.float32))
    a = torch.from_numpy(-rng.uniform(0.5, 2.0, (H,)).astype(np.float32))
    b, c = (torch.from_numpy(rng.standard_normal((B, S, G, N), np.float32))
            for _ in range(2))
    return (x.to(device, dtype), dt.to(device), a.to(device),
            b.to(device, dtype), c.to(device, dtype))


def rel_max(a, ref):
    return ((a.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


def check_passes(out, args, chunk):
    """The scratch each CUDA pass leaves against the plain passes: cum,
    C B^T on and below the diagonal (the kernel writes only its causal
    8-column tiles), and the state entering each chunk."""
    B, S = args[0].shape[:2]
    L = min(chunk, S)
    want = ssd_ref.ssd_scan_passes(*args, chunk=chunk)
    assert rel_max(out["cum"][..., :L], want.cum) < 1e-4
    assert rel_max(out["cb"][..., :L, :L].tril(), want.cb) < 1e-4
    assert not out["states"][:, 0].any()
    if want.states.shape[1] > 1:
        assert rel_max(out["states"][:, 1:], want.states[:, 1:]) < 1e-4


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", SSD_SWEEP)
def test_ssd_kernel_matches_plain_version(cuda, B, S, H, P, G, N, chunk):
    args = ssd_inputs(S + N, B, S, H, P, G, N, torch.float32, cuda)
    before = (ssd_kernel.ssd_scan.launches, ssd_kernel.ssd_scan.cuda_launches)
    out = ssd_kernel._run(*args, chunk=chunk)
    y, st = out["y"], out["state"]
    y_p, st_p = ssd_ref.ssd_scan_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert (ssd_kernel.ssd_scan.launches, ssd_kernel.ssd_scan.cuda_launches
            ) == (before[0] + 1, before[1] + len(ssd_kernel.PASSES))
    assert y.shape == (B, S, H, P) and st.shape == (B, H, N, P)
    assert rel_max(y, y_p) < 1e-4 and rel_max(st, st_p) < 1e-4
    check_passes(out, args, chunk)
    # ... and against the sequential oracle, ragged tails included
    y_r, st_r = ssd_ref.ssd_ref(*args)
    assert rel_max(y, y_r) < 1e-4 and rel_max(st, st_r) < 1e-4


# shapes off the main path's tiles: L not a multiple of 16 (77, 40), N not
# a multiple of 16 (20; in bf16 its rows are not 16-byte copies), P in two
# slices (128) or one of 48, G 2; B, S, H, P, G, N, chunk
SSD_ODD = [
    (2, 77, 4, 48, 2, 20, 128),
    (1, 200, 2, 128, 1, 36, 40),
    (2, 96, 4, 16, 2, 128, 96),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,G,N,chunk", SSD_ODD)
def test_ssd_kernel_pads_odd_shapes(cuda, B, S, H, P, G, N, chunk, dtype):
    """The kernel pads L, N and P to its tiles and masks the padding: y
    and the state within the bar of the f32 plain version (in bf16 plus
    half a bf16 ulp of each y), and each pass's scratch."""
    args = ssd_inputs(B + S + P + N, B, S, H, P, G, N, dtype, cuda)
    out = ssd_kernel._run(*args, chunk=chunk)
    f32 = [t.float() for t in args]
    y32, st32 = ssd_ref.ssd_scan_plain(*f32, chunk=chunk)
    over = ((out["y"].float() - y32).abs()
            - (2.0 ** -8 if dtype == torch.bfloat16 else 0.0) * y32.abs())
    assert out["y"].dtype == dtype
    assert over.max().item() / y32.abs().max().item() < 1e-4
    assert rel_max(out["state"], st32) < 1e-4
    check_passes(out, f32, chunk)


def test_ssd_kernel_holds_at_strong_decay(cuda):
    """The decay rates a trained Mamba-2 reaches (a_h down to -16, dt up to
    1: a chunk's cum spans hundreds, so exp(cum_i - cum_j) underflows
    across the chunk and a factorised decay would meet inf times 0): y and
    the state finite and within the bar of the plain version."""
    rng = np.random.default_rng(9)
    B, S, H, P, G, N = 2, 384, 4, 64, 1, 128
    x, _, _, b, c = ssd_inputs(9, B, S, H, P, G, N, torch.float32, cuda)
    dt = torch.from_numpy(rng.uniform(0.001, 1.0, (B, S, H)).astype(
        np.float32)).to(cuda)
    a = torch.from_numpy(-rng.uniform(1.0, 16.0, (H,)).astype(
        np.float32)).to(cuda)
    y, st = ssd_kernel.ssd_scan(x, dt, a, b, c)
    y_p, st_p = ssd_ref.ssd_scan_plain(x, dt, a, b, c)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    assert rel_max(y, y_p) < 1e-4 and rel_max(st, st_p) < 1e-4


def test_ssd_kernel_bf16_and_strided_views(cuda):
    """bf16 x, b, c (f32 arithmetic; y within the bar plus half a bf16 ulp
    of the f32 plain y), and f32 inputs that are strided views of one
    wider tensor, as the model hands them over."""
    x, dt, a, b, c = ssd_inputs(5, 2, 256, 4, 64, 1, 128, torch.bfloat16,
                                cuda)
    y, st = ssd_kernel.ssd_scan(x, dt, a, b, c)
    y32, st32 = ssd_ref.ssd_scan_plain(x.float(), dt, a, b.float(),
                                       c.float())
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    over = ((y.float() - y32).abs() - 2.0 ** -8 * y32.abs()).max()
    assert over.item() / y32.abs().max().item() < 1e-4
    assert rel_max(st, st32) < 1e-4
    wide = torch.cat([x.float().reshape(2, 256, -1), b.float()[:, :, 0],
                      c.float()[:, :, 0]], dim=-1)
    xs = wide[..., :256].reshape(2, 256, 4, 64)
    bs = wide[..., 256:384].reshape(2, 256, 1, 128)
    cs = wide[..., 384:].reshape(2, 256, 1, 128)
    assert not xs.is_contiguous()
    y_v, st_v = ssd_kernel.ssd_scan(xs, dt, a, bs, cs)
    assert rel_max(y_v, y32) < 1e-4 and rel_max(st_v, st32) < 1e-4
    # a view whose rows are not 16-byte aligned takes the element copies
    odd = torch.cat([wide[..., :1], wide], dim=-1)[..., 1:]
    y_o, st_o = ssd_kernel.ssd_scan(odd[..., :256].reshape(2, 256, 4, 64),
                                    dt, a,
                                    odd[..., 256:384].reshape(2, 256, 1, 128),
                                    odd[..., 384:].reshape(2, 256, 1, 128))
    assert torch.equal(y_o, y_v) and torch.equal(st_o, st_v)


def test_ssd_passes_fit_two_blocks_an_sm(cuda):
    """Passes A and C ask for little enough shared memory that two of
    their blocks share an H100 SM (233,472 bytes, 1 KB of it reserved a
    block) at the prefill's main shape, in f32 and bf16; C B^T fits one
    block's 227 KB."""
    lib = ssd_kernel._lib()
    plan = ssd_kernel.grid_plan(4, 2048, 24, 64, 1, 128, 128)
    for bf16 in (0, 1):
        def smem(name):
            return lib.ssd_smem_bytes(ssd_kernel.PASSES.index(name), bf16,
                                      plan.Lp, plan.Np, 64)
        for name in ("ssd_chunk_state", "ssd_chunk_scan"):
            assert 2 * (smem(name) + 1024) <= 233_472, (name, bf16)
        assert 0 < smem("ssd_cb") <= 232_448
        assert smem("ssd_state_pass") == 0


def test_ssd_bar_catches_a_missing_state_decay(cuda, tmp_path, monkeypatch):
    """The 1e-4 bar has teeth on the card: a copy of the kernel whose chain
    over chunks (pass B) carries the state without its exp(cum_L) decay
    misses the plain version by orders of magnitude, where the kernel
    passes."""
    src = (build.CSRC / "ssd_scan.cu").read_text()
    decay = "const float decay = expf(cum_L);"
    assert src.count(decay) == 1
    (tmp_path / "ssd.cu").write_text(src.replace(
        decay, "const float decay = 1.f;"))
    so = tmp_path / "libssd.so"
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I",
                    str(build.CSRC), "-o", str(so), str(tmp_path / "ssd.cu")],
                   check=True, capture_output=True)
    broken = ssd_kernel._bind(ctypes.CDLL(str(so)))
    args = ssd_inputs(6, 2, 512, 4, 64, 1, 128, torch.float32, cuda)
    y_p, st_p = ssd_ref.ssd_scan_plain(*args)
    y, st = ssd_kernel.ssd_scan(*args)
    monkeypatch.setattr(ssd_kernel, "_lib", lambda: broken)
    y_bad, st_bad = ssd_kernel.ssd_scan(*args)
    good, bad = rel_max(y, y_p), rel_max(y_bad, y_p)
    print(f"ssd_scan rel err: kernel {good}, no state decay {bad}")
    assert good < 1e-4 < 100 * 1e-4 < bad
    assert rel_max(st_bad, st_p) > 100 * 1e-4


def test_ssd_kernel_refuses_what_it_does_not_take(cuda):
    """Wrong layouts and shapes past the kernel's limits raise on CUDA
    tensors; nothing falls back to the plain version."""
    x, dt, a, b, c = ssd_inputs(7, 1, 256, 2, 32, 1, 16, torch.float32,
                                cuda)
    before = ssd_kernel.ssd_scan.launches
    with pytest.raises(tlpf.LPFFatalError, match="unit stride"):
        ssd_kernel.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3),
                            dt, a, b, c)
    with pytest.raises(tlpf.LPFFatalError, match="1 to 128"):
        ssd_kernel.ssd_scan(x, dt, a, b, c, chunk=256)
    with pytest.raises(tlpf.LPFFatalError, match="up to 128"):
        ssd_kernel.ssd_scan(*ssd_inputs(8, 1, 64, 2, 32, 1, 256,
                                        torch.float32, cuda))
    with pytest.raises(tlpf.LPFFatalError, match="float32 or bfloat16"):
        ssd_kernel.ssd_scan(x.half(), dt, a, b.half(), c.half())
    with pytest.raises(tlpf.LPFFatalError, match="1 to 128"):
        ssd_ops.ssd(x, dt, a, b, c, chunk=512)
    assert ssd_kernel.ssd_scan.launches == before


def mamba_cfg(**kw):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("mamba2-130m", smoke=True), **kw)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_mamba_smoke_prefill_on_card(cuda, compute):
    """The smoke model's prefill launches the kernel once a layer and
    matches the same weights' prefill on the CPU (the plain version)."""
    from repro_torch.interop import params_from_jax, params_to_numpy
    from repro_torch.models import Runtime, init_params, prefill
    cfg = mamba_cfg(compute_dtype=compute)
    params = init_params(3, cfg)
    cpu = params_from_jax(params_to_numpy(params), device="cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 100))
    ssd_kernel.ssd_scan.launches = 0
    got = prefill(params, {"tokens": toks}, cfg)
    assert got.is_cuda and ssd_kernel.ssd_scan.launches == cfg.n_layers
    want = prefill(cpu, {"tokens": toks}, cfg, Runtime("cpu"))
    assert rel(got.cpu()[:, :cfg.vocab], want[:, :cfg.vocab]) < (
        1e-4 if compute == "float32" else 2e-2)


def test_mamba_smoke_decode_and_serve_on_card(cuda):
    from repro_torch.launch.serve import ModelDecodeEngine, serve
    from repro_torch.models import (cast_params, decode_step, init_caches,
                                    init_params, prefill)
    cfg = mamba_cfg()
    params = cast_params(init_params(0, cfg), cfg)
    toks = torch.from_numpy(
        np.random.default_rng(4).integers(0, cfg.vocab, (1, 24))).to(cuda)
    want = prefill(params, {"tokens": toks}, cfg)
    caches = init_caches(cfg, 1, 24)
    for t in range(24):
        _, logits, caches = decode_step(params, toks[:, t], caches, t, cfg)
    assert rel(logits[:, :cfg.vocab], want[:, :cfg.vocab]) < 0.08
    eng = ModelDecodeEngine(cfg, [(2, 32), (4, 32)], params=params,
                            calibrate_tokens=3)
    out = serve(eng, requests=8, seed=0, max_tokens=16, check=True,
                verbose=False)
    assert out["completed"] >= 1
    assert out["solo_identical"] == out["completed"]
    assert out["health"]["deadline_misses"] == 0


# ---------------------------------------------------------------------------
# superstep methods, collectives and PageRank: the card against the CPU
# ---------------------------------------------------------------------------

def superstep_cases(p=8, w=5):
    """(name, rows, slot sizes, attrs, scratch): one superstep each; rows
    are (src, dst, src_sid, src_off, dst_sid, dst_off, size)."""
    big = {1: p * w + 7, 2: p * w + 3}
    a2a = [(s, d, 1, d * w, 2, s * w, w) for s in range(p) for d in range(p)]
    ag_ex = [(s, d, 1, 0, 2, s * w, w)
             for s in range(p) for d in range(p) if s != d]
    bruck = [(s, d, 1, (d * 3) % 11, 2, (s * 2) % 9, 1 + (s + d) % 3)
             for s in range(p) for d in range(p) if s != d]
    shift = [(s, (s + 3) % p, 1, 12 - s % 3 - s % 2, 2, 7 - s % 3, 4 + s % 3)
             for s in range(p)]
    small = {1: 16, 2: 16}
    return [
        # name, method, rows, slot sizes, attrs, scratch
        ("fused_ag", "fused_ag", [(s, d, 1, (3 * s) % 7, 2, s * w, w)
                                  for s in range(p) for d in range(p)],
         big, {}, 0),
        ("fused_ag_exclude_self", "fused_ag", ag_ex, big, {}, 0),
        ("fused_rs_sum", "fused_rs", [(s, d, 1, d * w, 2, d % 3, w)
                                      for s in range(p) for d in range(p)],
         big, {"reduce_op": "sum"}, 0),
        ("fused_rs_max", "fused_rs", [(s, d, 1, d * w, 2, 0, w)
                                      for s in range(p) for d in range(p)],
         big, {"reduce_op": "max"}, 0),
        ("fused_scatter", "fused_scatter", [(5, d, 1, d * w, 2, 1, w)
                                            for d in range(p) if d != 5],
         big, {}, 0),
        ("fused_gather", "fused_gather", [(s, 6, 1, 2, 2, s * w, w)
                                          for s in range(p) if s != 6],
         big, {}, 0),
        ("fused", "fused", a2a, big, {}, 0),
        ("direct", "direct", shift, small, {}, 0),
        ("bruck", "bruck", bruck, small, {"method": "bruck"}, 0),
        ("valiant", "valiant", a2a, big, {"method": "valiant"}, 256),
        ("compressed_direct", "direct", shift, small, {"compress": True}, 0),
        ("compressed_fused", "fused", a2a, big, {"compress": True}, 0),
        ("compressed_fused_ag", "fused_ag", ag_ex, big, {"compress": True},
         0),
    ]


def run_superstep(device, rows, slots, attrs, scratch, p=8):
    kw = dict(attrs)
    if kw.get("compress"):
        kw["compress"] = tlpf.CompressSpec()

    def spmd(ctx, s, p_, _):
        ctx.resize_message_queue(len(rows), valiant_payload=scratch)
        ctx.resize_memory_register(len(slots))
        h = {}
        for sid, size in sorted(slots.items()):
            rng = np.random.default_rng(sid)
            h[sid] = ctx.register_global(f"s{sid}", torch.from_numpy(
                rng.standard_normal((p, size)).astype(np.float32)))
        ctx.put_msgs([(a, b, h[x], xo, h[y], yo, n)
                      for a, b, x, xo, y, yo, n in rows])
        ctx.sync(tlpf.SyncAttributes(**kw), label="case")
        return [ctx.value(h[sid]).cpu() for sid in sorted(slots)]

    return tlpf.exec_(p, spmd, None, device=device, return_ledger=True)


@pytest.mark.parametrize("case", superstep_cases(),
                         ids=[c[0] for c in superstep_cases()])
def test_superstep_method_on_card_matches_cpu(cuda, case):
    name, method, rows, slots, attrs, scratch = case
    got, led = run_superstep(cuda, rows, slots, attrs, scratch)
    want, cled = run_superstep("cpu", rows, slots, attrs, scratch)
    assert [dataclasses.asdict(r) for r in led.records] == \
        [dataclasses.asdict(r) for r in cled.records]
    assert led.records[0].method == method
    for a, b in zip(got, want):
        if name == "fused_rs_sum":
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
        else:
            assert torch.equal(a, b), name


def collective_calls(p=8):
    from repro_torch import bsp
    int_attrs = tlpf.SyncAttributes()
    return {
        "allgather": lambda ctx, x: bsp.allgather(ctx, x),
        "alltoall": lambda ctx, x: bsp.alltoall(ctx, x),
        "broadcast": lambda ctx, x: bsp.broadcast(ctx, x, root=3),
        "reduce": lambda ctx, x: bsp.reduce(ctx, x, root=2),
        "allreduce": lambda ctx, x: bsp.allreduce(ctx, x),
        "allreduce_max_int": lambda ctx, x: bsp.allreduce(
            ctx, (x * 1000).to(torch.int32), op=torch.maximum,
            attrs=int_attrs),
        "allreduce_min_int": lambda ctx, x: bsp.allreduce(
            ctx, (x * 1000).to(torch.int32), op=torch.minimum),
        "allreduce_direct": lambda ctx, x: bsp.allreduce(
            ctx, x, attrs=tlpf.SyncAttributes(method="direct")),
        "allreduce_bruck": lambda ctx, x: bsp.allreduce(
            ctx, x, attrs=tlpf.SyncAttributes(method="bruck")),
        "allreduce_valiant": lambda ctx, x: bsp.allreduce(
            ctx, x, attrs=tlpf.SyncAttributes(method="valiant")),
        "allreduce_int8": lambda ctx, x: bsp.allreduce(
            ctx, x, attrs=tlpf.SyncAttributes(compress=tlpf.CompressSpec())),
        "exscan": lambda ctx, x: bsp.exscan(ctx, x),
    }


@pytest.mark.parametrize("name", sorted(collective_calls()))
def test_collective_on_card_matches_cpu(cuda, name):
    call = collective_calls()[name]
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (8, 1000)).astype(np.float32))

    def spmd(ctx, s, p, a):
        ctx.resize_message_queue(p * p, valiant_payload=1024)
        return call(ctx, a).cpu()

    got, led = tlpf.exec_(8, spmd, x, device=cuda, return_ledger=True)
    want, cled = tlpf.exec_(8, spmd, x, device="cpu", return_ledger=True)
    assert [dataclasses.asdict(r) for r in led.records] == \
        [dataclasses.asdict(r) for r in cled.records]
    if name == "allreduce_int8":
        # the card sums the exchanged chunks in another order, which can
        # move a value of the second superstep across a rounding boundary
        # of its int8 wire: one quantum, max|value| / 127
        quantum = want.abs().max().item() / 127
        assert (got - want).abs().max().item() <= 1.01 * quantum
    elif got.dtype.is_floating_point and name not in (
            "allgather", "alltoall", "broadcast"):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)
    else:
        assert torch.equal(got, want), name


def test_pagerank_on_card_matches_cpu(cuda):
    from repro_torch.algorithms import (lpf_pagerank, partition_graph,
                                        rmat_graph,
                                        sparse_reference_pagerank)
    edges = rmat_graph(1 << 12, 16 << 12, seed=1)
    g = partition_graph(edges, 1 << 12, 8)
    r, iters, res, led = lpf_pagerank(8, g, return_ledger=True)
    rc, ic, resc, cled = lpf_pagerank(8, g, device="cpu",
                                      return_ledger=True)
    assert r.is_cuda and iters == ic
    assert (r.cpu() - rc).abs().max().item() / rc.max().item() < 1e-5
    assert [dataclasses.asdict(x) for x in led.records] == \
        [dataclasses.asdict(x) for x in cled.records]
    ref, _ = sparse_reference_pagerank(edges, 1 << 12)
    assert ((r.double() - ref).abs().max() / ref.max()).item() < 1e-3


# ---------------------------------------------------------------------------
# compiled replay: programs as CUDA graphs, compile_loop bodies captured
# ---------------------------------------------------------------------------

def _canned_on_card(name, mode, dev, seed=0, n_runs=None, between=None,
                    pc=None):
    """Run a canned trace (default sizes, int32) on a fresh context:
    ``"ref"`` one eager superstep per step, ``"dispatched"`` and
    ``"compiled"`` as one recorded program, ``n_runs`` times (by default
    the compiled program's eager calls, its timed ones, its capture, its
    timed replays and two calls past its choice), each from the same
    initial values, calling ``between(k)`` before run ``k``, through
    ``pc`` (a fresh program cache by default).  Returns the values after
    each run, the ledger of the last run and the program cache."""
    from repro_torch.analysis import traces
    from repro_torch.core.program import TRIAL_CALLS
    p, slots, steps, scratch = traces.CANNED_TRACES[name]()
    gen = torch.Generator().manual_seed(seed)
    init = {s.sid: torch.randint(-(1 << 20), 1 << 20, (p, s.size),
                                 dtype=torch.int32, generator=gen).to(dev)
            for s in slots}
    pc = tlpf.ProgramCache() if pc is None else pc
    ctx = tlpf.LPFContext(p, device=dev, program_cache=pc)
    ctx.compile_programs = mode == "compiled"
    run, reset, handles, _ = traces.bind_trace(ctx, slots, steps, scratch,
                                               init, label=name)
    if n_runs is None:
        n_runs = 1 if mode == "ref" else 2 * TRIAL_CALLS + 4
    runs = []
    for k in range(n_runs):
        if between is not None:
            between(k)
        reset()
        before = len(ctx.ledger.records)
        run(recorded=mode != "ref")
        runs.append({sid: ctx.value(h).cpu() for sid, h in handles.items()})
    return runs, ctx.ledger.records[before:], pc


@pytest.mark.parametrize("name", ["fft_redistribute", "bucketed_sync8",
                                  "fragmented_valiant", "pagerank"])
def test_compiled_replay_matches_dispatched_on_card(cuda, name):
    """A canned trace's program, eager, replayed as a CUDA graph, and on
    whichever of the two its timed calls chose, leaves every slot
    bit-equal (int32) to the dispatched schedule and to recorded-order
    execution after every call, ledgers what the dispatched run ledgers,
    and is one cache entry with one artifact that replayed; a graph that
    lost its timing is dropped, and the context then dispatches."""
    from repro_torch.core.program import TRIAL_CALLS
    (ref,), _, _ = _canned_on_card(name, "ref", cuda)
    disp, dled, _ = _canned_on_card(name, "dispatched", cuda)
    comp, cled, pc = _canned_on_card(name, "compiled", cuda)
    for got in disp + comp:
        for sid in ref:
            assert torch.equal(got[sid], ref[sid]), sid
    assert [dataclasses.asdict(r) for r in dled] == \
        [dataclasses.asdict(r) for r in cled]
    (cp,) = pc.artifacts()
    assert len(pc) == 1 and not pc.quarantined
    assert cp.use_graph is not None
    assert len(cp.eager_s) == len(cp.replay_s) == TRIAL_CALLS
    assert cp.captured == cp.use_graph
    past = 2 if cp.use_graph else 0         # the calls past the choice
    assert cp.n_calls == 2 * TRIAL_CALLS + 2 + past
    assert cp.n_replays == TRIAL_CALLS + 1 + past


def _flood_index_memo(dev, n=64):
    """Build ``n`` index tables no schedule uses, so the index memo (made
    small by the caller) drops every table it held."""
    from repro_torch.core import sync as tsync
    for i in range(n):
        tsync._index([i, i + 7, i + 11], dev)


def test_compiled_replay_survives_index_memo_eviction(cuda, monkeypatch):
    """A captured program keeps the index tensors its graph reads: with
    the memo cut to one table and flooded before every call, the replays
    stay bit-equal to recorded order."""
    from repro_torch.core import sync as tsync
    monkeypatch.setattr(tsync, "_INDEX_MEMO_SIZE", 1)
    (ref,), _, _ = _canned_on_card("pagerank", "ref", cuda)
    comp, _, pc = _canned_on_card("pagerank", "compiled", cuda,
                                  between=lambda k: _flood_index_memo(cuda))
    for got in comp:
        for sid in ref:
            assert torch.equal(got[sid], ref[sid]), sid
    (cp,) = pc.artifacts()
    assert cp.n_replays > 0 and not pc.quarantined


def _ring_body(c2, carry):
    v, it = carry
    c2.resize_memory_register(2)
    c2.resize_message_queue(c2.p)
    a = c2.register_global("a", v)
    b = c2.register_global("b", torch.zeros_like(v))
    c2.put(a, b, to=lambda s_: (s_ + 1) % c2.p, size=4)
    c2.sync(label="shift")
    out = c2.value(b) * 3 + 1
    c2.deregister(a)
    c2.deregister(b)
    return out, it + 1


@pytest.mark.parametrize("counted", [True, False])
def test_captured_loop_body_matches_eager_loop(cuda, counted):
    """A compile_loop body with an all-tensor carry runs as a CUDA graph
    from its second iteration: the carry, the collected values and the
    once-ledgered body equal the eager loop's."""
    def run(compiled):
        ctx = tlpf.LPFContext(8, device=cuda)
        ctx.compile_programs = compiled
        v0 = (torch.arange(32, dtype=torch.int32, device=cuda).reshape(8, 4),
              torch.zeros((), dtype=torch.int64, device=cuda))
        if counted:
            out = ctx.compile_loop(_ring_body, v0, n_iters=6, label="ring",
                                   collect=lambda c: c[0][:, :1])
        else:
            out = (ctx.compile_loop(_ring_body, v0, label="ring",
                                    cond=lambda c: bool(c[1] < 6)), None)
        return out, ctx

    (g_carry, g_ys), gctx = run(True)
    (e_carry, e_ys), ectx = run(False)
    assert torch.equal(g_carry[0], e_carry[0])
    assert int(g_carry[1]) == int(e_carry[1]) == 6
    if counted:
        assert torch.equal(g_ys, e_ys)
    assert [dataclasses.asdict(r) for r in gctx.ledger.records] == \
        [dataclasses.asdict(r) for r in ectx.ledger.records]
    assert (gctx.loop_graph_replays, gctx.loop_graph_fallbacks) == (5, 0)
    assert ectx.loop_graph_replays == 0


def test_captured_loop_body_survives_index_memo_eviction(cuda, monkeypatch):
    """A captured compile_loop body keeps the index tensors its graph
    reads: with the memo cut to one table and flooded before every
    iteration, the loop stays bit-equal to the eager loop."""
    from repro_torch.core import sync as tsync
    monkeypatch.setattr(tsync, "_INDEX_MEMO_SIZE", 1)

    def run(compiled):
        ctx = tlpf.LPFContext(8, device=cuda)
        ctx.compile_programs = compiled
        v0 = (torch.arange(32, dtype=torch.int32, device=cuda).reshape(8, 4),
              torch.zeros((), dtype=torch.int64, device=cuda))

        def cond(c):
            _flood_index_memo(cuda)
            return bool(c[1] < 6)

        return ctx.compile_loop(_ring_body, v0, label="ring", cond=cond), ctx

    (g, _), gctx = run(True)
    (e, _), _ = run(False)
    assert torch.equal(g, e)
    assert (gctx.loop_graph_replays, gctx.loop_graph_fallbacks) == (5, 0)


def test_pagerank_captured_loop_matches_eager_on_card(cuda):
    """PageRank's compile_loop body captured as a CUDA graph: the ranks
    and the iteration count bit-equal to the eager loop's."""
    from repro_torch.algorithms import (pagerank_spmd, partition_graph,
                                        rmat_graph, shard_tensors)
    g = partition_graph(rmat_graph(1 << 12, 16 << 12, seed=1), 1 << 12, 8)

    def run(compiled):
        ctx = tlpf.LPFContext(8, device=cuda)
        ctx.compile_programs = compiled
        r, iters, res = pagerank_spmd(ctx, g, shard_tensors(g, cuda))
        return r, iters, ctx

    rg, ig, gctx = run(True)
    re_, ie, ectx = run(False)
    assert ig == ie and torch.equal(rg, re_)
    assert gctx.loop_graph_replays == ig - 1 and \
        gctx.loop_graph_fallbacks == 0
    assert [dataclasses.asdict(r) for r in gctx.ledger.records] == \
        [dataclasses.asdict(r) for r in ectx.ledger.records]


# ---------------------------------------------------------------------------
# serving: the captured decode step, the program engine, and the dense
# configs' attention shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-130m", "gemma2-9b",
                                  "granite-moe-3b-a800m", "jamba-v0.1-52b",
                                  "llava-next-mistral-7b",
                                  "deepseek-v3-671b"])
def test_captured_decode_matches_eager_per_token(cuda, arch):
    """A bucket's step captured once and replayed once a token decodes the
    eager per-token path's tokens bit for bit: 12 tokens into an 8-slot
    cache (the slots roll), then 5 from reset buffers, one capture."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_caches, load_params
    from repro_torch.runtime.train_step import build_serve_buckets
    cfg = get_config(arch, smoke=True)
    params = load_params(0, cfg)
    ss = build_serve_buckets(cfg, [(4, 8)])[(4, 8)]
    tok0 = torch.tensor([1, 5, 77, 300], device=cuda)
    for n in (12, 5):
        got, _ = ss.decode_fn(n)(params, tok0, 0)
        caches = init_caches(cfg, 4, 8)
        tok, want = tok0, []
        for pos in range(n):
            tok, caches = ss.step_fn(params, caches, tok, pos)
            want.append(tok)
        assert torch.equal(got, torch.stack(want)), n
    assert (ss.graph.captures, ss.graph.replays) == (1, 17)


def test_model_engine_serves_captured_and_checks_per_token(cuda):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import ModelDecodeEngine, serve
    eng = ModelDecodeEngine(get_config("gemma2-9b", smoke=True),
                            [(2, 16), (4, 16)], calibrate_tokens=3)
    assert eng.captures == 2 and eng.replays > 0
    out = serve(eng, requests=8, seed=0, max_tokens=16, check=True,
                verbose=False)
    assert out["completed"] >= 1 and out["quarantines"] == 0
    assert out["solo_identical"] == out["per_token_identical"] == \
        out["completed"]
    assert out["health"]["deadline_misses"] == 0
    assert eng.captures == 2 and eng.quarantined == set()


def test_failed_capture_moves_the_bucket_to_per_token(cuda, monkeypatch):
    """A capture that fails raises a transient error, never an eager run;
    behind the server the ladder quarantines the bucket and the request
    completes on the per-token path with the captured path's tokens."""
    from repro_torch.core import LPFTransientError
    from repro_torch.launch.serve import ModelDecodeEngine
    from repro_torch.runtime import train_step
    from repro_torch.runtime.server import LPFServer, ServeRequest
    eng = ModelDecodeEngine(smoke_cfg(), [(2, 16)], calibrate_tokens=2)
    r = ServeRequest(rid=0, n_tokens=6, deadline_s=10.0, seed=4242)
    want = eng.decode((2, 16), [r], 6)[0]
    real = train_step.decode_step

    def reads_pos_on_host(params, token, caches, pos, cfg, rt,
                          enc_out=None):
        if isinstance(pos, torch.Tensor) and \
                torch.cuda.is_current_stream_capturing():
            pos.item()                 # a host read: refused under capture
        return real(params, token, caches, pos, cfg, rt, enc_out)

    monkeypatch.setattr(train_step, "decode_step", reads_pos_on_host)
    eng._steps[(2, 16)].graph.graph = None          # capture again
    with pytest.raises(LPFTransientError, match="capture"):
        eng.decode((2, 16), [r], 6)
    srv = LPFServer(eng, max_queue=4)
    srv.submit(r)
    done = srv.step()
    assert done[0].status == "completed" and done[0].fallback
    assert done[0].tokens == want
    assert eng.quarantined == {(2, 16)} and eng.quarantines == 1


def test_program_engine_replays_its_loop_graph(cuda):
    """The pure-LPF engine on the card: the fused decode replays its
    captured loop body, and equals its per-token fallback, its solo
    decode and the same engine on the CPU."""
    from repro_torch.runtime.server import (LPFServer, ProgramDecodeEngine,
                                            ServeRequest, synthetic_requests)
    eng = ProgramDecodeEngine(buckets=((2, 8), (4, 8)))
    reqs = [ServeRequest(rid=i, n_tokens=8, deadline_s=1.0, seed=s)
            for i, s in enumerate((1234, 777, 5))]
    fused = eng.decode((4, 8), reqs, 8)
    assert (eng.loop_graph_replays, eng.loop_graph_fallbacks) == (7, 0)
    assert eng.decode((4, 8), reqs[:1], 8)[0] == fused[0]
    cpu = ProgramDecodeEngine(buckets=((4, 8),), device="cpu")
    assert cpu.decode((4, 8), reqs, 8) == fused
    eng.quarantine((4, 8))
    assert eng.decode((4, 8), reqs, 8) == fused
    eng.quarantined.clear()
    srv = LPFServer(eng, max_queue=8)
    for r in synthetic_requests(10, 3, eng.buckets(),
                                token_cost_s=eng.token_seconds((4, 8))):
        srv.submit(r)
    srv.run_until_idle()
    h = srv.drain()
    assert h["deadline_misses"] == 0 and h["program_pinned"] >= 2
    assert eng.loop_graph_fallbacks == 0


#: qwen3-14b's prefill attention (40 heads over 8: a GQA group of 5) and
#: qwen1.5-110b's (64 over 8), bf16 causal at S 2048
DENSE_FLASH = [(4, 40, 8, 2048, 128, True, None, None, torch.bfloat16),
               (1, 64, 8, 2048, 128, True, None, None, torch.bfloat16)]


@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window,softcap,dtype",
                         DENSE_FLASH, ids=["qwen3-14b", "qwen1.5-110b"])
def test_flash_kernel_matches_plain_version_at_dense_shapes(
        cuda, B, H, Hkv, S, D, causal, window, softcap, dtype):
    test_flash_kernel_matches_plain_version(cuda, B, H, Hkv, S, D, causal,
                                            window, softcap, dtype)


# ---------------------------------------------------------------------------
# the MoE configs: their kernel shapes, the MoE block on the card
# ---------------------------------------------------------------------------

#: granite-moe-3b-a800m's prefill attention (24 heads over 8: a GQA group
#: of 3, head dim 64, B 4 x S 2048) and jamba-v0.1-52b's (32 over 8, head
#: dim 128, B 1 x S 8192), bf16 causal
MOE_FLASH = [(4, 24, 8, 2048, 64, True, None, None, torch.bfloat16),
             (1, 32, 8, 8192, 128, True, None, None, torch.bfloat16)]


@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window,softcap,dtype",
                         MOE_FLASH, ids=["granite-moe-3b", "jamba-v0.1"])
def test_flash_kernel_matches_plain_version_at_moe_shapes(
        cuda, B, H, Hkv, S, D, causal, window, softcap, dtype):
    test_flash_kernel_matches_plain_version(cuda, B, H, Hkv, S, D, causal,
                                            window, softcap, dtype)


def test_ssd_kernel_matches_plain_version_at_jamba_shape(cuda):
    """jamba-v0.1-52b's scan: 128 heads of 64, N 16 (padded to no more
    than 16), chunk 128, S 8192 (64 chunks), in f32 as the model hands
    it, and in bf16 within the bar plus half a bf16 ulp of each y."""
    test_ssd_kernel_matches_plain_version(cuda, 1, 8192, 128, 64, 1, 16,
                                          128)
    args = ssd_inputs(8192 + 16, 1, 8192, 128, 64, 1, 16, torch.bfloat16,
                      cuda)
    out = ssd_kernel._run(*args, chunk=128)
    y32, st32 = ssd_ref.ssd_scan_plain(*[t.float() for t in args],
                                       chunk=128)
    over = (out["y"].float() - y32).abs() - 2.0 ** -8 * y32.abs()
    assert out["y"].dtype == torch.bfloat16
    assert over.max().item() / y32.abs().max().item() < 1e-4
    assert rel_max(out["state"], st32) < 1e-4


@pytest.mark.parametrize("case", ["granite-smoke", "padded", "drops"])
def test_moe_block_on_card_matches_cpu(cuda, case):
    """The MoE block in f32 on the card against the same call on the CPU
    (within 1e-5, the same tokens routed to each expert), at the granite
    smoke config's widths, with its expert count padded, and with a
    capacity that drops tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    mcfg = dataclasses.replace(
        get_config("granite-moe-3b-a800m", smoke=True).moe,
        **{"granite-smoke": {}, "padded": dict(ep_degree=4),
           "drops": dict(capacity_factor=0.5)}[case])
    gen = torch.Generator().manual_seed(3)
    p = moe.moe_params(gen, mcfg, torch.float32, "cpu")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 64, mcfg.d_model)).astype(np.float32))
    want = moe.moe_single(p, x, mcfg)
    pd = {k: v.to(cuda) for k, v in p.items()}
    got = moe.moe_single(pd, x.to(cuda), mcfg)
    assert rel(got.cpu(), want) < 1e-5
    assert moe.expert_load(pd, x.to(cuda), mcfg)[0].cpu().tolist() == \
        moe.expert_load(p, x, mcfg)[0].tolist()


# ---------------------------------------------------------------------------
# the rest of the model stack: whisper-base, llava-next-mistral-7b and
# deepseek-v3-671b's MLA
# ---------------------------------------------------------------------------

#: llava-next-mistral-7b's prefill attention (32 heads over 8, head dim
#: 128, B 4 x S 2048, causal) and whisper-base's at its encoder's 1500
#: frames (8 heads of 64, B 16; 1500 = 11 x 128 + 92): the encoder's
#: non-causal attention and the decoder's causal one, bf16
STACK_FLASH = [(4, 32, 8, 2048, 128, True, None, None, torch.bfloat16),
               (16, 8, 8, 1500, 64, False, None, None, torch.bfloat16),
               (16, 8, 8, 1500, 64, True, None, None, torch.bfloat16)]


@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window,softcap,dtype",
                         STACK_FLASH, ids=["llava", "whisper-encoder",
                                           "whisper-decoder"])
def test_flash_kernel_matches_plain_version_at_stack_shapes(
        cuda, B, H, Hkv, S, D, causal, window, softcap, dtype):
    test_flash_kernel_matches_plain_version(cuda, B, H, Hkv, S, D, causal,
                                            window, softcap, dtype)


# the backward shapes of chip_smoke.py's (ae) training paths: gemma2-9b's
# local (window 4096, soft-cap 50) and global layers at head dim 256,
# llava-next-mistral-7b's and qwen3-14b's at 128, whisper-base's encoder
# (non-causal, 1500 keys) and decoder (causal)
STACK_BWD = [(1, 16, 8, 8192, 256, True, 4096, 50.0, torch.bfloat16),
             (1, 16, 8, 8192, 256, True, None, None, torch.bfloat16),
             (4, 32, 8, 2048, 128, True, None, None, torch.bfloat16),
             (4, 40, 8, 2048, 128, True, None, None, torch.bfloat16),
             (16, 8, 8, 1500, 64, False, None, None, torch.bfloat16),
             (16, 8, 8, 1500, 64, True, None, None, torch.bfloat16)]


@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window,softcap,dtype",
                         STACK_BWD, ids=["gemma2-local", "gemma2-global",
                                         "llava", "qwen3", "whisper-encoder",
                                         "whisper-decoder"])
def test_flash_bwd_kernels_match_plain_version_at_training_shapes(
        cuda, B, H, Hkv, S, D, causal, window, softcap, dtype):
    test_flash_bwd_kernels_match_plain_version(cuda, B, H, Hkv, S, D,
                                               causal, window, softcap,
                                               dtype)


# smoke widths with each family's published head dim and GQA group
STACK_TRAIN_WIDTHS = {
    "whisper-base": dict(n_heads=2, n_kv=2, head_dim=64),
    "llava-next-mistral-7b": dict(n_heads=8, n_kv=2, head_dim=128),
    "gemma2-9b": dict(n_heads=4, n_kv=2, head_dim=256),
    "qwen3-14b": dict(n_heads=5, n_kv=1, head_dim=128),
}


@pytest.mark.parametrize("arch", sorted(STACK_TRAIN_WIDTHS))
def test_stack_train_step_launch_counts(cuda, arch):
    """One train step of each family chip_smoke.py's (ae) trains (smoke
    depth, the published head dim and group, flash attention, the steps
    donating their state): a forward launch an attention layer (and a
    cross-attention layer) a forward, two forwards under
    ``remat="full"``, one launch of each backward kernel an attention
    layer, a finite loss within 1e-2 of the reference attention's."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.models import loss_fn
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train_step import build_train_step
    base = dataclasses.replace(get_config(arch, smoke=True),
                               **STACK_TRAIN_WIDTHS[arch])
    cfg = dataclasses.replace(base, attn_impl="flash")
    ts = build_train_step(cfg, opt_cfg=AdamWConfig(lr=1e-3), donate=True)
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=128,
                                        global_batch=2), cfg)
    params, opt = ts.init_fn(0)
    batch = {k: torch.from_numpy(v).to(cuda)
             for k, v in stream.batch(0).items()}
    with torch.no_grad():
        want = loss_fn(params, batch, dataclasses.replace(
            base, attn_impl="reference"), ts.rt).item()
    for fn in (fa_kernel.flash_attention_fwd,
               fa_kernel.flash_attention_bwd_dkv,
               fa_kernel.flash_attention_bwd_dq):
        fn.launches = 0
    params, opt, m = ts.step_fn(params, opt, batch)
    loss = m["loss"].item()
    attn = sum(g.repeats * sum((b.mixer == "attn") + bool(b.cross_attn)
                               for b in g.blocks)
               for g in cfg.groups + cfg.encoder_groups)
    assert (fa_kernel.flash_attention_fwd.launches,
            fa_kernel.flash_attention_bwd_dkv.launches,
            fa_kernel.flash_attention_bwd_dq.launches) == (2 * attn, attn,
                                                           attn)
    assert np.isfinite(loss) and abs(loss - want) < 1e-2 * want


def test_examples_run_on_card(cuda, tmp_path):
    """Each example's ``run(device="cuda")``: quickstart's error codes,
    rows and ledger, fft_spectral's RMS drop and h-relation,
    pagerank_interop's iterations and error, and train_lm resumed from
    the checkpoint of step 3 within 1e-5 of the uninterrupted run."""
    from repro_torch.algorithms import fft_h_bytes
    from repro_torch.examples import (fft_spectral, pagerank_interop,
                                      quickstart, train_lm)
    for m, n, err, rows in ((1024, 512, 0, [128] * 8),
                            (5, 512, 1, [1] * 5 + [0] * 3),
                            (0, 512, 1, [0] * 8)):
        res = quickstart.run(m, n)
        assert res["errors"] == [err] * 8 and res["rows"] == rows
        assert [(r.label, r.h_bytes, r.rounds, r.n_msgs)
                for r in res["ledger"].records] == [
            ("fetch-dims", 56, 7, 8), ("error-broadcast", 28, 13, 64)]
    res = fft_spectral.run()
    assert res["spectrum"].is_cuda
    assert res["rms_after"] < res["rms_before"] / 2
    assert res["h_bytes"] == fft_h_bytes(fft_spectral.N, fft_spectral.P)
    res = pagerank_interop.run()
    assert res["iterations"] == 13 and res["rel_err"] < 1e-3
    full = train_lm.run(6, str(tmp_path), ckpt_every=3, log=None)
    shutil.rmtree(tmp_path / "step_6")         # a run stopped after step 3
    again = train_lm.run(6, str(tmp_path), ckpt_every=3, log=None)
    assert next(full["params"].parameters()).is_cuda
    assert again["start"] == 3 and len(again["losses"]) == 3
    for a, b in zip(again["losses"], full["losses"][3:]):
        assert abs(a - b) < 1e-5 * abs(b)


def test_captured_decode_with_enc_out_matches_eager(cuda):
    """whisper-base (smoke): the captured step reads the encoder output
    from its own buffer, into which every call copies it: 12 tokens into
    an 8-slot cache and 5 more, bit-equal to the eager per-token path, one
    capture; another encoder output changes the stream, a new shape
    captures again."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_caches, load_params
    from repro_torch.runtime.train_step import build_serve_buckets
    cfg = get_config("whisper-base", smoke=True)
    params = load_params(0, cfg)
    ss = build_serve_buckets(cfg, [(4, 8)])[(4, 8)]
    tok0 = torch.tensor([1, 5, 77, 300], device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    encs = [torch.randn(4, 20, 128, generator=gen, device=cuda).to(
        torch.bfloat16) for _ in range(2)]

    def eager(n, enc):
        caches = init_caches(cfg, 4, 8)
        tok, want = tok0, []
        for pos in range(n):
            tok, caches = ss.step_fn(params, caches, tok, pos, enc)
            want.append(tok)
        return torch.stack(want)

    outs = []
    for n, enc in ((12, encs[0]), (5, encs[1])):
        got, _ = ss.decode_fn(n)(params, tok0, 0, enc)
        assert torch.equal(got, eager(n, enc)), n
        outs.append(got)
    assert (ss.graph.captures, ss.graph.replays) == (1, 17)
    assert not torch.equal(outs[0][:5], outs[1])
    got, _ = ss.decode_fn(3)(params, tok0, 0, encs[0][:, :12].contiguous())
    assert torch.equal(got, eager(3, encs[0][:, :12]))
    assert ss.graph.captures == 2


def test_mla_layer_on_card_matches_cpu(cuda):
    """deepseek-v3-671b's dense MLA layer (smoke widths) in f32 on the card
    against the same call on the CPU, prefill and three absorbed decode
    steps, within 1e-5."""
    from repro_torch.configs import get_config
    from repro_torch.models import Runtime, blocks
    cfg = dataclasses.replace(get_config("deepseek-v3-671b", smoke=True),
                              compute_dtype="float32")
    bcfg = cfg.groups[0].blocks[0]
    p = blocks.block_params(torch.Generator().manual_seed(5), bcfg, cfg,
                            torch.float32, "cpu")
    pd = {k: {n: t.to(cuda) for n, t in v.items()} for k, v in p.items()}
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 64, 128)).astype(np.float32))
    pos = torch.arange(64)[None].expand(2, 64)
    want = blocks.block_apply(p, x, bcfg, cfg, Runtime("cpu"), pos)
    got = blocks.block_apply(pd, x.to(cuda), bcfg, cfg, Runtime(cuda),
                             pos.to(cuda))
    assert rel(got.cpu(), want) < 1e-5
    c = blocks.block_init_cache(bcfg, cfg, 2, 8, torch.float32, "cpu")
    cd = blocks.block_init_cache(bcfg, cfg, 2, 8, torch.float32, cuda)
    for t in range(3):
        w, _ = blocks.block_decode(p, x[:, t], c, bcfg, cfg, Runtime("cpu"),
                                   t)
        g, _ = blocks.block_decode(pd, x[:, t].to(cuda), cd, bcfg, cfg,
                                   Runtime(cuda), torch.tensor(t, device=cuda))
        assert rel(g.cpu(), w) < 1e-5, t
    assert rel(cd["ckv"].cpu(), c["ckv"]) < 1e-5


# --------------------------------------------------------------------------
# the persistent program store, fault plans and granite training


@pytest.mark.parametrize("name", ["fft_redistribute", "bucketed_sync8"])
def test_store_round_trip_replays_captured_program_on_card(cuda, tmp_path,
                                                           name):
    """A canned trace recorded on the card into a store, then run by a
    fresh cache on the same directory: the schedule is a verified disk hit
    (no search), the warm program is captured and replayed in its trial
    as the cold one was, and every run is bit-equal to the cold run's,
    with the same ledger."""
    from repro_torch.core.program import TRIAL_CALLS
    cold, cled, cpc = _canned_on_card(
        name, "compiled", cuda, pc=tlpf.ProgramCache(persist_dir=str(
            tmp_path)))
    assert cpc.stats.misses == 1 and len(cpc.store) == 1
    warm, wled, wpc = _canned_on_card(
        name, "compiled", cuda, pc=tlpf.ProgramCache(persist_dir=str(
            tmp_path)))
    assert (wpc.stats.misses, wpc.stats.disk_hits,
            wpc.stats.invalidated) == (0, 1, 0)
    (key,) = wpc.keys()
    assert wpc.certificate(key).ok
    (cp,) = wpc.artifacts()
    assert cp.n_replays >= TRIAL_CALLS and not wpc.quarantined
    for a, b in zip(cold, warm):
        for sid in a:
            assert torch.equal(a[sid], b[sid]), sid
    assert [dataclasses.asdict(r) for r in cled] == \
        [dataclasses.asdict(r) for r in wled]


def test_compile_seam_falls_back_from_capture_to_dispatch(cuda):
    """``compile@0`` fails the program's CUDA-graph compilation: the key is
    quarantined on the card and every flush dispatches the same certified
    schedule — values bit-equal to recorded order, the dispatched run's
    ledger."""
    from repro_torch.runtime import faults
    (ref,), _, _ = _canned_on_card("bucketed_sync8", "ref", cuda)
    _, dled, _ = _canned_on_card("bucketed_sync8", "dispatched", cuda)
    with faults.inject(faults.FaultPlan.parse("compile@0")) as inj:
        runs, led, pc = _canned_on_card("bucketed_sync8", "compiled", cuda,
                                        n_runs=3)
    assert inj.fired == [("compile", 0, "default")]
    (key,) = pc.keys()
    ((qkey, devices),) = pc.quarantined.items()
    assert qkey == key and len(devices) == 1
    assert pc.compile_quarantined(key, next(iter(devices)))
    assert next(iter(devices)).startswith("cuda")
    assert pc.stats.compile_fallbacks == 1 and pc.artifacts() == []
    for got in runs:
        for sid in ref:
            assert torch.equal(got[sid], ref[sid]), sid
    assert [dataclasses.asdict(r) for r in led] == \
        [dataclasses.asdict(r) for r in dled]


def test_granite_train_step_launch_counts(cuda):
    """One granite-moe-3b-a800m train step (smoke widths with 6 query and
    2 K/V heads of 64, ``ep_degree=1``, flash attention): a forward launch an attention layer a
    forward (two forwards under ``remat="full"``), one launch of each
    backward kernel an attention layer, a finite loss within 1e-2 of the
    reference attention's."""
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.launch import one_card_config
    from repro_torch.models import loss_fn
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train_step import build_train_step
    # the smoke widths with granite's published group of 3 at head dim 64
    base = dataclasses.replace(one_card_config("granite-moe-3b-a800m",
                                               smoke=True),
                               n_heads=6, n_kv=2, head_dim=64)
    cfg = dataclasses.replace(base, attn_impl="flash")
    ts = build_train_step(cfg, opt_cfg=AdamWConfig(lr=1e-3))
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=128,
                                        global_batch=2))
    params, opt = ts.init_fn(0)
    batch = {k: torch.from_numpy(v).to(cuda)
             for k, v in stream.batch(0).items()}
    with torch.no_grad():
        want = loss_fn(params, batch, dataclasses.replace(
            base, attn_impl="reference"), ts.rt).item()
    for fn in (fa_kernel.flash_attention_fwd,
               fa_kernel.flash_attention_bwd_dkv,
               fa_kernel.flash_attention_bwd_dq):
        fn.launches = 0
    params, opt, m = ts.step_fn(params, opt, batch)
    loss = m["loss"].item()
    attn = sum(g.repeats * sum(b.mixer == "attn" for b in g.blocks)
               for g in cfg.groups)
    fwd = attn * (2 if cfg.remat == "full" else 1)
    assert (fa_kernel.flash_attention_fwd.launches,
            fa_kernel.flash_attention_bwd_dkv.launches,
            fa_kernel.flash_attention_bwd_dq.launches) == (fwd, attn, attn)
    assert np.isfinite(loss) and abs(loss - want) < 1e-2 * want


# --------------------------------------------------------------------------
# virtual pods and split-phase overlap on CUDA streams
# --------------------------------------------------------------------------

def pod_grads(q, dev, layers=4, elems=1 << 12, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {f"l{i}": torch.randn(q, elems, generator=gen).to(dev)
            for i in range(layers)}


@pytest.mark.parametrize("route", ["dispatched", "compiled"])
def test_overlap_group_on_stream_pool_matches_one_stream(cuda, route,
                                                         monkeypatch):
    """The ``bucket_sync`` program's overlap groups (four buckets' reduce-
    scatters, then their all-gathers) issue their start halves on side
    streams of the pool when captured as a CUDA graph, and on the current
    stream when dispatched; either way the values are bit-equal to the
    one-stream run (``LPF_OVERLAP_STREAMS=0``)."""
    from repro_torch.bsp import build_cross_pod_sync
    from repro_torch.core import sync as tsync
    from repro_torch.launch.mesh import make_mesh
    grads = pod_grads(4, cuda)
    sync = build_cross_pod_sync(make_mesh((4, 1, 1)), None,
                                bucket_bytes=(1 << 12) * 4)
    monkeypatch.setenv("LPF_COMPILE_PROGRAMS",
                       "1" if route == "compiled" else "0")
    runs = {}
    for pool in (False, True):
        if pool:
            monkeypatch.delenv("LPF_OVERLAP_STREAMS", raising=False)
        else:
            monkeypatch.setenv("LPF_OVERLAP_STREAMS", "0")
        tlpf.global_program_cache().clear()
        streams = []
        real = tsync.begin_plan

        def spy(*a, **kw):
            streams.append(torch.cuda.current_stream(cuda))
            return real(*a, **kw)

        monkeypatch.setattr(tsync, "begin_plan", spy)
        outs = [sync(grads) for _ in range(8)]   # the compiled trial
        monkeypatch.setattr(tsync, "begin_plan", real)
        # the pool's streams (a capture runs on a stream of its own)
        side = {s.stream_id for s in streams} & {
            s.stream_id for pool_ in tsync._STREAM_POOLS.values()
            for s in pool_}
        assert bool(side) == (pool and route == "compiled"), \
            (pool, route, len(side))
        if side:
            assert len(side) == 4
        if route == "compiled":
            arts = tlpf.global_program_cache().artifacts()
            assert arts and all(a.captured or a.use_graph is False
                                for a in arts)
            assert any(a.n_replays > 0 for a in arts)
        for o in outs[1:]:
            for k in o:
                assert torch.equal(o[k], outs[0][k]), k
        runs[pool] = outs[-1]
    for k in grads:
        assert torch.equal(runs[True][k], runs[False][k]), k
        want = grads[k].mean(0, keepdim=True).expand_as(grads[k])
        assert torch.allclose(runs[True][k], want, rtol=1e-6, atol=1e-6)
    tlpf.global_program_cache().clear()


POD_METHODS = [("rs+ag", None), ("bucketed", 1 << 14),
               ("bucketed_fenced", 1 << 14), ("bucketed_overlap", 1 << 14),
               ("bucketed_overlap", 1), ("ring", None), ("int16", None)]


@pytest.mark.parametrize("q", [2, 4])
@pytest.mark.parametrize("method,bucket", POD_METHODS)
def test_pod_allreduce_on_card_matches_cpu(cuda, q, method, bucket):
    """Every ``pod_allreduce`` method on the card against the CPU: bit-equal
    at q = 2 and under compression (int16 sums are exact), within 1e-6
    relative at q = 4; the same ledger."""
    from repro_torch.bsp.pod_sync import pod_allreduce
    kw = dict(method=method, bucket_bytes=bucket)
    if method == "int16":
        kw = dict(method="ring", attrs=tlpf.SyncAttributes(
            compress=tlpf.CompressSpec(bits=8)))
    grads = pod_grads(q, "cpu", layers=6, elems=5000, seed=q)
    grads["bf16"] = grads.pop("l5").to(torch.bfloat16)
    led_c, led_g = tlpf.CostLedger(), tlpf.CostLedger()
    want = pod_allreduce(grads, q, ledger=led_c, **kw)
    got = pod_allreduce({k: v.to(cuda) for k, v in grads.items()}, q,
                        ledger=led_g, **kw)
    assert led_c.records == led_g.records
    for k in grads:
        g = got[k].cpu()
        assert g.dtype == want[k].dtype and g.shape == want[k].shape
        if q == 2 or method == "int16":
            assert torch.equal(g, want[k]), k
        else:
            assert torch.allclose(g.float(), want[k].float(), rtol=1e-6,
                                  atol=1e-6 * want[k].abs().max().item())


def test_pod_train_step_on_card(cuda):
    """One pod step of the smoke config over a 2x1x1 mesh on the card:
    loss and ``grad_norm`` within 1e-4 of the same step on the CPU, the
    bucketed-overlap step's parameters bit-equal to the flat one's, each
    flash kernel launched by both pods (twice the forward under full
    remat), the ledger as on the CPU."""
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train_step import build_train_step
    cfg = smoke_cfg(attn_impl="flash", compute_dtype="float32")
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=128,
                                        global_batch=4))
    b = stream.batch(0)

    from repro_torch.interop import params_from_jax, params_to_numpy
    from repro_torch.optim import adamw_init
    weights = params_to_numpy(build_train_step(cfg, device="cpu").init_fn(
        0)[0])

    def step(dev, **kw):
        ts = build_train_step(cfg, make_mesh((2, 1, 1)), grad_sync="lpf",
                              opt_cfg=AdamWConfig(lr=1e-3), device=dev,
                              **kw)
        params = params_from_jax(weights, device=dev, trainable=True)
        out = ts.step_fn(params, adamw_init(params.tree()),
                         {k: torch.from_numpy(v).to(dev)
                          for k, v in b.items()})
        return out, ts.ledger

    (_, _, m_cpu), led_cpu = step("cpu")
    for fn in (fa_kernel.flash_attention_fwd,
               fa_kernel.flash_attention_bwd_dkv,
               fa_kernel.flash_attention_bwd_dq):
        fn.launches = 0
    (p_flat, _, m_flat), led = step(cuda)
    assert (fa_kernel.flash_attention_fwd.launches,
            fa_kernel.flash_attention_bwd_dkv.launches,
            fa_kernel.flash_attention_bwd_dq.launches) == (8, 4, 4)
    assert led.records == led_cpu.records
    for k in ("loss", "grad_norm"):
        assert abs(m_flat[k].item() - m_cpu[k].item()) < \
            1e-4 * abs(m_cpu[k].item())
    (p_ovl, _, m_ovl), _ = step(cuda, grad_bucket_bytes=1 << 14)
    assert torch.equal(m_ovl["grad_norm"], m_flat["grad_norm"])
    for a, c in zip(p_ovl.parameters(), p_flat.parameters()):
        assert torch.equal(a, c)
