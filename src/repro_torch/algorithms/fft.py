"""The immortal BSP FFT (Inda & Bisseling, paper ref [10]) on the port.

Radix-p decomposition with a *single* data redistribution, valid whenever
``n >= p**2``.  Writing the input index ``j = l*p + s`` (cyclic over
processes) and the output index ``k = k2 + (n/p)*k1``:

    y[k2 + (n/p) k1] = sum_s  w_p^{s k1} * ( w_n^{s k2} * X_s[k2] )

where ``X_s = FFT_{n/p}(x_s)`` is a process-local FFT of the cyclic slice:

  (0) local ``n/p``-point FFT of the cyclic-distributed input,
  (1) local twiddle by ``w_n^{s k2}``,
  (2) ONE total exchange — blocks of ``n/p**2`` — so each process owns a
      contiguous ``k2`` range for all ``s``;   cost  (n/p)g + l,
  (3) local ``p``-point DFTs across the gathered ``s`` dimension, a dense
      [p, p] twiddle matmul,
  (4) *optional* second exchange to produce naturally-ordered output
      (``ordered=True``).

On the port the ``p`` processes are virtual processes stacked on one
device, so step (0) is ONE batched FFT over the ``[p, n/p]`` rows: the
CUDA kernel ``fft_stage`` when ``use_kernel=True``, else ``torch.fft``.

Under a profiler a call is the span ``fft.call``, and steps (0), (1) and
(3) the spans ``fft.local``, ``fft.twiddle`` and ``fft.dft``
(:mod:`repro_torch.core.trace`).

BSP cost:  2 (n/p) log(n/p + p) flops  +  (n/p)(p-1)/p * itemsize * g
           + l   (unordered; ordered doubles the comm term), itemsize 8
           for complex64 and 16 for complex128.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import (H100_SXM, LPF_SYNC_DEFAULT, HardwareModel, LPFContext,
                    SyncAttributes, exec_)
from ..core.trace import span

__all__ = ["bsp_fft_spmd", "bsp_fft", "fft_flops", "fft_h_bytes"]


def fft_flops(n: int) -> float:
    """Standard 5 n log2 n flop count for a complex FFT."""
    return 5.0 * n * math.log2(max(n, 2))


def fft_h_bytes(n: int, p: int, ordered: bool = True,
                itemsize: int = 8) -> int:
    """Predicted h-relation (bytes) of the BSP FFT — the immortal cost.
    ``itemsize`` is the *complex* element width: 8 for complex64, 16 for
    complex128."""
    if p == 1:
        return 0
    one = (n // p) * (p - 1) // p * itemsize
    return (2 * one) if ordered else one


@span("fft.local")
def _local_fft(x: torch.Tensor, use_kernel: bool) -> torch.Tensor:
    if use_kernel:
        from ..kernels.fft_stage import ops as fft_ops
        return fft_ops.fft(x)
    return torch.fft.fft(x)


def bsp_fft_spmd(ctx: LPFContext, x_local: torch.Tensor, n: int, *,
                 ordered: bool = True, use_kernel: bool = False,
                 attrs: SyncAttributes = LPF_SYNC_DEFAULT,
                 inverse: bool = False) -> torch.Tensor:
    """Run the immortal FFT over the context's ``p`` virtual processes.

    ``x_local``: ``[p, n/p]``, row ``s`` the *cyclic* slice
    ``x[s::p]``, complex64/128.  Returns ``[p, n/p]``: row ``s`` the
    contiguous block ``y[s*(n/p) : (s+1)*(n/p)]`` when ``ordered``, else
    the algorithm's native unordered block.
    """
    p, s = ctx.p, ctx.pid
    npp = n // p
    if n % (p * p) != 0 and p > 1:
        raise ValueError(f"BSP FFT requires p^2 | n (got n={n}, p={p})")
    if tuple(x_local.shape) != (p, npp):
        raise ValueError(f"local slices must be [p, n/p]=[{p}, {npp}], "
                         f"got {tuple(x_local.shape)}")
    ctype = x_local.dtype
    sign = 1.0 if inverse else -1.0

    # (0) local FFT of the cyclic slices (conj-trick for the inverse)
    if inverse:
        X = torch.conj(_local_fft(torch.conj(x_local), use_kernel))
    else:
        X = _local_fft(x_local, use_kernel)

    if p == 1:
        return X / n if inverse else X

    # (1) time-shifted twiddle  w_n^{+- s k2}, built in the real dtype
    # matching the input's precision (float64 for complex128 inputs)
    with span("fft.twiddle"):
        real_dt = ctype.to_real()
        k2 = torch.arange(npp, dtype=real_dt, device=ctx.device)
        phase = (s.to(real_dt) * k2 / n) * torch.tensor(
            sign * 2.0 * np.pi, dtype=real_dt, device=ctx.device)
        Z = X * torch.complex(torch.cos(phase), torch.sin(phase)).to(ctype)

    # (2)-(4) run recorded: the twiddle matmul is a compute dependency
    # between redistribute and reorder, so reading Zk flushes exactly the
    # redistribute's cone
    with ctx.program("bsp_fft"):
        # (2) the single redistribution: block d of my k2-range to process d
        w = npp // p  # n / p^2 elements per (src, dst) pair
        ctx.resize_memory_register(ctx.registry.n_active + 2)
        ctx.resize_message_queue(p * p)
        src = ctx.register_global("fft.src", Z)
        dst = ctx.register_global(
            "fft.buf", torch.zeros(p, p * w, dtype=ctype, device=ctx.device))
        ctx.put_msgs([(s_, d, src, d * w, dst, s_ * w, w)
                      for s_ in range(p) for d in range(p)])
        ctx.sync(attrs, label="fft.redistribute")
        Zk = ctx.tensor(dst).reshape(p, p, w)   # [pid, s, k2_local]
        ctx.deregister(src)

        # (3) p-point DFTs across s as a dense twiddle matmul
        with span("fft.dft"):
            k1 = np.arange(p)
            Wp = torch.from_numpy(
                np.exp(sign * 2j * np.pi * np.outer(k1, k1) / p)).to(
                    device=ctx.device, dtype=ctype)
            Y = torch.matmul(Wp, Zk)             # [pid, k1, k2_local]

        if not ordered:
            ctx.deregister(dst)
            out = Y.reshape(p, npp)
            return out / n if inverse else out

        # (4) ordering pass: row k1 belongs to process k1
        ctx.resize_memory_register(ctx.registry.n_active + 2)
        ctx.resize_message_queue(p * p)
        osrc = ctx.register_global("fft.osrc", Y.reshape(p, npp))
        odst = ctx.register_global(
            "fft.odst", torch.zeros(p, npp, dtype=ctype, device=ctx.device))
        # my row k1=d (length w) goes to process d at offset (my pid)*w
        ctx.put_msgs([(s_, d, osrc, d * w, odst, s_ * w, w)
                      for s_ in range(p) for d in range(p)])
        ctx.sync(attrs, label="fft.reorder")
        yl = ctx.tensor(odst)
        ctx.deregister(dst)
        ctx.deregister(osrc)
        ctx.deregister(odst)
    return yl / n if inverse else yl


@span("fft.call")
def bsp_fft(x, *, p: int = 8, ordered: bool = True,
            use_kernel: bool = False, inverse: bool = False,
            attrs: SyncAttributes = LPF_SYNC_DEFAULT,
            return_ledger: bool = False, device="cuda",
            hardware: HardwareModel = H100_SXM, **caches):
    """Whole-vector entry point: ``lpf_exec`` the immortal FFT over ``p``
    virtual processes on ``device`` (the card unless the caller asks for
    the CPU).  ``x`` (a tensor or numpy array of length n) is laid out
    cyclically, the SPMD FFT runs, and the naturally-ordered result is
    returned as a 1-D tensor on the device.  A real input is cast to
    complex64.  ``caches`` (``plan_cache``, ``program_cache``,
    ``persist_dir``) go to :func:`~repro_torch.core.exec_`."""
    x = torch.as_tensor(x)
    if not x.is_complex():
        x = x.to(torch.complex64)
    n = int(x.shape[0])
    xc = x.reshape(n // p, p).T   # cyclic layout: row s holds x[s::p]

    def spmd(ctx, s, pp, xt):
        return bsp_fft_spmd(ctx, xt.contiguous(), n, ordered=ordered,
                            use_kernel=use_kernel, attrs=attrs,
                            inverse=inverse)

    out = exec_(p, spmd, xc, device=device, hardware=hardware,
                return_ledger=return_ledger, **caches)
    if return_ledger:
        out, ledger = out
    y = out.reshape(-1)
    if not ordered:
        # undo the unordered layout: process s holds [k1, k2local] with
        # k2local in block s
        y = y.reshape(p, p, n // (p * p)).permute(1, 0, 2).reshape(-1)
    return (y, ledger) if return_ledger else y
