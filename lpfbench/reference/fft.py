"""The FFT cell's references.

:func:`fft_reference` is the transform in complex128 (``torch.fft`` on
the inputs cast up), against which the program's complex64 output is
judged.  :func:`fft_matmul` is the same transform as a four-step
decomposition whose DFTs are dense real matrix products: with TF32
allowed it is the control, the reference computed one precision below
the float32 that the configuration states."""

from __future__ import annotations

import math

import torch

#: the largest DFT :func:`fft_matmul` does as one dense product
MAX_DFT = 512


def fft_reference(x: torch.Tensor) -> torch.Tensor:
    """The complex128 FFT of ``x`` (1-D, any complex dtype)."""
    return torch.fft.fft(x.to(torch.complex128))


def compare(y: torch.Tensor, ref: torch.Tensor) -> dict:
    """The two numbers judged for one transform: the relative L2 error,
    and the largest error of one value over the reference's RMS value
    (an altered value shows there even where the L2 error stays
    small)."""
    if y.shape != ref.shape or not bool(torch.isfinite(
            torch.view_as_real(y)).all()):
        return {"rel_l2": math.inf, "max_err": math.inf}
    d = y.to(torch.complex128) - ref
    ref_ss = ref.abs().square().sum()
    rel_l2 = (d.abs().square().sum() / ref_ss).sqrt().item()
    rms = (ref_ss / ref.numel()).sqrt()
    return {"rel_l2": rel_l2, "max_err": (d.abs().max() / rms).item()}


def _dft_matrix(n: int, device) -> tuple:
    k = torch.arange(n, dtype=torch.float64, device=device)
    ang = -2.0 * math.pi * torch.outer(k, k).remainder(n) / n
    return torch.cos(ang).float(), torch.sin(ang).float()


def _cmatmul(ar, ai, br, bi):
    """(ar + i ai) @ (br + i bi) as four real products."""
    return ar @ br - ai @ bi, ar @ bi + ai @ br


def _fft_rows(re: torch.Tensor, im: torch.Tensor) -> tuple:
    """FFT along the last axis of float32 ``re + i im`` [..., n], n a
    power of two: n <= MAX_DFT as one product, else n = n1 * n2 with a
    DFT over n1 (one product), the twiddle, and the n2-point FFTs."""
    n = re.shape[-1]
    dev = re.device
    if n <= MAX_DFT:
        fr, fi = _dft_matrix(n, dev)
        return _cmatmul(re, im, fr, fi)       # F is symmetric
    n1 = MAX_DFT
    n2 = n // n1
    lead = re.shape[:-1]
    # j = j1 n2 + j2: the n1-point DFT over j1, for each j2
    r = re.reshape(*lead, n1, n2).transpose(-1, -2)
    i = im.reshape(*lead, n1, n2).transpose(-1, -2)
    fr, fi = _dft_matrix(n1, dev)
    r, i = _cmatmul(r, i, fr, fi)            # [..., j2, k1]
    # twiddle w_n^(j2 k1)
    j2 = torch.arange(n2, dtype=torch.float64, device=dev)
    k1 = torch.arange(n1, dtype=torch.float64, device=dev)
    ang = (-2.0 * math.pi / n) * torch.outer(j2, k1)
    tr, ti = torch.cos(ang).float(), torch.sin(ang).float()
    r, i = r * tr - i * ti, r * ti + i * tr
    # the n2-point FFTs over j2, for each k1: k = k1 + n1 k2
    r, i = _fft_rows(r.transpose(-1, -2).contiguous(),
                     i.transpose(-1, -2).contiguous())   # [..., k1, k2]
    return (r.transpose(-1, -2).reshape(*lead, n),
            i.transpose(-1, -2).reshape(*lead, n))


def fft_matmul(x: torch.Tensor, tf32: bool) -> torch.Tensor:
    """The FFT of the complex64 vector ``x`` by dense float32 products;
    ``tf32`` lets them run in TF32 (the control)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        re, im = _fft_rows(x.real.float().contiguous(),
                           x.imag.float().contiguous())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return torch.complex(re, im)
