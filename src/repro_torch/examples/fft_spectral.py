"""Immortal FFT in use: distributed spectral filtering on the port.

A noisy multi-tone signal is transformed with the LPF BSP FFT (paper
§4.2, Inda–Bisseling), low-pass filtered in the frequency domain, and
transformed back — all over 8 virtual processes with one total exchange
per transform.  The ledger shows the exact h-relation the immortal
analysis promises: (n/p)(p-1)/p elements per process per exchange.

Run:  PYTHONPATH=src python -m repro_torch.examples.fft_spectral
      (``--device cpu`` without a card)
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..algorithms import bsp_fft, fft_h_bytes
from ..core import H100_SXM, probe

N = 1 << 14
P = 8
CUTOFF = 200


def signal(n: int = N):
    """The clean two-tone signal and its noisy copy (seed 0)."""
    rng = np.random.default_rng(0)
    t = np.arange(n) / n
    clean = np.sin(2 * np.pi * 50 * t) + 0.5 * np.sin(2 * np.pi * 120 * t)
    return clean, clean + 0.8 * rng.standard_normal(n)


def run(device="cuda") -> dict:
    """The forward transform with its ledger, the low-pass mask of
    ``CUTOFF`` bins on each side, the inverse, and the RMS errors."""
    clean, noisy = signal()
    spectrum, ledger = bsp_fft(noisy.astype(np.complex64), p=P,
                               return_ledger=True, device=device)
    keep = torch.zeros(N, device=spectrum.device)
    keep[:CUTOFF] = 1.0
    keep[-CUTOFF:] = 1.0
    filtered = bsp_fft(spectrum * keep, p=P, inverse=True, device=device)
    recovered = filtered.real.cpu().numpy()
    return dict(
        n=N, p=P, spectrum=spectrum,
        rms_before=float(np.sqrt(np.mean((noisy - clean) ** 2))),
        rms_after=float(np.sqrt(np.mean((recovered - clean) ** 2))),
        h_bytes=ledger.h_bytes, predicted_h_bytes=fft_h_bytes(N, P),
        ledger=ledger, hardware=H100_SXM.name,
        report=ledger.report(probe({"vp": P}, H100_SXM)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; refused without a card) or "
                         "cpu")
    res = run(ap.parse_args(argv).device)
    print(f"n = {res['n']}, p = {res['p']}")
    print(f"RMS error before filtering: {res['rms_before']:.3f}")
    print(f"RMS error after filtering:  {res['rms_after']:.3f}")
    print(f"\npredicted immortal h-relation: {res['predicted_h_bytes']} "
          f"bytes")
    print(f"ledger h-relation:             {res['h_bytes']} bytes")
    print(f"(predicted costs on {res['hardware']})")
    print(res["report"])
    ok = res["rms_after"] < res["rms_before"] / 2 and \
        res["h_bytes"] == res["predicted_h_bytes"]
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
