"""ctypes wrapper of the CUDA kernel ``csrc/fft_stage.cu`` — the Hopper
port of the TPU kernel ``fft_planes`` (``repro/kernels/fft_stage/kernel.py``).

:func:`fft_planes` transforms ``[batch, n]`` complex64 rows on a CUDA
device.  Where the TPU kernel took separate re/im f32 planes, this one
reads and writes interleaved complex64 (``float2``) directly; the name is
kept so each counterpart is found.  The rows go through the passes of
:func:`pass_plan` — a four-step split, one pass for rows of up to 2^12
points, two up to 2^22, three up to 2^33 — each pass one CUDA launch that
moves the rows once through device memory.  Two or three passes write
through one scratch buffer allocated here.

``fft_planes.launches`` counts the calls that launched the kernel;
``fft_planes.cuda_launches`` counts the CUDA kernel launches they made.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List

import torch

from ...core.errors import LPFFatalError
from .. import build

__all__ = ["FFTPass", "TILE", "fft_planes", "pass_plan"]

#: points a tile holds: C sequences of T (``csrc/fft_stage.cu``'s TILE)
TILE = 8192
#: the largest sub-transform of a pass when there are two or more: a tile
#: then still holds C = 4 columns (32-byte runs)
MAX_T = TILE // 4
#: a row runs whole in one pass up to ONE_PASS * max_t points (C = 2)
ONE_PASS = 2
#: the most passes a plan has (n up to MAX_T^3 = 2^33, 64 GiB a row)
MAX_PASSES = 3
#: shared memory a block may use (H100: 227 KB)
SMEM_LIMIT = 232448

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_void_p]


@dataclasses.dataclass(frozen=True)
class FFTPass:
    """One pass of the four-step split (``csrc/fft_stage.cu``'s note).

    ``col``: each row viewed as ``[s, t, a]``; the t-point DFT along the
    middle axis, output k of inner index i times w_{t a}^{i k}, written
    back in the same layout.  ``row``: the t-point DFT of each contiguous
    run of t points, sequence ``d1 * m + dm`` writing output k to
    ``d1 + r1 * dm + s * k``.  A block stages ``c`` sequences of ``seq``
    shared-memory slots each."""

    kind: str
    t: int
    s: int
    a: int
    r1: int
    m: int
    c: int
    seq: int

    @property
    def smem_bytes(self) -> int:
        """The kernel's dynamic shared memory: two staged tiles (the TMA
        ring), the padded work buffer, the table of w_t (its first half
        from t = 2^12 on), the second stage's table (256 entries), four
        barriers."""
        def lines(b):
            return -(-b // 128) * 128
        table = self.t if self.t <= 1 << 11 else self.t // 2
        return 2 * TILE * 8 + lines(self.c * self.seq * 8) \
            + lines(table * 8) + 256 * 8 + 32


def _log2(v: int) -> int:
    return v.bit_length() - 1


def seq_slots(t: int, c: int) -> int:
    """Work-buffer slots of one of ``c`` t-point sequences: one pad slot
    every 16 points, and a stride of (16 / c) times an odd number, so that
    the c sequences of a half-warp's runs fall on different banks (0: one
    stage, no exchange)."""
    if t <= 16:
        return 0
    unit = 16 // c if c < 16 else 1
    odd = -(-(t + t // 16) // unit)
    return (odd + 1 - odd % 2) * unit


def _pass(kind, t, s, a=1, r1=1, m=1, inner=None) -> FFTPass:
    c = TILE // t
    if inner is not None:
        c = min(c, inner)
    return FFTPass(kind, t, s, a, r1, m, c, seq_slots(t, c))


def pass_plan(n: int, max_t: int = MAX_T) -> List[FFTPass]:
    """The passes of an n-point row (n a power of two >= 2): one row pass
    for n <= ONE_PASS * max_t; else two or three factors of at most
    ``max_t``, split as evenly as they go, the largest last.  ``max_t``
    below the kernel's (the CPU tests) gives the same algebra at small n."""
    if n < 2 or n & (n - 1):
        raise LPFFatalError(f"fft_planes needs a power-of-two n >= 2, got {n}")
    bits, top = _log2(n), _log2(max_t)
    if n <= ONE_PASS * max_t:
        return [_pass("row", n, 1)]
    parts = -(-bits // top)
    if parts > MAX_PASSES:
        raise LPFFatalError(
            f"fft_planes takes rows of up to {max_t ** MAX_PASSES} points "
            f"({MAX_PASSES} passes of {max_t}), got n={n}")
    logs = []
    for i in range(parts):               # smallest first
        logs.append((bits - sum(logs)) // (parts - i))
    ts = [1 << b for b in logs]
    plan, s = [], 1
    for t in ts[:-1]:
        a = n // (s * t)
        plan.append(_pass("col", t, s, a=a, inner=a))
        s *= t
    r1, m = ts[0], s // ts[0]
    plan.append(_pass("row", ts[-1], s, r1=r1, m=m, inner=r1))
    return plan


def _lib() -> ctypes.CDLL:
    lib = build.load("fft_stage")
    fn = lib.fft_stage_pass
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return lib


def fft_planes(x: torch.Tensor, *, inverse: bool = False) -> torch.Tensor:
    """Batched FFT of the rows of a contiguous complex64 CUDA tensor
    ``[batch, n]``, n a power of two >= 2; the inverse scales by 1/n.
    Returns a new tensor; ``x`` is not modified."""
    if x.device.type != "cuda":
        raise LPFFatalError(f"fft_planes needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.complex64 or x.ndim != 2 or not x.is_contiguous() \
            or x.is_conj() or x.is_neg():
        raise LPFFatalError(
            f"fft_planes takes a contiguous, materialised complex64 "
            f"[batch, n] tensor, got {x.dtype} {tuple(x.shape)} "
            f"contiguous={x.is_contiguous()} lazy conj/neg="
            f"{x.is_conj() or x.is_neg()}")
    plan = pass_plan(x.shape[1])
    if x.data_ptr() % 16:
        x = x.clone()       # TMA reads 16-byte aligned rows
    return _run(x, plan, inverse)


def _run(x: torch.Tensor, plan: List[FFTPass], inverse: bool) -> torch.Tensor:
    """Launch ``plan``'s passes over ``x`` (checked by the caller); a
    measurement may hand it another plan of the same n."""
    batch, n = x.shape
    fn = _lib().fft_stage_pass
    out = torch.empty_like(x)
    # a col pass may run in place: every pass but the last writes ``tmp``
    tmp = torch.empty_like(x) if len(plan) > 1 else out
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        src = x
        for i, p in enumerate(plan):
            last = i == len(plan) - 1
            dst = out if last else tmp
            rc = fn(ctypes.c_void_p(src.data_ptr()),
                    ctypes.c_void_p(dst.data_ptr()), batch, n,
                    int(p.kind == "col"), _log2(p.t), p.s, p.a, _log2(p.r1),
                    _log2(p.m), _log2(p.c), p.seq, int(inverse),
                    1.0 / n if inverse and last else 1.0, stream)
            if rc != 0:
                raise LPFFatalError(
                    f"fft_stage pass {i} of {len(plan)} ({p.kind}, T={p.t}, "
                    f"C={p.c}, {p.smem_bytes} bytes of shared memory; n={n}, "
                    f"batch={batch}) failed to launch: CUDA error {rc}")
            fft_planes.cuda_launches += 1
            src = dst
    fft_planes.launches += 1
    return out


fft_planes.launches = 0
fft_planes.cuda_launches = 0
