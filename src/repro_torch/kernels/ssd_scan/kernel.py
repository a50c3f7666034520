"""ctypes wrapper of the CUDA kernel ``csrc/ssd_scan.cu`` — the Hopper port
of the TPU kernel ``ssd_scan`` (``repro/kernels/ssd_scan/kernel.py:75``).

:func:`ssd_scan` takes x ``[B,S,H,P]``, dt ``[B,S,H]`` (f32), a ``[H]``
(f32) and b, c ``[B,S,G,N]`` (x, b and c all f32 or all bf16, on one CUDA
device) and returns ``(y [B,S,H,P] in x's dtype, final_state [B,H,N,P]
f32)``.  x, dt, b and c are read in place through their strides, so the
model's slices of the convolution output need no copy; x, b and c must be
unit-stride along P and N.  The chunk length is ``L = min(chunk, S)``; a
ragged tail is masked (:mod:`.ref` says how).

Limits of this kernel: L <= 128, N a multiple of 4 up to 128, P a
multiple of 16.  Anything else raises
:class:`~repro_torch.core.errors.LPFFatalError`; nothing falls back to the
plain version.  ``ssd_scan.launches`` counts the calls that launched the
kernel (one CUDA launch each).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ...core.errors import LPFFatalError
from .. import build

__all__ = ["ssd_scan", "pick_columns", "MAX_L", "MAX_N"]

#: the kernel's limits: at L 128, N 128 a block takes 220,672 bytes of
#: shared memory, of the 232,448 an H100 block may use
MAX_L = 128
MAX_N = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# x, dt, a, b, c, y, state, dtype, B, S, H, P, G, N, L, PB, 12 strides,
# stream
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
             + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])


def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    fn = lib.ssd_scan
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return lib


def pick_columns(B: int, H: int, P: int, L: int, N: int, sms: int) -> int:
    """The columns of P a block takes (16, 32 or 64): the fewest
    block-waves over ``sms`` multiprocessors times one block's FMAs a chunk
    (the causal half of C B^T and of M x, the full inter and state
    products), the widest slice on a tie.  Splitting P fills the card when
    B x H is small, at the price of recomputing C B^T in every slice."""
    best = None
    for pb in (64, 32, 16):
        if P % pb:
            continue
        waves = -(-(B * H * (P // pb)) // sms)
        cost = waves * (0.625 * L * L * (N + pb) + 2 * L * N * pb)
        if best is None or cost < best[0]:
            best = (cost, pb)
    return best[1]


def _check(x, dt, a, b, c, chunk: int) -> None:
    """Raise on anything the kernel does not take (the device last, so
    every other refusal shows without a card)."""
    fn = "ssd_scan"
    if x.ndim != 4 or dt.ndim != 3 or a.ndim != 1 or b.ndim != 4 \
            or c.shape != b.shape:
        raise LPFFatalError(
            f"{fn} takes x [B,S,H,P], dt [B,S,H], a [H], b and c [B,S,G,N]; "
            f"got {tuple(x.shape)}, {tuple(dt.shape)}, {tuple(a.shape)}, "
            f"{tuple(b.shape)}, {tuple(c.shape)}")
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if dt.shape != (B, S, H) or a.shape != (H,) or b.shape[:2] != (B, S) \
            or H % G:
        raise LPFFatalError(
            f"{fn}: shapes do not match x {tuple(x.shape)} (dt [B,S,H], a "
            f"[H], b/c [B,S,G,N] with G dividing H); got {tuple(dt.shape)}, "
            f"{tuple(a.shape)}, {tuple(b.shape)}")
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise LPFFatalError(
            f"{fn} takes float32 or bfloat16 x, b, c of one dtype, got "
            f"{x.dtype}, {b.dtype}, {c.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise LPFFatalError(f"{fn} takes float32 dt and a, got {dt.dtype}, "
                            f"{a.dtype}")
    for name, t in (("x", x), ("b", b), ("c", c)):
        if t.stride(-1) != 1:
            raise LPFFatalError(
                f"{fn} reads {name} along its last axis with unit stride; "
                f"{name} has strides {t.stride()}")
    if not a.is_contiguous():
        raise LPFFatalError(f"{fn} takes a contiguous a [H]")
    L = min(chunk, S)
    if not 1 <= L <= MAX_L:
        raise LPFFatalError(f"{fn}: chunk length min(chunk, S) = {L}; the "
                            f"kernel takes 1 to {MAX_L}")
    if N % 4 or not 4 <= N <= MAX_N:
        raise LPFFatalError(f"{fn}: d_state N = {N}; the kernel takes a "
                            f"multiple of 4 up to {MAX_N}")
    if P % 16:
        raise LPFFatalError(f"{fn}: head dim P = {P}; the kernel takes a "
                            f"multiple of 16")
    tensors = dict(x=x, dt=dt, a=a, b=b, c=c)
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise LPFFatalError(
                f"{fn} needs CUDA tensors, got {name} on {t.device}")
    if any(t.device != x.device for t in tensors.values()):
        raise LPFFatalError(f"{fn}: x, dt, a, b, c on different devices")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,H,P], dt [B,S,H], a [H], b/c [B,S,G,N] -> (y [B,S,H,P],
    final_state [B,H,N,P] f32)."""
    _check(x, dt, a, b, c, chunk)
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    L = min(chunk, S)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    pb = pick_columns(B, H, P, L, N, sms)
    y = torch.empty(B, S, H, P, dtype=x.dtype, device=x.device)
    state = torch.empty(B, H, N, P, dtype=torch.float32, device=x.device)
    fn = _lib().ssd_scan
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = fn(ptr(x), ptr(dt), ptr(a), ptr(b), ptr(c), ptr(y), ptr(state),
                _DTYPES[x.dtype], B, S, H, P, G, N, L, pb,
                *x.stride()[:3], *dt.stride(), *b.stride()[:3],
                *c.stride()[:3], stream)
    if rc != 0:
        raise LPFFatalError(f"ssd_scan failed to launch on {tuple(x.shape)} "
                            f"{x.dtype}: CUDA error {rc}")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
