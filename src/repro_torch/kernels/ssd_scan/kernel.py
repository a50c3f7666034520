"""ctypes wrapper of the CUDA kernel ``csrc/ssd_scan.cu`` — the Hopper port
of the TPU kernel ``ssd_scan`` (``repro/kernels/ssd_scan/kernel.py:75``).

:func:`ssd_scan` takes x ``[B,S,H,P]``, dt ``[B,S,H]`` (f32), a ``[H]``
(f32) and b, c ``[B,S,G,N]`` (x, b and c all f32 or all bf16, on one CUDA
device) and returns ``(y [B,S,H,P] in x's dtype, final_state [B,H,N,P]
f32)``.  x, dt, b and c are read in place through their strides, so the
model's slices of the convolution output need no copy; x, b and c must be
unit-stride along P and N.  The chunk length is ``L = min(chunk, S)``; a
ragged tail is masked (:mod:`.ref` says how).

A call is four CUDA launches on the current stream, the passes of
:func:`.ref.ssd_scan_passes` (:data:`PASSES`): C B^T once per (b, chunk,
group), each chunk's own state, the chain over chunks, and y.  The wrapper
allocates their scratch (:func:`grid_plan` gives the sizes).

Limits of this kernel: L <= 128, N a multiple of 4 up to 128, P a
multiple of 16.  Anything else raises
:class:`~repro_torch.core.errors.LPFFatalError`; nothing falls back to the
plain version.  ``ssd_scan.launches`` counts the calls that launched the
kernel; ``ssd_scan.cuda_launches`` counts the CUDA launches they made.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Tuple

import torch

from ...core.errors import LPFFatalError
from .. import build

__all__ = ["ssd_scan", "grid_plan", "GridPlan", "PASSES", "MAX_L", "MAX_N"]

MAX_L = 128
MAX_N = 128
#: columns of P a block of the chunk-state and chunk-scan passes takes
PB = 64
THREADS = 256
#: the launches of a call, in order (``grid_plan``'s keys)
PASSES = ("ssd_cb", "ssd_chunk_state", "ssd_state_pass", "ssd_chunk_scan")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class _Args(ctypes.Structure):
    """``struct SsdArgs`` of ``csrc/ssd_scan.cu``, field by field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "x", "dt", "a", "b", "c", "y", "state", "cum", "cb", "states")]
        + [(n, ctypes.c_int) for n in (
            "dtype", "B", "S", "H", "P", "G", "N", "L", "nc", "Lp", "Np")]
        + [(n, ctypes.c_longlong) for n in (
            "sxb", "sxs", "sxh", "sdb", "sds", "sdh", "sbb", "sbs", "sbg",
            "scb", "scs", "scg")])


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of a built ``ssd_scan`` library."""
    lib.ssd_scan.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p,
                             ctypes.POINTER(ctypes.c_int)]
    lib.ssd_scan.restype = ctypes.c_int
    lib.ssd_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.ssd_smem_bytes.restype = ctypes.c_longlong
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _bind(build.load("ssd_scan"))


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


@dataclasses.dataclass(frozen=True)
class GridPlan:
    """What one call launches: chunk length and its padding to the
    products' 16-row tiles, chunks, slices of P, the blocks of each pass
    (:data:`PASSES` order), and the scratch bytes."""
    L: int
    Lp: int
    Np: int
    nc: int
    p_slices: int
    blocks: Dict[str, int]
    scratch_bytes: int


def grid_plan(B: int, S: int, H: int, P: int, G: int, N: int, chunk: int
              ) -> GridPlan:
    """The launches of :func:`ssd_scan` for these shapes.  Passes A and C
    take one block per (b, chunk, head, 64 columns of P), C B^T one per (b,
    chunk, group, pair of 16-row tiles), the chain one thread per 4 state
    elements.  The C library's ``ssd_smem_bytes`` gives each pass's
    dynamic shared memory."""
    L = min(chunk, S)
    Lp, Np, nc = _up(L, 16), _up(N, 16), -(-S // L)
    slices = -(-P // PB)
    blocks = {
        "ssd_cb": B * nc * G * ((Lp // 16 + 1) // 2),
        "ssd_chunk_state": B * nc * H * slices,
        "ssd_state_pass": -(-(B * H * N * P // 4) // THREADS),
        "ssd_chunk_scan": B * nc * H * slices,
    }
    scratch = 4 * (B * H * nc * Lp + B * nc * G * Lp * Lp
                   + B * nc * H * N * P)
    return GridPlan(L, Lp, Np, nc, slices, blocks, scratch)


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


def _run(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
         b: torch.Tensor, c: torch.Tensor, chunk: int) -> dict:
    """The four launches; returns y, the final state and views of the
    scratch the passes leave (``cum [B,H,nc,Lp]``,
    ``cb [B,nc,G,Lp,Lp]`` with only its causal 8-column tiles written,
    ``states [B,nc,H,N,P]``: the state entering each chunk)."""
    _check(x, dt, a, b, c, chunk)
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    plan = grid_plan(B, S, H, P, G, N, chunk)
    dev = x.device
    nc, Lp = plan.nc, plan.Lp
    y = torch.empty(B, S, H, P, dtype=x.dtype, device=dev)
    state = torch.empty(B, H, N, P, dtype=torch.float32, device=dev)
    # one scratch buffer: cum, then cb, then the states
    scratch = torch.empty(plan.scratch_bytes // 4, dtype=torch.float32,
                          device=dev)
    n_cum, n_cb = B * H * nc * Lp, B * nc * G * Lp * Lp
    base = scratch.data_ptr()
    args = _Args(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), y.data_ptr(), state.data_ptr(), base,
        base + 4 * n_cum, base + 4 * (n_cum + n_cb), _DTYPES[x.dtype],
        B, S, H, P, G, N, plan.L, nc, Lp, plan.Np, *x.stride()[:3],
        *dt.stride(), *b.stride()[:3], *c.stride()[:3])
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = _lib().ssd_scan(ctypes.byref(args), stream,
                             ctypes.byref(launched))
    ssd_scan.cuda_launches += launched.value
    if rc != 0:
        raise LPFFatalError(
            f"ssd_scan: {PASSES[launched.value]} failed to launch on "
            f"{tuple(x.shape)} {x.dtype}: CUDA error {rc}")
    ssd_scan.launches += 1
    return dict(y=y, state=state, cum=scratch[:n_cum].view(B, H, nc, Lp),
                cb=scratch[n_cum:n_cum + n_cb].view(B, nc, G, Lp, Lp),
                states=scratch[n_cum + n_cb:].view(B, nc, H, N, P))


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,H,P], dt [B,S,H], a [H], b/c [B,S,G,N] -> (y [B,S,H,P],
    final_state [B,H,N,P] f32)."""
    out = _run(x, dt, a, b, c, chunk)
    return out["y"], out["state"]


ssd_scan.launches = 0
ssd_scan.cuda_launches = 0
