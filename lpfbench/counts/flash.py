"""Least times of the flash-attention kernels (copied from the port's
chip script's ``flash_bound_ms``, ``kept_pairs`` and
``flash_bwd_bound_ms``)."""

from __future__ import annotations

from .peaks import BF16_FLOPS, FP32_FLOPS, HBM_BYTES_PER_S


def kept_pairs(S: int, causal: bool, window=None) -> float:
    """The (q, k) pairs the masks keep in one [S, S] score square."""
    total = 0
    for q in range(S):
        lo = max(q - window + 1, 0) if window else 0
        hi = q + 1 if causal else S
        total += hi - lo
    return float(total)


def flash_fwd_bound_ms(B, H, Hkv, S, D, causal, window, itemsize) -> tuple:
    """Least ms of the forward on these inputs: q, k, v read and o, lse
    written once, or the two products over the kept (q, k) pairs (4 D
    flops a pair) at the dtype's peak."""
    pairs = kept_pairs(S, causal, window)
    t_ops = 4.0 * B * H * D * pairs / (BF16_FLOPS if itemsize == 2
                                       else FP32_FLOPS)
    nbytes = (2 * B * H * S * D + 2 * B * Hkv * S * D) * itemsize \
        + B * H * S * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def flash_bwd_bound_ms(B, H, Hkv, S, D, causal, window, itemsize) -> dict:
    """Least ms of each backward kernel: its products over the kept
    pairs at the dtype's peak (dK/dV: 8 D flops a pair; dQ: 6 D), or its
    bytes at the memory rate (q, k, v, dO, lse and delta read once; dk
    and dv, or dq, written once), whichever is longer."""
    peak = BF16_FLOPS if itemsize == 2 else FP32_FLOPS
    pairs = B * H * kept_pairs(S, causal, window)
    ins = (2 * B * H * S * D + 2 * B * Hkv * S * D) * itemsize \
        + 2 * B * H * S * 4
    out = {}
    for name, flops, written in (
            ("dkv", 8.0 * D * pairs, 2 * B * Hkv * S * D * itemsize),
            ("dq", 6.0 * D * pairs, B * H * S * D * itemsize)):
        t_ops, t_bytes = flops / peak, (ins + written) / HBM_BYTES_PER_S
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "bytes" if t_bytes >= t_ops else "operations")
    return out
