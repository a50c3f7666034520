"""``flash_fwd_roofline.vlm`` (%): the least time of the forward flash
kernel's launches (``fa_fwd_bf16``), each at its own shape
(``counts.flash.flash_fwd_bound_ms``: the decoder's causal [B, H, Hkv,
S, D], the tower's non-causal [B tiles, 16, 16, 577, 64] for as many
launches as the ``vision.layer`` ranges hold flash forwards), over their
device time."""
from lpfbench.counts.flash import flash_fwd_bound_ms
from lpfbench.metrics._vision import roofline

KERNEL = "fa_fwd_bf16"


def _bounds(shape):
    B, H, Hkv, S, D, causal = shape
    return {"fwd": (KERNEL, flash_fwd_bound_ms(B, H, Hkv, S, D, causal,
                                               None, 2)[0])}


def read(view):
    return roofline(view, _bounds)
