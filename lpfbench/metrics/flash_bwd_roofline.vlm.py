"""``flash_bwd_roofline.vlm`` (%): the least time of the backward flash
kernels' launches (``fa_bwd_dkv_bf16`` and ``fa_bwd_dq_bf16``
together), each at its own shape (``counts.flash.flash_bwd_bound_ms``:
the decoder's causal shape, the tower's non-causal one for as many
launches of each as the ``vision.layer`` ranges tie flash backward nodes
to), over their device time."""
from lpfbench.counts.flash import flash_bwd_bound_ms
from lpfbench.metrics._vision import roofline

KERNELS = {"dkv": "fa_bwd_dkv_bf16", "dq": "fa_bwd_dq_bf16"}


def _bounds(shape):
    B, H, Hkv, S, D, causal = shape
    got = flash_bwd_bound_ms(B, H, Hkv, S, D, causal, None, 2)
    return {part: (kernel, got[part][0]) for part, kernel in KERNELS.items()}


def read(view):
    return roofline(view, _bounds)
