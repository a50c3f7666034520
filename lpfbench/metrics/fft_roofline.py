"""``fft_roofline`` (%): the least time of one N-point complex64
transform (``counts.fft.transform_bound_ms``: 2 N 8 bytes at the memory
rate or 5 N log2 N operations at the float32 peak), over the traced
window's ms per transform.  It reads the same work whatever computes
the transform."""
from lpfbench.counts.fft import transform_bound_ms
from lpfbench.metrics._common import ms_per_unit


def read(view):
    ms = ms_per_unit(view)
    if ms is None:
        return None
    return 100.0 * transform_bound_ms(int(view.cell.config["n"])) / ms
