"""``fft_planes_roofline`` (%): the least time of the local FFTs that
``bsp_fft`` hands ``fft_planes`` (``csrc/fft_stage.cu``, kernel
``four_step_pass``): p rows of n/p points a transform
(``counts.fft.fft_bound_ms``), over the kernel's device time."""
from lpfbench.counts.fft import fft_bound_ms

KERNEL = "four_step_pass"


def read(view):
    prof = view.profile
    if prof is None:
        return None
    secs, launches = prof.kernel_s(KERNEL)
    if launches == 0 or secs <= 0:
        return None
    n, p = int(view.cell.config["n"]), int(view.cell.traffic["p"])
    bound_s = fft_bound_ms(p, n // p)[0] / 1e3 * view.window.units
    return 100.0 * bound_s / secs
