"""``device_idle_lpf.fft`` (%): the traced window's share in which no
kernel or copy runs on the device while the innermost program span open
on the host is an LPF one (``lpf.exec``, ``lpf.sync``, ``lpf.plan``,
``lpf.flush`` and its ``lpf.program.*`` stages), in the FFT cells."""
from lpfbench.metrics._spans import idle_share_under


def read(view):
    return idle_share_under(view, "lpf.")
