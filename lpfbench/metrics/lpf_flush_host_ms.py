"""``lpf_flush_host_ms`` (ms): the host time of the LPF flushes of one
transform: the ``lpf.flush`` spans (``core/context.py``
``_execute_steps``: the program's lookup, certificate, compile on a
miss, and its compiled call or dispatch) over the ``fft.call`` spans."""
from lpfbench.metrics._spans import span_host_ms


def read(view):
    return span_host_ms(view, "lpf.flush", "fft.call")
