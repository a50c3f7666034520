"""``lpf_host_ms`` (ms): the host time of one ``bsp_fft`` call, from the
call to its return, before the synchronize: the LPF entry (``exec_``),
the planner, the executor and the programs' replay or dispatch, on the
host (the mean over the traced window's calls)."""
from lpfbench.metrics._common import mean_span_ms


def read(view):
    return mean_span_ms(view)
