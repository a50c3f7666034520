"""``host_stalls.fft`` (stalls a call): the CUDA runtime calls that block
the host (synchronizes, ``cudaMalloc``, ``cudaFree``, copies other than
the ``Async`` ones) inside the ``fft.call`` spans, over those spans."""
from lpfbench.metrics._spans import stalls_per_unit


def read(view):
    return stalls_per_unit(view, "fft.call")
