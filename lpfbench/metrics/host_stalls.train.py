"""``host_stalls.train`` (stalls a step): the CUDA runtime calls that
block the host (synchronizes, ``cudaMalloc``, ``cudaFree``, copies other
than the ``Async`` ones) inside the ``train.step`` spans, on their thread
or in the autograd engine's backward, over those spans."""
from lpfbench.metrics._spans import stalls_per_unit


def read(view):
    return stalls_per_unit(view, "train.step")
