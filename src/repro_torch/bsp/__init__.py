"""BSP layer: immortal collectives and framework-facing sync programs,
all built on the LPF core primitives."""

from .collectives import (CollectiveHandle, allgather, allreduce,
                          allreduce_done, allreduce_start, alltoall,
                          broadcast, exscan, pad_to, reduce)
from .grad_sync import build_cross_pod_sync, lpf_allreduce
from .pod_sync import lpf_bucketed_allreduce

__all__ = [
    "allgather", "allreduce", "alltoall", "broadcast", "exscan", "reduce",
    "pad_to", "build_cross_pod_sync", "lpf_allreduce",
    "CollectiveHandle", "allreduce_start", "allreduce_done",
    "lpf_bucketed_allreduce",
]
