"""BSP layer: immortal collectives built on the LPF core primitives."""

from .collectives import (CollectiveHandle, allgather, allreduce,
                          allreduce_done, allreduce_start, alltoall,
                          broadcast, exscan, pad_to, reduce)

__all__ = [
    "allgather", "allreduce", "alltoall", "broadcast", "exscan", "reduce",
    "pad_to", "CollectiveHandle", "allreduce_start", "allreduce_done",
]
