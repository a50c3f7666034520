"""Immortal BSP algorithms on the port (paper §4): the FFT and the
GraphBLAS-lite PageRank, plus their baselines."""

from .fft import bsp_fft, bsp_fft_spmd, fft_flops, fft_h_bytes
from .graphs import PartitionedGraph, banded_graph, partition_graph, rmat_graph
from .pagerank import (dataflow_pagerank, lpf_pagerank, pagerank_spmd,
                       reference_pagerank, shard_tensors,
                       sparse_reference_pagerank)

__all__ = [
    "bsp_fft", "bsp_fft_spmd", "fft_flops", "fft_h_bytes",
    "PartitionedGraph", "banded_graph", "partition_graph", "rmat_graph",
    "dataflow_pagerank", "lpf_pagerank", "pagerank_spmd",
    "reference_pagerank", "shard_tensors", "sparse_reference_pagerank",
]
