"""Hand-written Hopper kernels of the port; CUDA sources in ``repro_torch/csrc``."""
