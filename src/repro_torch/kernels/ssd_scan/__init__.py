"""Mamba-2 SSD chunked scan: ``kernel`` (CUDA, ctypes), ``ref`` (plain PyTorch), ``ops`` (dispatch, autograd)."""
