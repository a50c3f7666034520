"""Flash attention forward: ``kernel`` (CUDA, ctypes), ``ref`` (plain PyTorch), ``ops`` (dispatch)."""
