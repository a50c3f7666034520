"""Local FFT kernel: ``kernel`` (CUDA, ctypes), ``ref`` (plain PyTorch), ``ops`` (dispatch)."""
