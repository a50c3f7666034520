"""Immortal BSP algorithms on the port: the FFT so far."""

from .fft import bsp_fft, bsp_fft_spmd, fft_flops, fft_h_bytes

__all__ = ["bsp_fft", "bsp_fft_spmd", "fft_flops", "fft_h_bytes"]
