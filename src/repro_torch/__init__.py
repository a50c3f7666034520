"""Lightweight Parallel Foundations on PyTorch and CUDA.

The port of the JAX package ``repro`` to one NVIDIA H100: the LPF core
over ``p`` virtual processes stacked in one device process
(:mod:`repro_torch.core`), the immortal BSP FFT
(:mod:`repro_torch.algorithms`), the LM stack that trains and serves on
it (:mod:`repro_torch.models`, ``optim``, ``data``, ``checkpoint``,
``runtime``, ``launch``), and the hand-written CUDA kernels that replace
the JAX package's Pallas kernels (:mod:`repro_torch.kernels`, sources in
``csrc/``).  It imports ``torch`` and numpy, never ``jax`` and
nothing of ``repro``.
"""
