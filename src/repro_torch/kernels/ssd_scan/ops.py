"""Public wrapper of the SSD scan, differentiable.

:func:`ssd` is a :class:`torch.autograd.Function`, the counterpart of the
JAX package's ``custom_vjp`` (``repro/kernels/ssd_scan/ops.py:23-40``).
Its forward is the chunked scan: a CUDA tensor goes to the CUDA kernel
(:func:`.kernel.ssd_scan`), which launches or raises and never falls back;
a CPU tensor goes to the plain version (:func:`.ref.ssd_scan_plain`) and
launches nothing.  Its backward is the VJP of
:func:`.ref.ssd_scan_plain` through autograd, at the forward's chunk: the
same function as the sequential oracle :func:`.ref.ssd_ref` (the JAX
``custom_vjp`` differentiates the oracle), in chunk algebra, so it takes
a few torch ops a chunk instead of a few a position.  It is plain PyTorch
on CPU and CUDA tensors alike: the TPU package has no backward kernel for
the scan.
"""

from __future__ import annotations

import torch

from ...core.errors import LPFFatalError
from ...core.trace import span
from . import kernel as _k
from . import ref as _ref

__all__ = ["ssd", "VJP_RANGE"]

#: the span (:mod:`repro_torch.core.trace`) around the backward: what
#: share of a training step's device time the plain VJP takes.  With no
#: profiler it costs one flag check; under one, a ``record_function``
#: range (12-16 us of host time a call, where an unguarded one cost
#: 9-15 us with no profiler)
VJP_RANGE = "ssd_scan.vjp"


class _SSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, a, b, c, chunk):
        if x.device.type == "cuda":
            fwd = _k.ssd_scan
        elif x.device.type == "cpu":
            fwd = _ref.ssd_scan_plain
        else:
            raise LPFFatalError(f"ssd runs on CUDA or CPU tensors, not "
                                f"{x.device}")
        y, _ = fwd(x, dt, a, b, c, chunk=chunk)
        ctx.save_for_backward(x, dt, a, b, c)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        with span(VJP_RANGE):
            ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            with torch.enable_grad():
                y, _ = _ref.ssd_scan_plain(*ins, chunk=ctx.chunk)
                grads = torch.autograd.grad(y, ins, dy, allow_unused=True)
        return (*grads, None)


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
        c: torch.Tensor, *, chunk: int = 128) -> torch.Tensor:
    """SSD scan output y [B, S, H, P] (see :func:`.kernel.ssd_scan`)."""
    return _SSD.apply(x, dt, a, b, c, chunk)
