"""Fault-injection seams — a stdlib-only shim.

Production code marks its failure seams by calling into this module; an
injector arms itself by installing into :data:`_INJECTOR`.  Every seam
entry point is a single ``is None`` check, so with no injector armed the
executed path is the same as a build without fault injection.

Seams the port fires so far (:data:`SEAMS`): ``capacity``
(:meth:`repro_torch.core.context.LPFContext._stage` — injected capacity
exhaustion, a mitigable ``LPFCapacityError``), ``compile``
(:func:`repro_torch.core.program.compile_program` — a failure the flush
degrades around to the dispatched schedule), ``serve_admit`` and
``serve_decode`` (:class:`repro_torch.runtime.server.LPFServer` —
admission and decode faults, refused or retried classified).  The JAX
package's other seams (``persist_save``, ``persist_load``,
``straggler``) come with the modules that fire them (ROADMAP A7).
"""

from __future__ import annotations

from typing import Optional

__all__ = ["InjectedFault", "SEAMS", "fire"]

#: the seams the port fires; an injector's plan may target these
SEAMS = ("compile", "capacity", "serve_admit", "serve_decode")


class InjectedFault(RuntimeError):
    """An infrastructure failure injected by an armed fault plan.

    Deliberately NOT an :class:`repro_torch.core.errors.LPFError`: it
    stands in for the exception an external layer (the CUDA runtime, the
    OS) would raise.  :func:`repro_torch.core.errors.classify` files it
    as ``"transient"``."""


#: the armed injector (an object with ``fire(seam, **info)``), or
#: ``None`` — the zero-fault fast path
_INJECTOR = None


def fire(seam: str, **info) -> None:
    """Raise the armed plan's exception for ``seam``, if any is due."""
    if _INJECTOR is not None:
        _INJECTOR.fire(seam, **info)


def _install(injector) -> Optional[object]:
    """Arm/disarm (``injector=None``) the process-wide injector; returns
    the previously armed one."""
    global _INJECTOR
    prev, _INJECTOR = _INJECTOR, injector
    return prev
