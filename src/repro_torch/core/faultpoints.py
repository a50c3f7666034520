"""Fault-injection seams — a stdlib-only shim for
:mod:`repro_torch.runtime.faults`.

Production code marks its failure seams by calling into this module;
:class:`repro_torch.runtime.faults.FaultInjector` arms itself by
installing into :data:`_INJECTOR`.  The split keeps the dependency
direction clean (``repro_torch.core`` never imports
``repro_torch.runtime``) and keeps the unarmed path free: every seam entry
point is a single ``is None`` check, so with no plan armed the executed
path is the same as a build without fault injection.

Seams (see ``runtime/faults.py`` for the plan grammar):

``persist_save``
    :meth:`repro_torch.core.persist.PersistentStore.save` — injected
    ``OSError`` (full disk, read-only directory).
``persist_load``
    :meth:`repro_torch.core.persist.PersistentStore._read` — injected
    ``OSError`` or a truncated / bit-flipped blob.
``compile``
    :func:`repro_torch.core.program.compile_program` — a compilation
    failure the flush degrades around to the dispatched schedule
    (:class:`InjectedFault`).
``straggler``
    :meth:`repro_torch.core.context.LPFContext._execute_steps` —
    wall-clock delay before the schedule issues (straggler simulation).
``capacity``
    :meth:`repro_torch.core.context.LPFContext._stage` — injected
    capacity exhaustion (mitigable ``LPFCapacityError``), exercising the
    paper's resize-and-retry contract.
``serve_admit``
    :meth:`repro_torch.runtime.server.LPFServer.submit` — injected
    infrastructure failure during request admission; the server must
    reject the request with a classified reason, never die.
``serve_decode``
    :meth:`repro_torch.runtime.server.LPFServer.step` — injected decode
    failure before a batch issues; the server retries on the per-token
    fallback path (bucket quarantined) and, if that also fails, fails
    the batch's requests with a classified reason.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["InjectedFault", "SEAMS", "armed", "fire", "corrupt", "delay"]

#: the closed set of seam names a plan may target
SEAMS = ("persist_save", "persist_load", "compile", "straggler",
         "capacity", "serve_admit", "serve_decode")


class InjectedFault(RuntimeError):
    """An infrastructure failure injected by an armed fault plan.

    Deliberately NOT an :class:`repro_torch.core.errors.LPFError`: it
    stands in for the exception an external layer (the CUDA runtime, the
    OS) would raise.  :func:`repro_torch.core.errors.classify` files it
    as ``"transient"``."""


#: the armed injector (a ``repro_torch.runtime.faults.FaultInjector``),
#: or ``None`` — the zero-fault fast path
_INJECTOR = None


def armed() -> bool:
    return _INJECTOR is not None


def fire(seam: str, **info) -> None:
    """Raise the armed plan's exception for ``seam``, if any is due.
    No-op (one pointer compare) when no plan is armed."""
    if _INJECTOR is not None:
        _INJECTOR.fire(seam, **info)


def corrupt(seam: str, blob: bytes) -> bytes:
    """Pass ``blob`` through the armed plan's corruption for ``seam``
    (truncation / bit-flip), or raise its injected I/O error.  Returns
    ``blob`` unchanged when no plan is armed."""
    if _INJECTOR is None:
        return blob
    return _INJECTOR.corrupt(seam, blob)


def delay(seam: str, **info) -> float:
    """Seconds of injected delay due at ``seam`` (0.0 when unarmed or not
    due).  The *caller* sleeps, so the seam stays trivially cheap on the
    zero-fault path."""
    if _INJECTOR is None:
        return 0.0
    return _INJECTOR.delay(seam, **info)


def _install(injector) -> Optional[object]:
    """Arm/disarm (``injector=None``) the process-wide injector; returns
    the previously armed one.  Called only by
    :mod:`repro_torch.runtime.faults`."""
    global _INJECTOR
    prev, _INJECTOR = _INJECTOR, injector
    return prev
