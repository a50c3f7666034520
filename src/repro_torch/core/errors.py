"""LPF error semantics for the virtual-process port.

The paper distinguishes *success*, *user-mitigable* errors (no side
effects; e.g. out-of-memory), and *fatal* errors.  Staging happens on the
host before any data moves, so capacity violations (``lpf_resize_*``
bounds) surface as mitigable Python exceptions before any communication
is issued — side-effect free, exactly as the paper requires.  Fatal errors
(malformed h-relations that can never execute, executor methods this port
does not implement yet) are :class:`LPFFatalError`.

:func:`classify` extends the paper's two error classes with a third:
*transient* infrastructure failures (disk I/O, injected faults, timeouts)
that did not corrupt LPF state and may be retried.
"""

from __future__ import annotations

__all__ = [
    "LPF_SUCCESS",
    "LPF_ERR_OUT_OF_MEMORY",
    "LPF_ERR_FATAL",
    "LPF_ERR_TRANSIENT",
    "LPFError",
    "LPFCapacityError",
    "LPFFatalError",
    "LPFAnalysisError",
    "LPFTransientError",
    "classify",
]

LPF_SUCCESS = 0
LPF_ERR_OUT_OF_MEMORY = 1   # user-mitigable, guaranteed no side effects
LPF_ERR_FATAL = 2
LPF_ERR_TRANSIENT = 3       # infrastructure fault; retry/restore may succeed


class LPFError(Exception):
    """Base class for LPF errors."""

    code = LPF_ERR_FATAL


class LPFCapacityError(LPFError):
    """Mitigable error: a reserved capacity (message queue / memory
    register) would be exceeded.  Raised *before* any state change, so the
    caller may ``lpf_resize_*`` and retry.

    ``required``/``capacity``/``kind`` let a handler size the retry:
    :meth:`repro_torch.core.context.LPFContext.with_capacity` resizes the
    named resource to at least ``required`` and re-runs the region."""

    code = LPF_ERR_OUT_OF_MEMORY

    def __init__(self, message: str, *, required: int = 0,
                 capacity: int = 0, kind: str = "queue"):
        super().__init__(message)
        self.required = int(required)
        self.capacity = int(capacity)
        self.kind = kind          # "queue" | "register"


class LPFFatalError(LPFError):
    """Non-mitigable error (malformed message, unregistered slot, ...)."""

    code = LPF_ERR_FATAL


class LPFTransientError(LPFError):
    """A classified infrastructure failure surfaced *before* any
    communication was issued for the failing operation: LPF state is
    intact, so a supervisor may back off and retry."""

    code = LPF_ERR_TRANSIENT


class LPFAnalysisError(LPFError):
    """Raised when a static check refuses a trace before any
    communication is issued."""

    code = LPF_ERR_FATAL


def classify(err: BaseException) -> str:
    """File an exception into the supervisor's taxonomy:
    ``"mitigable"`` (resize-and-retry per the paper's contract),
    ``"transient"`` (infrastructure fault — retry), or ``"fatal"``
    (re-raise; retrying cannot help and might re-execute communication).

    Anything unrecognised is ``"fatal"``: an *unclassified* exception
    must never be silently retried."""
    from .faultpoints import InjectedFault
    if isinstance(err, LPFCapacityError):
        return "mitigable"
    if isinstance(err, LPFTransientError):
        return "transient"
    if isinstance(err, LPFError):
        return "fatal"
    if isinstance(err, (OSError, TimeoutError, InjectedFault)):
        return "transient"
    return "fatal"
