"""Spans and counters at the port's layer boundaries, on the profiler's
clock.

A span is a ``torch.profiler.record_function`` range, opened only while a
profiler records: a user annotation in the same trace as the device's
kernels and runtime calls, so an idle gap on the device can be put down
to the span that was open on the host.  A span's parent is the span that
encloses it (one transform's spans sit under one ``fft.call``, one
step's under one ``train.step``).  The profiler holds the spans; there is
no store, clock or exporter here.

With no profiler a span costs one flag check and a dict lookup, and
returns the name's shared no-op: 0.4-0.8 us to enter and leave on the
host of an H100 machine, where an unguarded ``record_function`` costs
9-15 us.  Under a profiler a span is a ``record_function`` range (12-16
us of host time).  Tracing is off when no profiler runs: there is no other
switch.

``span(name)`` is a context manager and a decorator; a decorated function
checks the flag at every call, never at decoration time.  ``count(name,
value)`` adds a host int or a 0-d device tensor to a named counter, only
while a profiler records, and never reads a device value on the host;
:func:`counters` reads the totals (after the traced window) and
:func:`reset_counters` zeroes them.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Union

import torch

__all__ = ["span", "tracing", "count", "counters", "reset_counters"]

#: whether a profiler records (one flag read)
tracing: Callable[[], bool] = torch.autograd._profiler_enabled


class _Span:
    """The span ``name``: a ``record_function`` range if ``on``, else
    nothing to enter.  As a decorator it checks the flag at every call."""
    __slots__ = ("name", "_range")

    def __init__(self, name: str, on: bool):
        self.name = name
        self._range = torch.profiler.record_function(name) if on else None

    def __enter__(self):
        if self._range is not None:
            self._range.__enter__()

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
        return False

    def __call__(self, fn: Callable) -> Callable:
        name = self.name

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if not tracing():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return wrapped


_OFF: Dict[str, _Span] = {}


def span(name: str) -> _Span:
    """The span ``name``: a ``record_function`` range while a profiler
    records, else the name's shared no-op."""
    if tracing():
        return _Span(name, True)
    off = _OFF.get(name)
    return off if off is not None else _OFF.setdefault(name, _Span(name, False))


_totals: Dict[str, Union[int, torch.Tensor]] = {}


def count(name: str, value: Union[int, torch.Tensor]) -> None:
    """Add ``value`` (an int, or a 0-d tensor that stays on its device) to
    the counter ``name``, while a profiler records and outside a CUDA-graph
    capture (a captured add would land in the graph's memory)."""
    if not tracing():
        return
    if isinstance(value, torch.Tensor):
        if value.is_cuda and torch.cuda.is_current_stream_capturing():
            return
        value = value.detach()
    prev = _totals.get(name)
    _totals[name] = value if prev is None else prev + value


def counters() -> Dict[str, int]:
    """Each counter's total (device totals read here, on the host)."""
    return {k: int(v) for k, v in _totals.items()}


def reset_counters() -> None:
    _totals.clear()
