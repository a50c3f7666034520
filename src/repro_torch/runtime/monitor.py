"""Straggler detection from BSP superstep timing.

Bulk-synchrony makes stragglers *observable*: every step ends at a
barrier, so per-step wall time is exactly max over workers of their work
time.  The monitor keeps an EWMA mean/variance of step durations and
flags z-score outliers; the mitigation policy escalates:

  observe -> flag (log) -> skip-sync (stale step, bounded count) ->
  request elastic rescale (drop the worker, restore on a smaller mesh).

The detector is exercised in tests by injecting synthetic delays; the
serve loop (:mod:`repro_torch.runtime.server`) records one verdict per
decoded batch.  Pure Python, the JAX package's ``repro.runtime.monitor``
as is.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Deque, Dict, Optional

__all__ = ["StragglerMonitor", "StepVerdict", "cache_metrics"]


def cache_metrics(ctx) -> Dict[str, int]:
    """Flatten a context's memo-layer counters into one metrics dict.

    Keys are ``<layer>_<counter>`` (``plan_hits``, ``program_misses``,
    ``program_disk_hits``, ...) so the result can go straight into a
    scalar metric pipeline next to the straggler verdicts.  The program
    layer's disk counters are the persistent-cache health signal:
    ``program_disk_hits`` > 0 with ``program_misses`` == 0 is a clean
    warm start; a growing ``program_invalidated`` means the cache
    directory is stale or corrupt and is being re-built.

    Beyond the per-layer :class:`~repro_torch.core.sync.CacheStats` fields
    (which carry the degradation counters ``disk_errors`` and
    ``compile_fallbacks``), the program layer exports its ladder state:
    ``program_memory_only`` (1 = the persistent store was detached
    after repeated I/O failures — ``ProgramCache.memory_only_reason``
    holds the why), ``program_quarantined`` (signatures whose
    whole-program compile failed; replays run dispatched), ``program_
    pinned`` (eviction-exempt serving hot set) and ``program_entries``
    (resident programs).  A health snapshot built from this dict sees
    every rung of the cache's degradation ladder without reaching into
    cache internals.
    """
    out: Dict[str, int] = {}
    for layer, stats in sorted(ctx.cache_stats.items()):
        for f in dataclasses.fields(stats):
            out[f"{layer}_{f.name}"] = getattr(stats, f.name)
    pc = getattr(ctx, "program_cache", None)
    if pc is not None:
        out["program_entries"] = len(pc)
        out["program_memory_only"] = int(pc.memory_only_reason is not None)
        out["program_quarantined"] = sum(
            len(axes) for axes in pc._quarantined.values())
        out["program_pinned"] = len(pc.pinned)
    return out


@dataclasses.dataclass
class StepVerdict:
    step: int
    duration: float
    z: float
    straggle: bool
    action: str          # "ok" | "flag" | "skip_sync" | "rescale"


class StragglerMonitor:
    #: default verdict-history ring capacity.  The history is a
    #: debugging/reporting surface, not the detector state (the EWMA
    #: is O(1)); unbounded growth was an OOM for long-running servers,
    #: which record one verdict per decode batch indefinitely.
    HISTORY_CAP = 4096

    def __init__(self, alpha: float = 0.1, z_flag: float = 3.0,
                 z_skip: float = 6.0, max_skips: int = 3,
                 warmup: int = 5, history_cap: Optional[int] = None):
        self.alpha = alpha
        self.z_flag = z_flag
        self.z_skip = z_skip
        self.max_skips = max_skips
        self.warmup = warmup
        self.mean: Optional[float] = None
        self.var: float = 0.0
        self.n = 0
        self.consecutive_skips = 0
        #: bounded ring of recent verdicts (oldest dropped first)
        self.history: Deque[StepVerdict] = collections.deque(
            maxlen=self.HISTORY_CAP if history_cap is None
            else history_cap)

    def record(self, step: int, duration: float) -> StepVerdict:
        self.n += 1
        if self.mean is None:
            self.mean = duration
            v = StepVerdict(step, duration, 0.0, False, "ok")
            self.history.append(v)
            return v
        # relative floor: sub-10%-of-mean jitter is never a straggle
        std = max(math.sqrt(self.var) if self.var > 0 else 0.0,
                  0.1 * abs(self.mean))
        if std <= 0.0:
            # zero-mean/zero-variance stream (e.g. mocked clocks): any
            # on-model duration scores 0; only a genuine excursion above
            # the degenerate mean is an outlier.  Dividing by an epsilon
            # here would turn float noise into z ~ 1e9.
            z = 0.0 if duration <= self.mean else math.inf
        else:
            z = (duration - self.mean) / std
        straggle = self.n > self.warmup and z > self.z_flag
        if straggle and self.n > self.warmup and z > self.z_skip:
            self.consecutive_skips += 1
            action = ("rescale" if self.consecutive_skips > self.max_skips
                      else "skip_sync")
        elif straggle:
            action = "flag"
            self.consecutive_skips = 0
        else:
            action = "ok"
            self.consecutive_skips = 0
        # update EWMA only with non-outlier steps (don't poison the model)
        if not straggle:
            d = duration - self.mean
            self.mean += self.alpha * d
            self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        v = StepVerdict(step, duration, z, straggle, action)
        self.history.append(v)
        return v
