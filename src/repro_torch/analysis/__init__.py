"""repro_torch.analysis — static race detection, schedule verification
and sanitizer support for the LPF program IR, as in the JAX package.

* :mod:`repro_torch.analysis.linter` — race/hazard lint over recorded
  traces with stable diagnostic codes LPF001–LPF006;
* :mod:`repro_torch.analysis.verifier` — an independent re-derivation of
  the must-precede conflict DAG that certifies an optimized schedule
  (topological order, commuting merges, overlap contracts, Valiant
  rewrites on conflict-free tables, cost compliance) — the certificate
  :meth:`repro_torch.core.ProgramCache.certify` attaches to every cache
  entry and :meth:`~repro_torch.core.ProgramCache.set_compiled` requires;
* :mod:`repro_torch.analysis.traces` — the canned traces.

Sanitizer mode (``LPF_SANITIZE=1`` or ``LPFContext(sanitize=True)``)
runs the linter on every recorded trace at flush time: error diagnostics
raise :class:`repro_torch.core.LPFAnalysisError` before any data moves,
warnings accumulate on ``ctx.diagnostics``.
"""

from .linter import Diagnostic, ERROR, WARNING, lint_program, lint_trace
from .verifier import VerifierReport, verify_program
from .traces import (CANNED_TRACES, canned_bucketed_trace,
                     canned_fft_trace, canned_fragmented_trace,
                     canned_pagerank_trace)

__all__ = [
    "Diagnostic", "ERROR", "WARNING", "lint_trace", "lint_program",
    "VerifierReport", "verify_program",
    "CANNED_TRACES", "canned_fft_trace", "canned_bucketed_trace",
    "canned_fragmented_trace", "canned_pagerank_trace",
]
