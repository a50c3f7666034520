"""``python -m repro_torch.analysis`` — lint and verify LPF traces from
the command line.

With no arguments, lints every canned trace (FFT redistribute, bucketed
gradient sync, fragmented Valiant relation, PageRank iteration),
optimizes each against the port's machine model (:data:`MACHINE`: the
``"vp"`` link of 8 virtual processes on one H100), re-lints the
optimized program, and verifies the schedule certificate.  Pass
canned-trace names to restrict the set, or ``--pickle path`` for
recorded traces saved with :mod:`pickle` (a ``[ProgramStep, ...]``
list, a ``(p, steps)`` pair, or a ``(p, slots, steps, scratch)`` tuple).

Persistent program caches (``LPF_PROGRAM_CACHE_DIR``):

* ``--record-cache DIR`` optimizes + certifies every selected canned
  trace into the persistent cache at ``DIR``.
* ``--cache-dir DIR`` audits an existing cache: every entry is decoded,
  its recorded trace reconstructed from the persisted canonical
  signature, and the program re-verified offline — exactly the
  certificate check a warm-starting context would run.
* ``--dump-costs PATH`` (with either of the above) writes each entry's
  predicted schedule cost as JSON; ``--diff-costs BASELINE`` compares
  such a dump against a baseline and fails on missing entries or
  predicted-cost regressions beyond 1%.

Exit status is 1 iff any error-severity diagnostic fired, a schedule
failed verification, a cache entry failed to load or re-verify, or the
cost diff regressed — warnings alone exit 0.  Nothing here touches a
device: the CLI prices and verifies programs on the host.
"""

from __future__ import annotations

import argparse
import json
import pickle
import sys
from typing import List, Optional, Tuple

from ..core import ProgramStep, optimize_program
from ..core.cost import schedule_seconds
from ..core.machine import H100_SXM, LPFMachine, probe
from ..core.persist import (PersistentStore, entry_filename,
                            steps_from_signature)
from ..core.program import ProgramCache, SuperstepProgram
from .linter import ERROR, Diagnostic, lint_program, lint_trace
from .traces import CANNED_TRACES
from .verifier import verify_program

#: tolerated relative growth in an entry's predicted schedule seconds
#: before ``--diff-costs`` fails
COST_REGRESSION_TOL = 0.01

#: the machine model traces are optimized against: the port's default,
#: the ``"vp"`` link of 8 virtual processes on one H100
MACHINE = probe({"vp": 8}, H100_SXM)


def _load_pickle(path: str) -> Tuple[int, List[ProgramStep], Optional[object]]:
    with open(path, "rb") as fh:
        obj = pickle.load(fh)
    if isinstance(obj, (list, tuple)) and obj and \
            all(isinstance(s, ProgramStep) for s in obj):
        steps = list(obj)
        p = 1 + max((max(m.src, m.dst) for st in steps for m in st.msgs),
                    default=0)
        return p, steps, None
    if isinstance(obj, tuple) and len(obj) == 2:
        p, steps = obj
        return int(p), list(steps), None
    if isinstance(obj, tuple) and len(obj) == 4:
        p, _slots, steps, scratch = obj
        return int(p), list(steps), scratch
    raise SystemExit(
        f"{path}: expected a [ProgramStep, ...] list, a (p, steps) pair, "
        f"or a (p, slots, steps, scratch) tuple; got {type(obj).__name__}")


def _analyze(name: str, p: int, steps: List[ProgramStep], scratch,
             machine: LPFMachine) -> Tuple[List[Diagnostic], bool]:
    diags = list(lint_trace(steps, p, check_dead=True))
    prog = optimize_program(steps, p, machine, scratch=scratch)
    diags += lint_program(prog, steps)
    report = verify_program(steps, prog, scratch=scratch)
    diags += report.diagnostics
    print(f"== {name}: {len(steps)} recorded supersteps, p={p}")
    for d in diags:
        print(f"   {d}")
    print(f"   {report.summary()}")
    return diags, report.ok


def _entry_costs(prog: SuperstepProgram, machine: LPFMachine) -> dict:
    """Cost summary of one persisted program — the quantity the
    predicted-cost diff gates on."""
    plans = [st.plan for st in prog.steps]
    groups = [[plans[i].cost for i in grp] for grp in prog.groups()]
    return {
        "n_steps": len(prog.steps),
        "rounds": sum(c.rounds for c in (pl.cost for pl in plans)),
        "wire_bytes": sum(pl.cost.wire_bytes for pl in plans),
        "predicted_us": schedule_seconds(groups, machine) * 1e6,
    }


def _record_cache(directory: str, names: List[str],
                  machine: LPFMachine) -> Tuple[int, dict]:
    """``--record-cache``: optimize + certify the canned traces into the
    persistent store at ``directory``.  Returns (n_bad, costs)."""
    cache = ProgramCache(persist_dir=directory)
    bad, costs = 0, {}
    for name in names:
        p, _slots, steps, scratch = CANNED_TRACES[name]()
        prog, key = cache.get_or_build_keyed(steps, p, machine,
                                             scratch=scratch)
        cert = cache.certify(key, steps, prog, scratch=scratch)
        fname = entry_filename(key)
        print(f"== {name}: recorded {fname}  ({cert.summary()})")
        if not cert.ok:
            bad += 1
            continue
        costs[fname] = {"label": name, **_entry_costs(prog, machine)}
    return bad, costs


def _audit_cache(directory: str, machine: LPFMachine) -> Tuple[int, dict]:
    """``--cache-dir``: decode, reconstruct, and re-verify every entry of a
    persisted cache.  Returns (n_bad, costs)."""
    store = PersistentStore(directory)
    bad, costs, n = 0, {}, 0
    for fname, err, key, prog, cert in store.entries():
        n += 1
        if err is not None:
            print(f"== {fname}: INVALID — {err}")
            bad += 1
            continue
        sig, g, l = key
        p = sig[0]
        entry_machine = LPFMachine(p=p, g=g, l=l, r=machine.r)
        try:
            _p, steps, scratch = steps_from_signature(sig)
            report = verify_program(steps, prog, scratch=scratch,
                                    order=list(range(len(steps))))
        except Exception as exc:          # noqa: BLE001 — audit must not die
            print(f"== {fname}: INVALID — re-verification raised {exc!r}")
            bad += 1
            continue
        print(f"== {fname}: p={p}  {report.summary()}")
        if not report.ok:
            bad += 1
            continue
        costs[fname] = _entry_costs(prog, entry_machine)
    print(f"cache audit: {n} entries, {n - bad} verified, {bad} bad")
    return bad, costs


def _diff_costs(costs: dict, baseline_path: str) -> int:
    """``--diff-costs``: fail on entries missing from the current dump or
    whose predicted time regressed beyond ``COST_REGRESSION_TOL``."""
    with open(baseline_path) as fh:
        baseline = json.load(fh)
    bad = 0
    for fname, base in sorted(baseline.items()):
        cur = costs.get(fname)
        label = base.get("label", fname)
        if cur is None:
            print(f"costs: {label}: MISSING from current cache")
            bad += 1
            continue
        b, c = base["predicted_us"], cur["predicted_us"]
        rel = (c - b) / b if b else 0.0
        verdict = "REGRESSED" if rel > COST_REGRESSION_TOL else "ok"
        print(f"costs: {label}: {b:.3f}us -> {c:.3f}us ({rel:+.2%}) "
              f"{verdict}")
        bad += verdict == "REGRESSED"
    for fname in sorted(set(costs) - set(baseline)):
        print(f"costs: {fname}: new entry (not in baseline)")
    return bad


def main(argv=None, machine: Optional[LPFMachine] = None) -> int:
    """The CLI; ``machine`` replaces :data:`MACHINE` (a caller pricing
    against another hardware table)."""
    machine = MACHINE if machine is None else machine
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="lint and verify LPF program traces")
    ap.add_argument("traces", nargs="*", choices=[[], *CANNED_TRACES],
                    help="canned traces to analyze (default: all)")
    ap.add_argument("--pickle", action="append", default=[],
                    metavar="PATH", help="pickled recorded trace(s)")
    ap.add_argument("--record-cache", metavar="DIR",
                    help="record the selected canned traces into a "
                         "persistent program cache")
    ap.add_argument("--cache-dir", metavar="DIR",
                    help="audit a persisted program cache: decode, "
                         "reconstruct, and re-verify every entry")
    ap.add_argument("--dump-costs", metavar="PATH",
                    help="write per-entry predicted costs as JSON "
                         "(with --record-cache or --cache-dir)")
    ap.add_argument("--diff-costs", metavar="BASELINE",
                    help="compare the per-entry costs against a baseline "
                         "dump; fail on >1%% regressions or missing keys")
    args = ap.parse_args(argv)

    if args.cache_dir or args.record_cache:
        names = list(args.traces or sorted(CANNED_TRACES))
        nbad, costs = 0, {}
        if args.record_cache:
            b, costs = _record_cache(args.record_cache, names, machine)
            nbad += b
        if args.cache_dir:
            b, audit_costs = _audit_cache(args.cache_dir, machine)
            nbad += b
            # audit costs win: they price what is actually on disk, but
            # keep the recorder's trace labels when both modes ran
            for fname, c in audit_costs.items():
                label = costs.get(fname, {}).get("label")
                costs[fname] = {"label": label, **c} if label else c
        if args.dump_costs:
            with open(args.dump_costs, "w") as fh:
                json.dump(costs, fh, indent=2, sort_keys=True)
            print(f"costs: wrote {len(costs)} entries to {args.dump_costs}")
        if args.diff_costs:
            nbad += _diff_costs(costs, args.diff_costs)
        return 1 if nbad else 0

    if args.diff_costs or args.dump_costs:
        ap.error("--dump-costs/--diff-costs require --record-cache "
                 "or --cache-dir")

    jobs = []
    for name in (args.traces or sorted(CANNED_TRACES)):
        jobs.append((name, *CANNED_TRACES[name]()))
    for path in args.pickle:
        p, steps, scratch = _load_pickle(path)
        jobs.append((path, p, None, steps, scratch))

    bad = False
    for name, p, _slots, steps, scratch in jobs:
        diags, ok = _analyze(name, p, steps, scratch, machine)
        bad |= (not ok) or any(d.severity == ERROR for d in diags)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
