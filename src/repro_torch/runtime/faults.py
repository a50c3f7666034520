"""Deterministic fault injection and the chaos soak harness.

The LPF paper's error contract promises that *mitigable* errors are
side-effect-free (the caller may resize and retry) and that anything
else is classified before communication is issued.  This module makes
that contract testable: a :class:`FaultPlan` is a deterministic,
seedable schedule of infrastructure failures fired at the execution
stack's defined seams (see :mod:`repro_torch.core.faultpoints`):

========================  ==================================================
seam                      injected failure
========================  ==================================================
``persist_save``          ``OSError`` out of ``PersistentStore.save``
                          (full disk / read-only cache dir)
``persist_load``          ``OSError``, truncated, or bit-flipped read out
                          of ``PersistentStore._read``
``compile``               compilation failure out of ``compile_program``
                          (:class:`InjectedFault`)
``straggler``             wall-clock delay before a schedule issues
``capacity``              mitigable ``LPFCapacityError`` at staging time
``serve_admit``           :class:`InjectedFault` during request admission
                          (``LPFServer.submit``)
``serve_decode``          :class:`InjectedFault` before a decode batch
                          issues (``LPFServer.step``)
========================  ==================================================

No seam fires unless a plan is **armed** (:func:`arm` / :func:`inject`
/ the ``LPF_FAULT_PLAN`` env var), and an unarmed seam is a single
``is None`` check.

Plan grammar (``FaultPlan.parse`` / ``.spec()`` round-trip), the JAX
package's::

    LPF_FAULT_PLAN="compile@0;persist_load@1:bitflip;straggler@2=0.05"

    event   := seam "@" at ["x" repeat] [":" mode] ["=" arg]
    at      := 0-based invocation index of the seam at which to fire
    repeat  := consecutive firings from `at` (default 1, -1 = forever)
    mode    := persist_load only: oserror | truncate | bitflip
    arg     := straggler only: delay seconds (default 0.02)

The chaos soak harness (``python -m repro_torch.runtime.faults --chaos
--seeds N``) replays warm-start, bucketed-sync, decode and serve
workloads over 8 virtual processes under seeded random plans and asserts
the core invariant: every run either completes with values and ledger
**identical** to the fault-free run, or raises a **classified**
:class:`repro_torch.core.LPFError` before any communication is issued —
never an unclassified exception, never an unverified execution.
``--smoke`` runs one fixed plan per seam (:data:`SMOKE_PLANS`).  The
workloads run on ``--device`` (``cuda`` by default; ``cpu`` to run
there).

The ``serve`` workload's invariant is per *request*, not per run
(:func:`_serve_compare`): every request either completes with tokens
bit-identical to its unloaded solo decode, or terminates refused with a
classified :class:`~repro_torch.runtime.server.ServeRejected` — and the
server object itself must survive the whole arrival sequence.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import errno
import os
import random
import re
import sys
from typing import Dict, List, Optional, Sequence, Tuple

# module level stays stdlib-only: arming a plan (LPFContext reading
# LPF_FAULT_PLAN) must not drag in the heavy stack; the harness imports
# torch and the port lazily inside its functions
from ..core.faultpoints import SEAMS, InjectedFault, _install
from ..core import faultpoints as _faultpoints

__all__ = ["FaultEvent", "FaultPlan", "FaultInjector", "InjectedFault",
           "SEAMS", "arm", "disarm", "active", "inject",
           "ensure_env_plan", "SMOKE_PLANS", "WORKLOADS", "chaos_main"]

#: default injected straggler delay (seconds) when an event has no arg
DEFAULT_DELAY = 0.02

#: the virtual processes every workload runs over
P_CHAOS = 8

_MODES = {
    "persist_save": ("",),
    "persist_load": ("oserror", "truncate", "bitflip"),
    "compile": ("",),
    "straggler": ("",),
    "capacity": ("",),
    "serve_admit": ("",),
    "serve_decode": ("",),
}

_EVENT_RE = re.compile(
    r"^(?P<seam>[a-z_]+)@(?P<at>\d+)"
    r"(?:x(?P<repeat>-?\d+))?"
    r"(?::(?P<mode>[a-z_]+))?"
    r"(?:=(?P<arg>[0-9.eE+\-]+))?$")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled failure: fire at the ``at``-th invocation of ``seam``
    (0-based), for ``repeat`` consecutive invocations (-1 = every
    invocation from ``at`` on)."""

    seam: str
    at: int
    mode: str = ""
    arg: float = 0.0
    repeat: int = 1

    def __post_init__(self):
        if self.seam not in SEAMS:
            raise ValueError(f"unknown seam {self.seam!r}; one of {SEAMS}")
        if self.mode and self.mode not in _MODES[self.seam]:
            raise ValueError(
                f"seam {self.seam!r} has no mode {self.mode!r}")
        if self.at < 0:
            raise ValueError("event index must be >= 0")
        if self.repeat == 0:
            raise ValueError("repeat must be nonzero (-1 = forever)")

    def due(self, idx: int) -> bool:
        if idx < self.at:
            return False
        return self.repeat < 0 or idx < self.at + self.repeat

    def spec(self) -> str:
        s = f"{self.seam}@{self.at}"
        if self.repeat != 1:
            s += f"x{self.repeat}"
        if self.mode:
            s += f":{self.mode}"
        if self.arg:
            s += f"={self.arg:g}"
        return s


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic schedule of :class:`FaultEvent`; the unit the chaos
    harness seeds, replays, and prints on failure."""

    events: Tuple[FaultEvent, ...]
    seed: Optional[int] = None

    def spec(self) -> str:
        """The parseable textual form (``LPF_FAULT_PLAN`` syntax)."""
        return ";".join(e.spec() for e in self.events)

    def seams(self) -> Tuple[str, ...]:
        return tuple(sorted({e.seam for e in self.events}))

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        events = []
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            m = _EVENT_RE.match(part)
            if m is None:
                raise ValueError(f"malformed fault event {part!r} "
                                 f"(grammar: seam@at[xN][:mode][=arg])")
            events.append(FaultEvent(
                seam=m.group("seam"), at=int(m.group("at")),
                mode=m.group("mode") or "",
                arg=float(m.group("arg") or 0.0),
                repeat=int(m.group("repeat") or 1)))
        return cls(events=tuple(events))

    @classmethod
    def random(cls, seed: int, seams: Sequence[str] = SEAMS,
               max_events: int = 3) -> "FaultPlan":
        """A seed-deterministic plan over ``seams`` (stdlib ``random``, the
        JAX package's draw: the same seed gives the same spec)."""
        rng = random.Random(seed)
        events = []
        for _ in range(rng.randint(1, max_events)):
            seam = rng.choice(list(seams))
            mode = rng.choice(_MODES[seam]) if seam == "persist_load" \
                else ""
            # mostly one-shot faults; occasionally a *persistent* one
            # (every invocation fails) to drive the degradation ladder to
            # its terminal rung (memory-only mode / classified error)
            repeat = -1 if rng.random() < 0.2 else 1
            arg = round(rng.uniform(0.001, DEFAULT_DELAY), 4) \
                if seam == "straggler" else 0.0
            events.append(FaultEvent(seam=seam, at=rng.randint(0, 2),
                                     mode=mode, arg=arg, repeat=repeat))
        return cls(events=tuple(events), seed=seed)


class FaultInjector:
    """Counts seam invocations and fires the armed plan's due events.

    ``fired`` records every injected failure as ``(seam, invocation
    index, mode)`` so tests can assert a plan actually exercised its
    target (a plan that never fires proves nothing)."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.counts: Dict[str, int] = collections.Counter()
        self.fired: List[Tuple[str, int, str]] = []

    def _next(self, seam: str) -> Optional[FaultEvent]:
        idx = self.counts[seam]
        self.counts[seam] = idx + 1
        for e in self.plan.events:
            if e.seam == seam and e.due(idx):
                self.fired.append((seam, idx, e.mode or "default"))
                return e
        return None

    # -- seam entry points (see repro_torch.core.faultpoints) ------------
    def fire(self, seam: str, **info) -> None:
        e = self._next(seam)
        if e is None:
            return
        if seam == "persist_save":
            raise OSError(errno.ENOSPC, "injected fault: disk full")
        if seam == "compile":
            raise InjectedFault("injected fault: program compilation "
                                "failed")
        if seam == "capacity":
            from ..core.errors import LPFCapacityError
            staged = int(info.get("staged", 0))
            new = int(info.get("new", 1))
            cap = int(info.get("capacity", 0))
            raise LPFCapacityError(
                f"injected fault: message queue capacity exhausted "
                f"({staged} staged + {new} new > effective capacity)",
                required=staged + new, capacity=cap, kind="queue")
        if seam == "serve_admit":
            raise InjectedFault(
                f"injected fault: admission infrastructure failure "
                f"(rid={info.get('rid')})")
        if seam == "serve_decode":
            raise InjectedFault(
                f"injected fault: decode launch failure "
                f"(bucket={info.get('bucket')}, "
                f"fallback={bool(info.get('fallback'))})")
        raise AssertionError(f"seam {seam!r} has no fire() action")

    def corrupt(self, seam: str, blob: bytes) -> bytes:
        e = self._next(seam)
        if e is None:
            return blob
        mode = e.mode or "oserror"
        if mode == "oserror":
            raise OSError(errno.EIO, "injected fault: read failure")
        if mode == "truncate":
            return blob[:len(blob) // 2]
        # bitflip: corrupt one payload byte; the checksum must catch it
        pos = len(blob) // 2
        flipped = bytes([blob[pos] ^ 0x40])
        return blob[:pos] + flipped + blob[pos + 1:]

    def delay(self, seam: str, **info) -> float:
        e = self._next(seam)
        if e is None:
            return 0.0
        return e.arg if e.arg > 0 else DEFAULT_DELAY


# ==========================================================================
# arming
# ==========================================================================

def arm(plan: FaultPlan) -> FaultInjector:
    """Arm ``plan`` process-wide (replacing any armed injector) and return
    its injector."""
    inj = FaultInjector(plan)
    _install(inj)
    return inj


def disarm() -> None:
    _install(None)


def active() -> Optional[FaultInjector]:
    """The armed injector, or ``None`` on the zero-fault path."""
    return _faultpoints._INJECTOR


@contextlib.contextmanager
def inject(plan: FaultPlan):
    """``with inject(plan) as inj: ...`` — arm for the block, restore the
    previously armed injector (usually none) on exit."""
    inj = FaultInjector(plan)
    prev = _install(inj)
    try:
        yield inj
    finally:
        _install(prev)


def ensure_env_plan() -> Optional[FaultInjector]:
    """Arm the ``LPF_FAULT_PLAN`` env plan if one is set and nothing is
    armed yet (idempotent: a root :class:`LPFContext` calls this on
    construction)."""
    spec = os.environ.get("LPF_FAULT_PLAN")
    if not spec or _faultpoints.armed():
        return active()
    return arm(FaultPlan.parse(spec))


# ==========================================================================
# chaos workloads
# ==========================================================================
#
# Each workload is a deterministic function of the device returning a
# comparable result (values + ledger / predicted costs); the harness runs
# it fault-free once (the baseline), then under each plan, and asserts
# identical-result-or-classified-error.  Workloads declare which seams
# they can reach so random plans are drawn to actually fire.

def _wl_warm_start(device) -> dict:
    """Record every canned trace into a persistent cache, then warm-start
    a fresh cache from the same directory, as a fault target for the
    persist-I/O seams.  Host only (programs are searched, certified and
    stored on the host): disk faults must be absorbed by the degradation
    ladder, so this workload ALWAYS completes and must always match the
    baseline."""
    import tempfile
    from ..analysis.traces import CANNED_TRACES
    from ..core import H100_SXM, PlanCache, ProgramCache, probe
    machine = probe({"vp": P_CHAOS}, H100_SXM)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for phase in ("record", "warm"):
            pc = ProgramCache(persist_dir=tmp)
            plan_cache = PlanCache()
            for name, builder in sorted(CANNED_TRACES.items()):
                p, _slots, steps, scratch = builder()
                prog, key = pc.get_or_build_keyed(
                    steps, p, machine, plan_cache=plan_cache,
                    scratch=scratch)
                cert = pc.certify(key, steps, prog, scratch=scratch)
                if not cert.ok:   # pragma: no cover - verifier backstop
                    raise AssertionError(f"uncertified schedule: {name}")
                out[(phase, name)] = tuple(st.plan.cost
                                           for st in prog.steps)
    return {"costs": out}


def _run_trace(steps, slots, device) -> dict:
    """Issue a canned trace through the real ``ctx.program`` path (inside
    ``with_capacity``) over :data:`P_CHAOS` virtual processes; returns the
    slots' values and the ledger records."""
    import torch
    from ..core import LPFContext, PlanCache, ProgramCache

    ctx = LPFContext(P_CHAOS, device=device, plan_cache=PlanCache(),
                     program_cache=ProgramCache())
    ctx.resize_memory_register(len(slots) + 1)
    pid = ctx.pid.to(torch.int32)
    smap = {s.sid: ctx.register_global(
        s.name, torch.arange(s.size, dtype=torch.int32,
                             device=ctx.device) * 7
        + s.sid * 1000 + pid * 37) for s in slots}

    def region(c):
        with c.program("chaos"):
            for st in steps:
                c.put_msgs([(m.src, m.dst, smap[m.src_slot.sid],
                             m.src_off, smap[m.dst_slot.sid], m.dst_off,
                             m.size) for m in st.msgs])
                c.sync(st.attrs, label=st.label)
        return {s.sid: c.value(smap[s.sid]).cpu().numpy() for s in slots}

    ctx.resize_message_queue(max(len(st.msgs) for st in steps))
    values = ctx.with_capacity(region)
    return {"values": values, "ledger": list(ctx.ledger.records)}


def _wl_bucketed_sync(device) -> dict:
    """The DDP bucketed gradient sync shape: the compile seam exercises the
    compiled→dispatched fallback (ledger must stay bit-for-bit), capacity
    exercises resize-and-retry, the straggler seam only costs wall
    clock."""
    from ..analysis.traces import canned_bucketed_trace
    p, slots, steps, _scratch = canned_bucketed_trace(
        p=P_CHAOS, n_buckets=3, w=8)
    return _run_trace(steps, slots, device)


def _wl_decode(device) -> dict:
    """A decode-step-shaped loop: ``compile_loop`` runs an iterated
    one-superstep ring shift (the serve path's per-token program; on the
    card its body is captured as a CUDA graph); faults land on the body's
    single recorded program."""
    import torch
    from ..core import LPFContext, PlanCache, ProgramCache

    ctx = LPFContext(P_CHAOS, device=device, plan_cache=PlanCache(),
                     program_cache=ProgramCache())

    def body(c2, carry):
        c2.resize_memory_register(2)
        c2.resize_message_queue(c2.p)
        a = c2.register_global("tok", carry)
        b = c2.register_global("nxt", torch.zeros_like(carry))
        c2.put(a, b, to=lambda s_: (s_ + 1) % c2.p, size=4)
        c2.sync(label="decode.shift")
        out = c2.value(b) + 1.0
        c2.deregister(a)
        c2.deregister(b)
        return out

    x0 = torch.arange(4.0, device=ctx.device) + ctx.pid
    final = ctx.compile_loop(body, x0, n_iters=4, label="decode")
    return {"values": {0: final.cpu().numpy()},
            "ledger": list(ctx.ledger.records)}


def _wl_serve(device) -> dict:
    """The hardened serve loop under fault-plus-overload: a burst arrival
    pattern into a small bounded queue (driving the ladder through
    shrink, shed, and backpressure) while the ``serve_admit`` and
    ``serve_decode`` seams (plus the program layer's ``compile`` /
    ``straggler``) fire.  The result carries every request's terminal
    state AND the per-request solo-decode reference streams; the
    invariant is per request (:func:`_serve_compare`)."""
    from .server import LPFServer, ProgramDecodeEngine, synthetic_requests
    eng = ProgramDecodeEngine(buckets=((2, 8), (4, 8)), p=P_CHAOS,
                              device=device)
    reqs = synthetic_requests(
        24, seed=7, buckets=eng.buckets(),
        token_cost_s=eng.token_seconds((4, 8)), deadline_scale=60.0)
    # the unloaded baseline: every request decoded solo (the serve seams
    # fire only inside LPFServer).  Both buckets share cache_len, so
    # streams are bucket-independent and one solo decode per request
    # suffices.
    ref = {}
    for r in reqs:
        t = eng.round_tokens((2, 8), r.n_tokens)
        ref[r.rid] = eng.decode((2, 8), [r], t)[r.rid][:r.n_tokens]
    served: Dict[int, tuple] = {}
    try:
        srv = LPFServer(eng, max_queue=6)
        # bursts of 4 submissions per decode step: the queue saturates,
        # the ladder climbs, and admission keeps being exercised
        for i in range(0, len(reqs), 4):
            for r in reqs[i:i + 4]:
                srv.submit(r)
            srv.step()
        srv.drain()
    except BaseException as e:   # noqa: BLE001 - the invariant under test
        return {"server_died": f"{type(e).__name__}: {e}", "ref": ref,
                "served": served, "health": {}}
    for rid, out in srv.take_outcomes().items():
        if out.status == "completed":
            ok_deadline = out.completion_v <= out.predicted_v + 1e-12
            served[rid] = ("completed", out.tokens, ok_deadline)
        else:
            served[rid] = (out.status, out.reason, out.classified)
    return {"server_died": None, "ref": ref, "served": served,
            "health": srv.health()}


def _serve_compare(res: dict, baseline: dict) -> Tuple[bool, str]:
    """The serve chaos invariant, request by request (see
    :func:`_wl_serve`).  ``res`` may legitimately admit a different mix
    than ``baseline``; only ``baseline['ref']`` (the unloaded solo-decode
    streams) anchors the comparison."""
    if res["server_died"]:
        return False, f"server died: {res['server_died']}"
    h = res["health"]
    if h.get("deadline_misses", 0) != 0:
        return False, f"{h['deadline_misses']} admitted request(s) " \
                      f"missed their model-clock deadline"
    ref = baseline["ref"]
    if set(res["served"]) != set(ref):
        return False, "request(s) vanished without a terminal outcome"
    for rid, term in sorted(res["served"].items()):
        if term[0] == "completed":
            _, tokens, ok_deadline = term
            if not ok_deadline:
                return False, f"rid {rid}: completed past its " \
                              f"admission-predicted bound"
            if tuple(tokens) != tuple(ref[rid]):
                return False, f"rid {rid}: tokens differ from the " \
                              f"unloaded solo decode"
        else:
            status, reason, classified = term
            if not classified:
                return False, f"rid {rid}: {status} ({reason}) " \
                              f"without a classified LPFError"
    return True, ""


#: workload name -> (fn(device), seams random plans may draw from)
WORKLOADS = {
    "warm_start": (_wl_warm_start, ("persist_save", "persist_load")),
    "bucketed_sync": (_wl_bucketed_sync,
                      ("compile", "straggler", "capacity")),
    "decode": (_wl_decode, ("compile", "straggler", "capacity")),
    "serve": (_wl_serve, ("serve_admit", "serve_decode", "compile",
                          "straggler")),
}

#: workloads whose pass criterion is not whole-result equality; the
#: comparator returns ``(ok, why_not)`` against the fault-free baseline
_COMPARATORS = {
    "serve": _serve_compare,
}

#: the smoke matrix: one fixed plan per seam (and per persist_load
#: corruption mode), each pinned to a workload that can reach it
SMOKE_PLANS = (
    ("warm_start", "persist_save@0"),
    ("warm_start", "persist_save@0x-1"),
    ("warm_start", "persist_load@0:oserror"),
    ("warm_start", "persist_load@0:truncate"),
    ("warm_start", "persist_load@0:bitflip"),
    ("bucketed_sync", "compile@0"),
    ("bucketed_sync", "straggler@0=0.005"),
    ("bucketed_sync", "capacity@0"),
    ("decode", "compile@0"),
    ("decode", "capacity@0"),
    ("serve", "serve_admit@0"),
    ("serve", "serve_admit@0x-1"),
    ("serve", "serve_decode@0"),
    # both the fused attempt and the per-token retry fail: the whole
    # ladder runs and every affected request must end classified
    ("serve", "serve_decode@0x-1"),
    ("serve", "compile@0x-1"),
)


def _results_equal(a: dict, b: dict) -> bool:
    import numpy as np
    if a.keys() != b.keys():
        return False
    for k in a:
        if k == "values":
            if a[k].keys() != b[k].keys():
                return False
            for sid in a[k]:
                if not np.array_equal(a[k][sid], b[k][sid]):
                    return False
        elif a[k] != b[k]:
            return False
    return True


def _run_one(workload: str, plan: Optional[FaultPlan], baselines: dict,
             device="cuda") -> Tuple[str, str]:
    """Run ``workload`` under ``plan`` (or fault-free) on ``device`` and
    classify the outcome against the chaos invariant.  Returns
    ``(verdict, detail)`` where verdict is ``identical`` / ``classified``
    (both pass) or ``MISMATCH`` / ``UNCLASSIFIED`` (both fail)."""
    from ..core.errors import LPFError
    fn, _seams = WORKLOADS[workload]
    if workload not in baselines:
        disarm()
        baselines[workload] = fn(device)
    fired: List[Tuple[str, int, str]] = []
    try:
        if plan is None:
            res = fn(device)
        else:
            with inject(plan) as inj:
                res = fn(device)
                fired = list(inj.fired)
    except LPFError as e:
        # classified before any communication was issued for the failing
        # operation — the contract's acceptable outcome
        return "classified", f"{type(e).__name__}: {e}"
    except Exception as e:   # noqa: BLE001 - the invariant under test
        return "UNCLASSIFIED", f"{type(e).__name__}: {e}"
    compare = _COMPARATORS.get(workload)
    if compare is not None:
        ok, why = compare(res, baselines[workload])
        if not ok:
            return "MISMATCH", why
    elif not _results_equal(res, baselines[workload]):
        return "MISMATCH", "result differs from fault-free baseline"
    return "identical", f"{len(fired)} fault(s) fired"


# ==========================================================================
# CLI
# ==========================================================================

def chaos_main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.runtime.faults",
        description="Deterministic fault injection: chaos soak harness "
                    "and fixed-plan smoke runs.")
    ap.add_argument("--chaos", action="store_true",
                    help="seeded random-plan soak across the workloads")
    ap.add_argument("--smoke", action="store_true",
                    help="one fixed plan per seam")
    ap.add_argument("--seeds", type=int, default=100,
                    help="number of seeded plans for --chaos")
    ap.add_argument("--seed0", type=int, default=0,
                    help="first seed (shard long soaks across jobs)")
    ap.add_argument("--plan", type=str, default=None,
                    help="run one explicit plan spec (needs --workload)")
    ap.add_argument("--workload", type=str, default=None,
                    help="workload for --plan")
    ap.add_argument("--workloads", type=str,
                    default=",".join(WORKLOADS),
                    help="comma list to rotate --chaos seeds over")
    ap.add_argument("--device", default="cuda",
                    help="device the workloads run on (default cuda)")
    args = ap.parse_args(argv)

    baselines: dict = {}
    failures: List[str] = []
    tally = collections.Counter()

    def run(workload: str, plan: Optional[FaultPlan], tag: str) -> None:
        verdict, detail = _run_one(workload, plan, baselines, args.device)
        tally[verdict] += 1
        spec = plan.spec() if plan is not None else "<none>"
        line = f"[{tag}] {workload:<14} plan={spec:<40} {verdict}: {detail}"
        print(line, flush=True)
        if verdict in ("MISMATCH", "UNCLASSIFIED"):
            failures.append(line)

    if args.plan is not None:
        if args.workload not in WORKLOADS:
            ap.error(f"--plan needs --workload (one of {list(WORKLOADS)})")
        run(args.workload, FaultPlan.parse(args.plan), "plan")
    elif args.smoke:
        for workload, spec in SMOKE_PLANS:
            run(workload, FaultPlan.parse(spec), "smoke")
    elif args.chaos:
        names = [w.strip() for w in args.workloads.split(",") if w.strip()]
        for w in names:
            if w not in WORKLOADS:
                ap.error(f"unknown workload {w!r}")
        for i in range(args.seeds):
            seed = args.seed0 + i
            workload = names[seed % len(names)]
            plan = FaultPlan.random(seed, seams=WORKLOADS[workload][1])
            run(workload, plan, f"seed {seed}")
    else:
        ap.error("pick a mode: --chaos, --smoke, or --plan SPEC")

    print(f"\nchaos summary: {dict(tally)}")
    if failures:
        print(f"\n{len(failures)} INVARIANT VIOLATION(S):",
              file=sys.stderr)
        for line in failures:
            print("  " + line, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(chaos_main())
