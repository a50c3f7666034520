"""LPF contexts — ``lpf_exec``, ``lpf_hook``, ``lpf_rehook`` and the
twelve-primitive surface, over ``p`` virtual processes on one device.

One NVIDIA H100 cannot host ``p`` NCCL ranks, so the port runs the ``p``
processes of a context *inside one device process*: every slot value is
stacked ``[p, size]`` (see :mod:`repro_torch.core.memslot`), ``ctx.pid``
is ``arange(p)`` shaped ``[p, 1]`` so it broadcasts over the leading
process axis of per-process values, and every superstep lowers to index
gathers and scatters over the stacked store
(:func:`repro_torch.core.sync.execute_plan`).  An SPMD function
``spmd(ctx, s, p, args)`` therefore runs once and computes for all
processes at once: ``s`` is the ``[p, 1]`` pid tensor.

The context is imperative (mirroring the C API): ``put``/``get`` stage
messages, ``sync`` plans and executes the superstep, slot values are read
back with ``value``/``tensor``.  Supersteps recorded with
``ctx.program()`` flush as one program, as in the JAX package: canonical
order, the :class:`~repro_torch.core.program.ProgramCache`, the schedule
verifier's certificate, then the searched schedule — compiled
(:class:`~repro_torch.core.program.CompiledProgram`: a CUDA graph on the
card) or dispatched superstep by superstep.

Under a profiler the context's stages are spans
(:mod:`repro_torch.core.trace`): ``lpf.exec``, ``lpf.sync``,
``lpf.plan``, and ``lpf.flush`` with its stages ``lpf.program.lookup``,
``.certify``, ``.compile`` (a miss), then ``.compiled`` or
``.dispatch``.

Entry points run on the card: ``device`` defaults to ``"cuda"`` and a
context never falls back to the CPU when no GPU is present — pass
``device="cpu"`` to run there.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.utils._pytree as pytree

from . import faultpoints as _fp
from .attrs import LPF_SYNC_DEFAULT, SyncAttributes
from .cost import CostLedger, SuperstepCost
from .errors import (LPFAnalysisError, LPFCapacityError, LPFError,
                     LPFFatalError)
from .machine import H100_SXM, HardwareModel, LPFMachine, probe as _probe
from .memslot import Slot, SlotRegistry, replicate
from .program import (ProgramCache, ProgramStep, compile_program,
                      dependency_cone, global_program_cache, trace_slot_map)
from .sync import (Msg, PlanCache, _capturing, execute_plan,
                   execute_schedule, global_plan_cache, keep_indices)
from .trace import span

__all__ = ["LPFContext", "exec_", "hook", "rehook", "resolve_device"]

PidFn = Union[int, Sequence[int], Callable[[int], int]]


def resolve_device(device) -> torch.device:
    """The device a context runs on.  A CUDA device is refused — never
    replaced by the CPU — when ``torch.cuda.is_available()`` is false."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise LPFFatalError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run on the CPU")
    return dev


def _per_pid(value: PidFn, p: int, name: str) -> List[int]:
    if callable(value):
        return [int(value(s)) for s in range(p)]
    if isinstance(value, (int, np.integer)):
        return [int(value)] * p
    out = [int(v) for v in value]
    if len(out) != p:
        raise LPFFatalError(f"{name} table must have length p={p}")
    return out


class _CacheStatsView(dict):
    """``ctx.cache_stats``: a dict of the memo layers' counter objects
    (``plan``/``program``) with a ``reset()`` that zeroes them in place —
    replay measurements take hit/miss deltas with the caches warm."""

    def reset(self) -> None:
        for stats in self.values():
            stats.reset()


class LPFContext:
    """The LPF state of ``p`` virtual processes on one device (``lpf_t``)."""

    def __init__(self, p: int = 1, *, device="cuda",
                 hardware: HardwareModel = H100_SXM,
                 plan_cache: Optional[PlanCache] = None,
                 program_cache: Optional[ProgramCache] = None,
                 sanitize: Optional[bool] = None,
                 persist_dir: Optional[str] = None,
                 _parent: Optional["LPFContext"] = None):
        if int(p) < 1:
            raise LPFFatalError(f"a context needs p >= 1, got {p}")
        self.p: int = int(p)
        self.registry = SlotRegistry(self.p, resolve_device(device),
                                     capacity=0)
        self.device: torch.device = self.registry.device
        #: process ids, shaped to broadcast over the leading process axis
        self.pid = torch.arange(self.p, device=self.device).reshape(
            self.p, 1)
        self.hardware = hardware
        #: memoised superstep plans; shared process-wide by default
        self.plan_cache = plan_cache if plan_cache is not None \
            else global_plan_cache()
        #: memoised optimized programs; shared process-wide by default
        self.program_cache = program_cache if program_cache is not None \
            else global_program_cache()
        #: persistent program cache (``persist_dir=`` or the
        #: ``LPF_PROGRAM_CACHE_DIR`` env var for a root context):
        #: certified optimized programs are written to that directory and
        #: warm-loaded by any later context or process sharing it — a
        #: restarted worker pays zero re-planning and zero schedule-search
        #: cost.  Loaded entries are re-verified (``verify_program``)
        #: against the actual recorded trace before they may execute or be
        #: captured.
        if persist_dir is None and _parent is None:
            persist_dir = os.environ.get("LPF_PROGRAM_CACHE_DIR") or None
        if persist_dir:
            self.program_cache.attach_store(persist_dir)
        #: run optimized programs as :class:`CompiledProgram` (a CUDA graph
        #: on the card, the plain version on the CPU) and capture
        #: ``compile_loop`` bodies; ``LPF_COMPILE_PROGRAMS=0`` forces the
        #: dispatched path.  The ledger is identical either way.
        self.compile_programs: bool = \
            os.environ.get("LPF_COMPILE_PROGRAMS", "1") != "0"
        #: the most recently executed optimized program — inspect the
        #: searched schedule with ``ctx.last_program.explain(machine)``
        self.last_program = None
        #: sanitizer mode (``LPF_SANITIZE=1`` or ``sanitize=True``): every
        #: staged message is checked against live registrations and every
        #: flushed trace is linted (``repro_torch.analysis.linter``) —
        #: error diagnostics raise :class:`LPFAnalysisError` before any
        #: data moves, warnings accumulate on :attr:`diagnostics`.
        #: Sub-contexts (hook, compile_loop) inherit the parent's setting
        #: and diagnostics list.
        if sanitize is None:
            sanitize = _parent.sanitize if _parent is not None \
                else os.environ.get("LPF_SANITIZE", "0") != "0"
        self.sanitize: bool = bool(sanitize)
        self.diagnostics: List[Any] = [] if _parent is None \
            else _parent.diagnostics
        self._rec_registered: List[Slot] = []
        self._gate_machine: Optional[LPFMachine] = None
        # the deterministic fault-injection hook (LPF_FAULT_PLAN=...):
        # arming is lazy and idempotent — no plan, no injector, and the
        # seams stay single-pointer-compare no-ops
        if _parent is None and os.environ.get("LPF_FAULT_PLAN") \
                and not _fp.armed():
            from ..runtime.faults import ensure_env_plan
            ensure_env_plan()
        #: ``compile_loop`` iterations run as a replay of the captured
        #: body, captures that failed (each falls back to eager
        #: iterations), and their exceptions
        self.loop_graph_replays = 0
        self.loop_graph_fallbacks = 0
        self.loop_graph_errors: List[BaseException] = []
        self.ledger = CostLedger()
        self._queue: List[Msg] = []
        self._queue_capacity = 0
        #: the Valiant scratch slot (``resize_message_queue``)
        self._scratch: Optional[Slot] = None
        self._on_hold = False
        self._rec_depth = 0
        self._rec_labels: List[str] = []
        self._rec_pending: List[ProgramStep] = []
        self._rec_deferred_dereg: List[Slot] = []
        #: per-nesting-level start indices into ``_rec_pending`` — what
        #: lets :meth:`program` *discard* the supersteps recorded at an
        #: aborted level instead of executing a partial trace, which keeps
        #: a capacity error side-effect-free (:meth:`with_capacity`)
        self._rec_marks: List[int] = []

    # ------------------------------------------------------------------
    # the process-axis rule
    # ------------------------------------------------------------------
    def replicate(self, value) -> torch.Tensor:
        """A value every process shares, stacked ``[p, *value.shape]`` on
        this context's device — the one explicit way to register or write
        a process-independent value (slot values always carry the process
        axis first)."""
        return replicate(value, self.p, self.device)

    # ------------------------------------------------------------------
    # capacity management: lpf_resize_message_queue / _memory_register
    # ------------------------------------------------------------------
    def resize_message_queue(self, n_msgs: int, valiant_payload: int = 0,
                             payload_dtype=torch.float32) -> None:
        """Reserve queue capacity (O(N) as per the paper).  When
        ``valiant_payload`` > 0 a scratch slot of that many elements per
        process is provisioned for two-phase routing."""
        if n_msgs < 0:
            raise LPFFatalError("negative queue capacity")
        self._queue_capacity = n_msgs
        if valiant_payload <= 0:
            return
        if self._rec_pending:
            # re-provisioning replaces the scratch slot recorded supersteps
            # may reference — execute them against the current one first
            self._flush_program()
        if self._scratch is not None:
            # keeping the stale registration would leak register capacity
            # on every resize call
            self.registry.deregister(self._scratch)
            self._scratch = None
        if self.registry.capacity < self.registry.n_active + 1:
            self.registry.resize(self.registry.n_active + 1)
        self._scratch = self.registry.register(
            "__lpf_valiant_scratch",
            torch.zeros(self.p, valiant_payload, dtype=payload_dtype,
                        device=self.device), "global")

    def resize_memory_register(self, n_slots: int) -> None:
        reserve = 1 if self._scratch is not None else 0
        self.registry.resize(n_slots + reserve)

    def with_capacity(self, fn: Callable[["LPFContext"], Any], *,
                      max_attempts: int = 3, grow: float = 2.0) -> Any:
        """Run ``fn(ctx)`` under the paper's *mitigable-error* contract:
        an :class:`LPFCapacityError` is side-effect-free, so the staged
        queue (and any supersteps recorded inside the attempt, via
        :meth:`program`'s abort path) is rolled back, the exhausted
        resource (``e.kind``) is grown to ``max(e.required, current *
        grow)``, and ``fn`` runs again, up to ``max_attempts`` times.  The
        final attempt's capacity error propagates."""
        if max_attempts < 1:
            raise LPFFatalError("with_capacity needs max_attempts >= 1")
        for attempt in range(max_attempts):
            queue_snap = list(self._queue)
            pend_snap = len(self._rec_pending)
            try:
                return fn(self)
            except LPFCapacityError as e:
                if attempt == max_attempts - 1:
                    raise
                self._queue = queue_snap
                del self._rec_pending[pend_snap:]
                if e.kind == "register":
                    cap = self.registry.capacity
                    self.registry.resize(
                        max(e.required, int(cap * grow) + 1))
                else:
                    cap = self._queue_capacity
                    self.resize_message_queue(
                        max(e.required, int(cap * grow) + 1))
        raise AssertionError("unreachable")  # pragma: no cover

    # ------------------------------------------------------------------
    # registration: lpf_register_{global,local}, lpf_deregister
    # ------------------------------------------------------------------
    def register_global(self, name: str, value, flatten: bool = True) -> Slot:
        """Register ``value`` (leading dimension ``p``) collectively."""
        slot = self.registry.register(name, value, "global", flatten)
        if self._rec_depth and self.sanitize:
            self._rec_registered.append(slot)
        return slot

    def register_local(self, name: str, value, flatten: bool = True) -> Slot:
        slot = self.registry.register(name, value, "local", flatten)
        if self._rec_depth and self.sanitize:
            self._rec_registered.append(slot)
        return slot

    def deregister(self, slot: Slot) -> None:
        self._rec_registered = [
            s for s in self._rec_registered
            if not (s.sid == slot.sid and s.gen == slot.gen)]
        if self._rec_depth and self._pending_refs(slot):
            # a recorded superstep still moves data through this slot;
            # deregistration takes effect when the trace flushes
            self._rec_deferred_dereg.append(slot)
            return
        self.registry.deregister(slot)

    # ------------------------------------------------------------------
    # staging: lpf_put / lpf_get
    # ------------------------------------------------------------------
    def _require_active(self) -> None:
        if self._on_hold:
            raise LPFFatalError(
                "context is on hold while a rehook sub-program runs; "
                "active contexts must be disjoint (paper S2.2)")

    def _stage(self, msgs: List[Msg]) -> None:
        self._require_active()
        # fault seam: an armed plan may simulate capacity exhaustion here
        _fp.fire("capacity", staged=len(self._queue), new=len(msgs),
                 capacity=self._queue_capacity)
        if len(self._queue) + len(msgs) > self._queue_capacity:
            raise LPFCapacityError(
                f"message queue capacity {self._queue_capacity} exceeded "
                f"({len(self._queue)} staged + {len(msgs)} new); call "
                f"resize_message_queue first",
                required=len(self._queue) + len(msgs),
                capacity=self._queue_capacity, kind="queue")
        # extents/dtypes/kinds are checked the moment a transfer is staged
        for m in msgs:
            m.validate(self.p)
        if self.sanitize:
            for m in msgs:
                for slot in (m.src_slot, m.dst_slot):
                    if not slot.gen:
                        continue   # synthetic handle, never registered
                    if not self.registry.is_registered(slot) or any(
                            d.sid == slot.sid and d.gen == slot.gen
                            for d in self._rec_deferred_dereg):
                        raise LPFAnalysisError(
                            f"LPF003: staged transfer uses deregistered "
                            f"slot {slot}")
        self._queue.extend(msgs)

    def put(self, src_slot: Slot, dst_slot: Slot, *, to: PidFn,
            src_off: PidFn = 0, dst_off: PidFn = 0,
            size: Optional[PidFn] = None,
            where: Optional[Callable[[int], bool]] = None) -> None:
        """Stage a put from every process ``s`` to process ``to(s)``.
        Offsets/sizes may be ints, tables, or functions of the *sending*
        pid; ``where`` masks which pids participate."""
        if size is None:
            size = src_slot.size
        soff = _per_pid(src_off, self.p, "src_off")
        doff = _per_pid(dst_off, self.p, "dst_off")
        dsts = _per_pid(to, self.p, "to")
        sizes = _per_pid(size, self.p, "size")
        msgs = [Msg(s, dsts[s], src_slot, soff[s], dst_slot, doff[s],
                    sizes[s], origin="put")
                for s in range(self.p)
                if (where is None or where(s)) and sizes[s] > 0]
        self._stage(msgs)

    def get(self, src_slot: Slot, dst_slot: Slot, *, frm: PidFn,
            src_off: PidFn = 0, dst_off: PidFn = 0,
            size: Optional[PidFn] = None,
            where: Optional[Callable[[int], bool]] = None) -> None:
        """Stage a get: every process ``s`` reads from ``frm(s)``; tables
        are indexed by the *destination* pid ``s``."""
        if size is None:
            size = src_slot.size
        soff = _per_pid(src_off, self.p, "src_off")
        doff = _per_pid(dst_off, self.p, "dst_off")
        srcs = _per_pid(frm, self.p, "frm")
        sizes = _per_pid(size, self.p, "size")
        msgs = [Msg(srcs[s], s, src_slot, soff[s], dst_slot, doff[s],
                    sizes[s], origin="get")
                for s in range(self.p)
                if (where is None or where(s)) and sizes[s] > 0]
        self._stage(msgs)

    def put_msgs(self, msgs: Sequence[Tuple[int, int, Slot, int, Slot,
                                            int, int]]) -> None:
        """Stage an explicit message table [(src, dst, src_slot, src_off,
        dst_slot, dst_off, size), ...] — the fully general h-relation."""
        self._stage([Msg(*m) for m in msgs])

    # ------------------------------------------------------------------
    # the fence: lpf_sync
    # ------------------------------------------------------------------
    def sync(self, attrs: SyncAttributes = LPF_SYNC_DEFAULT,
             label: str = "") -> Optional[SuperstepCost]:
        """Plan (memoised), execute, and account one superstep; returns
        its ledger entry.  While a program is being recorded the superstep
        is deferred into the pending trace and ``None`` is returned; its
        ledger entry appears when the trace flushes."""
        self._require_active()
        if not label:
            prefix = next((l for l in reversed(self._rec_labels) if l), "")
            n = self.ledger.supersteps + len(self._rec_pending)
            label = f"{prefix}.superstep[{n}]" if prefix \
                else f"superstep[{n}]"
        with span("lpf.sync"):
            if self._rec_depth:
                self._rec_pending.append(
                    ProgramStep(tuple(self._queue), attrs, label))
                self._queue = []
                return None
            if self.sanitize and self._queue:
                self._sanitize_lint(
                    [ProgramStep(tuple(self._queue), attrs, label)])
            cost = self._execute(self._queue, attrs, label)
            self._queue = []
            return cost

    @span("lpf.plan")
    def _execute(self, msgs: Sequence[Msg], attrs: SyncAttributes,
                 label: str) -> SuperstepCost:
        plan = self.plan_cache.get_or_plan(msgs, self.p, attrs,
                                           self._scratch)
        cost = execute_plan(plan, self.registry, msgs, attrs, label,
                            scratch=self._scratch)
        self.ledger.add(cost)
        return cost

    # ------------------------------------------------------------------
    # program recording (see repro_torch.core.program)
    # ------------------------------------------------------------------
    def record(self, label: str = "") -> None:
        """Start (or nest into) program recording: subsequent ``sync``
        calls defer into a trace executed at flush time.  ``label``
        prefixes the default ledger labels of syncs recorded at this
        level."""
        self._require_active()
        self._rec_depth += 1
        self._rec_labels.append(label)
        self._rec_marks.append(len(self._rec_pending))

    def end_record(self) -> None:
        """Leave one level of recording; the outermost level flushes any
        pending supersteps."""
        if self._rec_depth == 0:
            raise LPFFatalError("end_record without a matching record()")
        self._rec_depth -= 1
        self._rec_labels.pop()
        self._rec_marks.pop()
        if self._rec_depth == 0:
            self._flush_program()
            if self.sanitize and self._rec_registered:
                from ..analysis.linter import Diagnostic, WARNING
                for slot in self._rec_registered:
                    if self.registry.is_registered(slot):
                        self.diagnostics.append(Diagnostic(
                            "LPF003", WARNING, -1,
                            f"slot {slot} registered during the "
                            f"recording is still registered at "
                            f"end_record (leak?)"))
            self._rec_registered = []

    def abort_record(self) -> None:
        """Abandon one level of recording: the supersteps recorded at
        this level are *discarded*, not executed — flushing a partial
        trace would issue communication the caller never completed."""
        if self._rec_depth == 0:
            raise LPFFatalError("abort_record without a matching record()")
        self._rec_depth -= 1
        self._rec_labels.pop()
        mark = self._rec_marks.pop()
        del self._rec_pending[mark:]
        self._queue = []
        if self._rec_depth == 0:
            self._rec_registered = []

    @contextlib.contextmanager
    def program(self, label: str = ""):
        """``with ctx.program(): ...`` — record the body's supersteps as
        one program; re-entrant.  If the body raises, the supersteps it
        recorded are discarded (:meth:`abort_record`) and the exception
        propagates."""
        self.record(label)
        try:
            yield self
        except BaseException:
            self.abort_record()
            raise
        else:
            self.end_record()

    def _pending_refs(self, slot: Slot) -> bool:
        """Does any pending recorded superstep reference ``slot``?"""
        return any(m.dst_slot.sid == slot.sid or m.src_slot.sid == slot.sid
                   for st in self._rec_pending for m in st.msgs)

    def _machine(self) -> LPFMachine:
        """The (g, l) machine the optimizer's cost gates price with: this
        context's own probe (the ``"vp"`` link of its ``p`` processes)."""
        if self._gate_machine is None:
            self._gate_machine = self.probe()
        return self._gate_machine

    @span("lpf.flush")
    def _execute_steps(self, steps: List[ProgramStep]) -> None:
        """Optimize (or fetch the cached optimization of) one trace and
        execute it, as the JAX package's flush does: canonical order,
        the program cache, the verifier's certificate (a schedule that
        fails it is refused before any data moves), then the compiled
        program or the dispatched schedule.  The ledger gains one entry
        per *optimized* superstep — its plan's predicted cost — and one
        ``overlap_cost`` entry per overlap group; ``materialize`` and
        ``ledger_costs`` resolve the program's canonical ranks against
        this trace's own canonical order, so labels stay attached to the
        right recorded steps whatever order the scheduler emitted.

        With :attr:`compile_programs` (the default) the schedule runs as
        a :class:`CompiledProgram` — on the card, CUDA graph replay where
        its first calls timed it faster than eager calls, else the
        dispatched schedule; the plain version on the CPU.  A compilation or replay failure that is
        not an :class:`LPFError` quarantines the key on this device
        (``program_cache.compile_errors`` keeps the exception) and the
        dispatched schedule runs instead: the same certified program, the
        same ledger.  An ``LPFError`` propagates.  Inside a CUDA-graph
        capture (a ``compile_loop`` body) the dispatched schedule runs, so
        no graph is launched inside another's capture."""
        with span("lpf.program.lookup"):
            order, sig = self.program_cache.canonicalize(steps, self.p,
                                                         self._scratch)
            prog, key = self.program_cache.get_or_build_keyed(
                steps, self.p, self._machine(), plan_cache=self.plan_cache,
                scratch=self._scratch, order=order, signature=sig)
        self.last_program = prog
        with span("lpf.program.certify"):
            cert = self.program_cache.certify(key, steps, prog,
                                              scratch=self._scratch,
                                              order=order)
        if not cert.ok:
            raise LPFAnalysisError(
                "schedule verification failed; refusing to execute:\n  "
                + "\n  ".join(str(d) for d in cert.diagnostics))
        if self.sanitize:
            self._sanitize_lint(steps, prog, order)
        # fault seam: an armed plan may delay this flush (a straggler);
        # pure wall-clock — values and ledger are untouched
        d = _fp.delay("straggler")
        if d > 0:
            time.sleep(d)
        labels = [st.label for st in steps]
        dev = str(self.device)
        cp = None
        if self.compile_programs and not _capturing(self.device) and \
                not self.program_cache.compile_quarantined(key, dev):
            cp = self.program_cache.compiled(key, dev)
            if cp is None:
                try:
                    with span("lpf.program.compile"):
                        cp = compile_program(prog, steps, order, self.p,
                                             self.device,
                                             scratch=self._scratch)
                except LPFError:
                    raise
                except Exception as e:
                    self.program_cache.quarantine_compile(key, dev, e)
                else:
                    self.program_cache.set_compiled(key, dev, cp)
        if cp is not None and cp.use_graph is False:
            # its graph lost to eager calls: the dispatched schedule is
            # the eager way, on the registry itself
            cp = None
        if cp is not None:
            slots = trace_slot_map(steps, order)
            vals = [self.registry.value(s) for s in slots]
            scratch_val = self.registry.value(self._scratch) \
                if cp.scratch is not None else None
            try:
                with span("lpf.program.compiled"):
                    out = cp(vals, scratch_val)
            except LPFError:
                raise
            except Exception as e:
                # nothing was written back: the dispatched schedule below
                # starts from the same values
                self.program_cache.quarantine_compile(key, dev, e)
                cp = None
            else:
                for sid, v in out.items():
                    self.registry.set_value(
                        self._scratch if sid < 0 else slots[sid], v)
                costs = prog.ledger_costs(labels, order)
        if cp is None:
            with span("lpf.program.dispatch"):
                entries = prog.materialize(steps, labels, order=order)
                costs = execute_schedule(entries, prog.groups(),
                                         self.registry,
                                         scratch=self._scratch)
        for cost in costs:
            self.ledger.add(cost)

    def _sanitize_lint(self, steps: List[ProgramStep],
                       prog=None, order=None) -> None:
        """Sanitizer hook: lint a trace about to execute.  Error
        diagnostics raise :class:`LPFAnalysisError` (before any data
        moves); warnings accumulate on :attr:`diagnostics`."""
        from ..analysis.linter import ERROR, lint_program, lint_trace
        diags = list(lint_trace(steps, self.p, check_dead=False))
        if prog is not None:
            diags += lint_program(prog, steps, order=order)
        errors = [d for d in diags if d.severity == ERROR]
        if errors:
            raise LPFAnalysisError(
                "sanitize: " + "; ".join(str(d) for d in errors))
        self.diagnostics.extend(diags)

    def _drain_deferred_dereg(self) -> None:
        still: List[Slot] = []
        for slot in self._rec_deferred_dereg:
            if self._rec_pending and self._pending_refs(slot):
                still.append(slot)       # a deferred step still moves data
            else:
                self.registry.deregister(slot)
        self._rec_deferred_dereg = still

    def _flush_program(self) -> None:
        """Execute the whole pending trace (end of recording)."""
        if not self._rec_pending:
            return
        steps, self._rec_pending = self._rec_pending, []
        self._rec_marks = [0] * len(self._rec_marks)
        self._execute_steps(steps)
        self._drain_deferred_dereg()

    def _flush_cone(self, slot: Slot, include_reads: bool) -> None:
        """Dataflow-precise flush: execute only the pending supersteps a
        local read (or write, with ``include_reads``) of ``slot`` depends
        on; independent supersteps stay recorded."""
        if not self._rec_pending:
            return
        cone = dependency_cone(self._rec_pending, slot.sid, include_reads)
        if not cone:
            return
        if len(cone) == len(self._rec_pending):
            self._flush_program()
            return
        cone_set = set(cone)
        steps = [st for i, st in enumerate(self._rec_pending)
                 if i in cone_set]
        self._rec_pending = [st for i, st in enumerate(self._rec_pending)
                             if i not in cone_set]
        # rebase the per-level abort marks: indices below a mark that
        # just flushed no longer occupy pending positions
        self._rec_marks = [m - sum(1 for i in cone_set if i < m)
                           for m in self._rec_marks]
        self._execute_steps(steps)
        self._drain_deferred_dereg()

    # ------------------------------------------------------------------
    # iterated programs
    # ------------------------------------------------------------------
    def compile_loop(self, body: Callable[["LPFContext", Any], Any],
                     carry: Any, *, n_iters: Optional[int] = None,
                     cond: Optional[Callable[[Any], Any]] = None,
                     label: str = "loop",
                     collect: Optional[Callable[[Any], Any]] = None) -> Any:
        """Run an iterated LPF program: ``body(sub_ctx, carry) -> carry``
        once an iteration, ``n_iters`` times or while ``cond(carry)`` is
        true (read on the host once an iteration).  Exactly one of
        ``n_iters``/``cond`` must be given.

        Each iteration runs against a fresh sub-context on this context's
        device, hardware, plan and program caches, whose supersteps record
        as one program (``sub.program(label)``).  As in the JAX package,
        which traces the body once whatever the trip count, the body's
        superstep costs are appended to this context's ledger once (the
        BSP model prices one iteration): those of the first iteration, or,
        for a loop that runs none, of one run of the body on clones of
        the carry whose result is discarded (the returned carry is the
        one passed in).

        On a CUDA context with :attr:`compile_programs`, when every leaf
        of the carry (nested tuples, lists, dicts) is a tensor, the body
        becomes one CUDA graph: the first iteration runs eagerly (it warms
        the caches and gives the ledger), the second is captured over
        static carry buffers and replayed, and every later iteration
        replays it (:attr:`loop_graph_replays`).  Inside the capture the
        sub-context runs its programs dispatched.  The captured body must
        not read device values on the host, and must return tensors of
        the carry's shapes and dtypes; a capture that fails falls back to
        eager iterations (:attr:`loop_graph_fallbacks`,
        :attr:`loop_graph_errors`).  A carry that holds host values
        (Python ints) runs every iteration eagerly.

        With ``collect`` (counted loops only) each iteration's
        ``collect(carry)``, a tensor, is stacked on a new leading axis and
        ``(final_carry, stacked)`` is returned; otherwise the final
        carry."""
        if (n_iters is None) == (cond is None):
            raise LPFFatalError(
                "compile_loop needs exactly one of n_iters= or cond=")
        if collect is not None and cond is not None:
            raise LPFFatalError(
                "collect= requires a counted loop (n_iters=): a "
                "conditional loop has no fixed trip count to stack into")
        self._require_active()
        first: List[SuperstepCost] = []
        ys: List[torch.Tensor] = []

        def one(c, ledger: bool = True):
            sub = LPFContext(self.p, device=self.device,
                             hardware=self.hardware,
                             plan_cache=self.plan_cache,
                             program_cache=self.program_cache,
                             _parent=self)
            sub.compile_programs = self.compile_programs
            with sub.program(label):
                out = body(sub, c)
            if ledger and not first:
                first.extend(sub.ledger.records)
                for cost in first:
                    self.ledger.add(cost)
            return out

        loop = None
        # a loop inside another loop's capture is part of that graph
        if self.compile_programs and self.device.type == "cuda" \
                and not _capturing(self.device):
            leaves = pytree.tree_leaves(carry)
            if leaves and all(isinstance(t, torch.Tensor) for t in leaves):
                loop = _LoopGraph(lambda c: one(c, ledger=False))
        k = 0
        while (k < n_iters) if cond is None else bool(cond(carry)):
            replayed = False
            if k > 0 and loop is not None:
                try:
                    carry = loop.step(carry)
                    replayed = True
                    self.loop_graph_replays += 1
                except LPFError:
                    raise
                except Exception as e:
                    self.loop_graph_fallbacks += 1
                    self.loop_graph_errors.append(e)
                    loop = None
            if not replayed:
                # the eager first iteration builds the index tensors that
                # the capture reads
                with keep_indices(loop.indices) if k == 0 and loop \
                        else contextlib.nullcontext():
                    carry = one(carry)
            if collect is not None:
                y = collect(carry)
                # a replayed carry lives in buffers the next replay writes
                ys.append(y.clone() if replayed else y)
            k += 1
        if k == 0:
            out = one(pytree.tree_map_only(torch.Tensor, torch.clone, carry))
            if collect is not None:
                y = collect(out)
                return carry, y.new_empty((0, *y.shape))
        return carry if collect is None else (carry, torch.stack(ys))

    @property
    def cache_stats(self) -> "_CacheStatsView":
        """Hit/miss/eviction counters of both memo layers; call
        ``.reset()`` on the returned view to zero the counters in place
        (the caches stay warm) for delta measurements."""
        return _CacheStatsView(plan=self.plan_cache.stats,
                               program=self.program_cache.stats)

    # ------------------------------------------------------------------
    # introspection: lpf_probe
    # ------------------------------------------------------------------
    def probe(self, axis_sizes: Optional[dict] = None) -> LPFMachine:
        """``lpf_probe``: by default the machine of this context's ``p``
        virtual processes (link class ``"vp"``)."""
        if axis_sizes is None:
            axis_sizes = {"vp": self.p} if self.p > 1 else {}
        return _probe(axis_sizes, self.hardware)

    # ------------------------------------------------------------------
    # local access (between supersteps)
    # ------------------------------------------------------------------
    def value(self, slot: Slot) -> torch.Tensor:
        """The slot's stacked ``[p, size]`` value.  A read executes only
        the pending supersteps in the slot's dependency cone."""
        self._flush_cone(slot, include_reads=False)
        return self.registry.value(slot)

    def tensor(self, slot: Slot) -> torch.Tensor:
        """The slot's value as ``[p, *orig_shape]``."""
        self._flush_cone(slot, include_reads=False)
        return self.registry.tensor(slot)

    def write(self, slot: Slot, value) -> None:
        """Local compute step writing a slot (allowed between supersteps).
        ``value`` carries the process axis first, like a registered
        value."""
        # recorded supersteps must observe the slot as it was when they
        # were staged: flush the cone of supersteps reading or writing it
        self._flush_cone(slot, include_reads=True)
        value = torch.as_tensor(value, device=self.device)
        if value.ndim == 0 or value.shape[0] != self.p:
            raise LPFFatalError(
                f"write to {slot}: leading dimension must be p={self.p}, "
                f"got shape {tuple(value.shape)}")
        self.registry.set_value(slot, value.reshape(self.p, -1).to(
            slot.dtype))


class _LoopGraph:
    """A ``compile_loop`` body captured as one CUDA graph that feeds
    itself: the body reads the static carry buffers and its result is
    copied back into them inside the graph, so one replay advances the
    carry by an iteration and the host only evaluates ``cond``."""

    def __init__(self, run_body: Callable[[Any], Any]):
        self.run_body = run_body
        self.graph = None
        self.inputs: List[torch.Tensor] = []
        self.spec = None
        #: the index tensors the graph reads (sync.keep_indices)
        self.indices: dict = {}

    def step(self, carry: Any) -> Any:
        leaves, spec = pytree.tree_flatten(carry)
        if self.graph is None:
            self.inputs = [t.clone() for t in leaves]
            graph = torch.cuda.CUDAGraph()
            with keep_indices(self.indices), torch.cuda.graph(graph):
                outs, _ = pytree.tree_flatten(self.run_body(
                    pytree.tree_unflatten(self.inputs, spec)))
                if len(outs) != len(self.inputs) or any(
                        not isinstance(o, torch.Tensor)
                        or o.shape != i.shape or o.dtype != i.dtype
                        or o.device != i.device
                        for o, i in zip(outs, self.inputs)):
                    raise RuntimeError(
                        "compile_loop body returned a carry of other "
                        "leaves, shapes or dtypes than it was given")
                held = {t.untyped_storage().data_ptr() for t in self.inputs}
                # an output that shares memory with an input would be
                # overwritten by an earlier copy back: copy it first
                outs = [o.clone() if o.untyped_storage().data_ptr() in held
                        else o for o in outs]
                for i, o in zip(self.inputs, outs):
                    i.copy_(o)
            self.graph, self.spec = graph, spec
        else:
            for i, t in zip(self.inputs, leaves):
                if t is not i:
                    i.copy_(t)
        self.graph.replay()
        return pytree.tree_unflatten(self.inputs, self.spec)


def _to_device(args: Any, device: torch.device) -> Any:
    """Move the tensors of ``args`` (nested tuples/lists/dicts) to
    ``device``; everything else passes through."""
    if isinstance(args, torch.Tensor):
        return args.to(device)
    if isinstance(args, (list, tuple)):
        return type(args)(_to_device(a, device) for a in args)
    if isinstance(args, dict):
        return {k: _to_device(v, device) for k, v in args.items()}
    return args


def hook(p: int, spmd: Callable, args: Any = None, *,
         device=None, hardware: HardwareModel = H100_SXM,
         plan_cache: Optional[PlanCache] = None,
         program_cache: Optional[ProgramCache] = None,
         parent: Optional[LPFContext] = None) -> Any:
    """``lpf_hook``: run an LPF SPMD function over ``p`` virtual processes
    inside an existing computation — the caller's tensors stay where they
    are and no process is spawned.  Returns the function's output.  With
    ``parent`` the child context inherits its device, plan and program
    caches, and sanitizer setting."""
    if parent is not None:
        device = parent.device if device is None else device
        plan_cache = parent.plan_cache if plan_cache is None else plan_cache
        if program_cache is None:
            program_cache = parent.program_cache
    ctx = LPFContext(p, device="cuda" if device is None else device,
                     hardware=hardware, plan_cache=plan_cache,
                     program_cache=program_cache, _parent=parent)
    return spmd(ctx, ctx.pid, ctx.p, args)


def rehook(ctx: LPFContext, spmd: Callable, args: Any = None) -> Any:
    """``lpf_rehook``: temporarily replace an active context with a
    pristine one over the same processes — the paper's sub-library
    encapsulation.  The parent context is on hold while the sub-program
    runs (active contexts are disjoint)."""
    ctx._on_hold = True
    try:
        return hook(ctx.p, spmd, args, hardware=ctx.hardware, parent=ctx)
    finally:
        ctx._on_hold = False


@span("lpf.exec")
def exec_(p: int, spmd: Callable, args: Any = None, *,
          device="cuda", hardware: HardwareModel = H100_SXM,
          return_ledger: bool = False,
          plan_cache: Optional[PlanCache] = None,
          program_cache: Optional[ProgramCache] = None,
          persist_dir: Optional[str] = None) -> Any:
    """``lpf_exec``: run ``spmd(ctx, s, p, args)`` over ``p`` virtual
    processes on ``device`` (the card unless the caller asks for the CPU).

    Tensors in ``args`` are moved to the device; every process sees the
    same ``args``.  The function returns per-process results stacked on a
    leading ``[p]`` axis.  With ``return_ledger=True`` also returns the
    cost ledger, for compliance checking.  ``plan_cache``,
    ``program_cache`` and ``persist_dir`` go to the context (the
    process-wide caches and ``LPF_PROGRAM_CACHE_DIR`` by default)."""
    ctx = LPFContext(p, device=device, hardware=hardware,
                     plan_cache=plan_cache, program_cache=program_cache,
                     persist_dir=persist_dir)
    out = spmd(ctx, ctx.pid, ctx.p, _to_device(args, ctx.device))
    return (out, ctx.ledger) if return_ledger else out
