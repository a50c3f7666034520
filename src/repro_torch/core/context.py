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
back with ``value``/``tensor``.

Entry points run on the card: ``device`` defaults to ``"cuda"`` and a
context never falls back to the CPU when no GPU is present — pass
``device="cpu"`` to run there.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import faultpoints as _fp
from .attrs import LPF_SYNC_DEFAULT, SyncAttributes
from .cost import CostLedger, SuperstepCost
from .errors import LPFCapacityError, LPFFatalError
from .machine import H100_SXM, HardwareModel, LPFMachine, probe as _probe
from .memslot import Slot, SlotRegistry, replicate
from .program import ProgramStep, dependency_cone
from .sync import Msg, PlanCache, execute_plan, global_plan_cache

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


class LPFContext:
    """The LPF state of ``p`` virtual processes on one device (``lpf_t``)."""

    def __init__(self, p: int = 1, *, device="cuda",
                 hardware: HardwareModel = H100_SXM,
                 plan_cache: Optional[PlanCache] = None):
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
        return self.registry.register(name, value, "global", flatten)

    def register_local(self, name: str, value, flatten: bool = True) -> Slot:
        return self.registry.register(name, value, "local", flatten)

    def deregister(self, slot: Slot) -> None:
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
        if self._rec_depth:
            self._rec_pending.append(
                ProgramStep(tuple(self._queue), attrs, label))
            self._queue = []
            return None
        cost = self._execute(self._queue, attrs, label)
        self._queue = []
        return cost

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

    def _execute_steps(self, steps: List[ProgramStep]) -> None:
        """Execute a flushed trace in recorded order: one planned
        superstep, and one ledger entry, per recorded sync."""
        for st in steps:
            self._execute(st.msgs, st.attrs, st.label)

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
        device, hardware and plan cache, whose supersteps record as one
        program (``sub.program(label)``).  As in the JAX package, which
        traces the body once, the first iteration's superstep costs are
        appended to this context's ledger once (the BSP model prices one
        iteration; a loop that runs no iteration appends none).  With
        ``collect`` (counted loops only) each iteration's
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

        def one(c):
            sub = LPFContext(self.p, device=self.device,
                             hardware=self.hardware,
                             plan_cache=self.plan_cache)
            with sub.program(label):
                out = body(sub, c)
            if not first:
                first.extend(sub.ledger.records)
                for cost in first:
                    self.ledger.add(cost)
            return out

        if cond is not None:
            while bool(cond(carry)):
                carry = one(carry)
        else:
            for _ in range(n_iters):
                carry = one(carry)
                if collect is not None:
                    ys.append(collect(carry))
        return carry if collect is None else (carry, torch.stack(ys))

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
         parent: Optional[LPFContext] = None) -> Any:
    """``lpf_hook``: run an LPF SPMD function over ``p`` virtual processes
    inside an existing computation — the caller's tensors stay where they
    are and no process is spawned.  Returns the function's output.  With
    ``parent`` the child context inherits its device and plan cache."""
    if parent is not None:
        device = parent.device if device is None else device
        plan_cache = parent.plan_cache if plan_cache is None else plan_cache
    ctx = LPFContext(p, device="cuda" if device is None else device,
                     hardware=hardware, plan_cache=plan_cache)
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


def exec_(p: int, spmd: Callable, args: Any = None, *,
          device="cuda", hardware: HardwareModel = H100_SXM,
          return_ledger: bool = False) -> Any:
    """``lpf_exec``: run ``spmd(ctx, s, p, args)`` over ``p`` virtual
    processes on ``device`` (the card unless the caller asks for the CPU).

    Tensors in ``args`` are moved to the device; every process sees the
    same ``args``.  The function returns per-process results stacked on a
    leading ``[p]`` axis.  With ``return_ledger=True`` also returns the
    cost ledger, for compliance checking."""
    ctx = LPFContext(p, device=device, hardware=hardware)
    out = spmd(ctx, ctx.pid, ctx.p, _to_device(args, ctx.device))
    return (out, ctx.ledger) if return_ledger else out
