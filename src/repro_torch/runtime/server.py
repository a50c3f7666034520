"""Hardened continuous-batching serve loop with model-priced admission.

The paper's thesis is that a strict performance model makes
communication costs *predictable*; this module is where predictability
becomes a robustness tool.  Every decode bucket's per-token superstep
program carries a predicted ledger cost (``SuperstepCost
.predicted_seconds`` summed over the recorded program — the same
quantity the schedule search minimises), so a request's service time
can be priced **before** it is admitted.  Deadlines are therefore
promises, not hopes: the admission controller proves, on the model
clock, that the request can finish in time, or rejects it at the door
with a classified reason — never a mid-decode timeout.

Model clock
-----------
The server keeps a *virtual clock* in model seconds: each decoded
batch advances it by the batch program's ledger cost.  Deadlines and
SLO accounting run on this clock — deterministic, reproducible, and
exactly the quantity the LPF machine ``(g, l)`` promises — while wall
times are recorded alongside for reporting.  Because every executed
superstep ledgers exactly its predicted cost (the repo-wide model
compliance invariant), "admitted implies completion before deadline"
is a theorem on the model clock, checked per request.

Admission bound
---------------
A request needing ``n`` tokens from bucket ``b`` is priced at::

    c(b, n) = overhead(b) + token_seconds(b) * round_tokens(b, n)

and admitted iff ``vclock + sum(c of queued) + c(b, n) <= deadline``.
The bound is sound because batches are led by the earliest-admitted
queued request, a joining member never extends the leader's decode
length, and one batch costs at most its leader's ``c`` — so the queue
drains no slower than the sum of per-request bounds.

Degradation ladder (overload)
-----------------------------
  0. normal — admission prices into the highest-throughput bucket;
  1. **shrink** — new requests route to the smallest batch bucket
     (lower per-batch latency, lower throughput);
  2. **shed** — lowest-priority / latest-deadline queued work is
     dropped with a classified reason until the queue recovers;
  3. **reject** — a full queue (backpressure) or a backlog past the
     configured bound rejects at admission.

Failure hardening
-----------------
``serve_admit`` / ``serve_decode`` fault seams (:mod:`repro_torch.core
.faultpoints`) let a fault injector inject infrastructure failures at
admission and decode time.  The invariant: under any
fault-plus-overload plan every request either
completes with numerics bit-identical to the unloaded baseline, or is
rejected/shed with a classified :class:`~repro_torch.core.errors.LPFError`
— the server itself never dies.  Decode failures quarantine the
bucket's fused path and retry once on the per-token fallback
(:func:`~repro_torch.core.errors.classify`: transient faults are
retried, contract violations are not degraded around).

The port
--------
The serve loop is pure Python: the JAX package's serve loop
(``repro.runtime.server``) line for line, so both packages' servers make
the same decisions on the same engine.  Its engines are
:class:`ProgramDecodeEngine` (a decode step that is a recorded LPF
program over ``p`` virtual processes, on the port's program optimizer,
``ProgramCache`` and ``compile_loop``) and the model engine,
:class:`repro_torch.launch.serve.ModelDecodeEngine`.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

from ..core import faultpoints as _fp
from ..core.errors import LPFError, classify
from .monitor import StragglerMonitor, cache_metrics

__all__ = ["Bucket", "REASONS", "ServeRequest", "ServeOutcome",
           "ServeRejected", "ServeMetrics", "LPFServer", "ProgramDecodeEngine",
           "synthetic_requests"]

#: a decode bucket: (batch rows, cache length == token capacity)
Bucket = Tuple[int, int]

#: rejection / shed reason codes (the classified taxonomy of refusals)
REASONS = ("queue_full", "overloaded", "deadline_unmeetable",
           "no_bucket", "draining", "admit_fault", "decode_failed",
           "shed_overload")


class ServeRejected(LPFError):
    """A classified refusal: the server declined (or abandoned) a
    request *before* violating any promise — at admission (queue
    full, unmeetable deadline, overload, drain), by shedding under
    overload, or after the decode fallback ladder was exhausted.
    Carries the machine-readable ``reason`` code and, for fault-driven
    refusals, the classified ``cause``."""

    def __init__(self, reason: str, message: str,
                 cause: Optional[BaseException] = None):
        super().__init__(message)
        if reason not in REASONS:
            raise ValueError(f"unknown reject reason {reason!r}")
        self.reason = reason
        self.cause = cause


@dataclasses.dataclass(frozen=True)
class ServeRequest:
    """One decode request: ``n_tokens`` greedy tokens wanted within
    ``deadline_s`` model-seconds of submission.  ``seed`` determines
    the request's payload (and therefore its token stream) — results
    must be a pure function of the request, never of its batchmates."""

    rid: int
    n_tokens: int
    deadline_s: float
    priority: int = 0
    #: minimum cache length the request needs (0 = any bucket whose
    #: token capacity fits ``n_tokens``)
    cache_len: int = 0
    seed: int = 0


@dataclasses.dataclass
class ServeOutcome:
    """The terminal record of one request's life in the server."""

    rid: int
    status: str                      # admitted | completed | rejected | shed
    reason: Optional[str] = None     # REASONS code for rejected/shed
    error: Optional[LPFError] = None
    tokens: Optional[Tuple[int, ...]] = None
    bucket: Optional[Bucket] = None
    admit_v: float = 0.0             # model clock at admission
    deadline_v: float = 0.0          # absolute model-clock deadline
    predicted_v: float = 0.0         # admission's completion bound
    completion_v: float = 0.0        # model clock at completion
    wall_s: float = 0.0              # wall time submit -> terminal
    fallback: bool = False           # served by the per-token path

    @property
    def classified(self) -> bool:
        """Refusals must carry a classified LPFError — the only
        acceptable non-completion."""
        return isinstance(self.error, LPFError)


@dataclasses.dataclass
class ServeMetrics:
    """Service counters for the health snapshot (all monotonic)."""

    submitted: int = 0
    admitted: int = 0
    completed: int = 0
    shed: int = 0
    deadline_misses: int = 0         # admitted requests past deadline_v
    batches: int = 0
    tokens_decoded: int = 0
    decode_fallbacks: int = 0        # batches retried on per-token path
    decode_failures: int = 0         # batches failed after the ladder
    unclassified_errors: int = 0     # non-LPF causes wrapped (bug signal)
    queue_peak: int = 0
    level_peak: int = 0
    rejected: Dict[str, int] = dataclasses.field(
        default_factory=lambda: collections.Counter())

    def snapshot(self) -> Dict[str, int]:
        out = {f.name: getattr(self, f.name)
               for f in dataclasses.fields(self) if f.name != "rejected"}
        out["rejected_total"] = sum(self.rejected.values())
        for reason, n in sorted(self.rejected.items()):
            out[f"rejected_{reason}"] = n
        return out


@dataclasses.dataclass
class _Ticket:
    req: ServeRequest
    bucket: Bucket
    cost_s: float                    # admission cost bound c(b, n)
    admit_v: float
    deadline_v: float
    predicted_v: float
    wall_t0: float


class LPFServer:
    """The hardened serve loop (see module docstring).

    ``engine`` provides the decode buckets and the model pricing —
    anything with this duck-typed surface works (the model engine in
    :mod:`repro_torch.launch.serve`, or a test fake):

    * ``buckets() -> Sequence[Bucket]``
    * ``token_seconds(bucket) / overhead_seconds(bucket) -> float``
    * ``round_tokens(bucket, n) -> int`` (decode-length bucketing)
    * ``decode(bucket, reqs, n_tokens) -> {rid: (int tokens...)}``
    * ``ledger_seconds(bucket, n_tokens) -> float``
    * ``quarantine(bucket)`` — move the bucket to the engine's per-token
      fallback path, where the engine has one apart from its loop
    * optional ``flush() -> int`` and ``cache_stats``/``program_cache``
      (for :func:`~repro_torch.runtime.monitor.cache_metrics`)

    The loop is deliberately synchronous and single-threaded:
    ``submit`` admits, ``step`` decodes one batch, ``drain`` finishes
    everything.  Determinism is what lets a fault soak compare runs
    bit-for-bit; a thread/asyncio front-end can pump this object
    without changing its semantics.
    """

    def __init__(self, engine, *, max_queue: int = 64,
                 shrink_frac: float = 0.5, shed_frac: float = 0.8,
                 reject_backlog_s: Optional[float] = None,
                 monitor: Optional[StragglerMonitor] = None):
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if not (0.0 < shrink_frac <= shed_frac <= 1.0):
            raise ValueError("need 0 < shrink_frac <= shed_frac <= 1")
        self.engine = engine
        self.max_queue = max_queue
        self.shrink_frac = shrink_frac
        self.shed_frac = shed_frac
        self.reject_backlog_s = reject_backlog_s
        self.vclock = 0.0
        self.queue: Deque[_Ticket] = collections.deque()
        self.metrics = ServeMetrics()
        self.monitor = monitor if monitor is not None \
            else StragglerMonitor(warmup=3)
        self.draining = False
        #: terminal outcomes by rid; callers consume via
        #: :meth:`take_outcomes` (a long-running front-end must drain
        #: this, the same boundedness contract as a response queue)
        self.outcomes: Dict[int, ServeOutcome] = {}
        self._buckets = tuple(sorted(engine.buckets()))
        if not self._buckets:
            raise ValueError("engine exposes no decode buckets")

    # ------------------------------------------------------------------
    # ladder state
    # ------------------------------------------------------------------
    @property
    def level(self) -> int:
        """Current degradation rung from queue utilisation: 0 normal,
        1 shrink, 2 shed (3, reject, is a per-request decision)."""
        u = len(self.queue) / self.max_queue
        if u >= self.shed_frac:
            return 2
        if u >= self.shrink_frac:
            return 1
        return 0

    def backlog_seconds(self) -> float:
        """Sum of queued admission cost bounds — the model-priced work
        ahead of a new arrival."""
        return sum(t.cost_s for t in self.queue)

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def _bucket_for(self, req: ServeRequest) -> Optional[Bucket]:
        """Cheapest feasible bucket: smallest sufficient cache length;
        within it the largest batch (throughput) at level 0, the
        smallest (latency — the *shrink* rung) under overload."""
        feas = [b for b in self._buckets
                if b[1] >= max(req.n_tokens, req.cache_len)]
        if not feas:
            return None
        min_c = min(b[1] for b in feas)
        feas = [b for b in feas if b[1] == min_c]
        return min(feas) if self.level >= 1 else max(feas)

    def cost_bound_s(self, bucket: Bucket, n_tokens: int) -> float:
        """The admission price ``c(b, n)`` (module docstring)."""
        return (self.engine.overhead_seconds(bucket)
                + self.engine.token_seconds(bucket)
                * self.engine.round_tokens(bucket, n_tokens))

    def _reject(self, req: ServeRequest, reason: str, msg: str,
                cause: Optional[BaseException] = None,
                status: str = "rejected") -> ServeOutcome:
        err = ServeRejected(reason, msg, cause)
        out = ServeOutcome(rid=req.rid, status=status, reason=reason,
                           error=err, admit_v=self.vclock,
                           deadline_v=self.vclock + req.deadline_s)
        if status == "shed":
            self.metrics.shed += 1
        else:
            self.metrics.rejected[reason] += 1
        if cause is not None and not isinstance(
                cause, (LPFError, OSError, TimeoutError)) \
                and type(cause).__name__ != "InjectedFault":
            self.metrics.unclassified_errors += 1
        self.outcomes[req.rid] = out
        return out

    def _shed_for(self, incoming: _Ticket) -> bool:
        """The *shed* rung: drop the worst queued ticket — lowest
        priority, then latest deadline — until the queue is back under
        the shed threshold.  The incoming ticket competes on the same
        ranking; ``False`` means it lost and must be rejected."""
        limit = max(1, int(self.shed_frac * self.max_queue))
        while len(self.queue) + 1 > limit:
            worst = min(self.queue,
                        key=lambda t: (t.req.priority, -t.deadline_v))
            wkey = (worst.req.priority, -worst.deadline_v)
            ikey = (incoming.req.priority, -incoming.deadline_v)
            if ikey <= wkey:
                return False          # the newcomer is the worst: reject
            self.queue.remove(worst)
            out = self._reject(
                worst.req, "shed_overload",
                f"shed under overload (level 2): priority="
                f"{worst.req.priority} deadline_v={worst.deadline_v:.6f}",
                status="shed")
            out.bucket = worst.bucket
            out.admit_v = worst.admit_v
            out.deadline_v = worst.deadline_v
            out.predicted_v = worst.predicted_v
            out.wall_s = time.perf_counter() - worst.wall_t0
        return True

    def submit(self, req: ServeRequest) -> ServeOutcome:
        """Admit or refuse ``req``.  Returns the admission outcome:
        ``status == "admitted"`` (terminal outcome arrives in
        :attr:`outcomes` when the request completes or is shed) or a
        terminal classified refusal.  Never raises for a per-request
        problem — robustness means the loop survives its inputs."""
        self.metrics.submitted += 1
        wall_t0 = time.perf_counter()
        if self.draining:
            return self._reject(req, "draining",
                                "server is draining; not admitting")
        # the admission fault seam: an injected infrastructure failure
        # here must classify and refuse, never propagate
        try:
            _fp.fire("serve_admit", rid=req.rid)
        except Exception as e:                    # noqa: BLE001
            return self._reject(
                req, "admit_fault",
                f"admission fault ({classify(e)}): "
                f"{type(e).__name__}: {e}", cause=e)
        if req.n_tokens < 1:
            return self._reject(req, "no_bucket",
                                "request decodes zero tokens")
        bucket = self._bucket_for(req)
        if bucket is None:
            return self._reject(
                req, "no_bucket",
                f"no bucket fits n_tokens={req.n_tokens} "
                f"cache_len>={req.cache_len} "
                f"(buckets: {list(self._buckets)})")
        # rung 3a — backpressure: a bounded queue refuses, it does not
        # grow; the client sees the refusal immediately
        if len(self.queue) >= self.max_queue:
            return self._reject(
                req, "queue_full",
                f"queue at capacity ({self.max_queue}); backpressure")
        cost = self.cost_bound_s(bucket, req.n_tokens)
        ticket = _Ticket(req=req, bucket=bucket, cost_s=cost,
                         admit_v=self.vclock,
                         deadline_v=self.vclock + req.deadline_s,
                         predicted_v=0.0, wall_t0=wall_t0)
        # rung 2 — shed: over the shed threshold the worst queued work
        # is dropped (classified) to keep room for better work
        if self.level >= 2 and not self._shed_for(ticket):
            return self._reject(
                req, "overloaded",
                "overloaded (level 2) and the request ranks below "
                "all queued work")
        # rung 3b — backlog bound: even meetable deadlines are refused
        # past the configured model-seconds backlog (wall-clock and
        # memory protection for the pathological all-loose-deadlines
        # arrival pattern)
        backlog = self.backlog_seconds()
        if self.reject_backlog_s is not None \
                and backlog + cost > self.reject_backlog_s:
            return self._reject(
                req, "overloaded",
                f"backlog {backlog + cost:.6f}s over bound "
                f"{self.reject_backlog_s:.6f}s")
        # THE model-priced admission decision: predicted completion on
        # the model clock must not pass the deadline.  Rejecting here
        # is the whole point — a request that cannot make it is told
        # now, not after burning a slot and timing out mid-decode.
        predicted = self.vclock + backlog + cost
        if predicted > ticket.deadline_v:
            return self._reject(
                req, "deadline_unmeetable",
                f"predicted completion {predicted:.6f}s (vclock "
                f"{self.vclock:.6f} + backlog {backlog:.6f} + cost "
                f"{cost:.6f}) past deadline {ticket.deadline_v:.6f}s")
        ticket.predicted_v = predicted
        self.queue.append(ticket)
        self.metrics.admitted += 1
        self.metrics.queue_peak = max(self.metrics.queue_peak,
                                      len(self.queue))
        self.metrics.level_peak = max(self.metrics.level_peak, self.level)
        return ServeOutcome(rid=req.rid, status="admitted", bucket=bucket,
                            admit_v=ticket.admit_v,
                            deadline_v=ticket.deadline_v,
                            predicted_v=predicted)

    # ------------------------------------------------------------------
    # the decode loop
    # ------------------------------------------------------------------
    def _form_batch(self) -> List[_Ticket]:
        """Continuous batching: the earliest-admitted ticket leads;
        same-bucket tickets join in admission order provided they do
        not extend the leader's decode length (that monotonicity is
        what makes the admission bound a theorem), up to the bucket's
        batch rows."""
        leader = self.queue[0]
        batch = [leader]
        rows, _cap = leader.bucket
        for t in list(self.queue)[1:]:
            if len(batch) >= rows:
                break
            if t.bucket == leader.bucket \
                    and t.req.n_tokens <= leader.req.n_tokens:
                batch.append(t)
        for t in batch:
            self.queue.remove(t)
        return batch

    def _fail_batch(self, batch: List[_Ticket], err: BaseException) -> None:
        """The ladder's terminal rung for a batch: every member is
        refused with the classified cause.  The server stays up."""
        self.metrics.decode_failures += 1
        for t in batch:
            out = self._reject(
                t.req, "decode_failed",
                f"decode failed after fallback ({classify(err)}): "
                f"{type(err).__name__}: {err}", cause=err)
            out.bucket = t.bucket
            out.admit_v = t.admit_v
            out.deadline_v = t.deadline_v
            out.predicted_v = t.predicted_v
            out.wall_s = time.perf_counter() - t.wall_t0

    def step(self) -> List[ServeOutcome]:
        """Decode one batch from the queue head.  Returns the batch's
        terminal outcomes ([] when idle).  All failure handling is in
        here: a decode fault quarantines the bucket's fused path and
        retries once per-token; a second failure refuses the batch
        classified.  This method never raises."""
        if not self.queue:
            return []
        batch = self._form_batch()
        leader = batch[0]
        bucket = leader.bucket
        n_tokens = self.engine.round_tokens(bucket, leader.req.n_tokens)
        reqs = [t.req for t in batch]
        wall0 = time.perf_counter()
        fellback = False
        try:
            _fp.fire("serve_decode", bucket=bucket, n=len(batch))
            results = self.engine.decode(bucket, reqs, n_tokens)
        except Exception as first:                # noqa: BLE001
            kind = classify(first)
            if kind == "fatal" and isinstance(first, LPFError):
                # contract violations are never degraded around
                self._fail_batch(batch, first)
                return [self.outcomes[t.req.rid] for t in batch]
            # transient/mitigable: quarantine the fused path and retry
            # once on the per-token fallback
            self.engine.quarantine(bucket)
            self.metrics.decode_fallbacks += 1
            fellback = True
            try:
                _fp.fire("serve_decode", bucket=bucket, n=len(batch),
                         fallback=True)
                results = self.engine.decode(bucket, reqs, n_tokens)
            except Exception as second:           # noqa: BLE001
                self._fail_batch(batch, second)
                return [self.outcomes[t.req.rid] for t in batch]
        wall = time.perf_counter() - wall0
        # the model clock advances by the batch program's ledger cost —
        # which, by model compliance, equals its predicted cost
        self.vclock += self.engine.ledger_seconds(bucket, n_tokens)
        self.metrics.batches += 1
        self.metrics.tokens_decoded += n_tokens * len(batch)
        self.monitor.record(self.metrics.batches, wall)
        done: List[ServeOutcome] = []
        for t in batch:
            toks = tuple(int(x)
                         for x in results[t.req.rid][:t.req.n_tokens])
            missed = self.vclock > t.deadline_v
            if missed:
                self.metrics.deadline_misses += 1
            out = ServeOutcome(
                rid=t.req.rid, status="completed", bucket=bucket,
                tokens=toks, admit_v=t.admit_v,
                deadline_v=t.deadline_v, predicted_v=t.predicted_v,
                completion_v=self.vclock,
                wall_s=time.perf_counter() - t.wall_t0,
                fallback=fellback)
            self.metrics.completed += 1
            self.outcomes[t.req.rid] = out
            done.append(out)
        return done

    def run_until_idle(self, max_batches: int = 1_000_000) -> int:
        """Pump :meth:`step` until the queue is empty; returns the
        number of batches decoded."""
        n = 0
        while self.queue and n < max_batches:
            self.step()
            n += 1
        return n

    # ------------------------------------------------------------------
    # drain / health
    # ------------------------------------------------------------------
    def drain(self) -> Dict[str, Any]:
        """Graceful shutdown: stop admitting (new submissions are
        refused with reason ``draining``), finish every queued decode,
        and flush the engine's caches (persistent entries written
        back).  Idempotent.  Returns the final :meth:`health`."""
        self.draining = True
        self.run_until_idle()
        flush = getattr(self.engine, "flush", None)
        if flush is not None:
            flush()
        return self.health()

    def take_outcomes(self) -> Dict[int, ServeOutcome]:
        """Consume (return and clear) the accumulated terminal
        outcomes — the response-delivery surface."""
        out, self.outcomes = self.outcomes, {}
        return out

    def health(self) -> Dict[str, Any]:
        """The service metrics snapshot: queue/ladder state, SLO
        counters, and the cache layer's degradation counters
        (:func:`~repro_torch.runtime.monitor.cache_metrics`) including
        memory-only mode and the compile quarantine."""
        snap: Dict[str, Any] = {
            "vclock_s": self.vclock,
            "queue_depth": len(self.queue),
            "backlog_s": self.backlog_seconds(),
            "level": self.level,
            "draining": self.draining,
        }
        snap.update(self.metrics.snapshot())
        if getattr(self.engine, "cache_stats", None) is not None:
            snap.update(cache_metrics(self.engine))
            pc = getattr(self.engine, "program_cache", None)
            if pc is not None and pc.memory_only_reason:
                snap["program_memory_only_reason"] = pc.memory_only_reason
        hist = list(self.monitor.history)
        snap["stragglers_flagged"] = sum(1 for v in hist if v.straggle)
        return snap


# ==========================================================================
# the pure-LPF decode engine
# ==========================================================================

class ProgramDecodeEngine:
    """Decode engine whose per-token step is a recorded LPF superstep
    program — the serve path the cost model can price exactly.  The JAX
    package's ``ProgramDecodeEngine`` over ``p`` virtual processes on one
    device (8 by default, as the JAX tests' 8 host devices).

    Per bucket ``(B, C)`` the per-token step ring-shifts the batch's
    ``[B, W]`` state tile (``W = max(1, C // 4)``) across the processes
    and mixes it row-locally; ``n`` tokens roll into one
    ``ctx.compile_loop`` (on the card its body is captured as a CUDA graph
    from the second iteration and replayed: ``loop_graph_replays``) with
    the body's program replayed from this engine's private
    :class:`~repro_torch.core.ProgramCache` (hot bucket entries pinned
    after warm-up).  Rows never mix, so a request's token stream is a pure
    function of its seed.

    Pricing comes from the recorded program's ledger: ``token_seconds``
    is the per-iteration predicted cost on ``probe({"vp": p},
    hardware)``, and every decode call's ledger equals prediction by
    model compliance.  ``quarantine(bucket)`` (or a transient decode
    failure) flips the bucket to the per-token fallback: the same body
    recorded and replayed one token at a time through sub-contexts, each
    token's records folded into the call's ledger — bit-identical values
    at higher dispatch cost.  The JAX package's persistent program store
    is not ported (ROADMAP A7): ``persist_dir`` raises."""

    #: decode lengths are bucketed to powers of two (capped by the
    #: cache length) so distinct request lengths share programs
    ROUND_POW2 = True

    def __init__(self, buckets: Sequence[Bucket] = ((2, 16), (4, 16)),
                 persist_dir: Optional[str] = None,
                 cache_maxsize: int = 256, pin_hot: bool = True, *,
                 p: int = 8, hardware=None, device="cuda"):
        from ..core import H100_SXM, PlanCache, ProgramCache, probe
        from ..core.context import resolve_device
        self._buckets = tuple(sorted(tuple(b) for b in buckets))
        self.p = int(p)
        self.device = resolve_device(device)
        self.hardware = hardware if hardware is not None else H100_SXM
        self.plan_cache = PlanCache()
        self.program_cache = ProgramCache(maxsize=cache_maxsize)
        if persist_dir is not None:
            self.program_cache.attach_store(persist_dir)   # raises: A7
        self.machine = probe({"vp": self.p}, self.hardware)
        self._step_costs: Dict[Bucket, list] = {}
        self.quarantined: set = set()
        self.quarantines = 0
        #: ``compile_loop`` iterations replayed as a captured body, and
        #: captures that failed (each ran its loop eagerly), over all calls
        self.loop_graph_replays = 0
        self.loop_graph_fallbacks = 0
        self.loop_graph_errors: List[BaseException] = []
        self._warmup(pin=pin_hot)

    # -- protocol surface ------------------------------------------------
    def buckets(self) -> Tuple[Bucket, ...]:
        return self._buckets

    def token_seconds(self, bucket: Bucket) -> float:
        """Model-predicted seconds per decoded token: the bucket's
        recorded per-token program priced on the probed machine."""
        return sum(c.predicted_seconds(self.machine)
                   for c in self._step_costs[tuple(bucket)])

    def overhead_seconds(self, bucket: Bucket) -> float:
        """Per-call overhead on the model clock: zero — the BSP model
        prices communication; dispatch overhead is a wall-clock concern
        the benchmarks measure separately."""
        return 0.0

    def round_tokens(self, bucket: Bucket, n: int) -> int:
        if not self.ROUND_POW2:
            return min(n, bucket[1])
        t = 1
        while t < n:
            t *= 2
        return min(t, bucket[1])

    def ledger_seconds(self, bucket: Bucket, n_tokens: int) -> float:
        """The decode call's ledger cost on the model clock: equal to
        ``token_seconds * n_tokens`` by construction (one recorded program
        replayed per token; the fused and per-token paths ledger
        identically)."""
        return self.token_seconds(bucket) * n_tokens

    def quarantine(self, bucket: Bucket) -> None:
        """Force the per-token fallback path for ``bucket`` (the serve
        ladder calls this when the fused decode fails)."""
        self.quarantined.add(tuple(bucket))
        self.quarantines += 1

    @property
    def cache_stats(self):
        """Duck-typed for :func:`~repro_torch.runtime.monitor
        .cache_metrics`."""
        return {"plan": self.plan_cache.stats,
                "program": self.program_cache.stats}

    def flush(self) -> int:
        """Write back certified programs to a persistent store (the drain
        hook): 0, the port has none."""
        return self.program_cache.flush()

    # -- internals -------------------------------------------------------
    def _width(self, bucket: Bucket) -> int:
        return max(1, bucket[1] // 4)

    def _run(self, bucket: Bucket, seeds, n_tokens: int, fused: bool):
        """Decode ``n_tokens`` steps of ``bucket`` from per-row ``seeds``
        (a float array ``[B]``).  Returns (ys ``[T, B, p * W]``, the
        processes' tiles side by side as the JAX engine's ``shard_map``
        lays them out, and the call's ledger records)."""
        import torch
        from ..core import LPFContext

        B, _C = bucket
        W = self._width(bucket)
        label = f"serve[{B}x{_C}]"
        caches = dict(plan_cache=self.plan_cache,
                      program_cache=self.program_cache)

        def body(c2, carry):                       # carry [p, B, W]
            c2.resize_memory_register(2)
            c2.resize_message_queue(c2.p)
            a = c2.register_global("tile", carry)
            b = c2.register_global("nxt", torch.zeros_like(carry))
            c2.put(a, b, to=lambda s: (s + 1) % c2.p, size=B * W)
            c2.sync(label=label)
            mixed = c2.value(b).reshape(c2.p, B, W)
            out = 0.5 * carry + 0.25 * mixed + 1.0
            c2.deregister(a)
            c2.deregister(b)
            return out

        ctx = LPFContext(self.p, device=self.device,
                         hardware=self.hardware, **caches)
        seeds = torch.as_tensor(seeds, dtype=torch.float32,
                                device=ctx.device)
        carry = (seeds[None, :, None] * 1e-3
                 + torch.arange(W, dtype=torch.float32,
                                device=ctx.device)[None, None, :] * 1e-2
                 + ctx.pid.to(torch.float32).reshape(self.p, 1, 1) * 0.1)
        if fused:
            _final, ys = ctx.compile_loop(body, carry, n_iters=n_tokens,
                                          label=label, collect=lambda c: c)
            self.loop_graph_replays += ctx.loop_graph_replays
            self.loop_graph_fallbacks += ctx.loop_graph_fallbacks
            self.loop_graph_errors.extend(ctx.loop_graph_errors)
        else:
            # per-token fallback: the same body recorded and replayed one
            # token at a time — no loop, every program still certified
            # and cache-served
            outs = []
            for _ in range(n_tokens):
                sub = LPFContext(self.p, device=self.device,
                                 hardware=self.hardware, _parent=ctx,
                                 **caches)
                with sub.program(label):
                    carry = body(sub, carry)
                for c in sub.ledger.records:
                    ctx.ledger.add(c)
                outs.append(carry)
            ys = torch.stack(outs)
        T = ys.shape[0]
        ys = ys.permute(0, 2, 1, 3).reshape(T, B, self.p * W)
        return ys, list(ctx.ledger.records)

    def _warmup(self, pin: bool) -> None:
        """Record/price every bucket's per-token program (one 1-token
        decode each) and pin the resulting cache entries: the hot serving
        set must survive any burst of cold signatures."""
        import numpy as np
        for bucket in self._buckets:
            _ys, records = self._run(bucket, np.zeros(bucket[0], np.float32),
                                     1, fused=True)
            if not records:       # pragma: no cover - the body always syncs
                raise LPFError(f"warmup recorded no ledger for {bucket}")
            self._step_costs[bucket] = list(records)
        if pin:
            for key in self.program_cache.keys():
                self.program_cache.pin(key)

    def decode(self, bucket: Bucket, reqs: Sequence[ServeRequest],
               n_tokens: int) -> Dict[int, Tuple[int, ...]]:
        """Decode ``n_tokens`` greedy tokens for up to ``B`` requests
        sharing ``bucket``.  Rows are seeded per request and never mix:
        the returned stream for a request is identical whether it decodes
        alone or fully batched."""
        import numpy as np
        bucket = tuple(bucket)
        B, _C = bucket
        if len(reqs) > B:
            raise LPFError(f"batch of {len(reqs)} into bucket {bucket}")
        seeds = np.zeros(B, np.float32)
        for i, r in enumerate(reqs):
            seeds[i] = float(r.seed % 9973) + 1.0
        ys, _records = self._run(bucket, seeds, n_tokens,
                                 fused=bucket not in self.quarantined)
        ys = ys.cpu().numpy()     # [T, B, W * p]
        # token t of row r: a deterministic digest of the row's state
        toks = (np.round(ys.sum(axis=2) * 16.0).astype(np.int64)
                % np.int64(65521))
        return {r.rid: tuple(int(x) for x in toks[:, i])
                for i, r in enumerate(reqs)}


# ==========================================================================
# request generation (CLI / tests)
# ==========================================================================

def synthetic_requests(n: int, seed: int, buckets: Sequence[Bucket],
                       *, token_cost_s: float = 2e-5,
                       deadline_scale: float = 40.0,
                       tight_frac: float = 0.25,
                       max_tokens: Optional[int] = None
                       ) -> List[ServeRequest]:
    """A deterministic mixed-deadline workload: token counts drawn
    across the buckets' capacities, most deadlines loose (admissible
    with queueing headroom), ``tight_frac`` of them deliberately
    unmeetable so the admission path is always exercised.  Deadlines
    are model-seconds, priced in multiples of ``token_cost_s`` (pass
    the engine's ``token_seconds`` for a calibrated mix)."""
    import random as _random
    rng = _random.Random(seed)
    cap = max(b[1] for b in buckets)
    if max_tokens is not None:
        cap = min(cap, max_tokens)
    reqs = []
    for rid in range(n):
        n_tok = rng.randint(1, cap)
        tight = rng.random() < tight_frac
        scale = (0.5 if tight else deadline_scale
                 * (1.0 + rng.random()))
        reqs.append(ServeRequest(
            rid=rid, n_tokens=n_tok,
            deadline_s=scale * n_tok * token_cost_s,
            priority=rng.randint(0, 2), seed=rng.randint(0, 1 << 30)))
    return reqs
