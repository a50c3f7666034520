"""The port's serving runtime on the CPU.

* the port's :class:`LPFServer` and the JAX package's drive the same
  scripted pure-Python engine over the same ``synthetic_requests`` stream
  and make the same decisions: outcome for outcome (status, reason,
  tokens, bucket, model-clock times, fallback), the same ``vclock`` and
  the same health snapshot apart from what wall time decides;
* admission, shedding, backpressure, drain and the decode-fault ladder,
  the faults injected through the port's ``serve_admit`` /
  ``serve_decode`` seams;
* the model engine (:class:`repro_torch.launch.serve.ModelDecodeEngine`)
  on ``device="cpu"`` at the llama3.2-1b smoke config: batched streams
  bit-identical to solo decodes, and the launcher's SLO gates.
"""

import contextlib
import dataclasses
import random

import pytest

from repro.core import LPFFatalError as JaxLPFFatalError
from repro.runtime import server as jax_server
from repro_torch.core import LPFFatalError, faultpoints
from repro_torch.core.faultpoints import InjectedFault
from repro_torch.launch import serve as serve_launch
from repro_torch.runtime import server as port_server
from repro_torch.runtime.monitor import StragglerMonitor
from repro_torch.runtime.server import (REASONS, LPFServer, ServeRejected,
                                        ServeRequest, synthetic_requests)

#: health fields that wall time decides (the straggler monitor's verdicts)
WALL_FIELDS = ("stragglers_flagged",)


class ScriptedEngine:
    """Protocol-complete decode engine with no device: tokens are a pure
    function of (seed, position), service is priced at a flat per-token
    cost, and failures are scripted via ``fail_with``."""

    def __init__(self, buckets=((2, 8), (4, 8)), token_s=1e-3,
                 fail_with=()):
        self._buckets = tuple(tuple(b) for b in buckets)
        self.token_s = token_s
        self.quarantined = set()
        self.decodes = 0
        self.flushed = 0
        self.fail_with = list(fail_with)

    def buckets(self):
        return self._buckets

    def token_seconds(self, bucket):
        return self.token_s

    def overhead_seconds(self, bucket):
        return 0.0

    def round_tokens(self, bucket, n):
        t = 1
        while t < n:
            t *= 2
        return min(t, bucket[1])

    def ledger_seconds(self, bucket, n_tokens):
        return self.token_s * n_tokens

    def quarantine(self, bucket):
        self.quarantined.add(tuple(bucket))

    def flush(self):
        self.flushed += 1
        return 0

    def decode(self, bucket, reqs, n_tokens):
        self.decodes += 1
        if self.fail_with:
            err = self.fail_with.pop(0)
            if err is not None:
                raise err
        return {r.rid: tuple((r.seed * 31 + i) % 997
                             for i in range(n_tokens)) for r in reqs}


def req(rid, n=4, deadline=10.0, priority=0, seed=None):
    return ServeRequest(rid=rid, n_tokens=n, deadline_s=deadline,
                        priority=priority,
                        seed=rid * 7919 if seed is None else seed)


def expected_tokens(r, n=None):
    return tuple((r.seed * 31 + i) % 997
                 for i in range(n if n is not None else r.n_tokens))


class SeamPlan:
    """Raise the port's :class:`InjectedFault` at seam invocations
    ``at`` .. ``at + repeat - 1`` (``repeat=-1``: every one from ``at``)."""

    def __init__(self, seam, at=0, repeat=1):
        assert seam in faultpoints.SEAMS
        self.seam, self.at, self.repeat = seam, at, repeat
        self.count = 0
        self.fired = []

    def fire(self, seam, **info):
        if seam != self.seam:
            return
        i = self.count
        self.count += 1
        if i >= self.at and (self.repeat < 0 or i < self.at + self.repeat):
            self.fired.append((seam, i))
            raise InjectedFault(f"injected fault at {seam} #{i}: {info}")


@contextlib.contextmanager
def armed(plan):
    prev = faultpoints._install(plan)
    try:
        yield plan
    finally:
        faultpoints._install(prev)


# ==========================================================================
# the same decisions as the JAX package's server
# ==========================================================================

def _outcome_fields(o):
    return (o.rid, o.status, o.reason, o.tokens, o.bucket, o.admit_v,
            o.deadline_v, o.predicted_v, o.completion_v, o.fallback,
            o.classified, type(o.error).__name__ if o.error else None)


def _drive(mod, reqs, seed, script, max_queue, **kw):
    """``script``: per decode call, None (serve), "transient" (OSError)
    or "fatal" (the package's own LPFFatalError)."""
    fatal = LPFFatalError if mod is port_server else JaxLPFFatalError
    eng = ScriptedEngine(fail_with=[
        None if s is None else OSError("transient") if s == "transient"
        else fatal("contract violation") for s in script])
    srv = mod.LPFServer(eng, max_queue=max_queue, **kw)
    rng = random.Random(seed)
    admitted = []
    for r in reqs:
        out = srv.submit(mod.ServeRequest(**dataclasses.asdict(r)))
        admitted.append(_outcome_fields(out))
        if rng.random() < 0.4:
            srv.step()
    srv.run_until_idle()
    health = srv.drain()
    outs = srv.take_outcomes()
    return (admitted, sorted(_outcome_fields(o) for o in outs.values()),
            srv.vclock, {k: v for k, v in health.items()
                         if k not in WALL_FIELDS}, eng.quarantined)


@pytest.mark.parametrize("seed", range(6))
def test_server_decides_as_the_jax_server(seed):
    rng = random.Random(100 + seed)
    max_queue = rng.choice([4, 8, 16])
    reqs = synthetic_requests(40, seed, ((2, 8), (4, 8)),
                              token_cost_s=1e-3, tight_frac=0.35)
    jreqs = jax_server.synthetic_requests(40, seed, ((2, 8), (4, 8)),
                                          token_cost_s=1e-3, tight_frac=0.35)
    assert [dataclasses.asdict(r) for r in reqs] == \
        [dataclasses.asdict(r) for r in jreqs]
    # a scripted transient fault (fallback) and a fatal one (refusal)
    script = [None] * rng.randint(0, 3) + ["transient"] \
        + [None] * rng.randint(0, 3) + ["fatal"]
    kw = dict(shrink_frac=rng.choice([0.5, 0.25]), shed_frac=0.8,
              reject_backlog_s=rng.choice([None, 0.05]))
    port = _drive(port_server, reqs, seed, script, max_queue, **kw)
    ref = _drive(jax_server, jreqs, seed, script, max_queue, **kw)
    assert port[0] == ref[0]          # admission outcomes, in order
    assert port[1] == ref[1]          # terminal outcomes
    assert port[2] == ref[2]          # vclock
    assert port[3] == ref[3]          # health
    assert port[4] == ref[4]          # quarantined buckets
    assert REASONS == jax_server.REASONS


# ==========================================================================
# admission and the degradation ladder
# ==========================================================================

def test_admission_deadline_property():
    eng = ScriptedEngine()
    srv = LPFServer(eng, max_queue=8)
    reqs = synthetic_requests(40, 3, eng.buckets(), token_cost_s=1e-3,
                              tight_frac=0.35)
    admitted = set()
    for r in reqs:
        out = srv.submit(r)
        if out.status == "admitted":
            admitted.add(r.rid)
            assert out.predicted_v <= out.deadline_v
        else:
            assert out.reason in REASONS
            assert isinstance(out.error, ServeRejected)
        srv.step()
    srv.run_until_idle()
    outs = srv.take_outcomes()
    assert set(outs) == {r.rid for r in reqs}
    assert srv.metrics.deadline_misses == 0
    for r in reqs:
        out = outs[r.rid]
        if out.status == "completed":
            assert r.rid in admitted
            assert out.completion_v <= out.deadline_v + 1e-12
            assert out.tokens == expected_tokens(r)
        else:
            assert out.classified


def test_rejection_classification_and_backlog():
    eng = ScriptedEngine(buckets=((2, 8),))
    srv = LPFServer(eng, max_queue=4)
    assert srv.submit(req(0, n=0)).reason == "no_bucket"
    assert srv.submit(req(1, n=64)).reason == "no_bucket"
    assert srv.submit(req(2, n=4, deadline=1e-9)
                      ).reason == "deadline_unmeetable"
    assert srv.submit(req(3, n=8, deadline=0.009)).status == "admitted"
    assert srv.submit(req(4, n=8, deadline=0.009)
                      ).reason == "deadline_unmeetable"
    assert srv.submit(req(5, n=8, deadline=0.025)).status == "admitted"
    for out in srv.take_outcomes().values():
        assert out.classified
    srv2 = LPFServer(ScriptedEngine(buckets=((2, 8),)), max_queue=64,
                     reject_backlog_s=0.010)
    assert srv2.submit(req(0, n=8)).status == "admitted"
    assert srv2.submit(req(1, n=8)).reason == "overloaded"


def test_backpressure_queue_full():
    srv = LPFServer(ScriptedEngine(buckets=((2, 8),)), max_queue=3,
                    shrink_frac=1.0, shed_frac=1.0)
    for i in range(3):
        assert srv.submit(req(i)).status == "admitted"
    out = srv.submit(req(3))
    assert out.status == "rejected" and out.reason == "queue_full"
    srv.step()
    assert srv.submit(req(4)).status == "admitted"


def test_shrink_and_shed():
    srv = LPFServer(ScriptedEngine(buckets=((2, 8), (4, 8))), max_queue=8,
                    shrink_frac=0.5)
    assert srv.submit(req(0)).bucket == (4, 8)       # level 0: throughput
    for i in range(1, 4):
        srv.submit(req(i))
    assert srv.level >= 1
    assert srv.submit(req(9)).bucket == (2, 8)       # level 1: latency
    srv = LPFServer(ScriptedEngine(buckets=((2, 8),)), max_queue=5,
                    shrink_frac=0.2, shed_frac=0.4)
    assert srv.submit(req(0, priority=1, deadline=5.0)).status == "admitted"
    assert srv.submit(req(1, priority=0, deadline=9.0)).status == "admitted"
    assert srv.submit(req(2, priority=2, deadline=5.0)).status == "admitted"
    shed = srv.outcomes[1]
    assert shed.status == "shed" and shed.reason == "shed_overload"
    assert shed.classified
    out = srv.submit(req(3, priority=0, deadline=99.0))
    assert out.status == "rejected" and out.reason == "overloaded"
    srv.run_until_idle()
    assert srv.outcomes[0].status == "completed"
    assert srv.outcomes[2].status == "completed"


def test_graceful_drain_and_health():
    eng = ScriptedEngine(buckets=((2, 8),))
    srv = LPFServer(eng, max_queue=8)
    for i in range(5):
        srv.submit(req(i))
    health = srv.drain()
    assert health["draining"] and health["queue_depth"] == 0
    assert health["completed"] == 5 and eng.flushed == 1
    out = srv.submit(req(9))
    assert out.status == "rejected" and out.reason == "draining"
    assert srv.drain()["queue_depth"] == 0
    for key in ("vclock_s", "backlog_s", "level", "submitted", "admitted",
                "rejected_total", "deadline_misses", "batches",
                "tokens_decoded", "queue_peak", "stragglers_flagged"):
        assert key in health, key
    assert srv.health()["rejected_draining"] == 1


def test_monitor_history_is_bounded():
    mon = StragglerMonitor(warmup=2, history_cap=16)
    for i in range(100):
        mon.record(i, 1.0 if i != 50 else 50.0)
    assert len(mon.history) == 16
    assert mon.n == 100


# ==========================================================================
# faults through the port's seams
# ==========================================================================

def test_seams_are_declared():
    assert {"serve_admit", "serve_decode"} <= set(faultpoints.SEAMS)
    assert faultpoints._INJECTOR is None


def test_admit_fault_is_refused_classified():
    srv = LPFServer(ScriptedEngine(buckets=((2, 8),)), max_queue=4)
    with armed(SeamPlan("serve_admit")) as plan:
        out = srv.submit(req(0))
    assert plan.fired == [("serve_admit", 0)]
    assert out.status == "rejected" and out.reason == "admit_fault"
    assert out.classified and "transient" in str(out.error)
    assert srv.metrics.unclassified_errors == 0
    assert srv.submit(req(1)).status == "admitted"


def test_decode_fault_quarantines_and_falls_back():
    eng = ScriptedEngine(buckets=((2, 8),))
    srv = LPFServer(eng, max_queue=4)
    with armed(SeamPlan("serve_decode")):
        srv.submit(req(0))
        done = srv.step()
    assert done[0].status == "completed" and done[0].fallback
    assert done[0].tokens == expected_tokens(req(0))
    assert (2, 8) in eng.quarantined
    assert srv.metrics.decode_fallbacks == 1


def test_persistent_decode_fault_fails_the_batch_classified():
    eng = ScriptedEngine(buckets=((2, 8),))
    srv = LPFServer(eng, max_queue=4)
    with armed(SeamPlan("serve_decode", repeat=-1)):
        srv.submit(req(0))
        srv.submit(req(1))
        done = srv.step()
    assert all(o.status == "rejected" and o.reason == "decode_failed"
               and o.classified for o in done)
    assert srv.metrics.decode_failures == 1
    srv.submit(req(2))
    assert srv.step()[0].status == "completed"     # the server survives


def test_fatal_error_is_not_degraded_around():
    eng = ScriptedEngine(buckets=((2, 8),),
                         fail_with=[LPFFatalError("contract violation")])
    srv = LPFServer(eng, max_queue=4)
    srv.submit(req(0))
    assert srv.step()[0].reason == "decode_failed"
    assert srv.metrics.decode_fallbacks == 0 and not eng.quarantined


# ==========================================================================
# the model engine on the CPU
# ==========================================================================

@pytest.fixture(scope="module")
def engine():
    from repro_torch.configs import get_config
    cfg = get_config("llama3.2-1b", smoke=True)
    return serve_launch.ModelDecodeEngine(cfg, [(2, 16), (4, 16)],
                                          device="cpu", calibrate_tokens=3)


def test_model_engine_batched_equals_solo(engine):
    reqs = [req(i, n=6, seed=s) for i, s in enumerate((5, 77, 301, 9))]
    batched = engine.decode((4, 16), reqs, 6)
    for r in reqs:
        assert engine.decode((4, 16), [r], 6)[r.rid] == batched[r.rid]
        assert all(0 <= t < 512 for t in batched[r.rid])
    # quarantine only records the bucket: it goes on decoding the same
    # stream through the one greedy loop
    engine.quarantine((2, 16))
    assert engine.quarantined == {(2, 16)}
    assert engine.decode((2, 16), reqs[:2], 6) == \
        {r.rid: batched[r.rid] for r in reqs[:2]}
    engine.quarantined.clear()
    for b in engine.buckets():
        assert engine.token_seconds(b) > 0
        assert engine.overhead_seconds(b) >= 0


def test_model_engine_serves_behind_lpfserver(engine):
    out = serve_launch.serve(engine, requests=8, seed=0, max_tokens=12,
                             check=True, verbose=False)
    assert out["completed"] >= 1
    assert out["solo_identical"] == out["completed"]
    assert out["health"]["deadline_misses"] == 0
    assert out["health"]["queue_depth"] == 0


def test_launcher_main_on_cpu(capsys):
    serve_launch.main(["--device", "cpu", "--requests", "4", "--tokens",
                       "6", "--cache-len", "8", "--batch", "2", "--check"])
    text = capsys.readouterr().out
    assert "bit-identical to solo decode" in text
    assert "deadline_misses: 0" in text
