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
  bit-identical to solo decodes and to the per-token path (also
  ``--per-token``), and the launcher's SLO gates; ``decode_step`` at a
  position held in a tensor (what a captured step replays) equal to the
  int path bit for bit;
* the program cache's health fields (``cache_metrics``,
  ``LPFServer.health``) equal to the JAX package's for the same counters;
* :class:`~repro_torch.runtime.server.ProgramDecodeEngine` on the CPU:
  solo, batched and per-token streams identical, prices equal to the
  ledger behind the server, and against the JAX package's engine the
  same tokens, ``ys``, ledger and ``token_seconds`` under CPU_HOST's
  fields.
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
    # a quarantined bucket decodes one eager step a token: the same
    # streams as the loop
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


# ==========================================================================
# the decode step at a position held on the device
# ==========================================================================

@pytest.mark.parametrize("arch,overrides", [
    ("llama3.2-1b", {}), ("mamba2-130m", {}), ("gemma2-9b", {}),
    ("llama3.2-1b", {"pos_embed": "learned"})],
    ids=["llama3.2-1b", "mamba2-130m", "gemma2-9b", "learned-positions"])
def test_decode_step_with_tensor_pos_equals_int_pos(arch, overrides):
    """12 steps into a rolling 8-slot cache: the position as a 0-d long
    tensor (what a captured step replays) gives the int path's tokens,
    logits and caches bit for bit."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import (Runtime, decode_step, init_caches,
                                    init_params)
    from torch.utils import _pytree as pytree
    cfg = dataclasses.replace(get_config(arch, smoke=True), **overrides)
    params = init_params(0, cfg, device="cpu")
    rt = Runtime("cpu")
    a = init_caches(cfg, 2, 8, device="cpu")
    b = init_caches(cfg, 2, 8, device="cpu")
    ta = tb = torch.tensor([3, 7])
    pos = torch.zeros((), dtype=torch.long)
    for step in range(12):
        ta, la, a = decode_step(params, ta, a, step, cfg, rt)
        tb, lb, b = decode_step(params, tb, b, pos, cfg, rt)
        pos += 1
        assert torch.equal(ta, tb) and torch.equal(la, lb), step
    for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(b)):
        assert torch.equal(x, y)
    assert int(pos) == 12


def test_bucket_decode_fn_on_cpu_is_the_eager_loop():
    """On the CPU a bucket has no graph, and its ``decode_fn(n)`` is the
    eager loop over ``step_fn`` from zeroed caches of the bucket's shape:
    12 tokens into its 8-slot cache, the slots rolling.  The bucket's
    shape is required, as in the JAX package."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_caches, init_params
    from repro_torch.runtime.train_step import (build_serve_buckets,
                                                build_serve_step)
    cfg = get_config("llama3.2-1b", smoke=True)
    params = init_params(0, cfg, device="cpu")
    ss = build_serve_buckets(cfg, [(2, 8)], device="cpu")[(2, 8)]
    assert ss.graph is None
    tok0 = torch.tensor([3, 7])
    got, caches = ss.decode_fn(12)(params, tok0, 0)
    want, tok = [], tok0
    ref = init_caches(cfg, 2, 8, device="cpu")
    for pos in range(12):
        tok, ref = ss.step_fn(params, ref, tok, pos)
        want.append(tok)
    assert got.shape == (12, 2) and torch.equal(got, torch.stack(want))
    with pytest.raises(TypeError):
        build_serve_step(cfg, device="cpu")


# ==========================================================================
# the model engine's two paths and the launcher's --per-token
# ==========================================================================

def test_model_engine_per_token_equals_loop():
    """A quarantined engine (every bucket on the per-token path from the
    start) decodes the loop's streams bit for bit."""
    from repro_torch.configs import get_config
    cfg = get_config("gemma2-9b", smoke=True)
    loop = serve_launch.ModelDecodeEngine(cfg, [(4, 16)], device="cpu",
                                          calibrate_tokens=2)
    per_token = serve_launch.ModelDecodeEngine(
        cfg, [(4, 16)], device="cpu", calibrate_tokens=2, per_token=True)
    assert per_token.quarantined == {(4, 16)} and per_token.quarantines == 1
    assert loop.quarantined == set() and loop.quarantines == 0
    reqs = [req(i, n=9, seed=s) for i, s in enumerate((5, 77, 301))]
    assert loop.decode((4, 16), reqs, 9) == per_token.decode((4, 16), reqs, 9)
    # on the CPU there is no graph: nothing captured, nothing replayed
    assert (loop.captures, loop.replays) == (0, 0)


def test_launcher_per_token_on_cpu(capsys):
    serve_launch.main(["--device", "cpu", "--requests", "4", "--tokens",
                       "6", "--cache-len", "8", "--batch", "2", "--check",
                       "--per-token", "--arch", "qwen3-14b"])
    text = capsys.readouterr().out
    assert "(per token)" in text
    assert "bit-identical to solo decode" in text
    assert "deadline_misses: 0" in text


def test_serve_check_holds_the_per_token_path(engine):
    """``serve(check=True)`` re-decodes every completed request solo on
    the loop and on the per-token path, and leaves the engine's
    quarantine set as it found it."""
    out = serve_launch.serve(engine, requests=6, seed=1, max_tokens=10,
                             check=True, verbose=False)
    assert out["solo_identical"] == out["completed"] >= 1
    assert out["per_token_identical"] == out["completed"]
    assert out["quarantines"] == 0 and engine.quarantined == set()


# ==========================================================================
# the program cache's health fields (cache_metrics, LPFServer.health)
# ==========================================================================

class CachedEngine(ScriptedEngine):
    """A scripted engine carrying a plan cache and a program cache, as a
    program engine does."""

    def __init__(self, plan_cache, program_cache):
        super().__init__(buckets=((2, 8),))
        self.plan_cache, self.program_cache = plan_cache, program_cache

    @property
    def cache_stats(self):
        return {"plan": self.plan_cache.stats,
                "program": self.program_cache.stats}


def _cached_engines():
    from repro.core import PlanCache as JaxPlanCache
    from repro.core import ProgramCache as JaxProgramCache
    from repro_torch.core import PlanCache, ProgramCache
    engines = (CachedEngine(PlanCache(), ProgramCache()),
               CachedEngine(JaxPlanCache(), JaxProgramCache()))
    for eng in engines:
        for layer, stats in eng.cache_stats.items():
            for i, f in enumerate(dataclasses.fields(stats)):
                setattr(stats, f.name, 3 * i + len(layer))
    return engines


def test_cache_metrics_of_a_program_cache_match_jax():
    from repro.runtime.monitor import cache_metrics as jax_cache_metrics
    from repro_torch.runtime.monitor import cache_metrics
    port, ref = _cached_engines()
    assert port.program_cache.memory_only_reason is None
    got = cache_metrics(port)
    assert got == jax_cache_metrics(ref)
    assert (got["program_memory_only"], got["program_pinned"],
            got["program_entries"], got["program_quarantined"]) == \
        (0, 0, 0, 0)


def test_server_health_over_a_program_cache_matches_jax():
    port, ref = _cached_engines()
    hp = LPFServer(port, max_queue=4)
    hj = jax_server.LPFServer(ref, max_queue=4)
    for srv, mod in ((hp, port_server), (hj, jax_server)):
        srv.submit(mod.ServeRequest(rid=0, n_tokens=3, deadline_s=1.0,
                                    seed=11))
        srv.run_until_idle()
    a, b = hp.drain(), hj.drain()
    assert {k: v for k, v in a.items() if k not in WALL_FIELDS} == \
        {k: v for k, v in b.items() if k not in WALL_FIELDS}
    assert "program_memory_only_reason" not in a
    assert a["program_memory_only"] == 0 and a["completed"] == 1


# ==========================================================================
# the pure-LPF decode engine
# ==========================================================================

def _cpu_host():
    """The JAX package's CPU_HOST fields as a port hardware model whose
    virtual-process link is CPU_HOST's ``ici`` link: the machine the
    JAX engine probes over its 8 host devices."""
    from repro.core import CPU_HOST
    from repro_torch.interop import hardware_from_fields
    hw = hardware_from_fields(dataclasses.asdict(CPU_HOST))
    return dataclasses.replace(hw, links={**hw.links,
                                          "vp": hw.links["ici"]})


@pytest.fixture(scope="module")
def program_engine():
    return port_server.ProgramDecodeEngine(buckets=((2, 8), (4, 8)),
                                           hardware=_cpu_host(),
                                           device="cpu")


def test_program_engine_bit_identical_solo_batched_fallback(program_engine):
    eng = program_engine
    a, b = req(0, seed=1234), req(1, seed=777)
    solo = eng.decode((4, 8), [a], 4)[0]
    batched = eng.decode((4, 8), [a, b], 4)[0]
    assert solo == batched
    eng.quarantine((4, 8))
    try:
        assert eng.decode((4, 8), [a], 4)[0] == solo
    finally:
        eng.quarantined.discard((4, 8))


def test_program_engine_prices_match_ledger_and_serve(program_engine):
    """Model compliance end to end, as the JAX engine's test: the served
    vclock is the sum of batch prices, no admitted request misses its
    deadline, each completes within its predicted time, and the hot
    buckets stay pinned in the health snapshot."""
    eng = program_engine
    assert eng.token_seconds((2, 8)) > 0
    assert eng.overhead_seconds((2, 8)) == 0.0
    assert eng.ledger_seconds((4, 8), 5) == eng.token_seconds((4, 8)) * 5
    assert [eng.round_tokens((4, 8), n) for n in (1, 3, 5, 9)] == \
        [1, 4, 8, 8]
    srv = LPFServer(eng, max_queue=8)
    reqs = synthetic_requests(10, 3, eng.buckets(),
                              token_cost_s=eng.token_seconds((4, 8)))
    for r in reqs:
        srv.submit(r)
    srv.run_until_idle()
    h = srv.drain()
    assert h["deadline_misses"] == 0
    assert h["completed"] > 0
    assert h["completed"] + h["shed"] == h["admitted"]
    assert h["program_pinned"] >= 2
    assert h["program_memory_only"] == 0
    for out in srv.take_outcomes().values():
        if out.status == "completed":
            assert out.completion_v <= out.predicted_v + 1e-12
        else:
            assert out.classified


def test_program_engine_refuses_a_persistent_store(tmp_path):
    """An unusable store directory is refused, not fatal: the engine's
    cache runs memory-only, says why, and serves."""
    blocker = tmp_path / "blocker"
    blocker.write_text("not a directory")
    eng = port_server.ProgramDecodeEngine(
        buckets=((2, 8),), persist_dir=str(blocker / "store"),
        device="cpu")
    assert eng.program_cache.store is None
    assert eng.program_cache.memory_only_reason
    assert eng.flush() == 0
    srv = port_server.LPFServer(eng)
    reqs = port_server.synthetic_requests(
        4, seed=1, buckets=eng.buckets(), token_cost_s=eng.token_seconds(
            (2, 8)), deadline_scale=100.0, tight_frac=0.0)
    for r in reqs:
        srv.submit(r)
    h = srv.drain()
    assert h["completed"] == 4
    assert h["program_memory_only_reason"].startswith("attach failed")


def test_program_engine_warm_starts_from_its_store(tmp_path):
    """``persist_dir=``: the first engine records and persists every
    bucket's program; a second engine on the directory warm-starts (every
    program a verified disk hit, no search) and decodes the same tokens;
    the server's drain flushes."""
    first = port_server.ProgramDecodeEngine(
        buckets=((2, 8), (4, 8)), persist_dir=str(tmp_path), device="cpu")
    st = first.program_cache.stats
    assert st.misses == len(first.program_cache) >= 1
    assert len(first.program_cache.store) == len(first.program_cache)
    reqs = port_server.synthetic_requests(
        6, seed=3, buckets=first.buckets(),
        token_cost_s=first.token_seconds((4, 8)), deadline_scale=100.0,
        tight_frac=0.0)
    want = {r.rid: first.decode((2, 8), [r], 8)[r.rid] for r in reqs}

    warm = port_server.ProgramDecodeEngine(
        buckets=((2, 8), (4, 8)), persist_dir=str(tmp_path), device="cpu")
    ws = warm.program_cache.stats
    assert ws.misses == 0 and ws.invalidated == 0
    assert ws.disk_hits == len(warm.program_cache)
    assert warm.plan_cache.stats.misses == 0
    got = {r.rid: warm.decode((2, 8), [r], 8)[r.rid] for r in reqs}
    assert got == want
    srv = port_server.LPFServer(warm)
    for r in reqs:
        srv.submit(r)
    h = srv.drain()
    assert h["completed"] == len(reqs) and h["program_disk_hits"] >= 1
    assert warm.flush() == 0              # the drain wrote back what's new


@pytest.fixture(scope="module")
def jax_program_engine():
    return jax_server.ProgramDecodeEngine(buckets=((2, 8), (4, 8)))


@pytest.mark.slow
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("bucket", [(2, 8), (4, 8)])
def test_program_engine_matches_jax_engine(program_engine,
                                           jax_program_engine, bucket,
                                           fused):
    """The same seeds through both engines: identical tokens, ``ys``
    within 1e-6, the same ledger (method, rounds, h_bytes, wire_bytes)
    and the same ``token_seconds`` under the JAX package's CPU_HOST
    fields, on the loop and on the per-token path."""
    import numpy as np
    port, ref = program_engine, jax_program_engine
    assert port.p == ref.n_devices == 8
    assert port.token_seconds(bucket) == ref.token_seconds(bucket)
    fields = lambda recs: [(r.label, r.method, r.rounds, r.h_bytes,
                            r.wire_bytes) for r in recs]
    assert fields(port._step_costs[bucket]) == \
        fields(ref._step_costs[bucket])
    seeds = np.array([float(s % 9973) + 1.0 for s in (1234, 777, 5, 99)
                      ][:bucket[0]], np.float32)
    ys_j, recs_j = ref._decode_fn(bucket, 8, fused)(seeds)
    ys_p, recs_p = port._run(bucket, seeds, 8, fused)
    ys_j = np.asarray(ys_j)
    assert ys_p.shape == ys_j.shape
    assert np.abs(ys_p.numpy() - ys_j).max() <= 1e-6 * np.abs(ys_j).max()
    assert fields(recs_p) == fields(recs_j)
    reqs = [req(i, n=8, seed=s) for i, s in
            enumerate((1234, 777, 5, 99)[:bucket[0]])]
    jreqs = [jax_server.ServeRequest(**dataclasses.asdict(r)) for r in reqs]
    if not fused:
        port.quarantine(bucket)
        ref.quarantine(bucket)
    try:
        assert port.decode(bucket, reqs, 8) == ref.decode(bucket, jreqs, 8)
    finally:
        port.quarantined.discard(bucket)
        ref._quarantined.discard(bucket)
