"""Parity of the port's persistent program store
(``repro_torch.core.persist`` and ``ProgramCache``'s disk ladder) with
the JAX package's ``repro.core.persist``.

* For every canned trace (and seeded random traces of
  ``tests/test_schedule_search.py``), priced on one machine in both
  packages, the cache key's entry filename and the payload JSON — key,
  program and certificate, byte for byte — are equal.
* An entry one package wrote loads in the other as ``invalid`` (the
  header's framework version differs), never as a hit.
* The store's own contract, as the JAX package tests it: round trip and
  warm hit, a cleared cache warm-starts, truncation, bit-flip, header
  skew and garbage degrade to a cold miss, a renamed entry is rejected,
  unverified programs are refused, eviction writes back, the
  ``LPF_PROGRAM_CACHE_DIR`` wiring, the metrics exporter.
* ``steps_from_signature`` rebuilds a trace whose signature is the
  persisted one (and equals the JAX package's reconstruction).
* A warm start through ``exec_`` on the CPU re-searches and re-plans
  nothing, and its values and ledger equal the JAX package's warm start.
Every comparison here is exact.
"""

import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import test_schedule_search as tss
from repro import core as jlpf
from repro.analysis import traces as jtraces
from repro.core import compat
from repro.core import machine as jmachine
from repro.core import persist as jpersist
from repro_torch import core as tlpf
from repro_torch.analysis import traces as ttraces
from repro_torch.analysis.verifier import VerifierReport
from repro_torch.core import persist as tpersist
from repro_torch.core.persist import FORMAT_VERSION, entry_filename
from repro_torch.interop import (hardware_from_fields, slot_from_fields,
                                 steps_from_fields)
from repro_torch.runtime.monitor import cache_metrics

P8 = 8
P4 = 4
JM = jmachine.probe({"x": P8}, jmachine.CPU_HOST)
TM = tlpf.probe({"x": P8}, hardware_from_fields(
    dataclasses.asdict(jmachine.CPU_HOST)))
MACHINE = tlpf.LPFMachine(p=P4, g=1e-9, l=1e-6, r=1e-10)


def _cpu_host_vp():
    """CPU_HOST as a port hardware model whose ``"vp"`` link is its
    ``"ici"`` link: a port context prices as the JAX package's on 8 host
    devices."""
    hw = hardware_from_fields(dataclasses.asdict(jmachine.CPU_HOST))
    return dataclasses.replace(hw, links={**hw.links,
                                          "vp": hw.links["ici"]})


def make_slot(sid, size=16):
    return tlpf.Slot(sid=sid, name=f"s{sid}", size=size,
                     dtype=torch.float32, kind="global", orig_shape=(size,))


def shift_trace(n_steps=3, base_sid=0):
    """n_steps independent shifts through distinct slot pairs — each a
    distinct content key, so the program has a unique canonical form."""
    steps = []
    for k in range(n_steps):
        a = make_slot(base_sid + 2 * k)
        b = make_slot(base_sid + 2 * k + 1)
        msgs = tuple(tlpf.Msg(s, (s + k + 1) % P4, a, 0, b, 0, 4 * (k + 1),
                              origin="put") for s in range(P4))
        steps.append(tlpf.ProgramStep(msgs, tlpf.LPF_SYNC_DEFAULT, f"s{k}"))
    return steps


def build_and_certify(cache, steps=None):
    steps = steps if steps is not None else shift_trace()
    prog, key = cache.get_or_build_keyed(steps, P4, MACHINE)
    cert = cache.certify(key, steps, prog)
    assert cert.ok
    return prog, key, steps


def _payload(mod, key, prog, cert) -> str:
    return json.dumps({"key": mod._encode(key),
                       "program": mod._encode(prog),
                       "certificate": mod._encode(cert)},
                      separators=(",", ":"))


def _both(jsteps, p, jscratch=None):
    """The JAX and the port's (key, program, certificate) of one trace."""
    tsteps = steps_from_fields([dataclasses.asdict(s) for s in jsteps])
    tscratch = None if jscratch is None else \
        slot_from_fields(dataclasses.asdict(jscratch))
    jpc, tpc = jlpf.ProgramCache(), tlpf.ProgramCache()
    jprog, jkey = jpc.get_or_build_keyed(jsteps, p, JM, scratch=jscratch)
    jcert = jpc.certify(jkey, jsteps, jprog, scratch=jscratch)
    tprog, tkey = tpc.get_or_build_keyed(tsteps, p, TM, scratch=tscratch)
    tcert = tpc.certify(tkey, tsteps, tprog, scratch=tscratch)
    return (jkey, jprog, jcert), (tkey, tprog, tcert)


# ---------------------------------------------------------------------------
# on-disk parity with the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(jtraces.CANNED_TRACES))
def test_entry_filename_and_payload_equal_jax(name):
    p, _slots, jsteps, jscratch = jtraces.CANNED_TRACES[name]()
    (jkey, jprog, jcert), (tkey, tprog, tcert) = _both(jsteps, p, jscratch)
    assert jcert.ok and tcert.ok
    assert tpersist.entry_filename(tkey) == jpersist.entry_filename(jkey)
    assert _payload(tpersist, tkey, tprog, tcert) == \
        _payload(jpersist, jkey, jprog, jcert)


@pytest.mark.parametrize("seed", range(12))
def test_random_trace_entries_equal_jax(seed):
    p, _slots, steps = tss.random_program(seed)
    (jkey, jprog, jcert), (tkey, tprog, tcert) = _both(steps, p)
    assert tpersist.entry_filename(tkey) == jpersist.entry_filename(jkey)
    assert _payload(tpersist, tkey, tprog, tcert) == \
        _payload(jpersist, jkey, jprog, jcert)


@pytest.mark.parametrize("name", sorted(ttraces.CANNED_TRACES))
def test_store_file_bytes_differ_only_in_the_header(name, tmp_path):
    """Both packages' stores hold one file of one name for the trace; the
    payload after the header line is byte-equal, the header names the
    framework (``"jax"`` / ``"torch"``) and nothing else differs."""
    p, _slots, jsteps, jscratch = jtraces.CANNED_TRACES[name]()
    (jkey, jprog, jcert), (tkey, tprog, tcert) = _both(jsteps, p, jscratch)
    jpath = jpersist.PersistentStore(str(tmp_path / "j")).save(
        jkey, jprog, jcert)
    tpath = tpersist.PersistentStore(str(tmp_path / "t")).save(
        tkey, tprog, tcert)
    assert os.path.basename(jpath) == os.path.basename(tpath)
    jblob, tblob = open(jpath, "rb").read(), open(tpath, "rb").read()
    jhead, jbody = jblob.split(b"\n", 1)
    thead, tbody = tblob.split(b"\n", 1)
    assert jbody == tbody
    jh, th = json.loads(jhead), json.loads(thead)
    assert "jax" in jh and "jax" not in th and th["torch"] == torch.__version__
    jh.pop("jax"), th.pop("torch")
    assert jh == th
    assert th["magic"] == tpersist.MAGIC == jpersist.MAGIC
    assert th["format"] == tpersist.FORMAT_VERSION == jpersist.FORMAT_VERSION


@pytest.mark.parametrize("name", sorted(ttraces.CANNED_TRACES))
def test_cross_package_entries_load_invalid(name, tmp_path):
    """An entry the JAX package wrote is version skew to the port (and the
    other way round): ``invalid``, never a hit; the port's own cache then
    counts it invalidated and cold-builds."""
    p, _slots, jsteps, jscratch = jtraces.CANNED_TRACES[name]()
    (jkey, jprog, jcert), (tkey, tprog, tcert) = _both(jsteps, p, jscratch)
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jpersist.PersistentStore(jdir).save(jkey, jprog, jcert)
    tpersist.PersistentStore(tdir).save(tkey, tprog, tcert)
    assert tpersist.PersistentStore(jdir).load(tkey) == ("invalid", None)
    assert jpersist.PersistentStore(tdir).load(jkey) == ("invalid", None)
    ((_f, err, *_rest),) = list(tpersist.PersistentStore(jdir).entries())
    assert "torch version skew" in err

    tsteps = steps_from_fields([dataclasses.asdict(s) for s in jsteps])
    tscratch = None if jscratch is None else \
        slot_from_fields(dataclasses.asdict(jscratch))
    cache = tlpf.ProgramCache(persist_dir=jdir)
    prog, key = cache.get_or_build_keyed(tsteps, p, TM, scratch=tscratch)
    assert key == tkey
    assert cache.stats.invalidated == 1 and cache.stats.disk_hits == 0
    assert cache.stats.misses == 1
    assert dataclasses.asdict(prog) == dataclasses.asdict(tprog)


@pytest.mark.parametrize("name", sorted(ttraces.CANNED_TRACES))
def test_steps_from_signature_matches_jax(name):
    p, _slots, jsteps, jscratch = jtraces.CANNED_TRACES[name]()
    (jkey, _, _), (tkey, _, _) = _both(jsteps, p, jscratch)
    sig = tkey[0]
    p2, steps2, scratch2 = tpersist.steps_from_signature(sig)
    jp2, jsteps2, jscratch2 = jpersist.steps_from_signature(jkey[0])
    assert p2 == jp2 == p
    assert tlpf.program_signature(steps2, p2, scratch2,
                                  list(range(len(steps2)))) == sig
    assert jlpf.program_signature(jsteps2, jp2, jscratch2,
                                  list(range(len(jsteps2)))) == jkey[0]
    assert sig == jkey[0]


# ---------------------------------------------------------------------------
# round trip + warm start (in-process)
# ---------------------------------------------------------------------------

def test_roundtrip_and_warm_hit(tmp_path):
    cold = tlpf.ProgramCache(persist_dir=str(tmp_path))
    prog, key, steps = build_and_certify(cold)
    assert cold.stats.misses == 1 and cold.stats.disk_misses == 1
    assert os.path.exists(tmp_path / entry_filename(key))

    warm = tlpf.ProgramCache(persist_dir=str(tmp_path))
    prog2, key2 = warm.get_or_build_keyed(steps, P4, MACHINE)
    assert key2 == key
    # a warm start is NOT a schedule search
    assert warm.stats.misses == 0
    assert warm.stats.disk_hits == 1 and warm.stats.invalidated == 0
    # the loaded entry arrives certified (re-verified at load)
    assert warm.certificate(key2).ok
    assert warm.certify(key2, steps, prog2).ok
    assert dataclasses.asdict(prog2) == dataclasses.asdict(prog)


def test_store_survives_clear(tmp_path):
    cache = tlpf.ProgramCache(persist_dir=str(tmp_path))
    _, key, steps = build_and_certify(cache)
    cache.clear()
    assert len(cache) == 0
    cache.get_or_build_keyed(steps, P4, MACHINE)
    assert cache.stats.misses == 0 and cache.stats.disk_hits == 1


def test_reconstructed_trace_matches_signature():
    steps = shift_trace()
    sig = tlpf.program_signature(steps, P4)
    p2, steps2, scratch2 = tlpf.steps_from_signature(sig)
    assert p2 == P4 and scratch2 is None
    assert tlpf.program_signature(steps2, p2) == sig


# ---------------------------------------------------------------------------
# corruption / skew: every path degrades to a cold miss, never an error
# ---------------------------------------------------------------------------

def _tamper_truncate(path):
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[:len(blob) - 7])


def _tamper_bitflip(path):
    blob = bytearray(open(path, "rb").read())
    blob[-3] ^= 0x40
    open(path, "wb").write(bytes(blob))


def _tamper_header(field, value):
    def tamper(path):
        blob = open(path, "rb").read()
        nl = blob.find(b"\n")
        header = json.loads(blob[:nl])
        header[field] = value
        open(path, "wb").write(json.dumps(header).encode() + blob[nl:])
    return tamper


def _tamper_garbage(path):
    open(path, "wb").write(b"not a cache entry at all")


@pytest.mark.parametrize("tamper", [
    _tamper_truncate,
    _tamper_bitflip,
    _tamper_header("format", FORMAT_VERSION + 1),
    _tamper_header("torch", "0.0.0"),
    _tamper_header("magic", "pickle"),
    _tamper_garbage,
], ids=["truncated", "bitflip", "format-skew", "torch-skew", "bad-magic",
        "garbage"])
def test_corrupt_entry_degrades_to_cold_miss(tmp_path, tamper):
    rec = tlpf.ProgramCache(persist_dir=str(tmp_path))
    prog, key, steps = build_and_certify(rec)
    tamper(str(tmp_path / entry_filename(key)))

    cache = tlpf.ProgramCache(persist_dir=str(tmp_path))
    prog2, key2 = cache.get_or_build_keyed(steps, P4, MACHINE)  # no raise
    assert key2 == key
    assert cache.stats.invalidated == 1 and cache.stats.disk_hits == 0
    assert cache.stats.misses == 1          # re-optimized from scratch
    assert dataclasses.asdict(prog2) == dataclasses.asdict(prog)
    # the bad entry was dropped, and certification re-persists a good one
    assert cache.certify(key2, steps, prog2).ok
    fresh = tlpf.ProgramCache(persist_dir=str(tmp_path))
    fresh.get_or_build_keyed(steps, P4, MACHINE)
    assert fresh.stats.disk_hits == 1 and fresh.stats.invalidated == 0


def test_renamed_entry_rejected_as_key_mismatch(tmp_path):
    rec = tlpf.ProgramCache(persist_dir=str(tmp_path))
    _, key_a, _ = build_and_certify(rec, shift_trace(n_steps=2))
    steps_b = shift_trace(n_steps=3)
    prog_b, key_b = rec.get_or_build_keyed(steps_b, P4, MACHINE)
    rec.certify(key_b, steps_b, prog_b)
    shutil.copyfile(tmp_path / entry_filename(key_a),
                    tmp_path / entry_filename(key_b))

    cache = tlpf.ProgramCache(persist_dir=str(tmp_path))
    cache.get_or_build_keyed(steps_b, P4, MACHINE)
    assert cache.stats.invalidated == 1 and cache.stats.disk_hits == 0


def test_stale_schedule_fails_reverification(tmp_path):
    """A well-formed entry whose schedule does not certify against the
    recorded trace (here: another program's, saved under this key) is
    invalidated, never served."""
    rec = tlpf.ProgramCache()
    prog_a, _key_a, _ = build_and_certify(rec, shift_trace(n_steps=2))
    steps_b = shift_trace(n_steps=3)
    prog_b, key_b = rec.get_or_build_keyed(steps_b, P4, MACHINE)
    cert_b = rec.certify(key_b, steps_b, prog_b)
    tlpf.PersistentStore(str(tmp_path)).save(key_b, prog_a, cert_b)

    cache = tlpf.ProgramCache(persist_dir=str(tmp_path))
    prog, _ = cache.get_or_build_keyed(steps_b, P4, MACHINE)
    assert cache.stats.invalidated == 1 and cache.stats.misses == 1
    assert dataclasses.asdict(prog) == dataclasses.asdict(prog_b)


def test_save_refuses_unverified(tmp_path):
    store = tlpf.PersistentStore(str(tmp_path))
    cache = tlpf.ProgramCache()
    steps = shift_trace()
    prog, key = cache.get_or_build_keyed(steps, P4, MACHINE)
    with pytest.raises(tlpf.PersistError):
        store.save(key, prog, None)
    failed = VerifierReport(ok=False, n_steps=1, n_groups=1, n_rewrites=0)
    with pytest.raises(tlpf.PersistError):
        store.save(key, prog, failed)
    assert store.filenames() == []


def test_eviction_writes_back(tmp_path):
    cache = tlpf.ProgramCache(maxsize=2)              # no store yet
    _, key_a, steps_a = build_and_certify(cache, shift_trace(2))
    build_and_certify(cache, shift_trace(3))
    cache.attach_store(str(tmp_path))                 # attached late
    assert tlpf.PersistentStore(str(tmp_path)).filenames() == []
    # inserting a third entry evicts the oldest certified one -> disk
    cache.get_or_build_keyed(shift_trace(4), P4, MACHINE)
    assert cache.stats.evictions == 1
    assert os.path.exists(tmp_path / entry_filename(key_a))

    warm = tlpf.ProgramCache(persist_dir=str(tmp_path))
    warm.get_or_build_keyed(steps_a, P4, MACHINE)
    assert warm.stats.disk_hits == 1


def test_flush_writes_back_what_is_new(tmp_path):
    cache = tlpf.ProgramCache()
    build_and_certify(cache, shift_trace(2))
    build_and_certify(cache, shift_trace(3))
    assert cache.flush() == 0                         # no store: no-op
    cache.attach_store(str(tmp_path))
    assert cache.flush() == 2
    assert cache.flush() == 0
    assert len(cache.store) == 2


# ---------------------------------------------------------------------------
# context wiring + metrics export
# ---------------------------------------------------------------------------

def test_context_env_var_attaches_store(tmp_path, monkeypatch):
    monkeypatch.setenv("LPF_PROGRAM_CACHE_DIR", str(tmp_path))
    ctx = tlpf.LPFContext(P4, device="cpu",
                          program_cache=tlpf.ProgramCache())
    assert ctx.program_cache.store is not None
    assert ctx.program_cache.store.directory == str(tmp_path)
    # explicit argument wins over the environment
    other = tmp_path / "other"
    ctx2 = tlpf.LPFContext(P4, device="cpu",
                           program_cache=tlpf.ProgramCache(),
                           persist_dir=str(other))
    assert ctx2.program_cache.store.directory == str(other)
    # a sub-context never reads the environment
    sub = tlpf.LPFContext(P4, device="cpu",
                          program_cache=tlpf.ProgramCache(), _parent=ctx)
    assert sub.program_cache.store is None
    # no env, no arg -> no store
    monkeypatch.delenv("LPF_PROGRAM_CACHE_DIR")
    ctx3 = tlpf.LPFContext(P4, device="cpu",
                           program_cache=tlpf.ProgramCache())
    assert ctx3.program_cache.store is None


def test_cache_metrics_exporter(tmp_path):
    cache = tlpf.ProgramCache(persist_dir=str(tmp_path))
    _, _, steps = build_and_certify(cache)
    warm = tlpf.ProgramCache(persist_dir=str(tmp_path))
    warm.get_or_build_keyed(steps, P4, MACHINE)
    ctx = tlpf.LPFContext(P4, device="cpu", program_cache=warm)
    m = cache_metrics(ctx)
    assert m["program_disk_hits"] == 1
    assert m["program_misses"] == 0
    assert {"plan_hits", "plan_misses", "program_hits",
            "program_invalidated"} <= set(m)


# ---------------------------------------------------------------------------
# the warm start through exec_, against the JAX package's
# ---------------------------------------------------------------------------

def _jax_workload(ctx, p):
    import jax.numpy as jnp
    ctx.resize_memory_register(3)
    ctx.resize_message_queue(2 * p)
    a = ctx.register_global("a", jnp.arange(4.0) + ctx.pid)
    b = ctx.register_global("b", jnp.zeros(8))
    c = ctx.register_global("c", jnp.zeros(4))
    with ctx.program("shifts"):
        ctx.put(a, b, to=lambda s: (s + 1) % p, size=4)
        ctx.sync(label="shift1")
        ctx.put(a, b, to=lambda s: (s + 2) % p, dst_off=4, size=4)
        ctx.sync(label="shift2")
    with ctx.program("gather"):
        ctx.put(a, c, to=lambda s: (s + 3) % p, size=4)
        ctx.sync(label="shift3")
    return ctx.value(b) + ctx.value(c).sum()


def _jax_run(mesh8, directory):
    pc = jlpf.ProgramCache(persist_dir=directory)
    plc = jlpf.PlanCache()
    box = []

    def wrapped(_):
        ctx = jlpf.LPFContext(("x",), hardware=jmachine.CPU_HOST,
                              plan_cache=plc, program_cache=pc)
        box.append(ctx.ledger)
        return _jax_workload(ctx, P8)

    fn = jax.jit(compat.shard_map(wrapped, mesh=mesh8, in_specs=(P(),),
                                  out_specs=P("x"), check_vma=False))
    out = np.asarray(fn(np.zeros(1, np.float32))).reshape(P8, 8)
    return out, box[0].records, pc.stats, plc.stats


def _port_run(directory):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "warm_start_script", os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "scripts", "warm_start.py"))
    ws = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ws)
    pc, plc = tlpf.ProgramCache(persist_dir=directory), tlpf.PlanCache()
    out, led = tlpf.exec_(P8, lambda ctx, s, p, _: ws._programs(ctx, p),
                          None, device="cpu", hardware=_cpu_host_vp(),
                          return_ledger=True, plan_cache=plc,
                          program_cache=pc)
    return out.numpy(), led.records, pc.stats, plc.stats


def test_warm_start_matches_the_jax_warm_start(mesh8, tmp_path):
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jcold, tcold = _jax_run(mesh8, jdir), _port_run(tdir)
    jwarm, twarm = _jax_run(mesh8, jdir), _port_run(tdir)
    for cold, warm in ((jcold, jwarm), (tcold, twarm)):
        assert cold[2].misses == 2 and cold[2].disk_hits == 0
        assert warm[2].misses == 0 and warm[3].misses == 0
        assert warm[2].disk_hits == 2 and warm[2].invalidated == 0
        assert [dataclasses.asdict(r) for r in warm[1]] == \
            [dataclasses.asdict(r) for r in cold[1]]
        assert (warm[0] == cold[0]).all()
    assert (twarm[0] == jwarm[0]).all()
    assert [dataclasses.asdict(r) for r in twarm[1]] == \
        [dataclasses.asdict(r) for r in jwarm[1]]
    # the two stores hold the same entries by name
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))


def test_warm_start_script_on_the_cpu(tmp_path):
    """``scripts/warm_start.py --device cpu``: two child processes on one
    store, the warm one with no searches and an equal ledger."""
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"))
    env.pop("LPF_FAULT_PLAN", None)
    proc = subprocess.run(
        [sys.executable, os.path.join(repo, "scripts", "warm_start.py"),
         "--device", "cpu", "--cache-dir", str(tmp_path)],
        env=env, cwd=repo, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 re-plans, 0 searches, 2 verified disk hits" in proc.stdout
    assert "ledger bit-for-bit" in proc.stdout
