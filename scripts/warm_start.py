#!/usr/bin/env python3
"""Cross-process warm start from the persistent program cache: the JAX
package's ``benchmarks/warm_start.py`` on the port.

    python3 scripts/warm_start.py                  # on the card
    python3 scripts/warm_start.py --device cpu     # a check on the CPU

A process records LPF programs with ``LPF_PROGRAM_CACHE_DIR`` set and
exits; a *fresh* process replaying the same programs must

* re-plan nothing (plan-cache misses == 0),
* re-search nothing (program-cache misses == 0, every program a disk hit
  re-certified by the schedule verifier), and
* produce a ledger (and values) bit-for-bit identical to the recording
  process's — the warm start changes where the schedule comes from,
  never what is executed or charged.

Run as a parent (no ``--phase``) it spawns the recording child and the
warm child on one store directory, asserts all three properties, and
prints the cold and warm host milliseconds to the end of the first
flush.  ``--phase run`` runs one child and writes its JSON to ``--out``:
``--workload programs`` (the default: two recorded programs over 8
virtual processes) or ``--workload bsp_fft`` (the paper's FFT at N =
2^``--log2n``, p = 8, through the ``fft_planes`` kernel on the card),
with the store and any fault plan from the environment
(``LPF_PROGRAM_CACHE_DIR``, ``LPF_FAULT_PLAN``).  A child's JSON holds
the cache counters, the ledger, a SHA-256 of the output's bytes, the
milliseconds to the first flush, and the faults an armed plan fired.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
sys.path.insert(0, SRC)

P = 8


def _programs(ctx, p):
    """Two recorded programs per run: a two-shift exchange and a
    scatter-style fan-out — distinct signatures, so a warm start must hit
    the store twice."""
    import torch

    ctx.resize_memory_register(3)
    ctx.resize_message_queue(2 * p)
    a = ctx.register_global("a", torch.arange(4.0, device=ctx.device)
                            + ctx.pid)
    b = ctx.register_global("b", ctx.replicate(torch.zeros(8)))
    c = ctx.register_global("c", ctx.replicate(torch.zeros(4)))
    with ctx.program("shifts"):
        ctx.put(a, b, to=lambda s: (s + 1) % p, size=4)
        ctx.sync(label="shift1")
        ctx.put(a, b, to=lambda s: (s + 2) % p, dst_off=4, size=4)
        ctx.sync(label="shift2")
    with ctx.program("gather"):
        ctx.put(a, c, to=lambda s: (s + 3) % p, size=4)
        ctx.sync(label="shift3")
    return ctx.value(b) + ctx.value(c).sum(dim=1, keepdim=True)


def fft_input(log2n: int):
    """The bsp_fft workload's input: seeded complex64 of length 2^log2n."""
    import numpy as np
    rng = np.random.default_rng([0, log2n])
    n = 1 << log2n
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)
            ).astype(np.complex64)


@contextlib.contextmanager
def first_flush_timer():
    """Yields a dict whose ``"ms"`` becomes the host milliseconds from the
    block's start to the end of the first program flush in it."""
    from repro_torch.core.context import LPFContext
    box = {"ms": None}
    real = LPFContext._execute_steps
    t0 = time.perf_counter()

    def timed(self, steps):
        out = real(self, steps)
        if box["ms"] is None:
            if self.device.type == "cuda":
                import torch
                torch.cuda.synchronize(self.device)
            box["ms"] = (time.perf_counter() - t0) * 1e3
        return out

    LPFContext._execute_steps = timed
    try:
        yield box
    finally:
        LPFContext._execute_steps = real


def digest(t) -> str:
    """SHA-256 of a tensor's bytes (on the host)."""
    import torch
    t = t.detach().cpu().contiguous()
    if t.is_complex():
        t = torch.view_as_real(t)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()


def run_workload(workload: str, device, log2n: int = 24, **caches) -> dict:
    """Run one workload through the public entry points (``exec_`` /
    ``bsp_fft``) and return the counters, ledger, output digest and the
    milliseconds to the first flush.  ``caches`` (``plan_cache``,
    ``program_cache``, ``persist_dir``) go to the context; by default the
    process-wide caches and ``LPF_PROGRAM_CACHE_DIR``."""
    import torch
    from repro_torch import core as lpf
    from repro_torch.algorithms import bsp_fft
    from repro_torch.runtime import faults

    plan_cache = caches.get("plan_cache")
    if plan_cache is None:
        plan_cache = lpf.global_plan_cache()
    program_cache = caches.get("program_cache")
    if program_cache is None:
        program_cache = lpf.global_program_cache()
    with first_flush_timer() as timer:
        t0 = time.perf_counter()
        if workload == "bsp_fft":
            x = torch.from_numpy(fft_input(log2n))
            out, ledger = bsp_fft(x, p=P, use_kernel=True, device=device,
                                  return_ledger=True, **caches)
        else:
            out, ledger = lpf.exec_(P, lambda ctx, s, p, _: _programs(
                ctx, p), None, device=device, return_ledger=True,
                **caches)
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
        wall = time.perf_counter() - t0
    st = program_cache.stats
    keys = program_cache.keys()
    inj = faults.active()
    certs = [program_cache.certificate(k) for k in keys]
    return {
        "workload": workload,
        "device": str(out.device),
        "wall_ms": wall * 1e3,
        "first_flush_ms": timer["ms"],
        "plan_misses": plan_cache.stats.misses,
        "program_misses": st.misses,
        "program_hits": st.hits,
        "program_disk_hits": st.disk_hits,
        "program_disk_misses": st.disk_misses,
        "program_invalidated": st.invalidated,
        "program_disk_errors": st.disk_errors,
        "compile_fallbacks": st.compile_fallbacks,
        "programs": len(keys),
        "certified": sum(1 for c in certs if c is not None and c.ok),
        "quarantined": len(program_cache.quarantined),
        "store": None if program_cache.store is None
        else program_cache.store.directory,
        "ledger": [dataclasses.asdict(r) for r in ledger.records],
        "digest": digest(out),
        "fault_plan": None if inj is None else inj.plan.spec(),
        "faults_fired": [] if inj is None else [list(f) for f in inj.fired],
    }


def spawn(workload: str, cache_dir: str, out_path: str, *, device: str,
          log2n: int = 24, fault_plan: str = None) -> dict:
    """Run one child (``--phase run``) with the store (and a fault plan)
    in its environment; returns its JSON."""
    env = dict(os.environ, LPF_PROGRAM_CACHE_DIR=cache_dir)
    env.pop("LPF_FAULT_PLAN", None)
    if fault_plan:
        env["LPF_FAULT_PLAN"] = fault_plan
    subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--phase", "run",
         "--workload", workload, "--log2n", str(log2n), "--device", device,
         "--out", out_path],
        env=env, check=True, timeout=600)
    with open(out_path) as fh:
        return json.load(fh)


def check_warm(cold: dict, warm: dict) -> None:
    """The warm-start claim: the recording child searched and persisted
    every program; the fresh one re-planned and re-searched nothing, every
    program a verified disk hit, and the ledger and output bit-for-bit."""
    assert cold["program_misses"] >= 1, cold
    assert cold["program_disk_hits"] == 0, cold
    assert warm["program_misses"] == 0, \
        f"warm start re-ran the schedule search: {warm}"
    assert warm["plan_misses"] == 0, \
        f"warm start re-planned a superstep: {warm}"
    assert warm["program_disk_hits"] == cold["programs"], (cold, warm)
    assert warm["certified"] == warm["programs"] == cold["programs"], warm
    assert warm["program_invalidated"] == 0, warm
    assert warm["ledger"] == cold["ledger"], (cold["ledger"],
                                              warm["ledger"])
    assert warm["digest"] == cold["digest"], (cold["digest"],
                                              warm["digest"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", choices=["run"],
                    help="run one child and write its JSON to --out")
    ap.add_argument("--workload", choices=["programs", "bsp_fft"],
                    default="programs")
    ap.add_argument("--log2n", type=int, default=24,
                    help="bsp_fft length 2^log2n")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    ap.add_argument("--cache-dir", help="store directory (default: a "
                                        "fresh temporary one)")
    args = ap.parse_args(argv)

    if args.phase == "run":
        res = run_workload(args.workload, args.device, args.log2n)
        with open(args.out, "w") as fh:
            json.dump(res, fh)
        print(f"{args.workload}: " + json.dumps(
            {k: v for k, v in res.items() if k != "ledger"}), flush=True)
        return 0

    with contextlib.ExitStack() as stack:
        cache_dir = args.cache_dir or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="lpf_warm_start_"))
        outdir = stack.enter_context(tempfile.TemporaryDirectory())
        kw = dict(device=args.device, log2n=args.log2n)
        cold = spawn(args.workload, cache_dir,
                     os.path.join(outdir, "cold.json"), **kw)
        warm = spawn(args.workload, cache_dir,
                     os.path.join(outdir, "warm.json"), **kw)
    check_warm(cold, warm)
    print("bench,phase,search_misses,disk_hits,first_flush_ms,wall_ms")
    for phase, r in (("cold", cold), ("warm", warm)):
        print(f"warm_start,{phase},{r['program_misses']},"
              f"{r['program_disk_hits']},{r['first_flush_ms']},"
              f"{r['wall_ms']}")
    print(f"# fresh-process replay on {warm['device']}: 0 re-plans, 0 "
          f"searches, {warm['program_disk_hits']} verified disk hits, "
          f"ledger bit-for-bit ({len(warm['ledger'])} records)")
    print("warm_start " + json.dumps({
        "workload": args.workload, "device": warm["device"],
        "cold_first_flush_ms": cold["first_flush_ms"],
        "warm_first_flush_ms": warm["first_flush_ms"],
        "cold_wall_ms": cold["wall_ms"], "warm_wall_ms": warm["wall_ms"],
        "disk_hits": warm["program_disk_hits"],
        "records": len(warm["ledger"])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
