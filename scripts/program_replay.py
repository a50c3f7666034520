#!/usr/bin/env python3
"""Program replay, bucketed gradient sync and split-phase overlap — the
JAX package's ``benchmarks/program_replay.py`` on the port: the BSP case
for fewer, fatter and overlapping h-relations, over virtual pods.

    python3 scripts/program_replay.py          # on the card
    python3 scripts/program_replay.py --cpu    # a check on the CPU

Four measurements, each at the JAX benchmark's own sizes:

1. **Bucketed grad sync** — an 8-layer gradient tree (2^14 f32 a layer)
   synced across q = 8 pods three ways at equal bytes: per layer, 4
   layers a bucket, one flattened pair.  The ledger's superstep count
   must drop >= 4x from per-layer to bucketed, and a recorded program's
   executed ledger must equal fresh plans of its tables bit for bit.
2. **Recorded-program replay** — an 8-superstep program re-staged 200
   times (host only): planning every superstep cold, a warm plan cache,
   and the program cache's replay.
3. **Split-phase overlap** — the 8-layer sync (2^16 f32 a layer) in
   buckets of 2 layers at p = 4 and p = 8, fenced against overlapped, on
   one stream (``LPF_OVERLAP_STREAMS=0``), dispatched and compiled, and
   compiled on the side-stream pool (dispatched, overlap groups never
   fork: ``core.sync.fork_streams``): ``pod_allreduce`` ``bucketed_fenced``
   against ``bucketed_overlap`` (compiled: the call captured as one CUDA
   graph), and the recorded ``bucket_sync`` program
   (``build_cross_pod_sync``: every bucket's pair staged before any is
   read, so its schedule overlaps the buckets' supersteps) against one
   ``allreduce`` program a bucket (compiled: ``CompiledProgram``).
   (``lpf_bucketed_allreduce`` reads each bucket inside its recording, a
   flush of that bucket's cone alone, in both packages: its buckets never
   overlap.)  Every
   variant's values are bit-equal to the fenced one-stream run; the
   overlapped ledgers carry ``overlap_cost`` groups, equal to fresh plans
   of their members bit for bit, at the fenced run's total wire and a
   lower predicted time.
4. **Compiled replay** — 64 iterations of a small-h bucketed sync:
   dispatched one flush an iteration against ``compile_loop`` (the loop
   body captured as one CUDA graph); both must land on the pods' mean.

Wall-clock comparisons are reported, never asserted (as the JAX
benchmark reports its paired ratio on hosts that cannot run the pods
side by side): the counts, ledgers and values are what must hold.
Times: medians, the host clock around calls that end in a synchronize;
the overlap rows also give the median of per-pair ratios of paired,
order-alternating calls.  Prints one JSON line a measurement and, on the
card, its name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))
sys.path.insert(0, HERE)

SEED = 0
LAYERS = 8
LAYER_ELEMS = 1 << 14          # measurement 1: 64 KiB a layer (f32)
OVERLAP_ELEMS = 1 << 16        # measurement 3: 256 KiB a layer
OVERLAP_P = (4, 8)
OVERLAP_REPS = 30
N_STEPS, N_ITERS = 8, 200      # measurement 2
COMPILED_ITERS, COMPILED_ELEMS, COMPILED_BUCKET = 64, 256, 128


def sync_device(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host_ms(fn, dev, reps: int, warmup: int = 2) -> float:
    """Median host milliseconds of ``fn()``, each call ending in a
    synchronize of ``dev``."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        sync_device(dev)
        t0 = time.perf_counter()
        fn()
        sync_device(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


@contextlib.contextmanager
def environ(values: dict):
    """Set (or, for None, unset) environment variables in the block."""
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def streams(pool: bool):
    """Overlap groups on the side-stream pool, or all on one stream."""
    return environ({"LPF_OVERLAP_STREAMS": None if pool else "0"})


def stream_routes(routes) -> list:
    """``(pool, route)`` pairs to run: every route on one stream, and the
    compiled one on the pool too (dispatched, overlap groups stay on the
    current stream whatever the setting: ``core.sync.fork_streams``)."""
    return [(False, r) for r in routes] + \
        [(True, r) for r in routes if r == "compiled"]


def compiled_programs(on: bool):
    """Contexts made in the block compile their programs, or dispatch
    them (``LPF_COMPILE_PROGRAMS=0``)."""
    return environ({"LPF_COMPILE_PROGRAMS": "1" if on else "0"})


def layer_grads(q: int, layers: int, elems: int, dev, seed=SEED) -> dict:
    """A pod-varying 8-layer gradient tree: ``layer{i}`` is ``[q, elems]``
    f32 drawn from ``seed``."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    return {f"layer{i}": torch.randn(q, elems, generator=gen).to(dev)
            for i in range(layers)}


def machine_of(p: int):
    from repro_torch import core as lpf
    return lpf.probe({"vp": p}, lpf.H100_SXM)


# --------------------------------------------------------------------------
# 1. bucketed gradient sync: superstep count at equal bytes
# --------------------------------------------------------------------------

def bench_bucketed(dev, q: int = 8, reps: int = 10) -> list:
    from repro_torch import core as lpf
    from repro_torch.bsp.pod_sync import pod_allreduce
    grads = layer_grads(q, LAYERS, LAYER_ELEMS, dev)
    layer_bytes = LAYER_ELEMS * 4
    rows = []
    for name, bucket in (("per-layer", 1), ("bucketed", 4 * layer_bytes),
                         ("flat", None)):
        ledger = lpf.CostLedger()
        method = "bucketed" if bucket is not None else "rs+ag"
        pod_allreduce(grads, q, ledger=ledger, method=method,
                      bucket_bytes=bucket)
        ms = host_ms(lambda: pod_allreduce(grads, q, method=method,
                                           bucket_bytes=bucket), dev, reps)
        rows.append(dict(name=name, supersteps=ledger.supersteps,
                         rounds=ledger.rounds, wire_bytes=ledger.wire_bytes,
                         ms=ms))
    per_layer, bucketed = rows[0], rows[1]
    ratio = per_layer["supersteps"] / bucketed["supersteps"]
    assert ratio >= 4, f"superstep reduction {ratio}x < 4x"
    assert abs(bucketed["wire_bytes"] - per_layer["wire_bytes"]) <= \
        4 * LAYER_ELEMS * 4
    return rows


def _slot(sid: int, size: int):
    import torch
    from repro_torch import core as lpf
    return lpf.Slot(sid, f"s{sid}", size, torch.float32, "global", (size,))


def check_ledger_bit_for_bit(dev, p: int = 8) -> int:
    """A recorded program of two independent shifts: its executed ledger
    equals fresh plans of its tables (overlapped, merged or one by one,
    as the optimizer chose), label aside."""
    import torch
    from repro_torch import core as lpf

    def spmd(ctx, s, p_, _):
        ctx.resize_memory_register(2)
        ctx.resize_message_queue(2 * p_)
        a = ctx.register_global("a", torch.arange(4.0, device=ctx.device)
                                + ctx.pid)
        b = ctx.register_global("b", ctx.replicate(torch.zeros(8)))
        with ctx.program():
            ctx.put(a, b, to=lambda s_: (s_ + 1) % p_, size=4)
            ctx.sync(label="shift1")
            ctx.put(a, b, to=lambda s_: (s_ + 2) % p_, dst_off=4, size=4)
            ctx.sync(label="shift2")
        return ctx.value(b)

    _, ledger = lpf.exec_(p, spmd, None, device=dev, return_ledger=True,
                          program_cache=lpf.ProgramCache())
    slot_a, slot_b = _slot(0, 4), _slot(1, 8)

    def msgs(pairs):
        return [lpf.Msg(s, (s + shift) % p, slot_a, 0, slot_b, off, 4,
                        origin="put") for shift, off in pairs
                for s in range(p)]

    plans = [lpf.plan_sync(msgs([pair]), p, lpf.LPF_SYNC_DEFAULT)
             for pair in ((1, 0), (2, 4))]
    if len(ledger.records) == 1:
        r = ledger.records[0]
        if r.method.startswith("overlap["):
            fresh = lpf.overlap_cost([pl.cost for pl in plans],
                                     label=r.label)
        else:       # the merge gate batched them into one superstep
            fresh = dataclasses.replace(lpf.plan_sync(
                msgs(((1, 0), (2, 4))), p, lpf.LPF_SYNC_DEFAULT).cost,
                label=r.label)
        assert fresh == r, (fresh, r)
    else:
        for r, pl in zip(ledger.records, plans):
            assert dataclasses.replace(pl.cost, label=r.label) == r, \
                (pl.cost, r)
    return len(ledger.records)


# --------------------------------------------------------------------------
# 2. recorded-program replay vs eager per-superstep planning (host only)
# --------------------------------------------------------------------------

def _fresh_trace(p: int, it: int) -> list:
    """The same 8-superstep shift program staged through fresh slots each
    iteration — what a collective called in a loop produces."""
    from repro_torch import core as lpf
    steps = []
    for k in range(N_STEPS):
        a = _slot(10_000 * it + 2 * k, 64)
        b = _slot(10_000 * it + 2 * k + 1, 64)
        msgs = tuple(lpf.Msg(s, (s + k + 1) % p, a, 0, b, 0, 64,
                             origin="put") for s in range(p))
        steps.append(lpf.ProgramStep(msgs, lpf.LPF_SYNC_DEFAULT, f"s{k}"))
    return steps


def bench_replay(p: int = 8, iters: int = N_ITERS) -> list:
    from repro_torch import core as lpf
    machine = machine_of(p)
    rows = []
    t0 = time.perf_counter()
    for it in range(iters):
        for st in _fresh_trace(p, it):
            lpf.plan_sync(list(st.msgs), p, st.attrs)
    rows.append(dict(name="eager-cold", plans=iters * N_STEPS,
                     ms=(time.perf_counter() - t0) * 1e3))
    cache = lpf.PlanCache()
    t0 = time.perf_counter()
    for it in range(iters):
        for st in _fresh_trace(p, it):
            cache.get_or_plan(list(st.msgs), p, st.attrs)
    rows.append(dict(name="eager-warm", plans=cache.stats.misses,
                     ms=(time.perf_counter() - t0) * 1e3))
    pcache = lpf.ProgramCache()
    t0 = time.perf_counter()
    for it in range(iters):
        steps = _fresh_trace(p, it)
        order = lpf.canonical_order(steps)
        prog = pcache.get_or_build(steps, p, machine, order=order)
        prog.materialize(steps, order=order)
    rows.append(dict(name="program-replay", plans=pcache.stats.misses,
                     ms=(time.perf_counter() - t0) * 1e3))
    assert rows[1]["plans"] == N_STEPS and rows[2]["plans"] == 1, rows
    return rows


# --------------------------------------------------------------------------
# 3. split-phase overlap: fenced buckets vs the pipeline, streams or not
# --------------------------------------------------------------------------

def graphed(fn, dev):
    """``fn()`` captured as one CUDA graph (after a warm-up call on a side
    stream); returns the replay, which returns the graph's outputs."""
    import torch
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()

    def replay():
        graph.replay()
        return out
    return replay


def paired(fns: dict, dev, reps: int) -> dict:
    """Paired, order-alternating host times of each of ``fns``."""
    times = {k: [] for k in fns}
    for rep in range(reps):
        order = list(fns) if rep % 2 == 0 else list(reversed(list(fns)))
        for k in order:
            sync_device(dev)
            t0 = time.perf_counter()
            fns[k]()
            sync_device(dev)
            times[k].append((time.perf_counter() - t0) * 1e3)
    return times


def bench_overlap(dev, p: int, elems: int = OVERLAP_ELEMS,
                  reps: int = OVERLAP_REPS) -> dict:
    """Fenced against overlapped buckets at ``p`` pods: ``pod_allreduce``
    and the recorded LPF pipeline, one stream dispatched and compiled,
    and the pool compiled (:func:`stream_routes`)."""
    import torch
    from repro_torch import core as lpf
    from repro_torch.bsp import allreduce, build_cross_pod_sync
    from repro_torch.bsp.pod_sync import pod_allreduce
    from repro_torch.launch.mesh import make_mesh
    grads = layer_grads(p, LAYERS, elems, dev, seed=SEED + p)
    bucket = 2 * elems * 4                  # 2 layers a bucket
    machine = machine_of(p)
    out = dict(p=p, layer_elems=elems, bucket_bytes=bucket, rows=[])

    # pod_allreduce: ledgers (stream-independent), then values and times
    ledgers = {}
    for method in ("bucketed_fenced", "bucketed_overlap"):
        ledgers[method] = lpf.CostLedger()
        pod_allreduce(grads, p, ledger=ledgers[method], method=method,
                      bucket_bytes=bucket)
    fen, ovl = ledgers["bucketed_fenced"], ledgers["bucketed_overlap"]
    assert fen.total_wire_bytes == ovl.total_wire_bytes
    assert ovl.supersteps == fen.supersteps + 1 == LAYERS // 2 + 1
    assert ovl.predicted_seconds(machine) < fen.predicted_seconds(machine)
    out["pod_allreduce_ledger"] = {m: dict(
        supersteps=l.supersteps, total_wire_bytes=l.total_wire_bytes,
        predicted_us=l.predicted_seconds(machine) * 1e6)
        for m, l in ledgers.items()}
    ref = None
    routes = ["dispatched"] + (["compiled"] if dev.type == "cuda" else [])
    for pool, route in stream_routes(routes):
        with streams(pool):
            fns = {}
            for method in ("bucketed_fenced", "bucketed_overlap"):
                def call(method=method):
                    return pod_allreduce(grads, p, method=method,
                                         bucket_bytes=bucket)
                fns[method] = graphed(call, dev) \
                    if route == "compiled" else call
            for method, fn in fns.items():
                got = fn()
                if ref is None:
                    ref = {k: v.clone() for k, v in got.items()}
                assert all(torch.equal(got[k], ref[k]) for k in ref), \
                    f"pod_allreduce {method} {route} pool={pool}"
            times = paired(fns, dev, reps)
            f, o = times["bucketed_fenced"], times["bucketed_overlap"]
            out["rows"].append(dict(
                path="pod_allreduce", route=route,
                streams="pool" if pool else "one",
                fenced_ms=statistics.median(f),
                overlap_ms=statistics.median(o),
                paired_ratio=statistics.median(
                    a / b for a, b in zip(f, o))))

    # the recorded bucket_sync program (every bucket's pair staged before
    # any is read: one program, its buckets' supersteps overlapped)
    # against one allreduce program a bucket, in the same buckets
    sync = build_cross_pod_sync(make_mesh((p, 1, 1)), None,
                                bucket_bytes=bucket)
    names = list(grads)
    lpf_ref, lpf_ledgers = None, {}
    for pool, route in stream_routes(("dispatched", "compiled")):
        with streams(pool):
            lpf.global_program_cache().clear()
            ctx = lpf.LPFContext(p, device=dev)
            ctx.compile_programs = route == "compiled"

            def fenced(ctx=ctx):
                out = {}
                for k in range(0, LAYERS, 2):
                    pair = names[k:k + 2]
                    red = allreduce(ctx, torch.cat(
                        [grads[n] for n in pair], dim=1),
                        label=f"bucket{k // 2}") / p
                    for j, n in enumerate(pair):
                        out[n] = red[:, j * elems:(j + 1) * elems]
                return out

            fns = {"fenced": fenced, "overlap": lambda: sync(grads)}
            with compiled_programs(route == "compiled"):
                for name, fn in fns.items():
                    n0 = len(ctx.ledger.records)
                    # the compiled programs' trial: eager calls, the
                    # capture, replays; every call checked
                    for _ in range(8):
                        res = fn()
                        got = torch.cat([res[n] for n in names], 1)
                        if lpf_ref is None:
                            lpf_ref = got.clone()
                        assert torch.equal(got, lpf_ref), \
                            f"lpf {name} {route} pool={pool}"
                    if name == "fenced":
                        recs = ctx.ledger.records[n0:]
                        recs = recs[:len(recs) // 8]
                    else:
                        recs = sync_ledger(sync, grads)
                    lpf_ledgers.setdefault(name, recs)
                    assert recs == lpf_ledgers[name]
                times = paired(fns, dev, reps)
            compiled = lpf.global_program_cache().artifacts()
            f, o = times["fenced"], times["overlap"]
            out["rows"].append(dict(
                path="bucket_sync", route=route,
                streams="pool" if pool else "one",
                fenced_ms=statistics.median(f),
                overlap_ms=statistics.median(o),
                paired_ratio=statistics.median(
                    a / b for a, b in zip(f, o)),
                graphs=sum(bool(a.use_graph) for a in compiled),
                programs=len(compiled)))
    fen_l, ovl_l = lpf_ledgers["fenced"], lpf_ledgers["overlap"]
    assert sum(r.total_wire_bytes for r in fen_l) == \
        sum(r.total_wire_bytes for r in ovl_l), (fen_l, ovl_l)
    assert any(r.method.startswith("overlap[") for r in ovl_l), ovl_l
    out["bucket_sync_ledger"] = {k: [dict(label=r.label, method=r.method,
                                          wire_bytes=r.wire_bytes)
                                     for r in v]
                                 for k, v in lpf_ledgers.items()}
    out["bucket_sync_predicted_us"] = {
        k: sum(r.predicted_seconds(machine) for r in v) * 1e6
        for k, v in lpf_ledgers.items()}
    assert out["bucket_sync_predicted_us"]["overlap"] < \
        out["bucket_sync_predicted_us"]["fenced"]
    return out


def sync_ledger(sync, grads) -> list:
    """The ledger of one ``bucket_sync`` call: the records its hooked
    context made."""
    from repro_torch.bsp import grad_sync
    ctxs = []
    real = grad_sync.hook

    def spy(q, spmd, args=None, **kw):
        def wrapped(ctx, s, p, a):
            ctxs.append(ctx)
            return spmd(ctx, s, p, a)
        return real(q, wrapped, args, **kw)

    grad_sync.hook = spy
    try:
        sync(grads)
    finally:
        grad_sync.hook = real
    return list(ctxs[0].ledger.records)


def check_overlap_ledger_bit_for_bit(dev, p: int = 8) -> int:
    """The recorded two-bucket pipeline schedules [rs0||rs1][ag0||ag1]; each
    overlap group's record equals ``overlap_cost`` of fresh plans of its
    members, bit for bit."""
    import torch
    from repro_torch import bsp, core as lpf

    def spmd(ctx, s, p_, _):
        x0 = (torch.arange(float(p_), device=ctx.device) + ctx.pid)
        x1 = (torch.arange(float(p_), device=ctx.device) * 2 - ctx.pid)
        with ctx.program("buckets"):
            h0 = bsp.allreduce_start(ctx, x0, label="b0")
            h1 = bsp.allreduce_start(ctx, x1, label="b1")
        return bsp.allreduce_done(ctx, h0) + bsp.allreduce_done(ctx, h1)

    with streams(True):
        _, ledger = lpf.exec_(p, spmd, None, device=dev, return_ledger=True,
                              program_cache=lpf.ProgramCache())
    records = ledger.records
    assert [r.method for r in records] == \
        ["overlap[fused_rs+fused_rs]", "overlap[fused_ag+fused_ag]"], records
    src, buf, out = (_slot(i, [p, 1, p][i]) for i in range(3))
    rs = [lpf.Msg(s, d, src, d, buf, 0, 1) for s in range(p)
          for d in range(p)]
    ag = [lpf.Msg(s, d, buf, 0, out, s, 1) for s in range(p)
          for d in range(p)]
    rs_plan = lpf.plan_sync(rs, p, lpf.LPF_SYNC_DEFAULT.replace(
        reduce_op="sum"))
    ag_plan = lpf.plan_sync(ag, p, lpf.LPF_SYNC_DEFAULT)
    for rec, plan in zip(records, (rs_plan, ag_plan)):
        fresh = lpf.overlap_cost([plan.cost, plan.cost], label=rec.label)
        assert fresh == rec, (fresh, rec)
    return len(records)


def overlap_phase(dev, reps: int = OVERLAP_REPS,
                  elems: int = OVERLAP_ELEMS) -> list:
    """Measurement 3 at p = 4 and 8, with the ledger check; one JSON
    line a p."""
    rows = []
    for p in OVERLAP_P:
        row = bench_overlap(dev, p, elems=elems, reps=reps)
        rows.append(row)
        print("program_replay overlap " + json.dumps(row), flush=True)
    n = check_overlap_ledger_bit_for_bit(dev)
    print(f"program_replay overlap ledger: {n} overlap groups equal to "
          f"fresh plans bit for bit", flush=True)
    return rows


# --------------------------------------------------------------------------
# 4. compiled replay: the loop body as one graph vs one flush an iteration
# --------------------------------------------------------------------------

def bench_compiled_replay(dev, p: int = 8, iters: int = COMPILED_ITERS,
                          reps: int = 5) -> dict:
    import torch
    from repro_torch import core as lpf
    from repro_torch.bsp.pod_sync import lpf_bucketed_allreduce

    def one_iter(ctx, x):
        return lpf_bucketed_allreduce(ctx, x, COMPILED_BUCKET, mean=True)

    x = (torch.arange(p * COMPILED_ELEMS, dtype=torch.float32) % 97.0
         ).reshape(p, COMPILED_ELEMS).to(dev) * 0.25 + 1.0

    def dispatched():
        ctx = lpf.LPFContext(p, device=dev)
        ctx.compile_programs = False
        y = x
        for _ in range(iters):
            y = one_iter(ctx, y)
        return y

    def fused():
        ctx = lpf.LPFContext(p, device=dev)
        return ctx.compile_loop(one_iter, x, n_iters=iters, label="ddp")

    d_ms = host_ms(dispatched, dev, reps, warmup=1)
    f_ms = host_ms(fused, dev, reps, warmup=1)
    ref = x.mean(0, keepdim=True).expand(p, COMPILED_ELEMS)
    err = max((dispatched() - ref).abs().max().item(),
              (fused() - ref).abs().max().item())
    assert err < 1e-4, f"fused/dispatched numerics diverged: {err}"
    return dict(iters=iters, dispatched_us_per_iter=d_ms * 1e3 / iters,
                fused_us_per_iter=f_ms * 1e3 / iters,
                ratio=d_ms / f_ms, max_abs_err=err)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="a check on the CPU at small sizes")
    args = ap.parse_args(argv)
    import torch
    if args.cpu:
        dev, reps, elems = torch.device("cpu"), 3, 1 << 10
    else:
        if not torch.cuda.is_available():
            print("program_replay: no CUDA device (use --cpu for a check "
                  "on the CPU)", file=sys.stderr)
            return 1
        dev, reps, elems = torch.device("cuda"), OVERLAP_REPS, OVERLAP_ELEMS
    rows = bench_bucketed(dev, reps=reps)
    print("program_replay bucketed " + json.dumps(rows), flush=True)
    n = check_ledger_bit_for_bit(dev)
    print(f"program_replay ledger: {n} records equal to fresh plans",
          flush=True)
    replay = bench_replay(iters=20 if args.cpu else N_ITERS)
    print("program_replay replay " + json.dumps(replay), flush=True)
    overlap_phase(dev, reps=reps, elems=elems)
    compiled = bench_compiled_replay(dev, iters=8 if args.cpu
                                     else COMPILED_ITERS, reps=reps)
    print("program_replay compiled " + json.dumps(compiled), flush=True)
    if dev.type == "cuda":
        from _timing import card_line
        print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
