#!/usr/bin/env python3
"""The searched schedule against the adjacent-pairs peephole against
recorded order, predicted and measured: the canned traces of
``repro_torch.analysis.traces`` (the JAX package's
``benchmarks/schedule_search.py`` shapes) at p = 8 on int32 values drawn
from a seed.

    python3 scripts/schedule_search.py              # on the card
    python3 scripts/schedule_search.py --cpu        # a check on the CPU

On the card the traces run at the sizes ``chip_smoke.py`` (o) runs them
(8 DDP buckets of 16 MiB a process, two FFT pairs of 8 MiB a process,
the fragmented trace, the PageRank shape with a 2 MiB halo); with
``--cpu`` at the builders' default sizes.  For each trace: the machine's
(g, l) (the context's own probe of the ``"vp"`` link), the predicted milliseconds of the three schedules, and each schedule
alone executed on a registry: recorded order (one ``execute_plan`` a
step), the peephole (``search=False``) and the searched schedule through
``execute_schedule``, and the searched schedule compiled
(``CompiledProgram``, timed once it has chosen between eager calls and
a CUDA graph replay, its copies in and out included; the times of its
timed calls each way and its choice are printed too).  Every schedule's
values are checked bit-equal to recorded order, on every call before the
timing.  Times are medians of 10 calls (CUDA events on the card,
the host clock on the CPU).  Prints one JSON line a trace and the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))
sys.path.insert(0, HERE)

SEED, REPS = 0, 10
CARD_SIZES = {
    "bucketed_sync8": (8, 8, 1 << 19),
    "fft_redistribute": (8, 1 << 18),
    "fragmented_valiant": (8,),
    "pagerank": (8, 1 << 16),
}


def timer(dev, reps: int):
    """Median milliseconds of ``fn()`` over ``reps`` calls."""
    if dev.type == "cuda":
        from _timing import cuda_ms
        return lambda fn: cuda_ms(fn, reps=reps, warmup=2)

    def host(fn):
        fn()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    return host


def run_trace(name, args, dev):
    import torch
    from repro_torch import core as lpf
    from repro_torch.analysis import traces
    from repro_torch.core.program import TRIAL_CALLS

    p, slots, steps, scratch = traces.CANNED_TRACES[name](*args)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    init = {s.sid: torch.randint(-(1 << 20), 1 << 20, (p, s.size),
                                 dtype=torch.int32, device=dev,
                                 generator=gen) for s in slots}
    ctx = lpf.LPFContext(p, device=dev, program_cache=lpf.ProgramCache())
    machine = ctx.probe()
    _, reset, handles, bound = traces.bind_trace(ctx, slots, steps, scratch,
                                                 init, label=name)
    searched = lpf.optimize_program(bound, p, machine, scratch=ctx._scratch)
    peephole = lpf.optimize_program(bound, p, machine, scratch=ctx._scratch,
                                    search=False)
    order = lpf.canonical_order(bound)
    plans = [lpf.plan_sync(list(st.msgs), p, st.attrs, ctx._scratch)
             for st in bound]

    def values():
        return {sid: ctx.registry.value(h) for sid, h in handles.items()}

    def in_order():
        for st, plan in zip(bound, plans):
            lpf.execute_plan(plan, ctx.registry, list(st.msgs), st.attrs,
                             st.label, scratch=ctx._scratch)

    def schedule(prog, ordr):
        entries = prog.materialize(bound, order=ordr)
        return lambda: lpf.execute_schedule(entries, prog.groups(),
                                            ctx.registry,
                                            scratch=ctx._scratch)

    cp = lpf.compile_program(searched, bound, order, p, dev,
                             scratch=ctx._scratch)
    slot_list = lpf.trace_slot_map(bound, order)

    def compiled():
        vals = [ctx.registry.value(s) for s in slot_list]
        sv = ctx.registry.value(ctx._scratch) if cp.scratch is not None \
            else None
        for sid, v in cp(vals, sv).items():
            ctx.registry.set_value(ctx._scratch if sid < 0
                                   else slot_list[sid], v)

    runs = {"in_order": in_order,
            "peephole": schedule(peephole, list(range(len(bound)))),
            "searched": schedule(searched, order),
            "searched_compiled": compiled}
    reset()
    in_order()
    ref = values()
    ms = timer(dev, REPS)
    row = dict(name=name, args=list(args), p=p, g_s_per_byte=machine.g,
               l_s=machine.l,
               predicted_ms=dict(
                   in_order=searched.in_order_seconds(machine) * 1e3,
                   peephole=peephole.predicted_seconds(machine) * 1e3,
                   searched=searched.predicted_seconds(machine) * 1e3),
               groups=dict(peephole=[list(g) for g in peephole.groups()],
                           searched=[list(g) for g in searched.groups()]),
               rewrites=[st.rewrite for st in searched.steps],
               measured_ms={})
    for key, fn in runs.items():
        n_checked = 2
        if key == "searched_compiled" and dev.type == "cuda":
            # its eager call, the timed eager calls, the capture and the
            # timed replays: the calls until it has chosen
            n_checked = 2 * TRIAL_CALLS + 2
        for _ in range(n_checked):
            reset()
            fn()
            got = values()
            if not all(torch.equal(got[k], ref[k]) for k in ref):
                raise SystemExit(f"{name} {key}: values differ from "
                                 f"recorded order")
        row["measured_ms"][key] = ms(fn)
    row["copy_bytes"] = cp.copy_bytes
    row["compiled_replays"] = cp.n_replays
    row["compiled_use_graph"] = cp.use_graph
    row["compiled_timed_ms"] = dict(
        eager=[t * 1e3 for t in cp.eager_s],
        graph=[t * 1e3 for t in cp.replay_s])
    pred = row["predicted_ms"]["searched"]
    row["searched_measured_over_predicted"] = \
        row["measured_ms"]["searched"] / pred
    row["compiled_measured_over_predicted"] = \
        row["measured_ms"]["searched_compiled"] / pred
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU at the builders' default sizes")
    a = ap.parse_args(argv)
    import torch
    if not a.cpu and not torch.cuda.is_available():
        print("schedule_search: no CUDA device; pass --cpu to check the "
              "script on the CPU", file=sys.stderr)
        return 1
    dev = torch.device("cpu" if a.cpu else "cuda")
    if not a.cpu:
        from _timing import card_line
        print(card_line(), flush=True)
    for name in sorted(CARD_SIZES):
        args = () if a.cpu else CARD_SIZES[name]
        row = run_trace(name, args, dev)
        print("schedule_search " + json.dumps(row), flush=True)
        m, pr = row["measured_ms"], row["predicted_ms"]
        print(f"{name}: predicted in order {pr['in_order']:.3f} ms, "
              f"peephole {pr['peephole']:.3f}, searched "
              f"{pr['searched']:.3f}; measured in order "
              f"{m['in_order']:.3f}, peephole {m['peephole']:.3f}, "
              f"searched {m['searched']:.3f}, compiled "
              f"{m['searched_compiled']:.3f}", flush=True)
    if not a.cpu:
        print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
