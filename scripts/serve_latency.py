#!/usr/bin/env python3
"""Serve-loop latency under the model-priced admission controller: the
JAX package's ``benchmarks/serve_latency.py`` on the port.

    python3 scripts/serve_latency.py                 # on the card
    python3 scripts/serve_latency.py --device cpu    # a check on the CPU

A burst-arrival synthetic workload (120 requests in bursts of 6, seed 0,
deadlines at 80x the priced token cost) runs through
:class:`repro_torch.runtime.server.LPFServer` over the pure-LPF
:class:`~repro_torch.runtime.server.ProgramDecodeEngine` at p = 8 virtual
processes with buckets (2, 16), (4, 16) and (4, 32).  Per completed
request it records the wall latency (submit to terminal) and the
model-clock latency (admission vclock to completion vclock), and prints
per bucket their p50/p99 as CSV, then the admission mix, throughput, the
engine's loop-graph replays and fallbacks, the pinned programs, and one
JSON line of all of it.  It exits nonzero when an admitted request missed
its model-clock deadline or completed after its predicted time.
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

BUCKETS = ((2, 16), (4, 16), (4, 32))


def _pctl(xs, q):
    xs = sorted(xs)
    if not xs:
        return float("nan")
    i = min(len(xs) - 1, max(0, round(q * (len(xs) - 1))))
    return xs[i]


def run(n_requests: int = 120, burst: int = 6, seed: int = 0, *,
        device="cuda", p: int = 8, hardware=None, verbose: bool = True
        ) -> dict:
    """Serve the workload; returns the per-bucket rows, the totals, the
    final health snapshot, the outcomes and the engine."""
    from repro_torch.runtime.server import (LPFServer, ProgramDecodeEngine,
                                            synthetic_requests)
    say = print if verbose else (lambda *a, **k: None)
    eng = ProgramDecodeEngine(buckets=BUCKETS, p=p, hardware=hardware,
                              device=device)
    srv = LPFServer(eng, max_queue=16)
    reqs = synthetic_requests(
        n_requests, seed, eng.buckets(),
        token_cost_s=max(eng.token_seconds(b) for b in eng.buckets()),
        deadline_scale=80.0)

    t0 = time.perf_counter()
    for i in range(0, len(reqs), burst):
        for r in reqs[i:i + burst]:
            srv.submit(r)
        srv.step()
    srv.run_until_idle()
    health = srv.drain()
    wall = time.perf_counter() - t0

    outs = srv.take_outcomes()
    per_bucket: dict = {}
    for out in outs.values():
        if out.status == "completed":
            per_bucket.setdefault(out.bucket, []).append(out)

    rows = []
    keys = ("bucket", "completed", "wall_p50_ms", "wall_p99_ms",
            "model_p50_ms", "model_p99_ms", "tokens")
    say(",".join(keys))
    for bucket in sorted(per_bucket):
        done = per_bucket[bucket]
        walls = [o.wall_s * 1e3 for o in done]
        models = [(o.completion_v - o.admit_v) * 1e3 for o in done]
        row = {
            "bucket": f"{bucket[0]}x{bucket[1]}",
            "completed": len(done),
            "wall_p50_ms": _pctl(walls, 0.50),
            "wall_p99_ms": _pctl(walls, 0.99),
            "model_p50_ms": _pctl(models, 0.50),
            "model_p99_ms": _pctl(models, 0.99),
            "tokens": sum(len(o.tokens) for o in done),
        }
        rows.append(row)
        say(",".join(str(row[k]) for k in keys))

    late = [o.rid for o in outs.values() if o.status == "completed"
            and o.completion_v > o.predicted_v + 1e-12]
    total = {
        "submitted": health["submitted"],
        "admitted": health["admitted"],
        "completed": health["completed"],
        "shed": health["shed"],
        "rejected": health["rejected_total"],
        "deadline_misses": health["deadline_misses"],
        "decode_fallbacks": health["decode_fallbacks"],
        "queue_peak": health["queue_peak"],
        "level_peak": health["level_peak"],
        "program_pinned": health["program_pinned"],
        "program_quarantined": health["program_quarantined"],
        "completed_after_predicted": len(late),
        "quarantines": eng.quarantines,
        "loop_graph_replays": eng.loop_graph_replays,
        "loop_graph_fallbacks": eng.loop_graph_fallbacks,
        "wall_s": wall,
        "tok_per_s": health["tokens_decoded"] / wall,
        "mean_wall_ms": statistics.fmean(
            o.wall_s for ds in per_bucket.values() for o in ds) * 1e3
        if per_bucket else float("nan"),
    }
    say(f"\nadmission: {total['admitted']}/{total['submitted']} admitted, "
        f"{total['rejected']} rejected, {total['shed']} shed, "
        f"{total['deadline_misses']} deadline misses, "
        f"{len(late)} completed after their predicted time")
    say(f"throughput: {health['tokens_decoded']} tokens in {wall:.3f}s "
        f"({total['tok_per_s']:.1f} tok/s), queue peak "
        f"{total['queue_peak']}, ladder peak level {total['level_peak']}")
    say(f"engine: {eng.loop_graph_replays} loop-graph replays, "
        f"{eng.loop_graph_fallbacks} fallbacks, {total['program_pinned']} "
        f"programs pinned, {eng.quarantines} quarantines")
    return dict(rows=rows, total=total, health=health, outcomes=outs,
                engine=eng)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--requests", type=int, default=120)
    ap.add_argument("--burst", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    res = run(args.requests, args.burst, args.seed, device=args.device)
    print(json.dumps({"serve_latency": res["rows"], "total": res["total"]}))
    if res["total"]["deadline_misses"]:
        print("SLO violation: admitted request(s) missed their model-clock "
              "deadline", file=sys.stderr)
        return 1
    if res["total"]["completed_after_predicted"]:
        print("request(s) completed after their predicted model-clock "
              "time", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
