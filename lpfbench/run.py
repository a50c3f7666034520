"""One run of one cell: ``python3 -m lpfbench --workload <name> --seed
<n> --seconds <s> --trace <0|1>`` from the root of a checkout.

Set-up, the window and the judgement are the driver's (``drivers/``);
this module finds the cell, refuses to run without the card it asks for
or without the program, reads the per-layer metrics of a traced run, and
prints the result: each number compared beside its limit as the last
lines of standard error, and the result as the last line of standard
output, its ``checks`` key last."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from .harness import (ROOT, BenchError, TraceView, cache_dirs, driver_of,
                      forbidden_modules, judge, load_cell, metric_reader,
                      process_age_s)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi gave nothing"


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m lpfbench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    clock_zero = time.perf_counter() - process_age_s()
    args = parse(argv)
    try:
        line = run(args, clock_zero)
    except BenchError as e:
        print(f"lpfbench: {e}", file=sys.stderr, flush=True)
        return 2
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def run(args, clock_zero: float, *, device=None, cell=None) -> dict:
    """One run; the result line.  ``device`` and ``cell`` are for the
    tests, which drive the rest of a run on the CPU: a run from the
    command line looks for the card the cell asks for and takes the cell
    from ``BENCHMARK.json``."""
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise BenchError(f"the program under test (src/repro_torch) is "
                         f"not in {ROOT}")
    for key, path in cache_dirs().items():
        os.environ[key] = path
    if str(ROOT / "src") not in sys.path:
        sys.path.insert(0, str(ROOT / "src"))
    cell = cell or load_cell(args.workload)
    import torch
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell.chips:
            raise BenchError(
                f"{cell.name} needs {cell.chips} CUDA device(s); available="
                f"{torch.cuda.is_available()}, count="
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
    trace = bool(args.trace)
    out = driver_of(cell).run(cell, seed=args.seed, seconds=args.seconds,
                              trace=trace, device=device,
                              clock_zero=clock_zero)
    w = out.window
    correct, checks = judge(out.compared, cell.limits)
    correct = correct and out.failed == 0 and out.attempted > 0
    metrics = {}
    if trace:
        view = TraceView(cell, w, w.profile)
        for m in cell.per_layer():
            value = metric_reader(m["name"])(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end():
            if m["name"] not in out.metrics:
                raise BenchError(f"the driver gave no {m['name']}")
            metrics[m["name"]] = {"value": out.metrics[m["name"]],
                                  "unit": m["unit"]}
    on_card = device.type == "cuda"
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card
           else device.type, "count": cell.chips,
           "memory_peak_bytes": max(w.setup_peak_bytes,
                                    w.window_peak_bytes)}
    line = {"correct": bool(correct), "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": dev}
    if trace:
        if w.profile is None or w.profile.busy_s <= 0:
            raise BenchError("the traced window recorded no device time")
        dev["busy_s"] = w.profile.busy_s
        dev["window_s"] = w.profile.window_s
        line["breakdown"] = {"device_ops": w.profile.device_ops(),
                             "idle_gaps": w.profile.idle_gaps()}
    if on_card:
        print(f"card {card_line()}", file=sys.stderr, flush=True)
    bad = forbidden_modules()
    if bad:
        raise BenchError(f"the run holds forbidden modules once its window "
                         f"has closed: {', '.join(bad)}")
    line["checks"] = checks
    return line
