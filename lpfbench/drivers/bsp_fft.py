"""Driver ``bsp_fft``: one caller of the port's immortal FFT
(``repro_torch.algorithms.bsp_fft``) in a closed loop.

The configuration gives the transform (``n``, ``ordered``,
``use_kernel``); the traffic mix gives the virtual processes ``p`` and
the loop: ``pool`` distinct complex64 signals made on the device from
the seed, called in turn so that no two calls in a row share one;
``warm_calls`` calls in set-up (each program compiles and chooses
between its graph replay and its eager path there); then back-to-back
calls, each timed from the call to its synchronize, until the window's
seconds are spent (a traced run stops after ``trace_calls``).

One unit of work is one transform.  Its output is judged after the
window against a complex128 transform of the same input (``reference/
fft.py``): ``samples`` calls drawn from the seed among the first
``sample_within`` (each output copied aside as it comes), and the
window's last call."""

from __future__ import annotations

import random
import statistics
import sys
import time

from ..harness import Outcome, SetupClock, Window
from ..reference.fft import compare, fft_reference


def signals(seed: int, count: int, n: int, device):
    """``count`` complex64 signals of length ``n``, standard normal in
    both parts, drawn on ``device`` from ``seed`` in one call."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    xs = torch.randn(count, n, 2, device=device, generator=gen)
    return torch.view_as_complex(xs)


def sample_calls(seed: int, within: int, count: int) -> set:
    return set(random.Random(seed).sample(range(within), count))


def run(cell, *, seed: int, seconds: float, trace: bool, device,
        clock_zero: float) -> Outcome:
    clock = SetupClock(clock_zero)
    import torch
    from repro_torch.algorithms import bsp_fft
    conf, mix = cell.config, cell.traffic
    n, p = int(conf["n"]), int(mix["p"])
    ordered, use_kernel = bool(conf["ordered"]), bool(conf["use_kernel"])
    if device.type == "cuda" and use_kernel:
        from repro_torch.kernels import build
        build.build(["fft_stage"])      # loaded, or built once per checkout
    clock.mark("program and kernel")
    pool = signals(seed, int(mix["pool"]), n, device)
    npool = pool.shape[0]

    def call(i):
        return bsp_fft(pool[i % npool], p=p, ordered=ordered,
                       use_kernel=use_kernel, device=device.type)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for i in range(int(mix["warm_calls"])):
        call(i)
    sync()
    clock.mark("inputs and warm calls")
    clock.report()
    want = sample_calls(seed, int(mix["sample_within"]),
                        int(mix["samples"]))
    kept = {}
    with Window(clock_zero, seconds, device, trace,
                mix.get("trace_calls")) as w:
        i = 0
        while True:
            a = time.perf_counter()
            y = call(i)
            b = time.perf_counter()
            sync()
            w.unit(b - a, time.perf_counter() - a)
            if i in want:
                kept[i] = y.clone()
                sync()
            i += 1
            if w.expired():
                break
        kept[i - 1] = y
    calls = w.units
    if device.type == "cuda":
        from repro_torch.core import global_program_cache
        chose = [a.use_graph for a in global_program_cache().artifacts()]
        print(f"programs: {chose.count(True)} replay as graphs, "
              f"{chose.count(False)} eager, {chose.count(None)} undecided",
              file=sys.stderr, flush=True)
    lat = sorted(w.latencies)
    metrics = {
        "setup_s": w.setup_s,
        "fft_ms": w.window_s / calls * 1e3,
        "fft_p95_ms": (statistics.quantiles(lat, n=20)[18] if calls > 1
                       else lat[0]) * 1e3,
        "peak_mem_gib": w.window_peak_bytes / 2 ** 30,
    }
    # the judgement, once the window has closed
    worst = {"rel_l2": 0.0, "max_err": 0.0}
    for j, y in kept.items():
        got = compare(y.reshape(-1), fft_reference(pool[j % npool]))
        for k in worst:
            worst[k] = max(worst[k], got[k])
    return Outcome(metrics=metrics, window=w, compared=worst,
                   attempted=calls, failed=0)


def control(cell, seed: int, device, kind: str = "tf32") -> dict:
    """The numbers the judgement compares, read from the reference put in
    the program's place: the transforms of the inputs a run of ``seed``
    judges, computed by dense products in TF32 (``kind="control"``, the
    control) or float32 (``"f32"``, the same method one precision up)."""
    from ..reference.fft import fft_matmul
    n, mix = int(cell.config["n"]), cell.traffic
    pool = signals(seed, int(mix["pool"]), n, device)
    judged = sorted(sample_calls(seed, int(mix["sample_within"]),
                                 int(mix["samples"])))
    worst = {"rel_l2": 0.0, "max_err": 0.0}
    for j in {j % pool.shape[0] for j in judged}:
        got = compare(fft_matmul(pool[j], tf32=kind != "f32"),
                      fft_reference(pool[j]))
        for k in worst:
            worst[k] = max(worst[k], got[k])
    return worst
