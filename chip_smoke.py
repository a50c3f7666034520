#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.  Run from the repository root with no arguments:

    python3 chip_smoke.py

It fails (nonzero exit, no result line) without a CUDA device, outside a
checkout of the repository, or when any check below fails; no phase's
failure is caught.  Phases:

1. the card's name and power limit (``nvidia-smi``);
2. build of every CUDA kernel from ``src/repro_torch/csrc`` (``nvcc``,
   ``sm_90a``), with the compiler's register/spill report;
3. each kernel against its plain PyTorch version on the card, forward and
   inverse, at the JAX package's test shapes and at the main path's shape:
   relative error, kernel / plain / ``torch.fft`` milliseconds (median of
   25 runs after warm-up, CUDA events);
4. the README quickstart (a one-superstep shift) through ``exec_`` at
   p = 8: values and ledger;
5. the main path: ``bsp_fft`` at N = 2^24 complex64 over p = 8 virtual
   processes with ``use_kernel=True``, ordered and unordered, forward then
   inverse: error against ``np.fft`` (complex128), the inverse round trip,
   the ledger (``fft.redistribute``/``fft.reorder``, ``fused``, 1 round,
   ``h_bytes == fft_h_bytes``) and the kernel's launch count on that run;
   then the end-to-end time;
6. the fit of the virtual-process link's (g, l) from timed total
   exchanges of growing h (T(h) = g*h + l, the paper's Table-3
   estimators: g from the two ends of the sweep, l from the smallest);
7. a ``{"kernels": [...]}`` line, the card line again, and the final
   ``{"ok": true, "device": ...}`` line.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
N_MAIN = 1 << 24          # BSP FFT length on the main path
P_MAIN = 8                # virtual processes
KERNEL_SHAPES = [(1, 64), (4, 256), (8, 1024), (3, 4096),
                 (P_MAIN, N_MAIN // P_MAIN)]
# data-sheet peaks of one H100 SXM (at its 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"CHECK FAILED: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median device milliseconds of ``fn()`` (CUDA events per run)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    """Median host milliseconds of ``fn()`` ending in a synchronize."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def complex_input(rng, shape) -> np.ndarray:
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def fft_bound_ms(batch: int, n: int) -> tuple:
    """Least time for a batched complex64 FFT: read and write every value
    once, or do 5 n log2 n fp32 flops per row, whichever is longer."""
    t_bytes = 2 * batch * n * 8 / HBM_BYTES_PER_S
    t_ops = batch * 5.0 * n * math.log2(n) / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def profile_bsp_fft(bsp_fft, x, wall_ms: float) -> dict:
    """Where one ordered ``bsp_fft`` call's time goes: device time of each
    kernel (``torch.profiler``, device-side events only), and the device's
    idle share of the call's unprofiled host wall time ``wall_ms``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        bsp_fft(x, p=P_MAIN, ordered=True, use_kernel=True, device="cuda")
        torch.cuda.synchronize()
    kernels = sorted(((e.key[:90], e.count, e.self_device_time_total)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda t: -t[2])
    busy_us = sum(t for _, _, t in kernels)
    out = dict(wall_us=wall_ms * 1e3, device_busy_us=busy_us,
               idle_share=1.0 - busy_us / (wall_ms * 1e3),
               kernels=[dict(kernel=k, count=c, device_us=t)
                        for k, c, t in kernels])
    print("bsp_fft profile " + json.dumps(out), flush=True)
    check(busy_us > 0, "profiler recorded no device time")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch import core as lpf
    from repro_torch.algorithms import bsp_fft, fft_h_bytes
    from repro_torch.kernels import build
    from repro_torch.kernels.fft_stage import kernel as fft_kernel
    from repro_torch.kernels.fft_stage import ref as fft_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. the card ---------------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} count {torch.cuda.device_count()}", flush=True)

    # 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build(["fft_stage"])
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s ({', '.join(built)})", flush=True)
    for res in built.values():
        print(res.log.strip(), flush=True)

    # 3. kernel against its plain version ------------------------------------
    rng = np.random.default_rng(SEED)
    rows = []
    for batch, n in KERNEL_SHAPES:
        x = torch.from_numpy(complex_input(rng, (batch, n))).to(dev)
        for inverse in (False, True):
            y_k = fft_kernel.fft_planes(x, inverse=inverse)
            y_p = fft_ref.stockham(x, inverse=inverse)
            torch.cuda.synchronize()
            err = (y_k - y_p).abs().max().item()
            rel = err / y_p.abs().max().item()
            bar = 2e-5 if n == N_MAIN // P_MAIN else 1e-5
            lib = torch.fft.ifft if inverse else torch.fft.fft
            row = dict(
                batch=batch, n=n, inverse=inverse, max_abs_err=err,
                rel_err=rel, bar=bar,
                ms=cuda_ms(lambda: fft_kernel.fft_planes(x, inverse=inverse)),
                plain_ms=cuda_ms(lambda: fft_ref.stockham(x, inverse=inverse)),
                library_ms=cuda_ms(lambda: lib(x)))
            rows.append(row)
            print("fft_planes " + json.dumps(row), flush=True)
            check(rel < bar, f"fft_planes {batch}x{n} inverse={inverse}: "
                             f"rel err {rel} >= {bar}")
            del y_k, y_p

    # 4. README quickstart through exec_ on the card -------------------------
    def quickstart(ctx, s, p, args):
        ctx.resize_memory_register(2)
        ctx.resize_message_queue(p)
        a = ctx.register_global("a", torch.arange(4.0, device=ctx.device)
                                + 10 * ctx.pid)
        b = ctx.register_global("b", ctx.replicate(torch.zeros(4)))
        ctx.put(a, b, to=lambda s: (s + 1) % p)
        ctx.sync(label="shift")
        return ctx.value(b)

    out, ledger = lpf.exec_(P_MAIN, quickstart, None, device="cuda",
                            return_ledger=True)
    want = (torch.arange(4.0) + 10 * ((torch.arange(P_MAIN) - 1) % P_MAIN)
            .reshape(-1, 1))
    check(out.is_cuda and torch.equal(out.cpu(), want),
          "quickstart values")
    recs = [(r.label, r.method, r.h_bytes, r.rounds, r.n_msgs)
            for r in ledger.records]
    check(recs == [("shift", "direct", 16, 1, P_MAIN)],
          f"quickstart ledger {recs}")
    print(f"quickstart: ok, ledger {recs}", flush=True)

    # 5. the main path: bsp_fft at N = 2^24 over p = 8, use_kernel=True -----
    x_np = complex_input(rng, N_MAIN)
    ref = np.fft.fft(x_np.astype(np.complex128))
    ref_max = np.abs(ref).max()
    x = torch.from_numpy(x_np).to(dev)
    main_rows = []
    fft_kernel.fft_planes.launches = 0
    fft_kernel.fft_planes.cuda_launches = 0
    for ordered in (True, False):
        y, led = bsp_fft(x, p=P_MAIN, ordered=ordered, use_kernel=True,
                         device="cuda", return_ledger=True)
        xi = bsp_fft(y, p=P_MAIN, ordered=ordered, use_kernel=True,
                     inverse=True, device="cuda")
        torch.cuda.synchronize()
        y_np = y.cpu().numpy()
        rel = float(np.abs(y_np - ref).max() / ref_max)
        rt = float((xi - x).abs().max().item())
        recs = [(r.label, r.method, r.rounds) for r in led.records]
        want_recs = [("fft.redistribute", "fused", 1)] + (
            [("fft.reorder", "fused", 1)] if ordered else [])
        row = dict(ordered=ordered, rel_err=rel, roundtrip_err=rt,
                   h_bytes=led.h_bytes,
                   want_h_bytes=fft_h_bytes(N_MAIN, P_MAIN, ordered),
                   ledger=recs)
        main_rows.append(row)
        print("bsp_fft " + json.dumps(row), flush=True)
        check(y.is_cuda and y.shape == (N_MAIN,) and bool(
            torch.isfinite(y).all()), "bsp_fft output shape/finite")
        check(rel < 2e-4, f"bsp_fft ordered={ordered} rel err {rel}")
        check(rt < 2e-3, f"bsp_fft ordered={ordered} round trip {rt}")
        check(recs == want_recs, f"bsp_fft ledger {recs}")
        check(led.h_bytes == fft_h_bytes(N_MAIN, P_MAIN, ordered),
              f"bsp_fft h_bytes {led.h_bytes}")
        del y, xi
    launches = fft_kernel.fft_planes.launches
    cuda_launches = fft_kernel.fft_planes.cuda_launches
    print(f"main path: fft_planes launches {launches}, CUDA launches "
          f"{cuda_launches}", flush=True)
    check(launches > 0, "the main path never launched fft_planes")
    for row in main_rows:
        ordered = row["ordered"]
        row["e2e_ms"] = host_ms(lambda: bsp_fft(
            x, p=P_MAIN, ordered=ordered, use_kernel=True, device="cuda"))
        row["e2e_ms_plain_local_fft"] = host_ms(lambda: bsp_fft(
            x, p=P_MAIN, ordered=ordered, use_kernel=False, device="cuda"))
        print(f"bsp_fft N=2^24 p=8 ordered={ordered}: {row['e2e_ms']:.3f} "
              f"ms with fft_stage, {row['e2e_ms_plain_local_fft']:.3f} ms "
              f"with torch.fft", flush=True)
    profile_bsp_fft(bsp_fft, x, main_rows[0]["e2e_ms"])

    # 6. (g, l) of the virtual-process link ----------------------------------
    ctx = lpf.LPFContext(P_MAIN, device="cuda")
    p = P_MAIN
    hs, ts = [], []
    for w in (1, 64, 1024, 16384, 1 << 18, 1 << 21):
        ctx.resize_memory_register(2)
        ctx.resize_message_queue(p * p)
        a = ctx.register_global("a", torch.ones(p, p * w, device=dev))
        b = ctx.register_global("b", torch.zeros(p, p * w, device=dev))
        table = [(s, d, a, d * w, b, s * w, w)
                 for s in range(p) for d in range(p)]

        def exchange():
            ctx.put_msgs(table)
            ctx.sync(label="probe")

        # each superstep timed on its own, staging and barrier included
        ms = host_ms(exchange, reps=25)
        h = (p - 1) * w * 4
        hs.append(h)
        ts.append(ms * 1e-3)
        print(f"total exchange h={h} B: {ms * 1e3:.2f} us", flush=True)
        ctx.deregister(a)
        ctx.deregister(b)
    # the paper's Table-3 estimators: g from the two ends of the sweep,
    # l as the time of the smallest exchange less its g*h
    g = (ts[-1] - ts[0]) / (hs[-1] - hs[0])
    l = ts[0] - g * hs[0]
    frac = (p - 1) / p
    fit = dict(g_s_per_byte=float(g), l_s=float(l), p=p,
               link_bw=float(frac / g), link_latency=float(l / math.log2(p)),
               points=list(zip(hs, ts)))
    print("link fit " + json.dumps(fit), flush=True)
    check(g > 0 and l > 0, f"link fit g={g} l={l}")

    # 7. result lines ----------------------------------------------------------
    big = [r for r in rows if r["n"] == N_MAIN // P_MAIN and not r["inverse"]][0]
    bound_ms, bound_by = fft_bound_ms(big["batch"], big["n"])
    kernels = {"kernels": [dict(
        name="fft_planes", route="cuda",
        source="src/repro_torch/csrc/fft_stage.cu",
        replaces="src/repro/kernels/fft_stage/kernel.py:64",
        launches=launches, max_abs_err=big["max_abs_err"], ms=big["ms"],
        plain_ms=big["plain_ms"], bound_ms=bound_ms, bound_by=bound_by,
        library_ms=big["library_ms"])]}
    print(json.dumps(kernels), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
