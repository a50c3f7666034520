#!/usr/bin/env python3
"""Time the ``ssd_scan`` CUDA kernel of one or more checkouts of this
repository on one NVIDIA GPU, so that two commits are compared on the same
card in one run:

    python3 scripts/ssd_pair.py [--prefill] [ROOT ...]

Each ROOT is the root of a checkout (default: this one); name the parent
and the change as ``parent change change parent`` to take each twice, in
turns.  Every checkout's ``ssd_scan`` builds first, all in parallel (into
that checkout's own ``build/``); then each ROOT runs in a process of its
own, in the order given, importing ``repro_torch`` from ``ROOT/src``.  A
run prints one JSON line a shape (``SHAPES``: the mamba2-130m prefill's
[4, 2048, 24, 64], G 1, N 128, chunk 128 in f32, the dtype the model hands
the kernel, and in bf16, then B 1 x S 16384 in f32): the kernel's
milliseconds (median of 25 after warm-up, CUDA events), the CUDA launches
a call where the wrapper counts them, and the relative error of y and of
the final state against that checkout's plain version, and each CUDA
kernel's device time in one call (``torch.profiler``, the mean of 5
calls).  With ``--prefill``, each run also times the mamba2-130m prefill
(the published width, seed-0 bf16 weights) at B 4 x S 2048 and B 1 x
S 16384 (host clock around a synchronised call, median of 5 and of 3)
and profiles one call of each: the device time of the SSD kernels, the
device's busy time, and the SSD share of it.  The card's name and power limit come first.  Exits
nonzero without a card or when a run fails.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

from _timing import card_line, cuda_ms, device_work, kernel_us

SEED = 0
# B, S, H, P, G, N, chunk, dtype
SHAPES = [(4, 2048, 24, 64, 1, 128, 128, "float32"),
          (4, 2048, 24, 64, 1, 128, 128, "bfloat16"),
          (1, 16384, 24, 64, 1, 128, 128, "float32")]
PREFILLS = [(4, 2048), (1, 16384)]


def host_ms(fn, reps: int, warmup: int = 1) -> float:
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


def rel(a, ref) -> float:
    return ((a.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


def kernel_rows(root: str) -> list:
    import numpy as np
    import torch
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan import ref as sr
    rng = np.random.default_rng(SEED)
    rows = []
    for B, S, H, P, G, N, chunk, dt_name in SHAPES:
        dtype = getattr(torch, dt_name)
        x = torch.from_numpy(rng.standard_normal(
            (B, S, H, P), dtype=np.float32)).cuda().to(dtype)
        dt = torch.from_numpy(rng.uniform(0.001, 0.1, (B, S, H)).astype(
            np.float32)).cuda()
        a = torch.from_numpy(-rng.uniform(0.5, 2.0, (H,)).astype(
            np.float32)).cuda()
        b, c = (torch.from_numpy(rng.standard_normal(
            (B, S, G, N), dtype=np.float32)).cuda().to(dtype)
            for _ in range(2))
        before = getattr(sk.ssd_scan, "cuda_launches", None)
        y, st = sk.ssd_scan(x, dt, a, b, c, chunk=chunk)
        launches = (None if before is None
                    else sk.ssd_scan.cuda_launches - before)
        y_p, st_p = sr.ssd_scan_plain(x, dt, a, b, c, chunk=chunk)
        rows.append(dict(
            root=root, shape=[B, S, H, P, G, N], chunk=chunk, dtype=dt_name,
            cuda_launches=launches, rel_err=rel(y, y_p),
            state_rel_err=rel(st, st_p),
            ms=cuda_ms(lambda: sk.ssd_scan(x, dt, a, b, c, chunk=chunk)),
            kernel_us=kernel_us(lambda: sk.ssd_scan(x, dt, a, b, c,
                                                    chunk=chunk))))
        del x, dt, a, b, c, y, st, y_p, st_p
        torch.cuda.empty_cache()
    return rows


def prefill_rows(root: str) -> list:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models import Runtime, cast_params, init_params, prefill
    cfg = get_config("mamba2-130m")
    rt = Runtime(torch.device("cuda"))
    params = cast_params(init_params(SEED, cfg, device="cuda"), cfg)
    rng = np.random.default_rng([SEED, 1])
    rows = []
    for B, S in PREFILLS:
        batch = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab, (B, S))).cuda()}
        run = lambda: prefill(params, batch, cfg, rt)
        ms = host_ms(run, reps=5 if S <= 2048 else 3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        busy = ssd = 0.0
        for e in device_work(prof, prof.key_averages()):
            busy += e.self_device_time_total
            if "ssd_" in e.key.lower():
                ssd += e.self_device_time_total
        rows.append(dict(root=root, prefill=[B, S], e2e_ms=ms,
                         device_busy_ms=busy / 1e3, ssd_ms=ssd / 1e3,
                         ssd_share_of_busy=ssd / busy if busy else None))
        del batch
    return rows


def main(argv) -> int:
    if argv[:1] == ["--build"]:
        sys.path.insert(0, os.path.join(argv[1], "src"))
        from repro_torch.kernels import build
        build.build(["ssd_scan"])
        return 0
    if argv[:1] == ["--one"]:
        root, with_prefill = argv[1], argv[2:] == ["--prefill"]
        sys.path.insert(0, os.path.join(root, "src"))
        import torch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        rows = kernel_rows(root) + (prefill_rows(root) if with_prefill
                                    else [])
        for row in rows:
            print(json.dumps(row), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("ssd_pair: no CUDA device", file=sys.stderr)
        return 1
    with_prefill = argv[:1] == ["--prefill"]
    argv = argv[1:] if with_prefill else argv
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    roots = [os.path.abspath(r) for r in argv] or [here]
    print(card_line(), flush=True)
    me = os.path.abspath(__file__)
    builds = [subprocess.Popen([sys.executable, me, "--build", r])
              for r in dict.fromkeys(roots)]
    if any(p.wait() for p in builds):
        print("ssd_pair: a build failed", file=sys.stderr)
        return 1
    for r in roots:
        cmd = [sys.executable, me, "--one", r] + (
            ["--prefill"] if with_prefill else [])
        if subprocess.run(cmd).returncode:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
