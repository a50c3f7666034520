#!/usr/bin/env python3
"""Time the ``fft_planes`` CUDA kernel of one or more checkouts of this
repository on one NVIDIA GPU, at the BSP FFT's local shape (8 rows of
2^21 complex64 points: N = 2^24 over p = 8), so that two commits are
compared on the same card in one run:

    python3 scripts/fft_pair.py [ROOT ...]

Each ROOT is the root of a checkout (default: this one); name the parent
and the change as ``parent change change parent`` to take each twice, in
turns.  Every checkout's ``fft_stage`` builds first, all in parallel (into
that checkout's own ``build/``); then each ROOT runs in a process of its
own, in the order given, importing ``repro_torch`` from ``ROOT/src``.  A
run prints one JSON line: forward and inverse milliseconds of
``fft_planes`` (median of 25 after warm-up, CUDA events), the CUDA
launches a call, the bytes the passes move and the rate, ``torch.fft``
on the same input (the yardstick; no port calls it), and the relative
error against the plain version.  A checkout whose wrapper has
``pass_plan`` also gives each pass's time alone, and times the other
pass plans listed in ``OPTIONS`` (one more JSON line each).  The card's name and power limit come first.
Exits nonzero without a card or when a run fails.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

BATCH, N = 8, 1 << 21
SEED = 0
#: other two-pass plans of N, timed beside the kept one: (label, col T)
OPTIONS = [("col 2^11 (C 4), row 2^10 (C 8)", 1 << 11)]


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
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


def option_plan(fk, col_t: int):
    """The two-pass plan of N with a col pass of ``col_t`` points."""
    row_t = N // col_t
    return [fk._pass("col", col_t, 1, a=row_t, inner=row_t),
            fk._pass("row", row_t, col_t, r1=col_t, m=1, inner=col_t)]


def time_plan(fk, x, plan) -> dict:
    fwd = cuda_ms(lambda: fk._run(x, plan, False))
    inv = cuda_ms(lambda: fk._run(x, plan, True))
    nbytes = 2 * len(plan) * x.numel() * 8
    return dict(ms=fwd, inverse_ms=inv, bytes=nbytes,
                tb_per_s=nbytes / (fwd * 1e-3) / 1e12)


def run_one(root: str) -> list:
    sys.path.insert(0, os.path.join(root, "src"))
    import numpy as np
    import torch
    from repro_torch.kernels.fft_stage import kernel as fk
    from repro_torch.kernels.fft_stage import ref as fr
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy((rng.standard_normal((BATCH, N))
                          + 1j * rng.standard_normal((BATCH, N)))
                         .astype(np.complex64)).cuda()
    before = fk.fft_planes.cuda_launches
    y = fk.fft_planes(x)
    launches = fk.fft_planes.cuda_launches - before
    want = fr.stockham(x)
    rel = ((y - want).abs().max() / want.abs().max()).item()
    del y, want
    out = dict(root=root, batch=BATCH, n=N, rel_err=rel,
               cuda_launches=launches,
               ms=cuda_ms(lambda: fk.fft_planes(x)),
               inverse_ms=cuda_ms(lambda: fk.fft_planes(x, inverse=True)),
               torch_fft_ms=cuda_ms(lambda: torch.fft.fft(x)),
               torch_ifft_ms=cuda_ms(lambda: torch.fft.ifft(x)))
    out["bytes"] = 2 * launches * x.numel() * 8
    out["tb_per_s"] = out["bytes"] / (out["ms"] * 1e-3) / 1e12
    rows = [out]
    if hasattr(fk, "pass_plan"):
        plan = fk.pass_plan(N)
        out["plan"] = [dict(kind=p.kind, t=p.t, c=p.c) for p in plan]
        # each pass alone (x to a new buffer), forward
        out["pass_ms"] = [cuda_ms(lambda p=p: fk._run(x, [p], False))
                          for p in plan]
        for label, col_t in OPTIONS:
            plan = option_plan(fk, col_t)
            y = fk._run(x, plan, False)
            want = fr.stockham(x)
            opt = dict(root=root, option=label,
                       plan=[dict(kind=p.kind, t=p.t, c=p.c) for p in plan],
                       rel_err=((y - want).abs().max()
                                / want.abs().max()).item())
            del y, want
            opt.update(time_plan(fk, x, plan))
            rows.append(opt)
    return rows


def main(argv) -> int:
    if argv[:1] == ["--build"]:
        sys.path.insert(0, os.path.join(argv[1], "src"))
        from repro_torch.kernels import build
        build.build(["fft_stage"])
        return 0
    if argv[:1] == ["--one"]:
        for row in run_one(argv[1]):
            print(json.dumps(row), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("fft_pair: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    roots = [os.path.abspath(r) for r in argv] or [here]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    me = os.path.abspath(__file__)
    builds = [subprocess.Popen([sys.executable, me, "--build", r])
              for r in dict.fromkeys(roots)]
    if any(p.wait() for p in builds):
        print("fft_pair: a build failed", file=sys.stderr)
        return 1
    for r in roots:
        if subprocess.run([sys.executable, me, "--one", r]).returncode:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
