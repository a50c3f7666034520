#!/usr/bin/env python3
"""Where a pass of the ``fft_planes`` CUDA kernel spends its time, on one
NVIDIA GPU, at the BSP FFT's local shape (8 rows of 2^21 complex64
points):

    python3 scripts/fft_anatomy.py

It builds copies of ``src/repro_torch/csrc/fft_stage.cu`` with parts of
the work taken out (into ``build/fft_anatomy/``, which ``.gitignore``
lists) and times each pass of ``pass_plan`` with each copy (median of 25
after warm-up, CUDA events), beside a ``clone`` of the input (one read
and one write of every byte):

* ``kernel``: the source as it is;
* ``no_math``: no butterflies and no twiddle products at the main
  shape's sub-transforms (the copies, the exchanges through shared memory,
  the table reads and the barriers stay);
* ``no_store``: no stores to device memory;
* ``no_load``: no TMA copies after each block's first two tiles;
* ``only_math``: neither loads after the first two tiles nor stores;
* ``only_load`` and ``only_store``: ``no_math`` without the stores, or
  without the loads.

The copies compute wrong values; only their times mean anything.  The
card's name and power limit come first.  Exits nonzero without a card or
when a build fails.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, N = 8, 1 << 21


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


def cut(src: str, line: str, new: str) -> str:
    if src.count(line) != 1:
        raise SystemExit(f"fft_anatomy: {line!r} is not in the source once")
    return src.replace(line, new)


def no_math(s: str) -> str:
    s = cut(s, "dft_regs<LOGR>(v, p.sgn);", "")
    s = cut(s, "v[i] = cmul(v[i], w[i << LL]);", "v[i].x += w[i << LL].x;")
    s = cut(s, "v[i] = cmul(v[i], tw[i * kk]);", "v[i].x += tw[i * kk].x;")
    return cut(s, "chirp<R>(v, w0, twiddle(a << LL, lq, p.sgn));",
               "v[0].x += w0.x;")


def no_store(s: str) -> str:
    never = "if (p.scale == 12345.f) "
    s = cut(s, "for (int m = 0; m < R; ++m) dst[m * step] = v[m];",
            "for (int m = 0; m < R; ++m) " + never + "dst[m * step] = v[m];")
    return cut(s, "dst[m * step] = make_float2(v[m].x * p.scale,",
               never + "dst[m * step] = make_float2(v[m].x * p.scale,")


def no_load(s: str) -> str:
    line = ("    hopper::mbar_arrive_expect_tx(bar, (uint32_t)(8u << (log_t + "
            "log_c)));")
    return cut(s, line, "    if (t >= 2 * (long long)gridDim.x) {\n"
               "        hopper::mbar_arrive(bar);\n        return;\n    }\n"
               + line)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("fft_anatomy: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    import numpy as np
    from repro_torch.kernels import build
    from repro_torch.kernels.fft_stage import kernel as fk
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    src = (build.CSRC / "fft_stage.cu").read_text()
    copies = dict(kernel=src, no_math=no_math(src), no_store=no_store(src),
                  no_load=no_load(src),
                  only_math=no_load(no_store(src)),
                  only_load=no_store(no_math(src)),
                  only_store=no_load(no_math(src)))
    out_dir = os.path.join(HERE, "build", "fft_anatomy")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in copies.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-o", os.path.join(out_dir, f"lib{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log, file=sys.stderr)
            return 1
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal((BATCH, N))
                          + 1j * rng.standard_normal((BATCH, N)))
                         .astype(np.complex64)).cuda()
    plan = fk.pass_plan(N)
    print(json.dumps(dict(clone_ms=cuda_ms(lambda: x.clone()),
                          plan=[dict(kind=p.kind, t=p.t, c=p.c)
                                for p in plan])), flush=True)
    for name in copies:
        lib = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so"))
        lib.fft_stage_pass.argtypes = fk._ARGTYPES
        lib.fft_stage_pass.restype = ctypes.c_int
        fk._lib = lambda lib=lib: lib
        print(json.dumps(dict(copy=name, pass_ms=[
            cuda_ms(lambda p=p: fk._run(x, [p], False)) for p in plan])),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
