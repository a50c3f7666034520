#!/usr/bin/env python3
"""Where the ``ssd_scan`` CUDA kernel spends its time, on one NVIDIA GPU,
at the mamba2-130m prefill's shape ([4, 2048, 24, 64], G 1, N 128,
chunk 128, f32 and bf16):

    python3 scripts/ssd_anatomy.py

It builds copies of ``src/repro_torch/csrc/ssd_scan.cu`` with parts of
the work taken out (into ``build/ssd_anatomy/``, which ``.gitignore``
lists) and gives, for each copy and dtype, each CUDA kernel's device time
in one call (``torch.profiler``, the mean of 5 calls), beside a ``clone``
of the chain pass's states (one read and one write of each byte):

* ``kernel``: the source as it is;
* ``no_products``: no wgmma products in passes A and C (the compiler then
  drops the A fragments' loads and splits too);
* ``no_a_loads``: the A fragments of passes A and C are constants, not
  loads from device memory;
* ``no_tile_split``: the B tiles of passes A and C are not split (their
  raw copies still arrive);
* ``no_chain_stores``: the chain pass does not write the entering
  states.

The copies compute wrong values; only their times mean anything.  The
card's name and power limit come first.  Exits nonzero without a card or
when a build fails.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

from _timing import card_line, kernel_us

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (4, 2048, 24, 64, 1, 128)


def cut(src: str, line: str, new: str) -> str:
    if src.count(line) != 1:
        raise SystemExit(f"ssd_anatomy: expected one {line!r} in the source")
    return src.replace(line, new)


def no_products(src: str) -> str:
    for line in ("        if (!A_EXACT) wgmma_tf32(acc, f.lo, "
                 "tile_desc(bhi, 8 * ks));\n",
                 "        if (!B_EXACT) wgmma_tf32(acc, f.hi, "
                 "tile_desc(blo, 8 * ks));\n",
                 "        wgmma_tf32(acc, f.hi, tile_desc(bhi, 8 * ks));\n"):
        src = cut(src, line, "")
    return src


def no_a_loads(src: str) -> str:
    src = cut(src, "kp < AHEAD && 2 * kp < KS; ++kp) a_pair(kp, pre[kp]);",
              "kp < AHEAD && 2 * kp < KS; ++kp) for (int r = 0; r < 2; ++r) "
              "for (int c = 0; c < 4; ++c) pre[kp][r][c] = 1.f + c;")
    return cut(src, "if (l == 1 && 2 * (kp + AHEAD) < KS) a_pair(kp + AHEAD, "
                    "v);", "")


def no_tile_split(src: str) -> str:
    return cut(src, "    for (int e = threadIdx.x; e < TILE; e += THREADS) {"
                    "\n        const int core = e >> 5, l = e & 31;",
               "    for (int e = threadIdx.x; e < 0; e += THREADS) {"
               "\n        const int core = e >> 5, l = e & 31;")


def no_chain_stores(src: str) -> str:
    return cut(src, "                s[(k0 + u) * step] = hv;            "
                    "// the state entering k\n", "")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ssd_anatomy: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    import numpy as np
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import kernel as sk
    print(card_line(), flush=True)
    src = (build.CSRC / "ssd_scan.cu").read_text()
    copies = dict(kernel=src, no_products=no_products(src),
                  no_a_loads=no_a_loads(src),
                  no_tile_split=no_tile_split(src),
                  no_chain_stores=no_chain_stores(src))
    out_dir = os.path.join(HERE, "build", "ssd_anatomy")
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
    B, S, H, P, G, N = SHAPE
    rng = np.random.default_rng(0)
    states = torch.empty(B, S // 128, H, N, P, device="cuda")
    print(json.dumps(dict(clone_of_states_us=kernel_us(
        lambda: states.clone()))), flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        x, b, c = (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).cuda().to(dtype)
            for shape in ((B, S, H, P), (B, S, G, N), (B, S, G, N)))
        dt = torch.from_numpy(rng.uniform(0.001, 0.1, (B, S, H)).astype(
            np.float32)).cuda()
        a = torch.from_numpy(-rng.uniform(0.5, 2.0, (H,)).astype(
            np.float32)).cuda()
        for name in copies:
            lib = sk._bind(ctypes.CDLL(os.path.join(out_dir,
                                                    f"lib{name}.so")))
            sk._lib = lambda lib=lib: lib
            print(json.dumps(dict(copy=name, dtype=str(dtype).split(".")[1],
                                  kernel_us=kernel_us(lambda: sk.ssd_scan(
                                      x, dt, a, b, c)))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
