#!/usr/bin/env python3
"""Time the bf16 flash-attention forward kernel of one or more checkouts
of this repository on one NVIDIA GPU, at llama3.2-1b's prefill shape (q
[4, 32, 2048, 64], k, v [4, 8, 2048, 64], causal), so that two commits
are compared on the same card in one run:

    python3 scripts/flash_fwd_pair.py [ROOT ...]

Each ROOT is the root of a checkout (default: this one); name the parent
and the change as ``parent change change parent`` to take each twice, in
turns.  Every checkout's ``flash_attention_fwd`` builds first, all in
parallel (into that checkout's own ``build/``); then each ROOT runs in a
process of its own, in the order given, importing ``repro_torch`` from
``ROOT/src``.  A run prints one JSON line: the milliseconds of
``flash_attention_fwd`` (median of 25 after warm-up, CUDA events), its
TFLOP/s over the 4 D flops of each kept (q, k) pair, SDPA on the same
inputs (the yardstick; no port calls it), and o's row error against the
plain version with P rounded to bf16 and with P in f32.  The card's name
and power limit come first.  Exits nonzero without a card or when a run
fails.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

SHAPE = (4, 32, 8, 2048, 64)          # B, H, Hkv, S, D
SEED = 0


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


def run_one(root: str) -> dict:
    sys.path.insert(0, os.path.join(root, "src"))
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref as fr
    B, H, Hkv, S, D = SHAPE
    rng = np.random.default_rng(SEED)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        s, dtype=np.float32)).cuda().bfloat16()
        for s in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    o, _ = fk.flash_attention_fwd(q, k, v)
    want_r, _ = fr.flash_attention_fwd_ref(q, k, v, round_p=True)
    want, _ = fr.flash_attention_fwd_ref(q, k, v)
    torch.cuda.synchronize()

    def row_err(a, ref):
        a, ref = a.float(), ref.float()
        return ((a - ref).abs() / ref.abs().amax(dim=-1, keepdim=True)
                .clamp_min(1e-30)).max().item()

    out = dict(root=root, shape=list(SHAPE),
               row_err_vs_round_p=row_err(o, want_r),
               row_err=row_err(o, want))
    del o, want, want_r
    out["ms"] = cuda_ms(lambda: fk.flash_attention_fwd(q, k, v))
    flops = 4.0 * B * H * D * S * (S + 1) / 2       # causal: kept pairs
    out["tflops"] = flops / (out["ms"] * 1e-3) / 1e12
    out["sdpa_ms"] = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
    return out


def main(argv) -> int:
    if argv[:1] == ["--build"]:
        sys.path.insert(0, os.path.join(argv[1], "src"))
        from repro_torch.kernels import build
        build.build(["flash_attention_fwd"])
        return 0
    if argv[:1] == ["--one"]:
        print(json.dumps(run_one(argv[1])), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("flash_fwd_pair: no CUDA device", file=sys.stderr)
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
        print("flash_fwd_pair: a build failed", file=sys.stderr)
        return 1
    for r in roots:
        if subprocess.run([sys.executable, me, "--one", r]).returncode:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
