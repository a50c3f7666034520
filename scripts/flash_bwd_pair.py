#!/usr/bin/env python3
"""Time the two bf16 flash-attention backward kernels of one or more
checkouts of this repository on one NVIDIA GPU, at llama3.2-1b's training
shape (q, dO [4, 32, 2048, 64], k, v [4, 8, 2048, 64], causal), so that
two commits are compared on the same card in the same session:

    python3 scripts/flash_bwd_pair.py [ROOT ...]

Each ROOT is the root of a checkout (default: this one); name the parent
and the change as ``parent change change parent`` to take each twice, in
turns.  Every checkout's ``flash_attention_bwd`` builds first, all in
parallel (into that checkout's own ``build/``); then each ROOT runs in a
process of its own, in the order given, importing ``repro_torch`` from
``ROOT/src``.  A run prints one JSON line: the milliseconds of
``flash_attention_bwd_dkv`` and ``flash_attention_bwd_dq`` (median of 25
after warm-up, CUDA events), their sum, ``delta = rowsum(dO * o)`` as the
wrapper computes it, SDPA's backward on the same inputs (the yardstick; no
port calls it), and each gradient's row error against the plain version
with P rounded to bf16.  The card's name and power limit come first.
Exits nonzero without a card or when a run fails.
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
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        s, dtype=np.float32)).cuda().bfloat16()
        for s in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D),
                  (B, H, S, D)))
    o, lse = fr.flash_attention_fwd_ref(q, k, v)
    got = fk.flash_attention_bwd(q, k, v, o, do, lse)
    want = fr.flash_attention_bwd_ref(q, k, v, o, do, lse, round_p=True)
    torch.cuda.synchronize()

    def row_err(a, ref):
        a, ref = a.float(), ref.float()
        scale = ref.abs().amax(dim=-1, keepdim=True).clamp_min(
            1e-3 * ref.abs().max().item())
        return ((a - ref).abs() / scale).max().item()

    out = dict(root=root, shape=list(SHAPE),
               row_err_vs_round_p={n: row_err(a, b) for n, a, b in zip(
                   ("dq", "dk", "dv"), got, want)})
    del got, want
    delta = (do.float() * o.float()).sum(dim=-1)
    out["dkv_ms"] = cuda_ms(lambda: fk.flash_attention_bwd_dkv(
        q, k, v, do, lse, delta))
    out["dq_ms"] = cuda_ms(lambda: fk.flash_attention_bwd_dq(
        q, k, v, do, lse, delta))
    out["pair_ms"] = out["dkv_ms"] + out["dq_ms"]
    out["delta_ms"] = cuda_ms(lambda: (do.float() * o.float()).sum(dim=-1))
    xs = [x.detach().requires_grad_() for x in (q, k, v)]
    o_lib = torch.nn.functional.scaled_dot_product_attention(
        *xs, is_causal=True, enable_gqa=True)
    out["sdpa_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
        o_lib, xs, do, retain_graph=True))
    return out


def main(argv) -> int:
    if argv[:1] == ["--build"]:
        sys.path.insert(0, os.path.join(argv[1], "src"))
        from repro_torch.kernels import build
        build.build(["flash_attention_bwd"])
        return 0
    if argv[:1] == ["--one"]:
        print(json.dumps(run_one(argv[1])), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_pair: no CUDA device", file=sys.stderr)
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
        print("flash_bwd_pair: a build failed", file=sys.stderr)
        return 1
    for r in roots:
        if subprocess.run([sys.executable, me, "--one", r]).returncode:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
