#!/usr/bin/env python3
"""The device memory peak and step times of a few full-width training
steps at one batch size: the check of which batch fits one card.

    python3 scripts/train_peak.py --batch 8     # granite-moe-3b-a800m

``build_train_step(donate=True)`` (AdamW in place), S 2048, flash
attention, ``launch.one_card_config(arch)``; seed-0 weights and the
synthetic stream, on the card only.  Prints one ``probe {...}`` JSON line: each step's host
ms, the peak allocated and reserved GB, or the out-of-memory message when
the batch does not fit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-moe-3b-a800m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)

    import torch
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.launch import one_card_config
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train_step import build_train_step
    cfg = dataclasses.replace(one_card_config(args.arch, smoke=False),
                              attn_impl="flash")
    ts = build_train_step(cfg, opt_cfg=AdamWConfig(lr=1e-4), donate=True,
                          device="cuda")
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                        global_batch=args.batch, seed=0))
    params, opt = ts.init_fn(0)
    torch.cuda.reset_peak_memory_stats()
    out = {"arch": args.arch, "B": args.batch, "S": args.seq}
    try:
        for step in range(args.steps):
            batch = {k: torch.from_numpy(v).to(ts.rt.device)
                     for k, v in stream.batch(step).items()}
            t0 = time.perf_counter()
            params, opt, m = ts.step_fn(params, opt, batch)
            m["loss"].item()
            out[f"step{step}_ms"] = (time.perf_counter() - t0) * 1e3
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["reserved_gb"] = torch.cuda.max_memory_reserved() / 1e9
    except torch.OutOfMemoryError as e:
        out["oom"] = str(e)[:200]
    print("probe " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
