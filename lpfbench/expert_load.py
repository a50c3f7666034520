"""The expert load of a training cell's batches, read outside any run:

    python3 -m lpfbench.expert_load --workload granite-train-b2s4096 --seeds 1 2 3

For each seed it builds the program's model with the seed's weights,
runs its forward (no gradient) over the first ``--batches`` batches of
the cell's token pool, and reads at each expert block the tokens routed
to each expert and the block's capacity through the program's own
``models.moe.expert_load``.  Prints one JSON line a seed: the share of
routed tokens dropped past an expert's capacity (all layers, and the
least and largest layer), and the fullest expert's load over the mean."""

from __future__ import annotations

import argparse
import json
import os
import sys

from .harness import ROOT, cache_dirs, load_cell


def read(cell, seed: int, batches: int, device) -> dict:
    import torch
    from repro_torch.models import blocks, lm
    from repro_torch.models.moe import expert_load

    from .drivers import train
    pool = train.token_pool(seed, cell.traffic,
                            cell.config["model"]["vocab_size"], device)
    ts, params, opt = train.build(cell, seed, device)
    del opt
    cfg = train.program_config(cell.config)
    loads = []
    real = blocks.moe_single

    def recorded(p, h, mcfg):
        load, cap = expert_load(p, h, mcfg)
        loads.append((load.float(), cap))
        return real(p, h, mcfg)
    blocks.moe_single = recorded
    try:
        with torch.no_grad():
            for i in range(batches):
                lm.loss_fn(params, train.batch_of(pool, i), cfg, ts.rt)
    finally:
        blocks.moe_single = real
    drop = [float((load - cap).clamp_min(0).sum() / load.sum())
            for load, cap in loads]
    routed = sum(float(load.sum()) for load, _ in loads)
    dropped = sum(float((load - cap).clamp_min(0).sum())
                  for load, cap in loads)
    return {"blocks": len(loads), "capacity": loads[0][1],
            "mean_load": float(loads[0][0].mean()),
            "dropped_share": dropped / routed,
            "dropped_share_least_layer": min(drop),
            "dropped_share_largest_layer": max(drop),
            "fullest_over_mean": max(float(load.max() / load.mean())
                                     for load, _ in loads)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m lpfbench.expert_load")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--batches", type=int, default=None)
    args = ap.parse_args(argv)
    for key, path in cache_dirs().items():
        os.environ[key] = path
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    cell = load_cell(args.workload)
    device = torch.device("cuda", 0)
    batches = args.batches or int(cell.traffic["check_steps"])
    if cell.config["program"].get("overrides", {}).get("attn_impl") \
            == "flash":
        from repro_torch.kernels import build as kbuild
        kbuild.build(["flash_attention_fwd", "flash_attention_bwd"])
    for seed in args.seeds:
        row = {"workload": cell.name, "seed": seed, "batches": batches,
               **read(cell, seed, batches, device)}
        print("expert_load " + json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
