"""The readings that a cell's limits are set from, on the card:

    python3 -m lpfbench.readings --workload <name> --kind control --seeds 1 2 3

``--kind control`` reads the numbers the judgement compares from the
control (the reference put in the program's place, one precision below
the configuration's); a driver may offer more kinds (planted faults).
The program's own readings come from the benchmark's runs.  Prints one
JSON line a seed, and writes them all to ``--out`` when given."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .harness import ROOT, cache_dirs, driver_of, load_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m lpfbench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--kind", default="control")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for key, path in cache_dirs().items():
        os.environ[key] = path
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    cell = load_cell(args.workload)
    device = torch.device("cuda", 0)
    drv = driver_of(cell)
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        got = drv.control(cell, seed, device, args.kind)
        detail = got.pop("detail", None)
        row = {"workload": cell.name, "kind": args.kind, "seed": seed,
               "numbers": got, "seconds": time.perf_counter() - t0}
        print("reading " + json.dumps(row), flush=True)
        if detail is not None:
            row["detail"] = detail
        rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
