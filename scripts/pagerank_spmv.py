#!/usr/bin/env python3
"""PageRank's SpMV on one NVIDIA GPU: the segment sum of
``vals * x_ext[col_ext]`` by row, as ``repro_torch.algorithms.pagerank``
computes it, beside other ways to compute the same sums.

    python3 scripts/pagerank_spmv.py [--scale 22]

On ``rmat_graph(2^scale, 16 * 2^scale, seed=1)`` partitioned over p = 8
(``chip_smoke.py`` (n)'s graph), with ranks drawn from a seed, it prints
for each way: milliseconds a call (CUDA events, median), the largest
error relative to the largest sum against the same sums in float64, and
whether five calls give bit-identical sums:

* ``port``: the port's ``_SpMV`` as it stands (``segment_reduce`` over
  the nonzeros sorted by row once);
* ``index_add``: ``index_add_`` over the valid nonzeros in shard order
  (float atomics);
* ``index_add_sorted``: the same over the nonzeros sorted by row;
* ``csr``: ``torch.sparse_csr_tensor`` times the vector (cuSPARSE), the
  library call.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from _timing import card_line, cuda_ms  # noqa: E402


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=22)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.algorithms import (partition_graph, rmat_graph,
                                        shard_tensors)
    from repro_torch.algorithms import pagerank as pr
    dev = torch.device("cuda")
    p, n = 8, 1 << args.scale
    t0 = time.perf_counter()
    g = partition_graph(rmat_graph(n, 16 * n, seed=1), n, p)
    print(f"graph scale {args.scale}: {time.perf_counter() - t0:.1f} s",
          flush=True)
    shard = shard_tensors(g, device=dev)
    port = pr._SpMV(g, shard)
    m = p * g.rows
    # the valid nonzeros in shard order, as flat (row, column, value)
    row_ids = shard["row_ids"].long()
    valid = row_ids < g.rows
    base = torch.arange(p, device=dev)[:, None]
    rows = (row_ids + base * g.rows)[valid]
    cols = (shard["col_ext"].long() + base * (g.rows + g.halo_max))[valid]
    vals = shard["vals"][valid]
    x = torch.from_numpy(np.random.default_rng(0).random(
        (p, g.rows + g.halo_max), dtype=np.float32)).to(dev)
    xf = x.reshape(-1)
    ref = torch.zeros(m, dtype=torch.float64, device=dev).index_add_(
        0, rows, vals.double() * xf.double()[cols])

    order = torch.argsort(rows, stable=True)
    rows_s, cols_s, vals_s = rows[order], cols[order], vals[order]
    lengths = torch.bincount(rows, minlength=m)
    crow = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      lengths.cumsum(0)])
    csr = torch.sparse_csr_tensor(crow, cols_s, vals_s,
                                  size=(m, xf.shape[0]))

    ways = {
        "port": lambda: port(x).reshape(-1),
        "index_add": lambda: torch.zeros(m, device=dev).index_add_(
            0, rows, vals * xf[cols]),
        "index_add_sorted": lambda: torch.zeros(m, device=dev).index_add_(
            0, rows_s, vals_s * xf[cols_s]),
        "csr": lambda: (csr @ xf[:, None]).reshape(-1),
    }
    out = dict(card=card_line(), scale=args.scale, nnz=int(rows.numel()),
               rows=m, ways={})
    for name, fn in ways.items():
        first = fn()
        same = all(torch.equal(first, fn()) for _ in range(4))
        err = ((first.double() - ref).abs().max() / ref.abs().max()).item()
        out["ways"][name] = dict(ms=cuda_ms(fn, reps=20, warmup=3),
                                 rel_err=err, bit_identical_runs=same)
        print(name, json.dumps(out["ways"][name]), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
