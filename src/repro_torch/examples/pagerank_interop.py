"""Interoperability (paper §4.3 / Algorithm 3) on the port: an LPF
immortal algorithm called from a foreign parallel program, unmodified on
both sides.

The 'host' is an analytics function that already holds the graph's
shards on the device (playing Spark's role).  It hooks the LPF PageRank
mid-computation — the paper's two-step recipe: (1) the host environment
already exists, (2) ``lpf_hook``.  No change to the PageRank, no change
to the host.

Run:  PYTHONPATH=src python -m repro_torch.examples.pagerank_interop
      (``--device cpu`` without a card)
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import core as lpf
from ..algorithms import (pagerank_spmd, partition_graph,
                          reference_pagerank, rmat_graph, shard_tensors)

N, EDGES, PROCS = 256, 1500, 8
TOL, MAX_ITER = 1e-7, 150


def run(device="cuda") -> dict:
    """PageRank hooked from the host function on ``device``, held against
    the dense float64 oracle."""
    edges = rmat_graph(N, EDGES, seed=42)
    g = partition_graph(edges, N, PROCS)
    shard = shard_tensors(g, device=device)

    def host_analytics(args):
        """A 'Spark stage': local degree statistics... then PageRank."""
        local_nnz = (args["vals"] > 0).sum(1)

        def spmd(ctx, s, p, a):          # the unmodified LPF algorithm
            return pagerank_spmd(ctx, g, a, tol=TOL, max_iter=MAX_ITER)

        r, iters, res = lpf.hook(PROCS, spmd, args,
                                 device=args["vals"].device)   # lpf_hook
        return r, iters, local_nnz

    r, iters, nnz = host_analytics(shard)
    ref, ref_iters = reference_pagerank(edges, N)
    r = r.reshape(-1).cpu().numpy()
    return dict(n=N, nnz=int(edges.shape[0]), nnz_per_process=nnz.tolist(),
                iterations=int(iters), ranks=r,
                rel_err=float(np.abs(r - ref).max() / ref.max()),
                mass=float(r.sum()),
                top5=[int(v) for v in np.argsort(-r)[:5]])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; refused without a card) or "
                         "cpu")
    res = run(ap.parse_args(argv).device)
    print(f"graph: n={res['n']}, nnz={res['nnz']} "
          f"(per-process: {res['nnz_per_process']})")
    print(f"LPF PageRank: {res['iterations']} iterations to eps={TOL:g}, "
          f"rel err vs dense oracle {res['rel_err']:.2e}")
    print(f"rank mass: {res['mass']:.6f} (dangling handled, sums to 1)")
    print("top-5 vertices:", res["top5"])
    return 0 if res["rel_err"] < 1e-3 else 1


if __name__ == "__main__":
    raise SystemExit(main())
