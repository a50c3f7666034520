"""PageRank on a GraphBLAS-lite SpMV over LPF (paper §4.3).

The accelerated implementation translates the canonical linear-algebra
formulation (Langville & Meyer, paper ref [11]) onto LPF supersteps:

    r' = alpha * (A r  +  1/n * sum_{dangling j} r_j)  +  (1 - alpha)/n

Each iteration is:
  superstep 1 — halo exchange: owners *put* packed rank entries to the
                processes whose rows reference them (the static plan from
                the sparsity structure — an irregular h-relation);
  local       — SpMV as a segment sum + dangling correction;
  superstep 2 — a tiny allreduce of [dangling mass, l1 residual, spare]
                fused into one 3-word vector.

As everywhere in the port, per-process values are stacked ``[p, ...]``:
the ranks are ``[p, rows]`` and one segment sum serves every process.
The shards' padding nonzeros (``row_ids == rows``, about 70 % of the
stacked entries of an R-MAT graph at p = 8, since the most loaded
process sets ``nnz_max``) are dropped once, before the loop: they would
all land on one dump row, which the reference slices off anyway.  The
rest are sorted by row once, and the segment sum is
``torch.segment_reduce`` over those runs: deterministic, each row's
terms added in shard order on the CPU and in a fixed tree on the card.
The alternative, ``index_add_``, adds a row's terms by float atomics in
an order that changes from run to run; at R-MAT scale 22 its sums drift
by ~5e-6 of the largest, enough to keep PageRank's l1 residual above
tol 1e-7 for a varying number of iterations (``scripts/pagerank_spmv.py``
measures both on the card).

:func:`dataflow_pagerank` is the paper's "pure Spark" baseline, which
gathers the whole rank vector every iteration and ignores dangling mass
and convergence; :func:`reference_pagerank` is the dense float64 oracle
of the tests and :func:`sparse_reference_pagerank` the same oracle over
the edge list, for graphs too large for a dense matrix.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import bsp
from ..core import LPFContext, LPF_SYNC_DEFAULT, SyncAttributes, exec_
from ..core.context import resolve_device
from .graphs import PartitionedGraph

__all__ = ["lpf_pagerank", "pagerank_spmd", "dataflow_pagerank",
           "reference_pagerank", "sparse_reference_pagerank",
           "shard_tensors"]

SHARD_KEYS = ("row_ids", "col_ext", "vals", "pack_idx", "dangling")


def shard_tensors(g: PartitionedGraph, device="cuda") -> Dict[str, Any]:
    """The graph's stacked per-process arrays as tensors on ``device``."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(getattr(g, k)).to(dev) for k in SHARD_KEYS}


def _halo_exchange(ctx: LPFContext, g: PartitionedGraph,
                   r_local: torch.Tensor, attrs: SyncAttributes,
                   pack_idx: torch.Tensor) -> torch.Tensor:
    """One halo superstep: returns the [p, halo_max] remote ranks."""
    pack = torch.gather(r_local, 1, pack_idx.long())   # entries to send
    ctx.resize_memory_register(ctx.registry.n_active + 2)
    ctx.resize_message_queue(max(1, len(g.msgs)))
    s_pack = ctx.register_global("pr.pack", pack)
    s_halo = ctx.register_global("pr.halo", torch.zeros(
        ctx.p, g.halo_max, dtype=r_local.dtype, device=ctx.device))
    ctx.put_msgs([(o, d, s_pack, po, s_halo, ho, c)
                  for (o, d, po, ho, c) in g.msgs if c > 0])
    ctx.sync(attrs, label="pr.halo")
    halo = ctx.tensor(s_halo)
    ctx.deregister(s_pack)
    ctx.deregister(s_halo)
    return halo


class _SpMV:
    """``y[s] = segment_sum(vals[s] * x_ext[s][col_ext[s]], row_ids[s])``
    for every process ``s`` at once, over the valid nonzeros only, in flat
    coordinates of the stacked ``[p, rows]`` / ``[p, rows + halo_max]``
    arrays, sorted by row (stably: a row's terms keep shard order)."""

    def __init__(self, g: PartitionedGraph, shard: Dict[str, Any]):
        p, rows, ext = g.p, g.rows, g.rows + g.halo_max
        row_ids = shard["row_ids"].long()
        valid = row_ids < rows               # the padding is the dump row
        base = torch.arange(p, device=row_ids.device)[:, None]
        flat_rows = (row_ids + base * rows)[valid]
        order = torch.argsort(flat_rows, stable=True)
        self.cols = (shard["col_ext"].long() + base * ext)[valid][order]
        self.vals = shard["vals"][valid][order]
        self.lengths = torch.bincount(flat_rows, minlength=p * rows)
        self.shape = (p, rows)

    def __call__(self, x_ext: torch.Tensor) -> torch.Tensor:
        contrib = self.vals * x_ext.reshape(-1)[self.cols]
        return torch.segment_reduce(contrib, "sum", lengths=self.lengths,
                                    unsafe=True).view(self.shape)


def _iteration(ctx: LPFContext, g: PartitionedGraph, spmv: _SpMV,
               shard: Dict[str, Any], r: torch.Tensor, dmass: torch.Tensor,
               alpha: float, attrs: SyncAttributes
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One PageRank iteration: halo superstep, SpMV, stats allreduce.
    Returns (r_new [p, rows], next dangling mass [p], residual [p]); the
    last two are the same on every process."""
    halo = _halo_exchange(ctx, g, r, attrs, shard["pack_idx"])
    r_new = alpha * (spmv(torch.cat([r, halo], dim=1))
                     + dmass[:, None] / g.n) + (1.0 - alpha) / g.n
    # fused 3-word allreduce: next dangling mass, residual, (spare)
    stats = torch.stack([(r_new * shard["dangling"]).sum(1),
                         (r_new - r).abs().sum(1),
                         torch.zeros_like(dmass)], dim=1)
    tot = bsp.allreduce(ctx, stats, attrs=attrs, label="pr.reduce")
    return r_new, tot[:, 0], tot[:, 1]


def pagerank_spmd(ctx: LPFContext, g: PartitionedGraph, shard: dict, *,
                  alpha: float = 0.85, tol: float = 1e-7,
                  max_iter: int = 200,
                  attrs: SyncAttributes = LPF_SYNC_DEFAULT
                  ) -> Tuple[torch.Tensor, int, torch.Tensor]:
    """Run PageRank inside an SPMD region.

    ``shard``: the stacked per-process arrays as tensors on the context's
    device (:func:`shard_tensors`): row_ids/col_ext/vals [p, nnz_max],
    pack_idx [p, send_max], dangling [p, rows].  Returns (r [p, rows],
    iterations, l1 residual [p], the same on every process).  The loop
    runs through ``ctx.compile_loop``, its condition read on the host
    once an iteration."""
    rows, n, p = g.rows, g.n, ctx.p
    spmv = _SpMV(g, shard)
    shard = dict(shard, pack_idx=shard["pack_idx"].long())
    dangling = shard["dangling"]
    r0 = torch.full((p, rows), 1.0 / n, dtype=torch.float32,
                    device=ctx.device)
    zeros = torch.zeros(p, dtype=torch.float32, device=ctx.device)

    # initial dangling mass of the uniform vector
    stats0 = bsp.allreduce(
        ctx, torch.stack([(r0 * dangling).sum(1), zeros, zeros], dim=1),
        attrs=attrs, label="pr.init")

    def cond(carry):
        _, _, it, res = carry
        return it < max_iter and bool(res[0] > tol)

    def body(ctx2, carry):
        r, dmass, it, _ = carry
        r_new, dnew, res = _iteration(ctx2, g, spmv, shard, r, dmass,
                                      alpha, attrs)
        return (r_new, dnew, it + 1, res)

    r, _, iters, res = ctx.compile_loop(
        body, (r0, stats0[:, 0], 0, torch.full_like(zeros, float("inf"))),
        cond=cond, label="pr.iter")
    return r, iters, res


def lpf_pagerank(p: int, g: PartitionedGraph, *, alpha: float = 0.85,
                 tol: float = 1e-7, max_iter: int = 200,
                 attrs: SyncAttributes = LPF_SYNC_DEFAULT, device="cuda",
                 return_ledger: bool = False):
    """Whole-graph entry point over ``p`` virtual processes on ``device``:
    distribute the shards, run, gather the [n] ranks.  Returns
    (ranks, iterations, residual), and the cost ledger with
    ``return_ledger=True``."""
    if p != g.p:
        raise ValueError(f"graph partitioned over {g.p} processes, not {p}")

    def spmd(ctx, s, p_, shard):
        return pagerank_spmd(ctx, g, shard, alpha=alpha, tol=tol,
                             max_iter=max_iter, attrs=attrs)

    (r, iters, res), ledger = exec_(p, spmd, shard_tensors(g, "cpu"),
                                    device=device, return_ledger=True)
    out = (r.reshape(-1), int(iters), float(res[0]))
    return out + (ledger,) if return_ledger else out


# --------------------------------------------------------------------------
# baselines and oracles
# --------------------------------------------------------------------------

def dataflow_pagerank(edges, n: int, iters: int, alpha: float = 0.85,
                      device="cuda") -> torch.Tensor:
    """The paper's "pure Spark" analogue: contributions shuffled globally
    every iteration (here: a full gather + segment sum), *without*
    dangling handling or convergence checks — faithful to
    SparkPageRank.scala, which computes
    ``rank = 0.15 + 0.85 * sum(contribs)``.  ``edges`` is the [m, 2]
    edge list, a numpy array or a tensor (already on ``device``, it is
    not copied)."""
    dev = resolve_device(device)
    e = torch.as_tensor(edges, device=dev)
    src, dst = e[:, 0], e[:, 1]
    deg = torch.bincount(src, minlength=n).clamp_(min=1).to(
        torch.float32)[src]
    r = torch.ones(n, dtype=torch.float32, device=dev)
    for _ in range(iters):
        s = torch.zeros_like(r).index_add_(0, dst, r[src] / deg)
        r = (1.0 - alpha) + alpha * s
    return r


def reference_pagerank(edges: np.ndarray, n: int, alpha: float = 0.85,
                       tol: float = 1e-10, max_iter: int = 500
                       ) -> Tuple[np.ndarray, int]:
    """Dense numpy oracle with dangling handling (test reference)."""
    A = np.zeros((n, n), np.float64)
    outdeg = np.bincount(edges[:, 0], minlength=n)
    for s, d in edges:
        A[d, s] = 1.0 / outdeg[s]
    dangling = (outdeg == 0).astype(np.float64)
    r = np.full(n, 1.0 / n)
    for it in range(max_iter):
        r_new = alpha * (A @ r + np.dot(dangling, r) / n) + (1 - alpha) / n
        if np.abs(r_new - r).sum() < tol:
            return r_new, it + 1
        r = r_new
    return r, max_iter


def sparse_reference_pagerank(edges: np.ndarray, n: int, alpha: float = 0.85,
                              tol: float = 1e-10, max_iter: int = 500,
                              device="cuda") -> Tuple[torch.Tensor, int]:
    """:func:`reference_pagerank`'s iteration in float64 over the edge
    list (``A r`` as an ``index_add_`` of ``r[src] / outdeg[src]`` into
    ``dst``), for graphs too large for a dense matrix.  An oracle: it
    shares no code with the LPF path."""
    dev = resolve_device(device)
    src = torch.from_numpy(np.ascontiguousarray(edges[:, 0])).to(dev)
    dst = torch.from_numpy(np.ascontiguousarray(edges[:, 1])).to(dev)
    outdeg = torch.from_numpy(
        np.bincount(edges[:, 0], minlength=n).astype(np.float64)).to(dev)
    w = 1.0 / outdeg[src]
    dangling = outdeg == 0
    r = torch.full((n,), 1.0 / n, dtype=torch.float64, device=dev)
    for it in range(max_iter):
        ar = torch.zeros_like(r).index_add_(0, dst, r[src] * w)
        r_new = alpha * (ar + r[dangling].sum() / n) + (1 - alpha) / n
        if float((r_new - r).abs().sum()) < tol:
            return r_new, it + 1
        r = r_new
    return r, max_iter
