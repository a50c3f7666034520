"""Graph substrate for the PageRank immortal algorithm (numpy only).

The port's own copy of the JAX package's ``algorithms/graphs.py``: the
deterministic R-MAT generator, a block row partitioner producing uniform
SPMD-ready shards, and the *static halo plan*: for every (owner,
requester) process pair, which rank entries must travel each iteration.
The plan is exactly an LPF h-relation, so every PageRank iteration is one
``lpf_put``-superstep plus one small allreduce.

Both functions return the same edge list and the same arrays as the JAX
package's for the same arguments, vectorised so that Graph500's scale 22
(4.19 M vertices, 67.1 M edges) builds in a minute or two on one host
core:

* ``rmat_graph`` keeps the first ``m`` distinct non-loop edges of the
  ``Generator.choice(4, size=(rows, scale), p=...)`` stream, in stream
  order.  That stream does not depend on how many rows one call draws
  (each choice is one ``random()`` draw compared against the cumulative
  probabilities), so drawing it in chunks gives the reference's set.
* ``partition_graph`` finds each source's halo position by a
  ``searchsorted`` in the process's sorted halo instead of a per-edge
  dict.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

__all__ = ["rmat_graph", "banded_graph", "PartitionedGraph", "partition_graph"]

#: rows of R-MAT choices drawn at once (each row is ``scale`` doubles)
CHUNK_ROWS = 1 << 20


def _bits(bits: np.ndarray) -> np.ndarray:
    """Each row of a ``[rows, k]`` bool array as an integer, column 0 the
    most significant bit."""
    packed = np.packbits(bits, axis=1)
    val = np.zeros(bits.shape[0], np.int64)
    for j in range(packed.shape[1]):
        val = (val << 8) | packed[:, j]
    return val >> (8 * packed.shape[1] - bits.shape[1])


def _rmat_chunk(rng: np.random.Generator, rows: int, scale: int,
                cdf: np.ndarray) -> np.ndarray:
    """``rows`` R-MAT edges as keys ``src * n + dst``, self loops dropped.
    The quadrant of each level is ``Generator.choice``'s draw, the count
    of cumulative probabilities at or below one ``random()`` value: its
    high bit (the source's) is ``u >= cdf[1]``, its low bit (the
    destination's) the parity of the three comparisons."""
    u = rng.random((rows, scale))
    hi = u >= cdf[1]
    src = _bits(hi)
    dst = _bits((u >= cdf[0]) ^ hi ^ (u >= cdf[2]))
    keep = src != dst
    return (src[keep] << scale) | dst[keep]


def rmat_graph(n: int, m: int, seed: int = 0,
               a: float = 0.57, b: float = 0.19, c: float = 0.19
               ) -> np.ndarray:
    """Directed R-MAT edge list [m, 2] (src, dst), deduplicated, no self
    loops, sorted.  ``n`` must be a power of two."""
    assert n & (n - 1) == 0, "rmat needs power-of-two n"
    rng = np.random.default_rng(seed)
    scale = int(np.log2(n))
    probs = np.array([a, b, c, 1.0 - a - b - c])
    cdf = probs.cumsum()
    cdf /= cdf[-1]
    if m <= 0:
        return np.array([], dtype=np.int64)
    parts: List[np.ndarray] = []
    kept = 0
    want = m + m // 8        # R-MAT repeats a few % of its edges at scale 20
    while True:
        while kept < want:
            parts.append(_rmat_chunk(rng, CHUNK_ROWS, scale, cdf))
            kept += parts[-1].size
        keys = np.concatenate(parts) if len(parts) > 1 else parts[0]
        parts = [keys]
        uniq, first = np.unique(keys, return_index=True)
        if uniq.size >= m:
            break
        # too many repeats: draw on, scaled by the repeat rate so far
        want = kept + int((m - uniq.size) * kept / max(uniq.size, 1)) + 1
    if uniq.size > m:
        uniq = uniq[first <= np.partition(first, m - 1)[m - 1]]
    return np.stack([uniq >> scale, uniq & (n - 1)], axis=1)


def banded_graph(n: int, band: int = 4) -> np.ndarray:
    """Deterministic banded digraph (cage-matrix-like): vertex v links to
    v+1 .. v+band (mod n)."""
    src = np.repeat(np.arange(n), band)
    off = np.tile(np.arange(1, band + 1), n)
    dst = (src + off) % n
    return np.stack([src, dst], axis=1)


@dataclasses.dataclass
class PartitionedGraph:
    """Block-row partitioned column-stochastic link matrix + halo plan.

    Per-process arrays, stacked on axis 0 (the port's process axis):
      ``row_ids``  [p, nnz_max]   local row of each stored nonzero
      ``col_ext``  [p, nnz_max]   column index into [local r | halo]
      ``vals``     [p, nnz_max]   1/outdeg(src)   (0 padding)
      ``pack_idx`` [p, send_max]  local r indices to pack for neighbours
      ``dangling`` [p, rows]      1.0 where the local vertex is dangling

    Padding nonzeros sit at the tail of each row of the shard arrays, with
    ``row_ids == rows`` (a dump row).

    Static (host) plan:
      ``msgs``     [(owner, requester, pack_off, halo_off, count)]
      ``halo_max`` / ``send_max`` reserved capacities (lpf_resize_*)
    """

    n: int
    p: int
    rows: int
    nnz_max: int
    send_max: int
    halo_max: int
    row_ids: np.ndarray
    col_ext: np.ndarray
    vals: np.ndarray
    pack_idx: np.ndarray
    dangling: np.ndarray
    msgs: List[Tuple[int, int, int, int, int]]

    def h_bytes(self, itemsize: int = 4) -> int:
        """The per-iteration halo h-relation (bytes) — the immortal cost."""
        sent = np.zeros(self.p, np.int64)
        recv = np.zeros(self.p, np.int64)
        for o, d, _, _, c in self.msgs:
            if o != d:
                sent[o] += c * itemsize
                recv[d] += c * itemsize
        return int(max(sent.max(initial=0), recv.max(initial=0)))


def partition_graph(edges: np.ndarray, n: int, p: int) -> PartitionedGraph:
    """Build the SPMD shards + halo plan for ``r' = A r`` with
    ``A[dst, src] = 1/outdeg(src)``."""
    if n % p:
        raise ValueError(f"n={n} must be divisible by p={p}")
    rows = n // p
    src, dst = edges[:, 0], edges[:, 1]
    outdeg = np.bincount(src, minlength=n).astype(np.float64)
    dangling_v = (outdeg == 0).astype(np.float32)

    owner = dst // rows            # nonzero [dst, src] lives on dst's owner
    col_owner = src // rows

    per_pid_nnz = np.bincount(owner, minlength=p)
    nnz_max = int(per_pid_nnz.max(initial=1))

    # per-pid halos: unique remote sources, sorted, hence grouped by their
    # owning process in ascending order
    members = [np.flatnonzero(owner == d) for d in range(p)]
    halos: List[np.ndarray] = []
    group_sizes = np.zeros((p, p), np.int64)          # [requester, owner]
    for d in range(p):
        s_d = src[members[d]]
        remote = np.unique(s_d[col_owner[members[d]] != d])
        halos.append(remote)
        group_sizes[d] = np.bincount(remote // rows, minlength=p)
    halo_max = max(1, max(h.size for h in halos))
    halo_start = np.cumsum(group_sizes, axis=1) - group_sizes

    # owner-side pack buffers: concatenation over requesters (ascending)
    # of the local indices each requester needs
    msgs: List[Tuple[int, int, int, int, int]] = []
    packs: List[np.ndarray] = []
    send_max = 1
    for o in range(p):
        cat = []
        off = 0
        for d in range(p):
            k = int(group_sizes[d, o])
            if not k:
                continue
            lo = int(halo_start[d, o])
            msgs.append((o, d, off, lo, k))
            cat.append(halos[d][lo:lo + k] - o * rows)
            off += k
        packs.append(np.concatenate(cat).astype(np.int32) if cat
                     else np.zeros(0, np.int32))
        send_max = max(send_max, off)
    pack_idx = np.zeros((p, send_max), np.int32)
    for o in range(p):
        pack_idx[o, :packs[o].size] = packs[o]

    # CSR-ish shards with extended column indices
    row_ids = np.full((p, nnz_max), rows, np.int32)  # pad -> dump bucket
    col_ext = np.zeros((p, nnz_max), np.int32)
    vals = np.zeros((p, nnz_max), np.float32)
    for d in range(p):
        s_d, t_d = src[members[d]], dst[members[d]]
        ext = np.where(col_owner[members[d]] == d, s_d - d * rows,
                       rows + np.searchsorted(halos[d], s_d))
        k = s_d.size
        row_ids[d, :k] = (t_d - d * rows).astype(np.int32)
        col_ext[d, :k] = ext.astype(np.int32)
        vals[d, :k] = (1.0 / outdeg[s_d]).astype(np.float32)

    dang = dangling_v.reshape(p, rows)
    return PartitionedGraph(
        n=n, p=p, rows=rows, nnz_max=nnz_max, send_max=send_max,
        halo_max=halo_max, row_ids=row_ids, col_ext=col_ext, vals=vals,
        pack_idx=pack_idx, dangling=dang, msgs=msgs)
