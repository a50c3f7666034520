"""Cross-pod pytree all-reduce as LPF supersteps — the JAX package's
``repro.bsp.pod_sync`` over virtual pods on one device.

The JAX module lowers the slow-link (DCN) gradient hop onto collectives
over the ``pod`` axis of a mesh.  One card holds the ``q`` pods as
virtual processes: every pod-varying value carries a leading ``[q]`` axis
(row ``i`` is pod ``i``'s), so each collective is arithmetic over that
axis:

* the **reduce-scatter** of a bucket reads its leaves as an f32 wire of
  ``n`` elements a pod (padded to ``q·m``) and sums over the pods: pod
  ``i``'s chunk ``[m]`` is the sum over pods of chunk ``i``;
* the **all-gather** gives every pod every chunk: ``[q, ...]`` leaves
  whose rows are one stride-0 view of the chunks;
* the **ring** (``lax.psum`` per leaf in JAX) sums each leaf over the
  pods; under ``compress`` the summands are int16 with one scale shared
  by the pods.

The methods, their validation and their :class:`CostLedger` entries are
the JAX package's field for field (``rs+ag``, ``bucketed``,
``bucketed_fenced``, ``bucketed_overlap``, ``ring``, ``auto``).  On one
stream every bucket runs in program order, which is ``bucketed_fenced``'s
fence.  ``bucketed_overlap`` issues the buckets last-layer-first, bucket
k-1's reduce-scatter with bucket k's all-gather: the schedule the JAX
code asks XLA for.  Inside a CUDA-graph capture the reduce-scatter runs
on a side stream of the device's pool while the all-gather runs on the
current stream; dispatched, both run on the current stream, where the
fork and join cost more host time than the overlap hides
(:func:`repro_torch.core.sync.fork_streams`).

Trees are nested dicts, lists and tuples of tensors, flattened with dict
keys in sorted order as ``jax.tree_util`` flattens them, so buckets and
ledgers match the JAX package's for the same tree.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..core import (CostLedger, LPF_SYNC_DEFAULT, SuperstepCost,
                    SyncAttributes, overlap_cost)
from ..core.errors import LPFFatalError
from ..core.sync import fork_streams, on_stream

__all__ = ["pod_allreduce", "bucketize", "lpf_bucketed_allreduce"]


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """``(leaves, spec)`` of a nested dict/list/tuple tree, dict keys in
    sorted order (``jax.tree_util.tree_flatten``'s order)."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves, specs = [], []
        for k in keys:
            ls, sp = tree_flatten(tree[k])
            leaves += ls
            specs.append(sp)
        return leaves, ("dict", keys, specs)
    if isinstance(tree, (list, tuple)):
        leaves, specs = [], []
        for x in tree:
            ls, sp = tree_flatten(x)
            leaves += ls
            specs.append(sp)
        return leaves, (type(tree), len(tree), specs)
    return [tree], None


def tree_unflatten(spec, leaves) -> Any:
    """The inverse of :func:`tree_flatten`."""
    return _build(spec, iter(leaves))


def _build(spec, it):
    # a module-level recursion: a recursive closure would be a reference
    # cycle holding the leaves until the cyclic collector ran
    if spec is None:
        return next(it)
    kind, keys, specs = spec
    if kind == "dict":
        return {k: _build(s, it) for k, s in zip(keys, specs)}
    return kind(_build(s, it) for s in specs)


def _leaf_bytes(tree) -> int:
    return sum(int(np.prod(l.shape)) * l.element_size()
               for l in tree_flatten(tree)[0])


def bucketize(sizes_bytes, bucket_bytes: Optional[int]):
    """Greedy contiguous packing of per-leaf byte sizes into buckets of
    at most ``bucket_bytes`` (a leaf larger than the bucket gets its
    own).  Returns a list of index lists.  ``bucket_bytes=None`` packs
    everything into one bucket.  Zero-byte leaves are skipped — they
    appear in no bucket (nothing to put on the wire) — so callers must
    pass such leaves through unchanged.  ``bucket_bytes <= 0`` is
    rejected: it used to silently mean per-leaf, which callers hit by
    accident when a byte-size computation underflowed."""
    if bucket_bytes is not None and bucket_bytes <= 0:
        raise ValueError(
            f"bucket_bytes must be a positive byte count or None (one "
            f"bucket), got {bucket_bytes!r}; pass e.g. 1 for per-leaf "
            f"buckets")
    if any(b < 0 for b in sizes_bytes):
        raise ValueError(f"negative leaf size in {sizes_bytes!r}")
    nonzero = [i for i, b in enumerate(sizes_bytes) if b > 0]
    if not nonzero:
        return []
    if bucket_bytes is None:
        return [nonzero]
    buckets, cur, cur_b = [], [], 0
    for i in nonzero:
        b = sizes_bytes[i]
        if cur and cur_b + b > bucket_bytes:
            buckets.append(cur)
            cur, cur_b = [], 0
        cur.append(i)
        cur_b += b
    buckets.append(cur)
    return buckets


def _rs_chunks(leaves, q: int):
    """One bucket's reduce-scatter chunks ``[q, m]``, unfilled, for the
    ``n`` elements a pod of ``leaves`` (``q·m`` is ``n`` padded up)."""
    n = sum(int(np.prod(l.shape[1:])) for l in leaves)
    m = -(-n // q)
    return (torch.empty(q, m, dtype=torch.float32, device=leaves[0].device),
            n, m)


def _rs_start(leaves, q: int, chunks=None):
    """The split-phase *start* half of one bucket's allreduce over the
    stacked ``[q, ...]`` leaves: reduce-scatter their f32 wire (the
    leaves flattened in order, zero-padded past the bucket's ``n``
    elements a pod to ``q·m``) — pod i's chunk ``[m]`` is the sum over
    pods of chunk i.  The sums go leaf by leaf straight into the chunks,
    so no ``[q, q·m]`` wire is ever built.  ``chunks`` is
    :func:`_rs_chunks`'s (made here when None).  Returns the chunks
    ``[q, m]``."""
    red, n, m = _rs_chunks(leaves, q) if chunks is None else chunks
    flat = red.view(-1)
    off = 0
    for l in leaves:
        k = int(np.prod(l.shape[1:]))
        torch.sum(l.reshape(q, k).float(), 0, out=flat[off:off + k])
        off += k
    flat[n:].zero_()
    return red, [(l.shape[1:], l.dtype) for l in leaves], n, m


def _ag_finish(red, leaves_meta, q: int):
    """The *done* half: all-gather the reduced chunks — every pod receives
    all ``q`` of them — and split them into the leaves' ``[q, *shape]``,
    each in its dtype.  Every pod's row is the same memory (a stride-0
    view of the chunks, converted once where the dtype is not f32)."""
    flat, outs, off = red.view(-1), [], 0
    for shp, dt in leaves_meta:
        k = int(np.prod(shp))
        outs.append(flat[off:off + k].view(shp).to(dt).expand(q, *shp))
        off += k
    return outs


def pod_allreduce(tree, q: int, axis: str = "pod", *,
                  attrs: SyncAttributes = LPF_SYNC_DEFAULT,
                  mean: bool = True,
                  ledger: Optional[CostLedger] = None,
                  method: str = "auto",
                  bucket_bytes: Optional[int] = None):
    """All-reduce a tree of pod-varying ``[q, ...]`` tensors over its ``q``
    pods; payloads optionally int16-quantised with a shared scale.
    Returns the tree with every leaf's rows equal (each pod's result),
    in the leaves' dtypes: the rows are one tensor's, a stride-0 view
    ``[q, ...]`` (the result is read, never written in place).  ``axis`` names the pod axis in ledger terms
    only (the stacked leaves carry it first).

    ``method``: ``auto`` (bucketed_overlap when ``bucket_bytes`` is set,
    rs+ag when uncompressed, ring otherwise), ``rs+ag`` (explicit
    reduce-scatter + all-gather of the whole flattened tree),
    ``bucketed`` (one rs+ag pair per ~``bucket_bytes`` of gradients),
    ``bucketed_fenced`` (the same with the BSP fence between buckets
    explicit — program order on one stream), ``bucketed_overlap`` (the
    buckets issued split-phase, last layer first: bucket k-1's
    reduce-scatter with bucket k's all-gather, on a side stream in a
    CUDA-graph capture), or ``ring`` (one sum over the pods per
    leaf)."""
    if q <= 1:
        return tree
    compress = attrs.compress is not None
    bucket_methods = ("bucketed", "bucketed_fenced", "bucketed_overlap")
    if method not in ("auto", "rs+ag", "ring") + bucket_methods:
        raise ValueError(f"unknown pod_allreduce method {method!r}")
    if method == "auto":
        method = "ring" if compress else \
            ("bucketed_overlap" if bucket_bytes is not None else "rs+ag")
    if method in ("rs+ag",) + bucket_methods and compress:
        raise ValueError(f"{method} cannot combine quantised payloads; "
                         "use method='ring' with compression")
    leaves, spec = tree_flatten(tree)
    for l in leaves:
        if l.ndim == 0 or l.shape[0] != q:
            raise LPFFatalError(
                f"pod_allreduce over {q} pods takes [q, ...] leaves, got "
                f"shape {tuple(l.shape)}")

    if method in ("rs+ag",) + bucket_methods:
        if not leaves:
            return tree
        # wire payloads are f32 regardless of the stored dtype
        sizes = [int(np.prod(l.shape[1:])) * 4 for l in leaves]
        buckets = bucketize(
            sizes, bucket_bytes if method != "rs+ag" else None)
        # zero-byte leaves ride no bucket: pass them through unchanged
        acc_leaves = [l if sizes[i] == 0 else None
                      for i, l in enumerate(leaves)]

        def half_cost(bi, m, tag):
            """One superstep (the rs or the ag half) of bucket bi."""
            wire = (q - 1) * m * 4              # f32 on the wire, per pod
            return SuperstepCost(
                label=f"pod_allreduce.b{bi}.{tag}[x{q}]", h_bytes=wire,
                wire_bytes=wire, total_wire_bytes=wire * q, rounds=1,
                n_msgs=q * q, method=method)

        def account_pair(bi, m):
            if ledger is None:
                return
            wire = 2 * (q - 1) * m * 4          # f32 on the wire, per pod
            suffix = f".b{bi}" if method != "rs+ag" else ""
            ledger.add(SuperstepCost(
                label=f"pod_allreduce{suffix}[x{q}]", h_bytes=wire,
                wire_bytes=wire, total_wire_bytes=wire * q, rounds=2,
                n_msgs=2 * q * q, method=method))

        def finish(state, account=True):
            bi, idxs, red, meta, n, m = state
            # the mean of the chunks before the gather (in place: the
            # chunks are this sync's own): the gathered values are those
            # of a mean after it, bit for bit
            outs = _ag_finish(red.div_(q) if mean else red, meta, q)
            for i, a in zip(idxs, outs):
                acc_leaves[i] = a
            if account:
                account_pair(bi, m)

        if method == "bucketed_overlap":
            # DDP-style software pipeline, last layer's bucket first (the
            # backward pass makes its gradients first): bucket k-1's
            # reduce-scatter is issued with bucket k's all-gather — on a
            # side stream inside a CUDA-graph capture (``fork_streams``).
            # The ledger records the schedule as issued — [rs_B-1]
            # [ag_k||rs_k-1]... [ag_0] — with every overlap group priced
            # by the overlap cost model
            dev = leaves[0].device
            pending = None
            for bi, idxs in reversed(list(enumerate(buckets))):
                part = [leaves[i] for i in idxs]
                if pending is None:
                    state = _rs_start(part, q)
                else:
                    # the chunks are allocated on the current stream,
                    # before the fork: a side stream's own cache would
                    # hold memory the current stream cannot reuse
                    chunks = _rs_chunks(part, q)
                    with fork_streams(dev, 1) as (side,):
                        with on_stream(side):
                            state = _rs_start(part, q, chunks)
                        finish(pending, account=False)
                    del chunks
                red, meta, n, m = state
                if ledger is not None:
                    rs_half = half_cost(bi, m, "rs")
                    if pending is None:
                        ledger.add(rs_half)
                    else:
                        ag_half = half_cost(pending[0], pending[5], "ag")
                        ledger.add(overlap_cost(
                            [ag_half, rs_half],
                            label=f"{ag_half.label}||{rs_half.label}"))
                pending = (bi, idxs, red, meta, n, m)
            if pending is not None:
                finish(pending, account=False)
                if ledger is not None:
                    ledger.add(half_cost(pending[0], pending[5], "ag"))
        else:
            # in-order schedule: on one stream each bucket's pair follows
            # the last, which is also ``bucketed_fenced``'s BSP fence
            for bi, idxs in enumerate(buckets):
                red, meta, n, m = _rs_start([leaves[i] for i in idxs], q)
                finish((bi, idxs, red, meta, n, m))
        return tree_unflatten(spec, acc_leaves)

    if compress:
        def one(l):
            lf = l.float()
            # one scale shared by the pods (a max over them all), so the
            # int16 summands commute exactly; ``* (1 / 127)`` is what XLA
            # compiles the reference's ``/ 127.0`` into
            scale = lf.abs().amax() * (1.0 / 127.0) + 1e-30
            qv = torch.clamp(torch.round(lf / scale), -127, 127).to(
                torch.int16)
            s = qv.sum(0, dtype=torch.int16)
            return s.float() * scale
        acc = [one(l) for l in leaves]
    else:
        acc = [l.float().sum(0) for l in leaves]

    if ledger is not None:
        n = _leaf_bytes([l[0] for l in leaves])
        per_round = (n // 2 if compress else n)
        wire = per_round * 2 * (q - 1) // q     # all-reduce: 2n(q-1)/q
        ledger.add(SuperstepCost(
            label=f"pod_allreduce[x{q}]", h_bytes=n * (q - 1) // q * 2,
            wire_bytes=wire, total_wire_bytes=wire * q, rounds=1,
            n_msgs=2 * (q - 1) * q,
            method="ring" + ("+int16" if compress else "")))
    # each sum is this sync's own: the mean divides it in place
    return tree_unflatten(spec, [
        (a.div_(q) if mean else a).to(l.dtype).expand(q, *a.shape)
        for a, l in zip(acc, leaves)])


def lpf_bucketed_allreduce(ctx, x: torch.Tensor, bucket_elems: int, *,
                           mean: bool = False,
                           attrs: SyncAttributes = LPF_SYNC_DEFAULT,
                           label: str = "ddp") -> torch.Tensor:
    """Slot-based bucketed allreduce of a stacked ``[p, n]`` vector — the
    DDP bucket pipeline expressed through the core program layer instead
    of per-leaf pod collectives.

    The vector splits into ceil(n/bucket_elems) buckets; every bucket's
    reduce-scatter + allgather pair is *started* split-phase before any
    is finished, so the whole schedule records as ONE program whose
    schedule search overlaps independent bucket supersteps (captured on
    the card, each overlap group's members on side streams), and whose
    replay (for a fixed shape) is one compiled program (a CUDA graph on
    the card)."""
    from .collectives import allreduce_done, allreduce_start

    n = int(x.shape[1])
    if bucket_elems <= 0:
        raise ValueError(f"bucket_elems must be positive, got {bucket_elems}")
    with ctx.program(label):
        handles = []
        for k, off in enumerate(range(0, n, bucket_elems)):
            part = x[:, off:min(off + bucket_elems, n)]
            handles.append(allreduce_start(
                ctx, part, attrs=attrs, label=f"{label}.b{k}"))
        parts = [allreduce_done(ctx, h, mean=mean) for h in handles]
    return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
