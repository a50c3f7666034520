"""Cross-pod gradient synchronisation as an explicit LPF superstep program
— the JAX package's ``repro.bsp.grad_sync`` over virtual pods.

The pod-to-pod (DCN) hop is the slow link; this module owns it so the
paper's sync attributes apply to it:

* default      — BSP reduce-scatter + allgather over the pods
                 (bandwidth-optimal 2n(q-1)/q wire for q pods), staged as
                 accumulating-put supersteps,
* COMPRESSED   — int8 payloads on the wire (effective g / 4); pair with
                 error feedback (``optim/compress.py``) for convergence,
* STALE(k)     — at *bucket* granularity when ``bucket_bytes`` is set:
                 ``attrs.stale = k`` skips individual stale buckets on
                 off-steps (:func:`bucket_staleness` — the last-layer
                 bucket, whose gradients carry the highest variance, stays
                 fresh every step).  Without buckets the loop-level skip
                 (``runtime/train_loop.py`` ``sync_every``) applies.

In JAX the sync runs manual over the mesh, each device exchanging its
gradient shards with the devices of equal (data, model) coordinates in
the other pods.  One card has no data or model axis above 1
(:func:`repro_torch.core.mesh.virtual_pods`), so the ``q`` pods are the
``q`` processes of one LPF context on the device, and every gradient
leaf is stacked ``[q, ...]``.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..core import LPFContext, LPF_SYNC_DEFAULT, SyncAttributes, hook
from ..core.mesh import VirtualMesh, virtual_pods
from . import collectives
from .pod_sync import bucketize, tree_flatten, tree_unflatten

__all__ = ["build_cross_pod_sync", "bucket_staleness", "lpf_allreduce"]


def bucket_staleness(n_buckets: int, stale: int) -> list:
    """Per-bucket staleness schedule for the bucketed-sync x local-SGD
    composition: bucket ``b`` syncs on (static) step ``s`` iff its entry
    here is 0 or ``s`` is a multiple of it.

    Bucket indices follow :func:`repro_torch.bsp.pod_sync.bucketize`
    order (first bucket = first layers).  The LAST bucket — the layers
    closest to the loss, whose gradients carry the highest variance and
    tolerate staleness worst — is always fresh; every earlier
    (lower-variance) bucket inherits ``stale`` and is skipped on
    off-steps.  ``stale <= 0`` disables skipping entirely."""
    if stale <= 0 or n_buckets <= 0:
        return [0] * max(n_buckets, 0)
    return [stale] * (n_buckets - 1) + [0]


def lpf_allreduce(ctx: LPFContext, x: torch.Tensor, *,
                  op=torch.add,
                  attrs: SyncAttributes = LPF_SYNC_DEFAULT,
                  mean: bool = False) -> torch.Tensor:
    """Allreduce a stacked ``[p, w]`` vector over the context's processes;
    optionally average.

    Rides the fused reduce-scatter + allgather supersteps for
    sum/max/min (uncompressed), the exchange algorithm otherwise."""
    out = collectives.allreduce(ctx, x, op=op, attrs=attrs)
    return out / ctx.p if mean else out


def build_cross_pod_sync(mesh: Optional[VirtualMesh], grad_specs: Any = None,
                         *, attrs: SyncAttributes = LPF_SYNC_DEFAULT,
                         pod_axis: str = "pod", mean: bool = True,
                         bucket_bytes: Optional[int] = None):
    """Returns ``sync(grads, step=0) -> grads`` averaging a tree of
    ``[q, ...]`` gradient leaves across the mesh's ``q`` pods.  If the
    mesh has no pod axis (or one pod) the function is the identity —
    single-pod programs pay nothing.  ``grad_specs`` is the JAX
    signature's sharding tree: one device shards nothing, so it is not
    read.

    Every bucket's reduce-scatter + all-gather pair is staged
    *split-phase* into one recorded LPF program (``bucket_sync``) before
    any result is read, in REVERSE layer order (the last layers'
    gradients materialise first in the backward pass): the program
    optimizer's schedule search then overlaps the mutually independent
    cross-bucket supersteps (on the card, on side streams), and repeated
    steps replay the cached program.  ``bucket_bytes=None`` is one
    bucket.

    ``attrs.stale = k > 0`` composes bucketing with local SGD at bucket
    granularity: ``sync(grads, step=i)`` skips the stale buckets on
    off-steps per :func:`bucket_staleness`; their leaves pass through
    pod-local.  The last-layer bucket always syncs."""
    q = virtual_pods(mesh, pod_axis)
    if q == 1:
        return lambda grads, step=0: grads

    def sync(grads, step: int = 0):
        def spmd(ctx, s, p, leaves_in):
            shapes = [l.shape[1:] for l in leaves_in]
            dtypes = [l.dtype for l in leaves_in]
            flats = [l.reshape(p, -1).float() for l in leaves_in]
            buckets = bucketize([f.shape[1] * 4 for f in flats],
                                bucket_bytes)
            stales = bucket_staleness(len(buckets), attrs.stale)
            # start every bucket's rs+ag pair inside ONE recording,
            # last-layer bucket first; leaving the program flushes the
            # whole multi-bucket trace as one optimized program
            handles = []
            with ctx.program("bucket_sync"):
                for bi, idxs in reversed(list(enumerate(buckets))):
                    if stales[bi] and step % stales[bi] != 0:
                        continue    # stale bucket: keep local gradients
                    flat = torch.cat([flats[i] for i in idxs], dim=1) \
                        if len(idxs) > 1 else flats[idxs[0]]
                    n = flat.shape[1]
                    pad = (-n) % max(p, 1)
                    flat = collectives.pad_to(flat, n + pad)
                    handles.append((idxs, n, collectives.allreduce_start(
                        ctx, flat, attrs=attrs, label=f"bucket{bi}")))
            red_parts = [None] * len(flats)
            for idxs, n, handle in handles:
                red = collectives.allreduce_done(ctx, handle,
                                                 mean=mean)[:, :n]
                off = 0
                for i in idxs:
                    k = flats[i].shape[1]
                    red_parts[i] = red[:, off:off + k]
                    off += k
            outs = []
            for part, flat, shp, dt in zip(red_parts, flats, shapes,
                                           dtypes):
                if part is None:
                    # zero-byte leaf, or a stale-skipped bucket: nothing
                    # on the wire, the pod-local value rides
                    part = flat
                outs.append(part.reshape(p, *shp).to(dt))
            return outs

        leaves, spec = tree_flatten(grads)
        if not leaves:
            return grads
        out = hook(q, spmd, leaves, device=leaves[0].device)
        return tree_unflatten(spec, out)

    return sync
