"""BSP collectives implemented ON the LPF primitives.

These are the textbook one/two-superstep BSP algorithms (Valiant/McColl,
Bisseling) — *immortal* in the paper's sense: their cost is provable from
(p, g, l) alone and holds on any compliant layer.

============  ========================================  ==================
collective    algorithm (fused superstep methods)        BSP cost
============  ========================================  ==================
broadcast     fused_scatter + fused_ag                   2(n/p)(p-1)g + 2l
allgather     one superstep (fused_ag)                   (n/p)(p-1)g + l
alltoall      one superstep (fused total exchange)       (n/p)(p-1)g + l
reduce        fused_rs + fused_gather to root            2(n/p)(p-1)g + 2l
allreduce     fused_rs + fused_ag                        2(n/p)(p-1)g + 2l
exscan        allgather of partials + local sum          (p-1)wg + l
============  ========================================  ==================

``reduce`` and ``allreduce`` stage *accumulating-put* supersteps
(``attrs.reduce_op``): the reduce-scatter relation — every process puts
chunk d at the same destination offset on process d, conflicting writes
combining — executes as one reduction over the stacked source axis
(``fused_rs``).  Ops other than ``torch.add``/``torch.maximum``/
``torch.minimum`` (or any op under wire compression, or an explicit
``bruck``/``valiant`` method) run the total-exchange + local-reduce
algorithm instead — same BSP cost, more rounds on the wire.

``allreduce`` with ``CompressSpec`` quantises the wire payload (the
paper's relaxed-guarantee sync attribute): effective g drops by ~4x for
int8 at a bounded precision cost.

The process-axis rule holds throughout: a collective takes ``x`` as
``[p, w]`` — row ``s`` is process ``s``'s vector — and returns stacked
per-process results.  Every call registers fresh slots; the plan cache
keys on the *shape* of the h-relation, so a collective invoked
repeatedly plans its exchange once.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..core import LPFContext, LPF_SYNC_DEFAULT, Slot, SyncAttributes
from ..core.errors import LPFFatalError
from ..core.sync import _REDUCE_FNS

__all__ = ["broadcast", "allgather", "alltoall", "allreduce", "reduce",
           "exscan", "pad_to", "CollectiveHandle", "allreduce_start",
           "allreduce_done"]


def pad_to(x: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad the last axis of ``[p, w]`` to ``n``."""
    if x.ndim != 2:
        raise LPFFatalError(
            f"pad_to expects a stacked [p, w] tensor, got shape "
            f"{tuple(x.shape)}; flatten each process's tensor before padding")
    if x.shape[1] > n:
        raise LPFFatalError(
            f"pad_to cannot shrink: input length {x.shape[1]} exceeds "
            f"target {n}")
    if x.shape[1] == n:
        return x
    return torch.nn.functional.pad(x, (0, n - x.shape[1]))


def _chunk(n: int, p: int) -> int:
    return -(-n // p)  # ceil


def _zeros(ctx: LPFContext, n: int, dtype) -> torch.Tensor:
    return torch.zeros(ctx.p, n, dtype=dtype, device=ctx.device)


def _reduce_op_name(op: Callable) -> Optional[str]:
    """Name of ``op`` in the planner's accumulating-put vocabulary
    (single source of truth: ``repro_torch.core.sync._REDUCE_FNS``)."""
    for name, fn in _REDUCE_FNS.items():
        if op is fn:
            return name
    return None


def _use_fused_reduction(op: Callable, attrs: SyncAttributes
                         ) -> Optional[str]:
    """The reduce_op to stage, or None when the generic exchange
    algorithm must run instead: exotic combine fn, compressed wire
    (quantised payloads cannot be combined before dequantisation), or
    an explicit bruck/valiant method request (those schedules cannot
    combine conflicting writes)."""
    red_op = _reduce_op_name(op)
    if red_op is None or attrs.compress is not None \
            or attrs.method in ("bruck", "valiant"):
        return None
    return red_op


def allgather(ctx: LPFContext, x: torch.Tensor, *,
              attrs: SyncAttributes = LPF_SYNC_DEFAULT,
              label: str = "allgather") -> torch.Tensor:
    """Every process contributes its row of ``x`` ([p, w]); returns
    [p, p*w]."""
    p = ctx.p
    w = int(x.shape[1])
    if p == 1:
        return x
    with ctx.program(label):
        ctx.resize_memory_register(ctx.registry.n_active + 2)
        ctx.resize_message_queue(p * p)
        src = ctx.register_global(f"{label}.src", x)
        dst = ctx.register_global(f"{label}.dst", _zeros(ctx, p * w, x.dtype))
        ctx.put_msgs([(s, d, src, 0, dst, s * w, w)
                      for s in range(p) for d in range(p)])
        ctx.sync(attrs, label=label)
        out = ctx.tensor(dst)
        ctx.deregister(src)
        ctx.deregister(dst)
    return out


def alltoall(ctx: LPFContext, x: torch.Tensor, *,
             attrs: SyncAttributes = LPF_SYNC_DEFAULT,
             label: str = "alltoall") -> torch.Tensor:
    """Canonical total exchange: ``x`` is [p, p*w]; chunk d of each row
    goes to process d; returns [p, p*w] with chunk s received from
    process s."""
    p = ctx.p
    if p == 1:
        return x
    if x.shape[1] % p:
        raise LPFFatalError(
            f"alltoall payload {x.shape[1]} not divisible by p={p}")
    w = x.shape[1] // p
    with ctx.program(label):
        ctx.resize_memory_register(ctx.registry.n_active + 2)
        ctx.resize_message_queue(p * p)
        src = ctx.register_global(f"{label}.src", x)
        dst = ctx.register_global(f"{label}.dst", torch.zeros_like(x))
        ctx.put_msgs([(s, d, src, d * w, dst, s * w, w)
                      for s in range(p) for d in range(p)])
        ctx.sync(attrs, label=label)
        out = ctx.tensor(dst)
        ctx.deregister(src)
        ctx.deregister(dst)
    return out


def broadcast(ctx: LPFContext, x: torch.Tensor, root: int = 0, *,
              attrs: SyncAttributes = LPF_SYNC_DEFAULT,
              label: str = "broadcast") -> torch.Tensor:
    """Two-phase broadcast of the root's row (scatter + allgather):
    2(n/p)(p-1)g + 2l — the BSP-optimal algorithm for n >= p.  Both
    phases take fused one-exchange supersteps (fused_scatter +
    fused_ag)."""
    p = ctx.p
    if p == 1:
        return x
    n = int(x.shape[1])
    c = _chunk(n, p)
    xp = pad_to(x, c * p)
    with ctx.program("broadcast"):
        ctx.resize_memory_register(ctx.registry.n_active + 2)
        ctx.resize_message_queue(p + p * p)
        src = ctx.register_global(f"{label}.src", xp)
        buf = ctx.register_global(f"{label}.buf", _zeros(ctx, c * p, x.dtype))
        # phase 1: root scatters chunk d to process d
        ctx.put_msgs([(root, d, src, d * c, buf, d * c, c)
                      for d in range(p)])
        ctx.sync(attrs, label=f"{label}.scatter")
        # phase 2: each process owns chunk `s` at offset s*c; allgather
        ctx.put_msgs([(s, d, buf, s * c, buf, s * c, c)
                      for s in range(p) for d in range(p) if s != d])
        ctx.sync(attrs, label=f"{label}.allgather")
        out = ctx.tensor(buf)[:, :n]
        ctx.deregister(src)
        ctx.deregister(buf)
    return out


def _reduce_scatter_chunk(ctx: LPFContext, xp: torch.Tensor, c: int,
                          red_op: str, attrs: SyncAttributes,
                          label: str) -> Slot:
    """Stage + sync the fused reduce-scatter superstep: chunk d of every
    process combines (via ``red_op``) into a [c]-slot on process d.
    Returns the chunk slot (caller deregisters)."""
    p = ctx.p
    src = ctx.register_global(f"{label}.src", xp)
    buf = ctx.register_global(f"{label}.chunk", _zeros(ctx, c, xp.dtype))
    ctx.put_msgs([(s, d, src, d * c, buf, 0, c)
                  for s in range(p) for d in range(p)])
    ctx.sync(attrs.replace(reduce_op=red_op), label=f"{label}.rs")
    ctx.deregister(src)
    return buf


@dataclasses.dataclass
class CollectiveHandle:
    """A split-phase collective in flight: its supersteps are staged
    (deferred into the recording trace, or already executed when the
    context is not recording) but the result read is postponed.  Reading
    through the matching ``*_done`` call is what flushes the handle's
    dependency cone."""

    out_slot: Optional[Slot]
    n: int                       # valid payload length in the out slot
    p: int
    value: Optional[torch.Tensor] = None   # eager result


def _fused_reduction_start(ctx: LPFContext, x: torch.Tensor, red_op: str,
                           attrs: SyncAttributes, label: str, suffix: str,
                           chunk_dsts: Callable) -> CollectiveHandle:
    """Stage the fused-reduction pair split-phase: reduce-scatter the
    chunks, then a second superstep distributing them per
    ``chunk_dsts(s, p)`` — every process s's reduced [c]-chunk lands at
    offset s*c on those pids.  The result read is deferred to
    :func:`_fused_reduction_done`."""
    p = ctx.p
    n = int(x.shape[1])
    c = _chunk(n, p)
    ctx.resize_memory_register(ctx.registry.n_active + 3)
    ctx.resize_message_queue(p * p)
    buf = _reduce_scatter_chunk(ctx, pad_to(x, c * p), c, red_op, attrs,
                                label)
    out = ctx.register_global(f"{label}.out", _zeros(ctx, c * p, x.dtype))
    ctx.put_msgs([(s, d, buf, 0, out, s * c, c)
                  for s in range(p) for d in chunk_dsts(s, p)])
    ctx.sync(attrs, label=f"{label}.{suffix}")
    ctx.deregister(buf)      # deferred while the trace references it
    return CollectiveHandle(out_slot=out, n=n, p=p)


def _fused_reduction_done(ctx: LPFContext, handle: CollectiveHandle
                          ) -> torch.Tensor:
    if handle.value is not None:
        return handle.value
    result = ctx.tensor(handle.out_slot)[:, :handle.n]
    ctx.deregister(handle.out_slot)
    return result


def _fused_reduction(ctx: LPFContext, x: torch.Tensor, red_op: str,
                     attrs: SyncAttributes, label: str, suffix: str,
                     chunk_dsts: Callable) -> torch.Tensor:
    with ctx.program("fused_reduction"):
        handle = _fused_reduction_start(ctx, x, red_op, attrs, label,
                                        suffix, chunk_dsts)
        result = _fused_reduction_done(ctx, handle)
    return result


def allreduce_start(ctx: LPFContext, x: torch.Tensor, *,
                    op: Callable = torch.add,
                    attrs: SyncAttributes = LPF_SYNC_DEFAULT,
                    label: str = "allreduce") -> CollectiveHandle:
    """Split-phase allreduce: stage the reduce-scatter + allgather pair
    *without* reading the result.  Inside a recording, several started
    allreduces share one trace; :func:`allreduce_done` flushes exactly
    the handle's dependency cone.  Ops with no fused lowering (exotic
    combine fns, compressed wire) run the exchange algorithm now and
    return a resolved handle."""
    if ctx.p == 1:
        return CollectiveHandle(None, int(x.shape[1]), 1, value=x)
    red_op = _use_fused_reduction(op, attrs)
    if red_op is None:
        return CollectiveHandle(
            None, int(x.shape[1]), ctx.p,
            value=_allreduce_exchange(ctx, x, op=op, attrs=attrs,
                                      label=label))
    return _fused_reduction_start(ctx, x, red_op, attrs, label, "ag",
                                  lambda s, p_: range(p_))


def allreduce_done(ctx: LPFContext, handle: CollectiveHandle, *,
                   mean: bool = False) -> torch.Tensor:
    """Finish a :func:`allreduce_start`: read (cone-flushing) the result
    and release the slot; optionally average."""
    out = _fused_reduction_done(ctx, handle)
    return out / handle.p if mean else out


def reduce(ctx: LPFContext, x: torch.Tensor, root: int = 0, *,
           op: Callable = torch.add,
           attrs: SyncAttributes = LPF_SYNC_DEFAULT,
           label: str = "reduce") -> torch.Tensor:
    """Genuine two-superstep reduction to ``root``: a fused
    reduce-scatter of chunks, then a fused gather of the reduced chunks
    to root — 2(n/p)(p-1)g + 2l.  Non-root rows of the result are zeros
    (the result is defined at root only, as in the paper's BSP
    reduce)."""
    p = ctx.p
    if p == 1:
        return x
    red_op = _use_fused_reduction(op, attrs)
    if red_op is None:
        # no fused lowering: reduce via the allreduce algorithm
        y = _allreduce_exchange(ctx, x, op=op, attrs=attrs, label=label)
        return torch.where(ctx.pid == root, y, torch.zeros_like(y))
    # superstep 2 gathers the reduced chunks at root (fused_gather)
    return _fused_reduction(ctx, x, red_op, attrs, label, "gather",
                            lambda s, p_: (root,))


def allreduce(ctx: LPFContext, x: torch.Tensor, *,
              op: Callable = torch.add,
              attrs: SyncAttributes = LPF_SYNC_DEFAULT,
              label: str = "allreduce") -> torch.Tensor:
    """Two-superstep reduce-scatter + allgather: 2(n/p)(p-1)g + 2l —
    bandwidth-optimal, matching a ring all-reduce's 2n(p-1)/p volume.
    For sum/max/min without wire compression both supersteps take the
    fused paths (``fused_rs`` + ``fused_ag``, 1 round each)."""
    p = ctx.p
    if p == 1:
        return x
    red_op = _use_fused_reduction(op, attrs)
    if red_op is None:
        return _allreduce_exchange(ctx, x, op=op, attrs=attrs, label=label)
    # superstep 2 allgathers the reduced chunks to everyone (fused_ag)
    return _fused_reduction(ctx, x, red_op, attrs, label, "ag",
                            lambda s, p_: range(p_))


def _allreduce_exchange(ctx: LPFContext, x: torch.Tensor, *,
                        op: Callable = torch.add,
                        attrs: SyncAttributes = LPF_SYNC_DEFAULT,
                        label: str = "allreduce") -> torch.Tensor:
    """The generic algorithm: total exchange + local reduce + allgather.
    Same 2(n/p)(p-1)g + 2l cost; used when the op has no accumulating-put
    lowering, the wire is compressed (quantised payloads must be
    decompressed before they can be combined) or the method is
    ``bruck``/``valiant``."""
    p = ctx.p
    n = int(x.shape[1])
    c = _chunk(n, p)
    xp = pad_to(x, c * p)
    with ctx.program("allreduce_exchange"):
        ctx.resize_memory_register(ctx.registry.n_active + 3)
        ctx.resize_message_queue(p * p)
        src = ctx.register_global(f"{label}.src", xp)
        buf = ctx.register_global(f"{label}.buf", _zeros(ctx, c * p, x.dtype))
        out = ctx.register_global(f"{label}.out", _zeros(ctx, c * p, x.dtype))
        # superstep 1: total exchange — chunk d of every process lands on d
        ctx.put_msgs([(s, d, src, d * c, buf, s * c, c)
                      for s in range(p) for d in range(p)])
        ctx.sync(attrs, label=f"{label}.scatter")
        # local reduction of my chunk across all p contributions (the
        # tensor read flushes the exchange — a compute barrier)
        contrib = ctx.tensor(buf).reshape(p, p, c)    # [me, source, c]
        if op is torch.add:
            red = contrib.sum(1)
        else:
            red = contrib[:, 0]
            for i in range(1, p):
                red = op(red, contrib[:, i])
        ctx.write(out, torch.cat([red, _zeros(ctx, c * (p - 1), x.dtype)],
                                 dim=1))
        # superstep 2: allgather reduced chunks (mine lives at offset 0)
        ctx.put_msgs([(s, d, out, 0, out, s * c, c)
                      for s in range(p) for d in range(p)])
        ctx.sync(attrs, label=f"{label}.allgather")
        result = ctx.tensor(out)[:, :n]
        ctx.deregister(src)
        ctx.deregister(buf)
        ctx.deregister(out)
    return result


def exscan(ctx: LPFContext, x: torch.Tensor, *,
           attrs: SyncAttributes = LPF_SYNC_DEFAULT,
           label: str = "exscan") -> torch.Tensor:
    """Exclusive prefix sum over processes of each row of ``x`` ([p, w]):
    local partials are allgathered through the fused_ag superstep
    (w(p-1)g + l) and summed below each process's pid."""
    p = ctx.p
    if p == 1:
        return torch.zeros_like(x)
    parts = allgather(ctx, x, attrs=attrs,
                      label=f"{label}.ag").reshape(p, p, -1)
    mask = (torch.arange(p, device=ctx.device) < ctx.pid)[..., None]
    return (parts * mask.to(x.dtype)).sum(1)
