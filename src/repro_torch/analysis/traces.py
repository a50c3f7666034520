"""Canned LPF traces — the communication shapes of the paper's target
workloads, as recorded ``ProgramStep`` lists.

The JAX package's canned traces, built from the port's ``Slot`` and
``Msg``: the same builders, sizes and seeds, so both packages schedule
the same trace.  Used by ``scripts/schedule_search.py`` and by
``chip_smoke.py``'s phase (o), which run them at the card's sizes.
Every builder returns ``(p, slots, steps, scratch)``; slots are
synthetic handles (generation 0) that never enter a
:class:`~repro_torch.core.SlotRegistry`.
"""

from __future__ import annotations

from ..core import LPF_SYNC_DEFAULT, Msg, ProgramStep, Slot, SyncAttributes
from ..core.memslot import as_torch_dtype

__all__ = ["CANNED_TRACES", "canned_fft_trace", "canned_bucketed_trace",
           "canned_fragmented_trace", "canned_pagerank_trace"]


def _slot(sid, size, dtype="int32"):
    return Slot(sid=sid, name=f"s{sid}", size=size,
                dtype=as_torch_dtype(dtype), kind="global",
                orig_shape=(size,))


def canned_fft_trace(p: int = 8, w: int = 64):
    """Two interleaved FFT instances: redistribute + reorder each, the
    reorder reading its own redistribute's destination slot."""
    steps = []
    slots = []
    for inst in ("A", "B"):
        src = _slot(len(slots) + 100, p * w)
        buf = _slot(len(slots) + 101, p * w)
        out = _slot(len(slots) + 102, p * w)
        slots += [src, buf, out]
        redist = tuple(Msg(s, d, src, d * w, buf, s * w, w)
                       for s in range(p) for d in range(p))
        reorder = tuple(Msg(s, d, buf, d * w, out, s * w, w)
                        for s in range(p) for d in range(p))
        steps.append(ProgramStep(redist, LPF_SYNC_DEFAULT,
                                 f"fft{inst}.redistribute"))
        steps.append(ProgramStep(reorder, LPF_SYNC_DEFAULT,
                                 f"fft{inst}.reorder"))
    return p, slots, steps, None


def canned_bucketed_trace(p: int = 8, n_buckets: int = 4, w: int = 64):
    """The DDP bucket shape: per bucket a fused reduce-scatter into a
    chunk slot, then a fused all-gather of the chunks."""
    steps = []
    slots = []
    sid = 200
    for k in range(n_buckets):
        src = _slot(sid, p * w)
        buf = _slot(sid + 1, w)
        out = _slot(sid + 2, p * w)
        sid += 3
        slots += [src, buf, out]
        rs = tuple(Msg(s, d, src, d * w, buf, 0, w)
                   for s in range(p) for d in range(p))
        ag = tuple(Msg(s, d, buf, 0, out, s * w, w)
                   for s in range(p) for d in range(p))
        steps.append(ProgramStep(rs, SyncAttributes(reduce_op="sum"),
                                 f"b{k}.rs"))
        steps.append(ProgramStep(ag, LPF_SYNC_DEFAULT, f"b{k}.ag"))
    return p, slots, steps, None


def canned_fragmented_trace(p: int = 8):
    """Two supersteps spread over 4x4 slot pairs, one message per pair:
    direct pays one coloured round per pair (16 rounds each).  frag2
    writes exactly the ranges frag1 *reads* (WAR): commutation fails,
    so split-phase overlap is inadmissible — and the Valiant-aware
    rewrite routes each fat superstep two-phase instead (the cost gate
    declines the *merged* valiant table: 32 messages through p=8
    intermediates double the via-collisions), consolidating 2x16
    coloured rounds to 14+12 through the scratch slot."""
    A = [_slot(300 + i, 32) for i in range(4)]
    B = [_slot(310 + i, 32) for i in range(4)]
    C = [_slot(320 + i, 32) for i in range(4)]
    scratch = _slot(399, 4096)
    msgs1, msgs2 = [], []
    for ai in range(4):
        for bi in range(4):
            k = 4 * ai + bi
            m1 = Msg((k * 3) % p, (k * 5 + 1) % p, A[ai], 8 * bi,
                     B[bi], (k * 3) % 16, 4)
            msgs1.append(m1)
            # the mirror: write the exact range m1 reads, on m1's pid
            msgs2.append(Msg((k * 7 + 2) % p, m1.src, C[bi], 8 * ai,
                             A[ai], 8 * bi, 4))
    steps = [ProgramStep(tuple(msgs1), LPF_SYNC_DEFAULT, "frag1"),
             ProgramStep(tuple(msgs2), LPF_SYNC_DEFAULT, "frag2")]
    return p, A + B + C, steps, scratch


def canned_pagerank_trace(p: int = 8, w: int = 8):
    """The PageRank iteration shape: an irregular halo permutation, an
    accumulating reduction of a 3-word stats vector to pid 0, and its
    broadcast back."""
    rank = _slot(300, p * w)
    halo = _slot(301, w)
    stats = _slot(302, 3)
    tot = _slot(303, 3)
    halo_msgs = tuple(Msg(s, (s * 3 + 1) % p, rank, (s % 4) * w, halo, 0, w)
                      for s in range(p))
    red = tuple(Msg(s, 0, stats, 0, tot, 0, 3) for s in range(p))
    bcast = tuple(Msg(0, d, tot, 0, tot, 0, 3) for d in range(1, p))
    steps = [ProgramStep(halo_msgs, LPF_SYNC_DEFAULT, "pr.halo"),
             ProgramStep(red, SyncAttributes(reduce_op="sum"), "pr.red"),
             ProgramStep(bcast, LPF_SYNC_DEFAULT, "pr.bcast")]
    return p, [rank, halo, stats, tot], steps, None


CANNED_TRACES = {
    "fft_redistribute": canned_fft_trace,
    "bucketed_sync8": canned_bucketed_trace,
    "fragmented_valiant": canned_fragmented_trace,
    "pagerank": canned_pagerank_trace,
}


def bind_trace(ctx, slots, steps, scratch, values, label: str = "trace"):
    """Register a canned trace's slots on ``ctx`` and return what drives
    it there: ``(run, reset, handles, bound)``.

    ``values`` maps each slot's sid to its ``[p, size]`` initial value
    (and, for a trace with a scratch slot, the scratch is provisioned
    with ``resize_message_queue(..., valiant_payload=scratch.size)``).
    ``run(recorded=True)`` stages every step through ``put_msgs`` and
    ``sync`` inside ``ctx.program(label)`` — one flushed program —
    or, with ``recorded=False``, as one eager superstep per step, the
    recorded order.  ``reset()`` writes ``values`` back.  ``handles`` maps
    each sid to its registered slot, and ``bound`` is the trace over the
    registered slots (``ProgramStep`` list)."""
    n_msgs = max((len(st.msgs) for st in steps), default=0)
    if scratch is not None:
        ctx.resize_message_queue(n_msgs, valiant_payload=scratch.size,
                                 payload_dtype=scratch.dtype)
    else:
        ctx.resize_message_queue(n_msgs)
    ctx.resize_memory_register(ctx.registry.n_active + len(slots))
    handles = {s.sid: ctx.register_global(s.name, values[s.sid])
               for s in slots}
    bound = [ProgramStep(tuple(Msg(m.src, m.dst, handles[m.src_slot.sid],
                                   m.src_off, handles[m.dst_slot.sid],
                                   m.dst_off, m.size, m.origin)
                               for m in st.msgs), st.attrs, st.label)
             for st in steps]

    def stage_all() -> None:
        for st in bound:
            ctx.put_msgs([(m.src, m.dst, m.src_slot, m.src_off, m.dst_slot,
                           m.dst_off, m.size) for m in st.msgs])
            ctx.sync(st.attrs, label=st.label)

    def run(recorded: bool = True) -> None:
        if not recorded:
            stage_all()
            return
        with ctx.program(label):
            stage_all()

    def reset() -> None:
        for s in slots:
            ctx.write(handles[s.sid], values[s.sid])

    return run, reset, handles, bound
