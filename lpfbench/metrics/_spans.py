"""Arithmetic the readers of the program's own spans and counters share.

The program's spans (``repro_torch.core.trace``) are profiler ranges: in
a traced window they are the ops (``harness.Profile.ops``) that the
profiler marks as user annotations, nested by ``cpu_parent``.  A unit of
work has one top span (``fft.call`` a transform, ``train.step`` a
step).  A reader that finds no span, or no counter, returns ``None``: a
program without them (the parent of the change that added them) reports
nothing."""

import heapq

from lpfbench.harness import _is_node

#: the CUDA runtime calls that block the host: the names holding these
STALL_MARKS = ("Synchronize", "cudaMalloc", "cudaFree")


def is_stall(name: str) -> bool:
    """Whether a CUDA runtime call of this name blocks the host:
    synchronizes, allocations and frees, and copies other than the
    ``Async`` ones."""
    return any(m in name for m in STALL_MARKS) or (
        name.startswith("cudaMemcpy") and "Async" not in name)


def spans(ops, name: str) -> list:
    """The spans ``name`` among ``ops`` (none of the program's spans
    nests in one of its own name)."""
    return [e for e in ops if e.name == name]


def span_host_ms(view, name: str, unit: str):
    """The host time of the spans ``name`` over the units (``unit``
    spans), in ms a unit."""
    prof = view.profile
    if prof is None:
        return None
    units = spans(prof.ops, unit)
    hits = spans(prof.ops, name)
    if not units or not hits:
        return None
    total_us = sum(e.time_range.end - e.time_range.start for e in hits)
    return total_us / 1e3 / len(units)


def span_share(view, name: str):
    """The device time of the span ``name``'s ops, forward and backward
    (``Profile.range_device_s``: the autograd nodes they made, tied by
    sequence number), over the busy time, in %.  ``None`` where the span
    is absent or holds no device time."""
    prof = view.profile
    if prof is None or prof.busy_s <= 0 or not spans(prof.ops, name):
        return None
    secs, _ = prof.range_device_s(name)
    if secs <= 0:
        return None
    return 100.0 * secs / prof.busy_s


def _under_node(e) -> bool:
    """Whether ``e`` runs inside an autograd node's backward."""
    while e is not None:
        if _is_node(e):
            return True
        e = e.cpu_parent
    return False


def stalls(ops, unit: str) -> dict:
    """The stalls inside the ``unit`` spans, by name: CUDA runtime calls
    that block the host (:func:`is_stall`) whose interval lies inside a
    unit span's, on the span's thread or under an autograd node (the
    engine's thread runs a backward that the span waits on).  A call
    after the span (the caller's own synchronize) is not the unit's."""
    units = spans(ops, unit)
    out: dict = {}
    for e in ops:
        if not is_stall(e.name):
            continue
        a, b = e.time_range.start, e.time_range.end
        if any(u.time_range.start <= a and b <= u.time_range.end
               and (e.thread == u.thread or _under_node(e)) for u in units):
            out[e.name] = out.get(e.name, 0) + 1
    return out


def stalls_per_unit(view, unit: str):
    """The stalls (:func:`stalls`) over the ``unit`` spans."""
    prof = view.profile
    if prof is None:
        return None
    units = spans(prof.ops, unit)
    if not units:
        return None
    return sum(stalls(prof.ops, unit).values()) / len(units)


def innermost_segments(ops, w0: float, w1: float) -> list:
    """The window ``[w0, w1]`` (us) cut where the innermost open program
    span changes: ``(start_us, end_us, name)``, the innermost being the
    open span that started last (``None`` where none is open)."""
    marks = sorted((e for e in ops if getattr(e, "is_user_annotation",
                                              False)),
                   key=lambda e: e.time_range.start)
    cuts = sorted({w0, w1} | {min(max(t, w0), w1) for e in marks
                              for t in (e.time_range.start,
                                        e.time_range.end)})
    heap: list = []
    i, out = 0, []
    for a, b in zip(cuts, cuts[1:]):
        while i < len(marks) and marks[i].time_range.start <= a:
            e = marks[i]
            heapq.heappush(heap, (-e.time_range.start, e.time_range.end,
                                  e.name))
            i += 1
        # an ended span below the top is dropped when it rises
        while heap and heap[0][1] <= a:
            heapq.heappop(heap)
        out.append((a, b, heap[0][2] if heap else None))
    return out


def idle_by_span(prof) -> dict:
    """The window's idle time (no kernel or copy on the device), in s, by
    the innermost program span open on the host (``None``: none open)."""
    gaps, t = [], prof.w0
    for a, b in prof.busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if prof.w1 > t:
        gaps.append((t, prof.w1))
    out: dict = {}
    segs = innermost_segments(prof.ops, prof.w0, prof.w1)
    j = 0
    for ga, gb in gaps:
        while j < len(segs) and segs[j][1] <= ga:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < gb:
            a, b, name = segs[k]
            out[name] = out.get(name, 0.0) + (min(b, gb) - max(a, ga)) / 1e6
            k += 1
    return out


def idle_share_under(view, prefix: str):
    """The window's share, in %, that is idle while the innermost open
    program span's name starts with ``prefix``; ``None`` where no such
    span was traced."""
    prof = view.profile
    if prof is None or prof.window_s <= 0 or prof.busy_s <= 0 or not any(
            e.name.startswith(prefix) for e in prof.ops
            if getattr(e, "is_user_annotation", False)):
        return None
    idle = sum(s for n, s in idle_by_span(prof).items()
               if n is not None and n.startswith(prefix))
    return 100.0 * idle / prof.window_s
