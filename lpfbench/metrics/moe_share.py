"""``moe_share`` (%): the MoE block's device time, forward and backward,
over the device's busy time.  The block is the ops inside its profiler
range (``models/moe.py``'s ``MOE_RANGE``, ``moe_single``: the forward
and its remat recompute) and the autograd nodes those ops made, tied to
them by the profiler's sequence numbers (``Profile.range_ops``).  Where
no node is tied (the backward cannot be seen), nothing is read."""

RANGE = "moe_single"


def read(view):
    prof = view.profile
    if prof is None or prof.busy_s <= 0:
        return None
    secs, nodes = prof.range_device_s(RANGE)
    if nodes == 0 or secs <= 0:
        return None
    return 100.0 * secs / prof.busy_s
