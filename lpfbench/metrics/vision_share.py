"""``vision_share`` (%): the vision frontend's device time, forward,
remat recompute and backward, over the device's busy time.  The frontend
is the ops inside the program's ``vision`` range (``models/lm.py``
``_image_prefix``: the tower, projector and packing in the forward) and
inside its ``vision.layer`` ranges (each tower layer, in the forward and
in its recompute), with the autograd nodes those ops made, tied by the
profiler's sequence numbers (``Profile.range_ops``), each op counted
once, CUDA runtime calls and what they hold left out (the profiler can
tie a kernel to one of them besides the op that launched it).  Where no
node is tied (the backward cannot be seen), nothing is read."""
from lpfbench.metrics._vision import RANGES, vision_ops
from lpfbench.harness import _EVALUATE


def read(view):
    prof = view.profile
    if prof is None or prof.busy_s <= 0:
        return None
    ops = vision_ops(prof, RANGES)
    nodes = sum(e.name.startswith(_EVALUATE) for e in ops)
    secs = sum(e.self_device_time_total for e in ops) / 1e6
    if nodes == 0 or secs <= 0:
        return None
    return 100.0 * secs / prof.busy_s
