"""``moe_combine_share`` (%): the device time of the MoE block's combine,
forward and backward, over the device's busy time.  The combine is the
ops inside the ``moe.combine`` spans (``models/moe.py`` ``_moe_shards``:
the per-expert ``index_add_`` into the f32 output and the partials' sum,
in the forward and its remat recompute) and the autograd nodes those ops
made, tied as ``moe_share`` ties the whole block's, so it is a part of
``moe_share``."""
from lpfbench.metrics._spans import span_share


def read(view):
    return span_share(view, "moe.combine")
