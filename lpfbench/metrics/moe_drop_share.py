"""``moe_drop_share`` (%): the routed tokens the MoE blocks dropped past
an expert's capacity over the tokens they routed, in the traced window:
the program's counters ``moe.dropped`` over ``moe.routed``
(``repro_torch.core.trace``; counted only while a profiler records, once
a forward, with ``expert_load``'s arithmetic).  A reading of the
router's balance: each expert computes its full capacity whatever its
load, so the share does not change the step's time."""


def read(view):
    try:
        from repro_torch.core.trace import counters
    except ImportError:         # a program without counters
        return None
    got = counters()
    routed = got.get("moe.routed", 0)
    if view.profile is None or routed <= 0:
        return None
    return 100.0 * got.get("moe.dropped", 0) / routed
