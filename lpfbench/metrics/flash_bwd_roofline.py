"""``flash_bwd_roofline`` (%): the least time of the backward flash
kernels' launches (``csrc/flash_attention_bwd.cu``: ``fa_bwd_dkv_bf16``
and ``fa_bwd_dq_bf16`` together) at the cell's attention shape
(``counts.flash.flash_bwd_bound_ms``), over their device time."""
from lpfbench.counts.flash import flash_bwd_bound_ms

KERNELS = {"dkv": "fa_bwd_dkv_bf16", "dq": "fa_bwd_dq_bf16"}


def read(view):
    prof = view.profile
    if prof is None:
        return None
    m, mix = view.cell.config["model"], view.cell.traffic
    bounds = flash_bwd_bound_ms(
        int(mix["batch"]), m["num_attention_heads"],
        m["num_key_value_heads"], int(mix["seq"]), m["head_dim"], True,
        None, 2)
    least = secs = 0.0
    for part, kernel in KERNELS.items():
        s, launches = prof.kernel_s(kernel)
        least += bounds[part][0] / 1e3 * launches
        secs += s
    if secs <= 0 or least <= 0:
        return None
    return 100.0 * least / secs
