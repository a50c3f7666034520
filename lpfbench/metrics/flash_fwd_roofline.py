"""``flash_fwd_roofline`` (%): the least time of the forward flash
kernel's launches (``csrc/flash_attention_fwd.cu``, ``fa_fwd_bf16``) at
the cell's attention shape (``counts.flash.flash_fwd_bound_ms``), over
their device time."""
from lpfbench.counts.flash import flash_fwd_bound_ms

KERNEL = "fa_fwd_bf16"


def read(view):
    prof = view.profile
    if prof is None:
        return None
    secs, launches = prof.kernel_s(KERNEL)
    if launches == 0 or secs <= 0:
        return None
    m, mix = view.cell.config["model"], view.cell.traffic
    bound_ms, _ = flash_fwd_bound_ms(
        int(mix["batch"]), m["num_attention_heads"],
        m["num_key_value_heads"], int(mix["seq"]), m["head_dim"], True,
        None, 2)
    return 100.0 * bound_ms / 1e3 * launches / secs
