"""``train_mfu`` (%): the whole training step's share of the card's bf16
peak: 6 N_active B S useful operations a step (``counts.model``),
times the traced steps, over the traced window's time, over 989
TFLOP/s.  Attention scores and the remat recompute are not counted."""
from lpfbench.counts.model import train_flops
from lpfbench.counts.peaks import BF16_FLOPS


def read(view):
    prof, steps = view.profile, view.window.units
    if prof is None or steps == 0:
        return None
    mix = view.cell.traffic
    tokens = int(mix["batch"]) * int(mix["seq"]) * steps
    flops = train_flops(view.cell.config["model"], tokens)
    return 100.0 * flops / prof.window_s / BF16_FLOPS
