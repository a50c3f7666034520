"""``train_mfu.vlm`` (%): the whole training step's share of the card's
bf16 peak in a vision-language cell: 6 N D useful operations
(``counts.vlm.vlm_train_flops``: the decoder's parameters but its head
over B S positions a step, the head's over the text positions, B S less
the image positions the program's ``vision.positions`` counter counted,
the tower's over 577 positions and the projector's over 576 of each tile
its ``vision.tiles`` counter counted), over the traced window's time,
over 989 TFLOP/s.  Attention scores and the remat recompute are not
counted."""
from lpfbench.counts.peaks import BF16_FLOPS
from lpfbench.counts.vlm import vlm_train_flops


def read(view):
    try:
        from repro_torch.core.trace import counters
    except ImportError:         # a program without counters
        return None
    prof, steps = view.profile, view.window.units
    got = counters()
    tiles = got.get("vision.tiles", 0)
    image = got.get("vision.positions", 0)
    if prof is None or steps == 0 or tiles <= 0 or image <= 0:
        return None
    mix = view.cell.traffic
    positions = int(mix["batch"]) * int(mix["seq"]) * steps
    flops = vlm_train_flops(view.cell.config["model"], positions,
                            positions - image, tiles)
    return 100.0 * flops / prof.window_s / BF16_FLOPS
