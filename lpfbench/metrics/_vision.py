"""Arithmetic the readers of a vision-language cell share: the ops of
the program's vision ranges, and the flash launches the tower made."""

#: the program's ranges around the vision frontend's forward and around
#: each tower layer (forward and remat recompute)
RANGES = ("vision", "vision.layer")

#: the port's flash-attention ops (``kernels/flash_attention/ops.py``),
#: by the kernel each launches once a call: the forward (or its remat
#: recompute), and the backward node, which launches dK/dV and dQ
FLASH_OPS = {"fa_fwd_bf16": "_FlashAttention",
             "fa_bwd_dkv_bf16": "_FlashAttentionBackward",
             "fa_bwd_dq_bf16": "_FlashAttentionBackward"}


def _runtime(e) -> bool:
    """A CUDA runtime or driver call, or an event the CUDA tracer records
    inside one (``Command Buffer Full``): the profiler ties a kernel to
    such an event when its correlation number meets the kernel's, so a
    kernel can count twice, once with the op that launched it."""
    return e.name.startswith("cu") or e.name == "Command Buffer Full"


def vision_ops(prof, names) -> list:
    """The ops of the ranges ``names`` (``Profile.range_ops``), each
    once, without runtime calls and what they hold."""
    out = {}
    for name in names:
        for e in prof.range_ops(name):
            up, inside = e, False
            while up is not None and not inside:
                inside = _runtime(up)
                up = up.cpu_parent
            if not inside:
                out[id(e)] = e
    return list(out.values())


def shapes(view) -> tuple:
    """The decoder's and the tower's attention shapes of the cell
    (``counts.vlm.attention_shapes``)."""
    from lpfbench.counts.vlm import attention_shapes
    from lpfbench.reference.llava_next import image_layout
    m, mix = view.cell.config["model"], view.cell.traffic
    m = {**m, **view.cell.config.get("run_as", {})}
    B = int(mix["batch"])
    got = attention_shapes(m, B, int(mix["seq"]),
                           B * image_layout(m)["tiles"])
    return got["decoder"], got["tower"]


def roofline(view, bounds) -> float:
    """The summed least times of the launches of each kernel part at its
    own shape over the kernels' device time, in %: ``bounds(shape)``
    gives ``{part: (kernel name, least ms)}``; the tower's launches are
    as many as the flash ops (:data:`FLASH_OPS`) in the ``vision.layer``
    ranges, the rest the decoder's.  ``None`` where no launch of the
    tower or of the decoder is seen."""
    prof = view.profile
    if prof is None:
        return None
    dec, tower = shapes(view)
    ops = vision_ops(prof, ("vision.layer",))
    least = secs = 0.0
    for part, (kernel, dec_ms) in bounds(dec).items():
        s, launches = prof.kernel_s(kernel)
        n_tower = sum(e.name == FLASH_OPS[kernel] for e in ops)
        if n_tower == 0 or launches - n_tower <= 0:
            return None
        least += (dec_ms * (launches - n_tower)
                  + bounds(tower)[part][1] * n_tower) / 1e3
        secs += s
    return 100.0 * least / secs if secs > 0 else None
