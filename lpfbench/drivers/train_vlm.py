"""Driver ``train_vlm``: back-to-back training steps of a vision-language
model of the port (a ``VLMConfig``: a vision tower before the decoder),
through the same ``build_train_step`` as the ``train`` driver, whose
arithmetic it shares (``drivers/train.py``: the configuration, the
program's build, the gaps compared); its batches also carry the images.

The traffic mix gives the batch ``batch`` x ``seq`` decoder positions,
each sample one image at ``image_px`` (the configuration's
``run_as.image_pinpoint``: its tiles and packed positions from the
reference's ``image_layout``) followed by ``seq`` less the image's
positions of text: token ids Zipf-like (``zipf_exponent``) from the seed,
the labels the next tokens, as ``train``'s pool draws them; the pixels
N(0, 1) float32 from the seed, the scale of the image processor's
normalised output; ``pool`` batches of both, on the device.  The weights
are made from the seed in the layout of the reference's ``param_specs``
(``reference.make_params``: ``training.make_leaf``, and 1 for the
LayerNorm scales the reference lists in ``ONES``).

Set-up, the window and the judgement are ``train``'s: ``check_steps``
steps on batches 0, 1, 2 through the window's step object; the window's
steps from batch 3 on (a traced run stops after ``trace_steps``); one
unit of work is one step of ``batch * seq`` decoder positions, image and
text alike; after the window, once the program's state is freed, the
plain reference in float32 follows the check steps (its ``loss`` takes
the ids and the pixels together as its ``tokens``).

:func:`control` gives the readings the limits are set from: the
reference in fp8 (``control``), the program on half of each batch's rows
(``half_batch``), and planted faults (:data:`FAULTS`) in the program."""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import statistics
import sys
import time

from ..harness import BenchError, Outcome, SetupClock, Window
from ..reference import training
from . import train
from .train import (flatten, free_cuda, program_config, reference_of, sizes,
                    token_pool)


def layout(cell) -> dict:
    """The reference's ``image_layout`` of the configuration, with the
    text positions a sample has after its image (``text``)."""
    m, mix = sizes(cell.config), cell.traffic
    if list(mix["image_px"]) != list(m["image_pinpoint"]):
        raise BenchError(f"the traffic's images ({mix['image_px']} px) are "
                         f"not at the configuration's pinpoint "
                         f"({m['image_pinpoint']} px)")
    lay = reference_of(cell.config).image_layout(m)
    text = int(mix["seq"]) - lay["positions"]
    if text < 2:
        raise BenchError(f"seq {mix['seq']} leaves no text after an image "
                         f"of {lay['positions']} positions")
    return dict(lay, text=text)


def batch_pool(seed: int, cell, device) -> tuple:
    """(token ids ``pool`` x [batch, text + 1], pixels ``pool`` x [batch,
    tiles, 3, s, s]), both from the seed on the device."""
    import torch
    mix, m = cell.traffic, sizes(cell.config)
    lay = layout(cell)
    ids = token_pool(seed, dict(mix, seq=lay["text"]), m["vocab_size"],
                     device)
    s = m["vision_config"]["image_size"]
    gen = torch.Generator(device=device)
    gen.manual_seed(training.leaf_seed(seed, -2))
    pixels = torch.randn((int(mix["pool"]), int(mix["batch"]),
                          lay["tiles"], 3, s, s), device=device,
                         generator=gen)
    return ids, pixels


def batch_of(pool, i: int) -> dict:
    ids, pixels = pool
    t = ids[i % ids.shape[0]]
    return {"tokens": t[:, :-1], "labels": t[:, 1:],
            "pixels": pixels[i % pixels.shape[0]]}


def build(cell, seed: int, device):
    """``train.build``'s step, weights and moments, the reference's
    ``ONES`` leaves started at 1."""
    import torch
    ts, params, opt = train.build(cell, seed, device)
    flat = dict(params.named_parameters())
    with torch.no_grad():
        for name in reference_of(cell.config).ONES:
            flat[name].add_(1.0)
    return ts, params, opt


def step_readings(cell, seed, ts, params, opt, pool, steps: int,
                  step_fn=None):
    """``train.step_readings`` on this driver's batches and weights."""
    b1 = cell.config["optimizer"]["b1"]
    ref = reference_of(cell.config)
    specs = ref.param_specs(sizes(cell.config))
    step_fn = step_fn or ts.step_fn
    out = {"loss": [], "grad1": {}, "first": {}, "change": {}}
    for i in range(steps):
        params, opt, met = step_fn(params, opt, batch_of(pool, i))
        out["loss"].append(float(met["loss"]))
        if i == 0:
            moments = flatten(opt["m"])
            for j, (name, _, _) in enumerate(specs):
                first = moments[name] / (1 - b1)
                out["grad1"][name] = first.norm().item()
                out["first"][name] = training.grad_sample(seed, j, first)
            del moments, first
    flat = dict(params.named_parameters())
    for i, s in enumerate(specs):
        out["change"][s[0]] = (flat[s[0]].detach() - ref.start_leaf(
            seed, i, s, flat[s[0]].device)).norm().item()
    return params, opt, out


def reference_readings(cell, seed, pool, steps, device, low=None) -> dict:
    """The reference's readings of the check (``training.follow``'s, on
    the reference's own starting weights)."""
    ref, m = reference_of(cell.config), sizes(cell.config)
    specs = ref.param_specs(m)
    batches = [({"tokens": b["tokens"], "pixels": b["pixels"]},
                b["labels"]) for b in (batch_of(pool, i)
                                       for i in range(steps))]
    params = ref.make_params(seed, specs, device)
    out = training.adamw_steps(
        params, batches,
        lambda p, tokens, labels, low: ref.loss(p, tokens, labels, m, low),
        cell.config["optimizer"], seed, low)
    out["change"] = {s[0]: (params[s[0]] - ref.start_leaf(
        seed, i, s, device)).norm().item() for i, s in enumerate(specs)}
    del params
    return out


def gaps(got: dict, want: dict) -> dict:
    """``train.gaps``, with ``grad_err`` the worst leaf's relative error
    of the first gradient, leaves whose reference gradient is under a
    thousandth of the median leaf's left out, as ``change_gap`` leaves
    them out: the tower's key bias, whose gradient is nought by symmetry
    (one vector added to every key moves no softmax), reads round-off on
    both sides.  A fault confined to a few leaves (the projector, the
    newline, the patch embedding) moves the worst leaf, where it cannot
    move the median.  Read and not compared: the median leaf's error
    (``grad_err_median``) and ``grad_gap``."""
    out = train.gaps(got, want)
    out.pop("grad_err_worst")
    out["grad_err_median"] = out.pop("grad_err")
    g_med = statistics.median(want["grad0"].values())
    out["grad_err"] = max(
        ((got["first"][k] - w).norm() / w.norm()).item()
        for k, w in want["first"].items() if want["grad0"][k] >= 1e-3 * g_med)
    return out


NOT_COMPARED = ("grad_err_median", "grad_gap")


def _kernels(cell, device):
    if device.type == "cuda" and cell.config["program"].get(
            "overrides", {}).get("attn_impl") == "flash":
        from repro_torch.kernels import build as kbuild
        kbuild.build(["flash_attention_fwd", "flash_attention_bwd"])


def run(cell, *, seed: int, seconds: float, trace: bool, device,
        clock_zero: float) -> Outcome:
    clock = SetupClock(clock_zero)
    mix = cell.traffic
    program_config(cell.config)         # a program without the model stops here
    _kernels(cell, device)
    clock.mark("kernels")
    steps = int(mix["check_steps"])
    pool = batch_pool(seed, cell, device)
    ts, params, opt = build(cell, seed, device)
    clock.mark("program, weights and batches")
    params, opt, got = step_readings(cell, seed, ts, params, opt, pool,
                                     steps)
    gc.collect()
    clock.mark("check steps and their readings")
    clock.report()
    with Window(clock_zero, seconds, device, trace,
                mix.get("trace_steps")) as w:
        i = steps
        while True:
            a = time.perf_counter()
            params, opt, _ = ts.step_fn(params, opt, batch_of(pool, i))
            w.unit(time.perf_counter() - a)
            i += 1
            if w.expired():
                break
    tokens = int(mix["batch"]) * int(mix["seq"]) * w.units
    metrics = {"setup_s": w.setup_s,
               "train_tokens_per_s": tokens / w.window_s,
               "peak_mem_gib": w.window_peak_bytes / 2 ** 30}
    # the judgement, once the window has closed and the state is freed
    del params, opt, ts
    free_cuda(device)
    want = reference_readings(cell, seed, pool, steps, device)
    compared = gaps(got, want)
    for k in NOT_COMPARED:
        print(f"reading {k} {compared.pop(k)!r} (not compared)",
              file=sys.stderr, flush=True)
    return Outcome(metrics=metrics, window=w, compared=compared,
                   attempted=w.units, failed=0)


def _tower_output_zeroed():
    from repro_torch.models import vision
    real = vision.project
    return vision, "project", lambda p, x, v: real(p, x * 0, v)


def _last_tower_layer_skipped():
    from repro_torch.models import lm
    real = lm._layers

    def layers(gp, repeats):
        out = real(gp, repeats)
        # the tower's group: the one whose attention has an output bias
        return out[:-1] if "bo" in gp["b0"].get("attn", {}) else out
    return lm, "_layers", layers


def _newline_zeroed():
    from repro_torch.models import vision
    real = vision.pack
    return vision, "pack", lambda f, newline, v: real(f, newline * 0, v)


#: planted faults in the program, by name: the pixels left out of the
#: prefix (the tower's features zeroed before the projector), the tower's
#: last run layer skipped, ``image_newline`` left out (zeroed in place)
FAULTS = {"no_pixels": _tower_output_zeroed,
          "skip_layer": _last_tower_layer_skipped,
          "no_newline": _newline_zeroed}


@contextlib.contextmanager
def planted(kind: str):
    """The program with the fault ``kind`` (:data:`FAULTS`) planted while
    the block runs."""
    mod, name, fn = FAULTS[kind]()
    real = getattr(mod, name)
    setattr(mod, name, fn)
    try:
        yield
    finally:
        setattr(mod, name, real)


def control(cell, seed: int, device, kind: str = "control") -> dict:
    """The numbers compared, read with something else in the program's
    place, each against the float32 reference: ``control`` the reference
    in fp8 (``reference/training.py``), ``half_batch`` the program
    stepping on the first half of each batch's rows, a name of
    :data:`FAULTS` the program with that fault; ``program`` the program
    itself, as a run's judgement reads it.  (A step that returns its
    state unchanged reads a change gap of 1 by the measure and needs no
    run.)"""
    steps = int(cell.traffic["check_steps"])
    pool = batch_pool(seed, cell, device)
    if kind == "control":
        got = reference_readings(cell, seed, pool, steps, device, "fp8")
    else:
        _kernels(cell, device)
        ts, params, opt = build(cell, seed, device)
        step_fn = ts.step_fn
        if kind == "half_batch":
            def step_fn(p, o, b):
                return ts.step_fn(p, o, {k: v[:v.shape[0] // 2]
                                         for k, v in b.items()})
        elif kind != "program" and kind not in FAULTS:
            raise BenchError(f"no reading {kind!r}")
        with planted(kind) if kind in FAULTS else contextlib.nullcontext():
            params, opt, got = step_readings(cell, seed, ts, params, opt,
                                             pool, steps, step_fn)
        del params, opt, ts
    free_cuda(device)
    want = reference_readings(cell, seed, pool, steps, device)
    free_cuda(device)
    detail = {side: {k: v for k, v in r.items() if k != "first"}
              for side, r in (("got", got), ("want", want))}
    detail["grad_err_by_leaf"] = {
        k: ((got["first"][k] - w).norm() / w.norm()).item()
        for k, w in want["first"].items()}
    return dict(gaps(got, want), detail=detail)
