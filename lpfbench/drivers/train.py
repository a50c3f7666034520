"""Driver ``train``: back-to-back training steps of the port
(``repro_torch.runtime.train_step.build_train_step``, donated AdamW, as
``launch/train.py --no-smoke`` drives it).

The configuration gives the model's published sizes (``model``), the
sizes the port runs that the source does not publish (``run_as``), its
plain reference (``reference``: the module ``reference/<name>.py``), how
the port builds it (``program``: its registry name, ``ep_degree``,
config overrides, and where it is cut, ``layers`` kept and ``experts``
held), and the optimizer (``optimizer``).  The traffic mix gives the
batch ``batch`` x ``seq`` and the token pool: ``pool`` batches of token
ids drawn on the device from the seed with Zipf-like frequencies
(``zipf_exponent``), every position a real token, the labels the next
tokens.  The weights are made on the device from the seed
(``reference/training.py``, in the layout the reference's
``param_specs`` gives) and handed to the program as its parameter tree.

Set-up builds one training step with its state and drives it through
its first ``check_steps`` steps on batches 0, 1, 2 of the pool, through
the same call the window makes; the window then goes on with that state
over the following batches, each step timed from the call to its
return, until its seconds are spent (a traced run stops after
``trace_steps``).  One unit of work is one step of ``batch * seq``
positions.

The judgement follows the check's steps with the plain reference in
float32, after the window, once the program's state is freed: each
step's loss, the first gradient leaf by leaf as the optimizer got it
(the program's from its first moment after one step), and each leaf's
change after the last check step."""

from __future__ import annotations

import dataclasses
import functools
import gc
import importlib
import statistics
import sys
import time

from ..harness import BenchError, Outcome, SetupClock, Window
from ..reference import training


def token_pool(seed: int, mix: dict, vocab: int, device):
    """``pool`` x [batch, seq + 1] token ids: ranks drawn with weights
    1 / rank^zipf_exponent, mapped to ids by a permutation, both from the
    seed on the device."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(training.leaf_seed(seed, -1))
    P, B, S = int(mix["pool"]), int(mix["batch"]), int(mix["seq"])
    w = torch.arange(1, vocab + 1, dtype=torch.float64, device=device) \
        .pow(-float(mix["zipf_exponent"]))
    ranks = torch.multinomial(w.float(), P * B * (S + 1), replacement=True,
                              generator=gen)
    perm = torch.randperm(vocab, device=device, generator=gen)
    return perm[ranks].reshape(P, B, S + 1).int()


def batch_of(pool, i: int) -> dict:
    t = pool[i % pool.shape[0]]
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def sizes(conf: dict) -> dict:
    """The model as run: its published sizes and ``run_as``."""
    return {**conf["model"], **conf.get("run_as", {})}


def reference_of(conf: dict):
    """The configuration's plain reference module."""
    return importlib.import_module(f"lpfbench.reference.{conf['reference']}")


def program_config(conf: dict):
    """The port's model config for the configuration file, checked
    against the sizes it states (the reference reads the port's config
    back under the file's keys)."""
    from repro_torch.configs import get_config
    prog, m = conf["program"], sizes(conf)
    cfg = get_config(prog["arch"], smoke=bool(prog.get("smoke", False)),
                     ep_degree=int(prog["ep_degree"]))
    cfg = dataclasses.replace(cfg, **prog.get("overrides", {}))
    if "layers" in prog:        # a cut in depth: the model's one group
        if len(cfg.groups) != 1:
            raise BenchError("a cut in depth takes a model of one group")
        cfg = dataclasses.replace(cfg, groups=(dataclasses.replace(
            cfg.groups[0], repeats=int(prog["layers"])),))
    if "experts" in prog:       # the experts this chip holds
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=int(prog["experts"])))
    got = reference_of(conf).port_sizes(cfg)
    bad = {k: (v, m.get(k)) for k, v in got.items() if v != m.get(k)}
    if bad:
        raise BenchError(f"the port's {prog['arch']} is not the "
                         f"configuration's model: {bad}")
    return cfg


def optimizer_config(conf: dict):
    from repro_torch.optim import AdamWConfig
    o = conf["optimizer"]
    return AdamWConfig(lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                       weight_decay=o["weight_decay"],
                       clip_norm=o["clip_norm"])


def nest(flat: dict) -> dict:
    """``{"a.b": t}`` -> ``{"a": {"b": t}}``."""
    out: dict = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        d = out
        for k in path:
            d = d.setdefault(k, {})
        d[leaf] = t
    return out


def flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def build(cell, seed: int, device):
    """The program's training step and its state: the configuration's
    weights of ``seed`` as its parameter tree, fresh AdamW moments."""
    from repro_torch.models.lm import ParamTree
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.train_step import build_train_step
    cfg = program_config(cell.config)
    opt_cfg = optimizer_config(cell.config)
    ts = build_train_step(cfg, opt_cfg=opt_cfg, donate=True,
                          device=device.type)
    like = {k: tuple(v.shape) for k, v in
            ts.like_fn()[0].named_parameters()}
    specs = reference_of(cell.config).param_specs(sizes(cell.config))
    want = {name: tuple(shape) for name, shape, _ in specs}
    if like != want:
        raise BenchError(f"the port's parameter tree is not the "
                         f"reference's: {sorted(set(like) ^ set(want))} "
                         f"{[(k, like[k], want[k]) for k in like if k in want and like[k] != want[k]]}")
    params = ParamTree(nest(training.make_params(seed, specs, device)),
                       trainable=True)
    return ts, params, adamw_init(params.tree(), opt_cfg)


def step_readings(cell, seed, ts, params, opt, pool, steps: int,
                  step_fn=None):
    """Drives the program's first ``steps`` steps and reads what the
    check compares: each loss, the first gradient's leaf norms from the
    first moment after one step, each leaf's change after the last.
    Returns (params, opt, readings)."""
    b1 = cell.config["optimizer"]["b1"]
    specs = reference_of(cell.config).param_specs(sizes(cell.config))
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
    flat = {k: v for k, v in params.named_parameters()}
    for i, s in enumerate(specs):
        out["change"][s[0]] = (flat[s[0]].detach() - training.make_leaf(
            seed, i, s, flat[s[0]].device)).norm().item()
    return params, opt, out


def reference_readings(cell, seed, pool, steps, device, low=None) -> dict:
    batches = [(b["tokens"], b["labels"]) for b in
               (batch_of(pool, i) for i in range(steps))]
    ref, m = reference_of(cell.config), sizes(cell.config)
    return training.follow(seed, ref.param_specs(m),
                           functools.partial(_loss_of, ref, m),
                           cell.config["optimizer"], batches, device, low)


def _loss_of(ref, m, params, tokens, labels, low):
    return ref.loss(params, tokens, labels, m, low)


def gaps(got: dict, want: dict) -> dict:
    """The numbers compared: the largest relative gap of a check step's
    loss (``loss_gap``); the median leaf's relative error of the first
    gradient as the optimizer took it, the L2 norm of the difference at
    the sampled positions over the reference's (``grad_err``); and the
    largest gap of a leaf's change after the last check step over the
    larger of the reference's change of that leaf and of the median leaf
    (``change_gap``), leaves whose reference gradient is under a
    thousandth of the median leaf's left out (they move by round-off).
    Read and not compared: the worst leaf's gradient error
    (``grad_err_worst``: the router's swings from seed to seed with the
    tokens whose top-k or capacity cut-off rounding flips) and the gap of
    a leaf's first-gradient norm over the larger of the reference's norm
    of that leaf and of the median leaf (``grad_gap``: no control or
    fault separates it from sound runs)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["loss"],
                                                    want["loss"]))
    errs = [((got["first"][k] - w).norm() / w.norm()).item()
            for k, w in want["first"].items()]
    g_med = statistics.median(want["grad0"].values())
    floor = statistics.median(want["grad1"].values())
    grad = max(abs(got["grad1"][k] - w) / max(w, floor)
               for k, w in want["grad1"].items())
    moved = [k for k, g in want["grad0"].items() if g >= 1e-3 * g_med]
    c_med = statistics.median(want["change"][k] for k in moved)
    change = max(abs(got["change"][k] - want["change"][k])
                 / max(want["change"][k], c_med) for k in moved)
    return {"loss_gap": loss, "grad_err": statistics.median(errs),
            "change_gap": change, "grad_err_worst": max(errs),
            "grad_gap": grad}


NOT_COMPARED = ("grad_err_worst", "grad_gap")


def free_cuda(device):
    gc.collect()
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def run(cell, *, seed: int, seconds: float, trace: bool, device,
        clock_zero: float) -> Outcome:
    clock = SetupClock(clock_zero)
    mix, m = cell.traffic, cell.config["model"]
    if device.type == "cuda" and \
            cell.config["program"].get("overrides", {}).get(
                "attn_impl") == "flash":
        from repro_torch.kernels import build as kbuild
        kbuild.build(["flash_attention_fwd", "flash_attention_bwd"])
    clock.mark("kernels")
    steps = int(mix["check_steps"])
    pool = token_pool(seed, mix, m["vocab_size"], device)
    ts, params, opt = build(cell, seed, device)
    clock.mark("program, weights and tokens")
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


def control(cell, seed: int, device, kind: str = "control") -> dict:
    """The numbers compared, read with something else in the program's
    place: ``control`` the reference in fp8 (``reference/training.py``),
    ``half_batch`` the program stepping on the first half of each batch's
    rows (the mean over the rest); each against the float32 reference.
    ``program`` reads the program itself, as a run's judgement does.  (A
    step that returns its state unchanged reads a change gap of 1 by the
    measure and needs no run.)"""
    mix, m = cell.traffic, cell.config["model"]
    steps = int(mix["check_steps"])
    pool = token_pool(seed, mix, m["vocab_size"], device)
    if kind == "control":
        got = reference_readings(cell, seed, pool, steps, device, "fp8")
    else:
        if cell.config["program"].get("overrides", {}).get(
                "attn_impl") == "flash" and device.type == "cuda":
            from repro_torch.kernels import build as kbuild
            kbuild.build(["flash_attention_fwd", "flash_attention_bwd"])
        ts, params, opt = build(cell, seed, device)
        step_fn = {"program": ts.step_fn,
                   "half_batch": lambda p, o, b: ts.step_fn(
                       p, o, {k: v[:v.shape[0] // 2] for k, v in b.items()})
                   }[kind]
        params, opt, got = step_readings(cell, seed, ts, params, opt, pool,
                                         steps, step_fn)
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

