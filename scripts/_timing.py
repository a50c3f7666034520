"""Timing helpers of the scripts that measure the port's kernels on one
NVIDIA GPU: a function's milliseconds by CUDA events, the device time of
each CUDA kernel a call launches (profiler ranges left out), and the
card's name and power limit.  ``torch`` is imported inside each
function, so a script that imports this module still starts (and fails
cleanly) without it."""

from __future__ import annotations

import re
import statistics
import subprocess


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` over ``reps`` calls after ``warmup``,
    each between two CUDA events on the current stream."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_work(prof, events) -> list:
    """The kernels and copies among ``events`` (``prof.events()`` or
    ``prof.key_averages()``): the device's events that are not profiler
    ranges.  A range (``record_function``, the port's spans) shows on the
    device's timeline too, spanning the kernels it launched; it is no
    kernel."""
    import torch
    ranges = {e.name for e in prof.events()
              if getattr(e, "is_user_annotation", False)}
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.key not in ranges]


def kernel_us(fn, calls: int = 5) -> dict:
    """Device microseconds a call of each CUDA kernel ``fn`` launches
    (``torch.profiler``, the mean of ``calls`` calls after one warm-up)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in device_work(prof, prof.key_averages()):
        if e.self_device_time_total > 0:
            m = re.search(r"([A-Za-z_]\w*)(?=[<(])", e.key)
            name = m.group(1) if m else e.key
            out[name] = out.get(name, 0.0) + e.self_device_time_total / calls
    return out


def card_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi`` gives
    them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
