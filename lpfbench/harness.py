"""What every cell shares: finding a cell's files by the names in
``BENCHMARK.json``, the measured window, the reading of a traced window,
and the result line.

A cell names a configuration (``configs/<file>.json``) and a traffic mix
(``traffic/<name>.json``).  The mix names its driver (``drivers/<driver>
.py``), the general code that makes the inputs from the seed, sets the
program up, drives it through the window and judges what it produced.
The limits of that judgement are data too (``checks/<workload>.json``),
and each per-layer metric is a reader of its own (``metrics/<name>.py``),
loaded by its name."""

from __future__ import annotations

import dataclasses
import heapq
import importlib
import importlib.util
import json
import math
import os
import re
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent

#: top-level module names a run must not hold once its window has closed
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


class BenchError(Exception):
    """A run that cannot give a result (no card, a missing file, a
    forbidden import); the harness prints it and exits with a code other
    than 0."""


# --------------------------------------------------------------------------
# the cell
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    name: str
    entry: dict            # the workload's entry in BENCHMARK.json
    config: dict           # configs/<config>.json
    traffic: dict          # traffic/<traffic>.json
    limits: dict           # checks/<workload>.json: number -> limit
    spec: dict             # the whole of BENCHMARK.json

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def end_to_end(self) -> List[dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.spec["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> List[dict]:
        """The per-layer metrics this cell reports: those whose
        ``workloads`` list it (every per-layer metric has the list)."""
        return [m for m in self.spec["per_layer"]
                if self.name in m["workloads"]]


def read_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, with its files."""
    spec_path = root / "BENCHMARK.json"
    if not spec_path.is_file():
        raise BenchError(f"no BENCHMARK.json in {root}")
    spec = read_json(spec_path)
    entry = next((w for w in spec["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise BenchError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    traffic = read_json(PKG / "traffic" / f"{entry['traffic']}.json")
    limits = read_json(PKG / "checks" / f"{workload}.json")["limits"]
    return Cell(workload, entry, read_json(root / conf["file"]), traffic,
                limits, spec)


def driver_of(cell: Cell):
    """The driver module the cell's traffic mix names."""
    return importlib.import_module(f"lpfbench.drivers.{cell.traffic['driver']}")


def metric_reader(name: str) -> Callable:
    """``metrics/<name>.py``'s ``read``, loaded by its file's name (a
    metric's name may hold dots)."""
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"lpfbench.metrics._{re.sub(r'[^0-9A-Za-z_]', '_', name)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cache_dirs(root: Path = ROOT) -> Dict[str, str]:
    """The fixed directories inside the checkout where the program's
    caches live, by the environment variable that names each: the LPF
    program store and the compilers' caches.  (The port's CUDA kernels
    build into ``build/repro_torch`` of the checkout, a path fixed in
    its code.)"""
    base = root / "build" / "lpfbench"
    return {"LPF_PROGRAM_CACHE_DIR": str(base / "programs"),
            "TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
            "TRITON_CACHE_DIR": str(base / "triton")}


def forbidden_modules(modules=None) -> List[str]:
    """The forbidden top-level names among ``sys.modules``, compared
    whole (``repro_torch`` is not ``repro``)."""
    names = modules if modules is not None else list(sys.modules)
    tops = {m.split(".", 1)[0] for m in names}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def process_age_s() -> float:
    """Seconds since this process started (its start time in
    ``/proc/self/stat`` against ``/proc/uptime``), so that set-up counts
    the interpreter's own start; 0 where ``/proc`` does not say."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


class SetupClock:
    """Seconds of each part of set-up, printed on standard error at the
    window's start (``start`` is when the driver began; the time before it
    is the interpreter's start and the imports)."""

    def __init__(self, clock_zero: float):
        self.last = self.start = time.perf_counter()
        self.parts = [("start and imports", self.start - clock_zero)]

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.parts.append((name, now - self.last))
        self.last = now

    def report(self) -> None:
        print("setup " + ", ".join(f"{n} {s:.2f} s" for n, s in self.parts),
              file=sys.stderr, flush=True)


# --------------------------------------------------------------------------
# the measured window
# --------------------------------------------------------------------------

class Window:
    """The measured window of one run.

    Entering it synchronises the device, ends set-up, resets the memory
    peak and, in a traced run, starts the profiler; ``expired()`` says
    when the window's time (or a traced run's cap on units) is spent; a
    driver records each unit of work it completes with ``unit()``.
    Leaving it synchronises the device, so the window holds all the work
    that was issued in it, and reads the peak and the trace."""

    def __init__(self, clock_zero: float, seconds: float, device,
                 trace: bool = False, trace_units: Optional[int] = None):
        self.clock_zero = clock_zero
        self.seconds = seconds
        self.device = device
        self.trace = trace
        self.trace_units = trace_units
        self.latencies: List[float] = []     # call to completion, s
        self.spans: List[float] = []         # call to return, s
        self.units = 0
        self.setup_s = math.nan
        self.window_s = math.nan
        self.setup_peak_bytes = 0
        self.window_peak_bytes = 0
        self.profile = None
        self._prof = None
        self._range = None

    def _sync(self):
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        import torch
        self._sync()
        if self.device.type == "cuda":
            self.setup_peak_bytes = torch.cuda.max_memory_allocated(
                self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        if self.trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self._range = torch.profiler.record_function(WINDOW_RANGE)
            self._range.__enter__()
        self.t0 = time.perf_counter()
        self.setup_s = self.t0 - self.clock_zero
        return self

    def now(self) -> float:
        return time.perf_counter() - self.t0

    def expired(self) -> bool:
        if self.trace and self.trace_units is not None \
                and self.units >= self.trace_units:
            return True
        return self.now() >= self.seconds

    def unit(self, span_s: float, latency_s: Optional[float] = None):
        self.units += 1
        self.spans.append(span_s)
        if latency_s is not None:
            self.latencies.append(latency_s)

    def __exit__(self, *exc):
        import torch
        self._sync()
        self.window_s = time.perf_counter() - self.t0
        if self.device.type == "cuda":
            self.window_peak_bytes = torch.cuda.max_memory_allocated(
                self.device)
        if self._prof is not None:
            self._range.__exit__(None, None, None)
            self._prof.__exit__(None, None, None)
            if exc[0] is None:
                self.profile = Profile(self._prof)
            self._prof = None
        return False


#: the profiler range around a traced window
WINDOW_RANGE = "lpfbench.window"


# --------------------------------------------------------------------------
# reading a traced window
# --------------------------------------------------------------------------

def kernel_name(key: str) -> str:
    """A kernel's name without its template arguments and signature."""
    m = re.search(r"([A-Za-z_]\w*)(?=[<(])", key)
    return m.group(1) if m else key[:80]


class Profile:
    """A traced window as the readers see it: the device's kernels and
    copies ``(name, start_us, end_us)`` inside the window, the busy time
    (their union), the window's length, the device time of the ops
    inside named profiler ranges, and the idle gaps."""

    def __init__(self, prof):
        import torch
        cpu_t = torch.autograd.DeviceType.CPU
        events = prof.events()
        win = [e for e in events if e.name == WINDOW_RANGE
               and e.device_type == cpu_t]
        if not win:
            raise BenchError("the traced window's range is missing")
        w0, w1 = win[0].time_range.start, win[0].time_range.end
        self.w0, self.w1 = w0, w1
        self.window_s = (w1 - w0) / 1e6
        # a profiler range appears on the device's timeline too (a user
        # annotation spanning its kernels): it is no kernel
        ranges = {e.name for e in events if e.device_type == cpu_t
                  and getattr(e, "is_user_annotation", False)}
        ranges.add(WINDOW_RANGE)
        self.kernels = sorted(
            (kernel_name(e.name), max(e.time_range.start, w0),
             min(e.time_range.end, w1))
            for e in events if e.device_type != cpu_t
            and not getattr(e, "is_user_annotation", False)
            and e.name not in ranges
            and e.time_range.end > w0 and e.time_range.start < w1)
        self.ops = [e for e in events
                    if e.device_type == cpu_t and e.name != WINDOW_RANGE
                    and e.time_range.end > w0 and e.time_range.start < w1]
        self.cpu = [(e.time_range.start, e.time_range.end, e.name,
                     e.device_time_total) for e in self.ops]
        self.busy = _union([(a, b) for _, a, b in self.kernels])
        self.busy_s = sum(b - a for a, b in self.busy) / 1e6

    def kernel_s(self, pattern: str) -> tuple:
        """(seconds, launches) of the kernels whose name holds
        ``pattern``."""
        hits = [(a, b) for n, a, b in self.kernels if pattern in n]
        return sum(b - a for a, b in hits) / 1e6, len(hits)

    def range_ops(self, name: str) -> list:
        """The ops of the code inside the profiler range ``name``,
        forward and backward: the ops inside the range (its forward, and
        its remat recompute, which enters the range again) and the
        autograd nodes that those ops made, with what the engine does for
        each node (its gradients' accumulation).  A node is tied to its op
        by the profiler's (thread, sequence number); a recompute that a
        node triggers, of code outside the range, is left out."""
        keys = {(e.thread, e.sequence_nr) for e in self.ops
                if e.sequence_nr >= 0 and not _is_node(e)
                and _in_range(e, name)}
        return [e for e in self.ops if _belongs(e, name, keys)]

    def range_device_s(self, name: str) -> tuple:
        """(device seconds, autograd nodes) of :meth:`range_ops`: each
        kernel counts once, the sum running over the ops' own device
        time."""
        ops = self.range_ops(name)
        return (sum(e.self_device_time_total for e in ops) / 1e6,
                sum(e.name.startswith(_EVALUATE) for e in ops))

    def device_ops(self, top: int = 10) -> list:
        tot: Dict[str, float] = {}
        for n, a, b in self.kernels:
            tot[n] = tot.get(n, 0.0) + (b - a) / 1e6
        return sorted(([n, s] for n, s in tot.items()),
                      key=lambda t: -t[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle time inside the window, summed by what the host was doing
        at the middle of each gap: the innermost op or range then open
        (``python`` where none was)."""
        gaps, t = [], self.w0
        for a, b in self.busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.w1 > t:
            gaps.append((t, self.w1))
        cpu = sorted(self.cpu)
        heap: list = []
        i = 0
        tot: Dict[str, float] = {}
        for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = (a + b) / 2
            while i < len(cpu) and cpu[i][0] <= mid:
                heapq.heappush(heap, (-cpu[i][0], cpu[i][1], cpu[i][2]))
                i += 1
            while heap and heap[0][1] < mid:
                heapq.heappop(heap)
            # the open op that started last is the innermost one (lazily
            # dropped: an ended op below the top is popped when it rises)
            name = heap[0][2] if heap else "python"
            tot[name] = tot.get(name, 0.0) + (b - a) / 1e6
        return sorted(([n, s] for n, s in tot.items()),
                      key=lambda t: -t[1])[:top]


#: the autograd engine's event around one node's backward
_EVALUATE = "autograd::engine::evaluate_function: "


def _is_node(e) -> bool:
    """An autograd node's backward (the engine's event around it, or the
    node's own, whose scope is the backward function's)."""
    return e.name.startswith(_EVALUATE) or e.scope == 1


def _in_range(e, name: str) -> bool:
    while e is not None:
        if e.name == name:
            return True
        e = e.cpu_parent
    return False


def _belongs(e, name: str, keys: set) -> bool:
    """Whether op ``e`` is the range ``name``'s work: the nearest of its
    ancestors (itself included) that decides is the range itself, or a
    node made by an op of the range (``keys``).  An op recorded with a
    sequence number under a node is forward work, a recompute, and
    belongs to the node only inside the range."""
    forward = False
    while e is not None:
        if e.name == name:
            return True
        if _is_node(e):
            return not forward and (e.fwd_thread, e.sequence_nr) in keys
        if e.sequence_nr >= 0:
            forward = True
        e = e.cpu_parent
    return False


def _union(iv: list) -> list:
    out: list = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


@dataclasses.dataclass
class TraceView:
    """What a per-layer metric's reader gets: the cell, the window and its
    profile (``None`` where nothing was traced)."""
    cell: Cell
    window: Window
    profile: Optional[Profile]


# --------------------------------------------------------------------------
# the run's outcome and its line
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Outcome:
    """What a driver hands back: its end-to-end numbers by metric name,
    the window, what it compared (name -> value), and the work attempted
    and failed."""
    metrics: Dict[str, float]
    window: Window
    compared: Dict[str, float]
    attempted: int
    failed: int


def judge(compared: Dict[str, float], limits: dict) -> tuple:
    """(correct, checks): every number compared at or under its limit
    (a number with no limit, or one that is not finite, fails)."""
    checks, ok = {}, True
    for name, value in compared.items():
        limit = limits.get(name)
        good = limit is not None and math.isfinite(value) \
            and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    for name in limits:
        if name not in compared:
            ok = False
            checks[name] = {"value": None, "limit": limits[name]}
    return ok, checks
