"""The training loop: checkpointing, failure recovery and the straggler
policy — the JAX package's ``repro.runtime.train_loop`` on one device.

Fault-tolerance contract:
  * checkpoints are atomic + async; on (re)start the loop resumes from the
    newest published step — crash-at-any-point safe;
  * the data pipeline is a pure function of (seed, step): no iterator
    state can be lost;
  * step wall-times feed the BSP straggler monitor; its verdicts are
    recorded (flag -> skip-sync -> rescale is policy surface for the
    caller);
  * step exceptions route through the :class:`StepSupervisor`, which
    applies the LPF error taxonomy (:func:`repro_torch.core.errors.
    classify`): *transient* failures (I/O, injected faults, timeouts) are
    retried from the newest published checkpoint with bounded backoff
    (``max_restarts``); *fatal* and *mitigable* errors propagate — a
    contract violation must never be silently retried, and a capacity
    error belongs to ``ctx.with_capacity``'s resize-and-retry, not to
    checkpoint rollback.

Local SGD (the paper's STALE attribute realised at loop level): the inner
loop runs `sync_every` steps with the cross-pod sync OFF (a second step
variant, ``step_fn_nosync``), then one step syncs across pods.  As in
JAX, the no-sync step of a pod mesh is the GSPMD step over the whole
batch (``runtime/train_step.py``).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Deque, Dict, List, Optional

import torch

from ..checkpoint import AsyncCheckpointer, latest_step, restore
from ..core.errors import classify
from ..data import SyntheticStream
from .monitor import StepVerdict, StragglerMonitor
from .train_step import TrainStep

__all__ = ["TrainLoopConfig", "Anomaly", "StepSupervisor", "train_loop"]


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    resume: bool = True
    # local SGD / stale sync: 0 = every step is synchronous
    sync_every: int = 0
    # recovery supervision: how many checkpoint-restore retries a run
    # may spend on *transient* step failures before the error
    # propagates, and the (doubling) backoff before each retry
    max_restarts: int = 2
    restart_backoff: float = 0.05
    # flight-recorder ring capacity (see StepSupervisor.ANOMALY_CAP)
    anomaly_cap: Optional[int] = None


@dataclasses.dataclass
class Anomaly:
    """One supervision event, in the order it happened — the run's
    flight recorder (returned in the ``train_loop`` summary)."""

    step: int
    kind: str        # "straggler" | "transient" | "restart" | "give_up"
    action: str      # verdict action, "restore", "propagate", ...
    detail: str = ""


class StepSupervisor:
    """Per-step recovery policy: classify, escalate, bound.

    Verdicts from the :class:`StragglerMonitor` are recorded as
    anomalies when they escalate past "ok".  Step exceptions are
    classified with the LPF taxonomy: *transient* errors are absorbed up
    to ``max_restarts`` times — each absorption asks the caller to
    restore from the newest published checkpoint after a doubling
    backoff — everything else propagates unchanged.  Retries are bounded
    per RUN, not per step: a fault that keeps recurring must eventually
    surface, classified, to the operator."""

    #: default flight-recorder ring capacity: the anomalies list is a
    #: post-mortem surface, and a long-running job with a chronically
    #: flagged straggler appends one entry per step — unbounded, that
    #: is an OOM with extra steps; bounded, the newest (most relevant)
    #: evidence survives
    ANOMALY_CAP = 1024

    def __init__(self, max_restarts: int = 2, backoff: float = 0.05,
                 anomaly_cap: Optional[int] = None):
        self.max_restarts = max_restarts
        self.backoff = backoff
        self.restarts = 0
        #: bounded ring of supervision events (oldest dropped first)
        self.anomalies: Deque[Anomaly] = collections.deque(
            maxlen=self.ANOMALY_CAP if anomaly_cap is None
            else anomaly_cap)

    def on_verdict(self, verdict: StepVerdict) -> None:
        if verdict.action != "ok":
            self.anomalies.append(Anomaly(
                step=verdict.step, kind="straggler",
                action=verdict.action,
                detail=f"z={verdict.z:.2f} dt={verdict.duration:.4f}s"))

    def on_error(self, step: int, err: BaseException) -> bool:
        """Decide the fate of a step that raised: ``True`` = absorb and
        retry from the latest checkpoint (the caller restores), after
        sleeping the backoff; ``False`` = propagate."""
        kind = classify(err)
        if kind != "transient" or self.restarts >= self.max_restarts:
            self.anomalies.append(Anomaly(
                step=step, kind=kind, action="propagate",
                detail=f"{type(err).__name__}: {err}"))
            return False
        self.restarts += 1
        self.anomalies.append(Anomaly(
            step=step, kind="transient", action="restore",
            detail=f"restart {self.restarts}/{self.max_restarts}: "
                   f"{type(err).__name__}: {err}"))
        time.sleep(self.backoff * (2 ** (self.restarts - 1)))
        return True


def train_loop(ts: TrainStep, stream: SyntheticStream,
               cfg: TrainLoopConfig, *,
               step_fn_nosync: Optional[Callable] = None,
               on_step: Optional[Callable] = None) -> Dict[str, Any]:
    """Run training from seed 0 (or the newest checkpoint); returns summary
    metrics + the monitor history.  ``loss`` is read back each step, so a
    step's wall time ends when its work on the device has.  With
    ``cfg.sync_every = k > 1`` and ``step_fn_nosync``, every step but each
    k-th runs ``step_fn_nosync`` (local SGD)."""
    dev = ts.rt.device
    start = 0
    params = opt = None
    ckpt = AsyncCheckpointer(cfg.ckpt_dir) if cfg.ckpt_dir else None

    if ckpt and cfg.resume:
        last = latest_step(cfg.ckpt_dir)
        if last is not None:
            params, opt = restore(cfg.ckpt_dir, last, ts.like_fn(),
                                  device=dev)
            start = last

    if params is None:
        params, opt = ts.init_fn(0)

    monitor = StragglerMonitor()
    supervisor = StepSupervisor(max_restarts=cfg.max_restarts,
                                backoff=cfg.restart_backoff,
                                anomaly_cap=cfg.anomaly_cap)
    losses: List[float] = []
    step = start
    while step < cfg.steps:
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in stream.batch(step).items()}
        use_nosync = (cfg.sync_every > 1 and step_fn_nosync is not None
                      and (step + 1) % cfg.sync_every != 0)
        fn = step_fn_nosync if use_nosync else ts.step_fn
        t0 = time.perf_counter()
        try:
            params, opt, metrics = fn(params, opt, batch)
            loss = float(metrics["loss"])
        except Exception as err:
            if not supervisor.on_error(step, err):
                raise
            # transient, absorbed: roll back to the newest published
            # state and re-run from there.  Without a checkpointer the
            # live (params, opt) are still pre-step — the step that
            # raised never committed its update — so retrying in place
            # is the same rollback with a zero-step window.
            if ckpt:
                rstep, state = ckpt.restore_latest(ts.like_fn(), device=dev)
                if rstep is not None:
                    params, opt = state
                    del losses[max(0, rstep - start):]
                    step = rstep
            continue
        dt = time.perf_counter() - t0
        verdict = monitor.record(step, dt)
        supervisor.on_verdict(verdict)
        losses.append(loss)
        if on_step:
            on_step(step, loss, verdict)
        if ckpt and (step + 1) % cfg.ckpt_every == 0:
            ckpt.save(step + 1, (params, opt),
                      meta={"loss": loss, "data": stream.state(step + 1)})
        step += 1
    if ckpt:
        ckpt.save(cfg.steps, (params, opt),
                  meta={"data": stream.state(cfg.steps)})
        ckpt.wait()
    return {
        "params": params, "opt": opt, "losses": losses,
        "monitor": monitor.history, "final_loss": losses[-1] if losses
        else float("nan"),
        "anomalies": supervisor.anomalies,
        "restarts": supervisor.restarts,
    }
