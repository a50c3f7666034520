"""End-to-end training on the port: a small LM for a few hundred
steps on a virtual (data, model) mesh, with checkpointing and straggler
monitoring.

The mesh's devices are virtual shards on one device
(:mod:`repro_torch.launch.mesh`); the steps donate their state (AdamW in
place), as the JAX package's default step does.  A restart resumes from
the newest checkpoint in ``--ckpt`` (a directory of this package's own:
the two packages' checkpoints are not interchangeable).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm      (quick)
      PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300
      (``--device cpu`` without a card)
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from ..configs import get_config
from ..data import DataConfig, SyntheticStream
from ..launch.mesh import make_mesh
from ..optim import AdamWConfig, warmup_cosine
from ..runtime.train_loop import TrainLoopConfig, train_loop
from ..runtime.train_step import build_train_step

ARCH = "llama3.2-1b"
MESH = (4, 2)
SEQ, BATCH, PEAK_LR, WARMUP = 64, 16, 3e-3, 20
DEFAULT_CKPT = os.path.join(tempfile.gettempdir(), "repro_torch_train_lm")


def build(steps: int, device="cuda"):
    """The example's step and stream: llama3.2-1b's smoke config on the
    virtual ``MESH``, AdamW under ``warmup_cosine(PEAK_LR, WARMUP,
    steps)``, the synthetic stream of seed 0."""
    cfg = get_config(ARCH, smoke=True)    # same family, reduced
    ts = build_train_step(cfg, make_mesh(MESH, ("data", "model")),
                          opt_cfg=AdamWConfig(lr=warmup_cosine(
                              PEAK_LR, WARMUP, steps)),
                          donate=True, device=device)
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                        global_batch=BATCH, seed=0), cfg)
    return ts, stream


def run(steps: int = 120, ckpt: str = DEFAULT_CKPT, device="cuda",
        ckpt_every: int = 50, log=print) -> dict:
    """Train to ``steps`` from the newest checkpoint in ``ckpt`` (or from
    seed 0), saving every ``ckpt_every`` steps; ``log`` gets a line every
    20 steps.  Returns the loop's summary with ``start``, the step the
    run began at."""
    ts, stream = build(steps, device)

    def on_step(step, loss, verdict):
        if step % 20 == 0 and log:
            log(f"step {step:>4}  loss {loss:.4f}  "
                f"{verdict.duration * 1e3:6.1f} ms")

    out = train_loop(ts, stream, TrainLoopConfig(
        steps=steps, ckpt_dir=ckpt, ckpt_every=ckpt_every), on_step=on_step)
    out["start"] = steps - len(out["losses"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--ckpt", default=DEFAULT_CKPT)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; refused without a card) or "
                         "cpu")
    args = ap.parse_args(argv)
    out = run(args.steps, args.ckpt, args.device)
    losses = out["losses"]
    if out["start"]:
        print(f"resumed from step {out['start']}")
    if len(losses) < 20:
        print(f"{len(losses)} steps run: too few to compare the first and "
              f"last 10 losses")
        return 0
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"\nloss: {first:.3f} -> {last:.3f}")
    print(f"checkpoints in {args.ckpt}: restart me to resume from there.")
    return 0 if last < first else 1


if __name__ == "__main__":
    raise SystemExit(main())
