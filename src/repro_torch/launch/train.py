"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``.

Trains ``--arch`` on the deterministic synthetic stream (with the model's
``embeds`` or ``frames`` where it has a vision prefix or an encoder) with
AdamW under a warmup-cosine schedule, on the card unless ``--device
cpu``.  The smoke config is the default; ``--no-smoke`` trains the
published geometry (on the card: llama3.2-1b and mamba2-130m at B 4 x S
2048 fit one 80 GB H100 with ``remat="full"``).  The config is one
card's, its ``ep_degree`` the mesh's model axis (``M``).  Both steps
donate their state (AdamW in place, one copy of it), as the JAX
launcher's do.

``--mesh PxDxM`` (or ``DxM``) runs the mesh's devices as virtual shards
on the one device (:mod:`repro_torch.launch.mesh`): ``P`` pods as
virtual processes, the data and model axes through the step's runtime
(an MoE model's capacity per ``(pod, data)`` shard, its experts over the
``M`` model shards).  With ``--grad-sync lpf`` the pods' gradients cross
an explicit LPF sync (``bsp.pod_sync``; ``--compress``: the int16 ring),
whose superstep ledger is printed at the end; ``--sync-every k`` runs
local SGD, every k-th step synced and the others the GSPMD step, as the
JAX launcher does.  ``--devices`` is the JAX launcher's host-device
count, accepted and not read.  On the CPU: ``python -m
repro_torch.launch.train --device cpu --mesh 2x1x1 --grad-sync lpf
--steps 3``, or ``--arch granite-moe-3b-a800m --mesh 1x2x2``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

from . import one_card_config
from .mesh import make_mesh
from ..core import CompressSpec, SyncAttributes
from ..data import DataConfig, SyntheticStream
from ..models import count_params, model_flops
from ..optim import AdamWConfig, warmup_cosine
from ..runtime.train_loop import TrainLoopConfig, train_loop
from ..runtime.train_step import build_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--no-smoke", dest="smoke", action="store_false")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; refused without a card) or "
                         "cpu")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--attn-impl", default=None,
                    choices=["blocked", "flash", "reference"],
                    help="override the config's attention implementation")
    ap.add_argument("--mesh", default="1x1",
                    help="DxM (data x model), or PxDxM for multi-pod: "
                         "virtual shards on the one device")
    ap.add_argument("--devices", type=int, default=0,
                    help="the JAX launcher's host-device count; one card "
                         "has nothing to force, so it is not read")
    ap.add_argument("--grad-sync", default="gspmd",
                    choices=["gspmd", "lpf"])
    ap.add_argument("--sync-every", type=int, default=0,
                    help="local-SGD period (0 = synchronous)")
    ap.add_argument("--compress", action="store_true",
                    help="int8 cross-pod gradient compression (lpf mode)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--grad-accum", type=int, default=1)
    args = ap.parse_args(argv)

    mesh = make_mesh(tuple(int(x) for x in args.mesh.split("x")))
    model = mesh.shape.get("model", 1)
    # a model axis pads the experts to a multiple of its size
    cfg = one_card_config(args.arch, args.smoke, model)
    if args.attn_impl:
        cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    attrs = SyncAttributes(compress=CompressSpec(bits=8)
                           if args.compress else None)
    ts = build_train_step(
        cfg, mesh,
        opt_cfg=AdamWConfig(lr=warmup_cosine(args.lr, 10, args.steps)),
        grad_sync=args.grad_sync, sync_attrs=attrs,
        grad_accum=args.grad_accum, donate=True, device=args.device)
    ts_nosync = None
    if args.sync_every > 1:
        ts_nosync = build_train_step(
            cfg, mesh, opt_cfg=AdamWConfig(
                lr=warmup_cosine(args.lr, 10, args.steps)),
            grad_sync="gspmd", grad_accum=args.grad_accum, donate=True,
            device=args.device)
    stream = SyntheticStream(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch), cfg)
    tokens = args.batch * args.seq
    print(f"{cfg.name}: {count_params(cfg)} parameters, attn_impl "
          f"{cfg.attn_impl}, remat {cfg.remat}, B {args.batch} x S "
          f"{args.seq} on {ts.rt.device}, mesh {mesh.shape}, grad sync "
          f"{args.grad_sync}")

    def on_step(step, loss, verdict):
        if step % 10 == 0 or step == args.steps - 1 or verdict.straggle:
            flag = f" [{verdict.action}]" if verdict.action != "ok" else ""
            print(f"step {step:>5}  loss {loss:.4f}  "
                  f"{verdict.duration * 1e3:9.1f} ms  "
                  f"{tokens / verdict.duration:10.1f} tok/s{flag}")

    t0 = time.perf_counter()
    out = train_loop(ts, stream, TrainLoopConfig(
        steps=args.steps, ckpt_dir=args.ckpt_dir,
        sync_every=args.sync_every),
        step_fn_nosync=ts_nosync.step_fn if ts_nosync else None,
        on_step=on_step)
    wall = time.perf_counter() - t0
    print(f"final loss: {out['final_loss']:.4f}")
    ran = len(out["losses"])
    if ran:
        print(f"{ran} steps in {wall:.2f} s wall on {ts.rt.device}; model "
              f"flops 6ND {model_flops(cfg, tokens * ran) / wall / 1e12:.2f}"
              f" TFLOP/s (the remat recompute not counted)")
    if ts.ledger.records:
        print("\nLPF superstep ledger (first steps):")
        print(ts.ledger.report())
    return out


if __name__ == "__main__":
    main()
