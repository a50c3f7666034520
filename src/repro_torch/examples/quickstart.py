"""Quickstart — the paper's Algorithm 2 ('hello world') on the port.

Launch an SPMD function over 8 virtual processes, bootstrap a parallel
matrix computation: fetch the global size from process 0 (``get``),
validate locally, and broadcast errors with CRCW write-conflict
resolution (no extra buffer, exactly as the paper shows).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart 1024 512
      (``--device cpu`` without a card; ``0 512`` takes the error path)
"""

from __future__ import annotations

import argparse

import torch

from .. import core as lpf
from ..core import H100_SXM, HardwareModel

OK, ILLEGAL_INPUT = 0, 1
P = 8


def spmd(ctx, s, p, args):
    # allocate and activate LPF buffers (lpf_resize_* + sync)
    ctx.resize_memory_register(3)
    ctx.resize_message_queue(p * p + p)

    # register memory areas for communication
    lerr = ctx.register_local("lerr", ctx.replicate(
        torch.zeros(1, dtype=torch.int32)))
    gerr = ctx.register_global("gerr", ctx.replicate(
        torch.zeros(1, dtype=torch.int32)))
    mdim = ctx.register_global("mdim", ctx.replicate(args["mdim"]))

    # everyone reads the matrix size from the root process
    ctx.get(mdim, mdim, frm=0, size=2)
    ctx.sync(label="fetch-dims")

    dims = ctx.tensor(mdim)                          # [p, 2]
    M = (dims[:, :1] + p - ctx.pid - 1) // p         # my row count, [p, 1]
    N = dims[:, 1:]
    bad = torch.where((M <= 0) | (N <= 0), ILLEGAL_INPUT, OK)
    ctx.write(lerr, bad.to(torch.int32))

    # broadcast errors via CRCW conflict resolution: every process puts
    # its local error to everyone; any nonzero writer wins over zeros
    # (per-pid deterministic order), no gather buffer needed
    for k in range(p):
        ctx.put(lerr, gerr, to=k, size=1, where=lambda s_: True)
    ctx.sync(label="error-broadcast")

    err = ctx.tensor(gerr)[:, 0]
    # ... build the local matrix, compute, etc.
    return err, M[:, 0].to(torch.int32)


def run(m: int = 1024, n: int = 512, device="cuda",
        hardware: HardwareModel = H100_SXM) -> dict:
    """Algorithm 2 over ``P`` virtual processes on ``device``: the error
    code every process holds, each one's rows, and the ledger priced on
    ``hardware``'s virtual-process link."""
    args = {"mdim": torch.tensor([m, n], dtype=torch.int32)}
    (err, rows), ledger = lpf.exec_(P, spmd, args, device=device,
                                    hardware=hardware, return_ledger=True)
    machine = lpf.probe({"vp": P}, hardware)
    return dict(error=int(err[0]), errors=err.tolist(), rows=rows.tolist(),
                ledger=ledger, machine=machine, hardware=hardware.name,
                report=ledger.report(machine))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("m", type=int, nargs="?", default=1024)
    ap.add_argument("n", type=int, nargs="?", default=512)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; refused without a card) or "
                         "cpu")
    args = ap.parse_args(argv)
    res = run(args.m, args.n, args.device)
    err = res["error"]
    print(f"global error code: {err} "
          f"({'OK' if err == OK else 'ILLEGAL_INPUT'})")
    print(f"rows per process:  {res['rows']}")
    print(f"\nsuperstep ledger (predicted costs on {res['hardware']}, "
          f"p = {P} virtual processes):")
    print(res["report"])
    # the example's own check: every process holds the same code
    return 0 if len(set(res["errors"])) == 1 else 1


if __name__ == "__main__":
    raise SystemExit(main())
