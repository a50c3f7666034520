"""Serving launcher: the hardened continuous-batching loop over real model
decode buckets, on one device.

``python -m repro_torch.launch.serve --device cpu --check`` serves the
llama3.2-1b smoke config on the CPU (``--arch mamba2-130m`` the Mamba-2
one, whose decode carries a recurrent state in place of a KV cache);
without ``--device`` it runs on the card (and refuses to start without
one), and ``--no-smoke`` serves the full-width model.  Requests are admitted by the model-priced controller
(:class:`repro_torch.runtime.server.LPFServer`), batched continuously
into ``(batch, cache_len)`` buckets and decoded greedily through each
bucket's loop (:func:`repro_torch.runtime.train_step.build_serve_buckets`).

Admission prices are *wall-calibrated* from warm-up decodes per bucket,
as in the JAX package's ``repro.launch.serve``.  Greedy decode is
row-independent and every call pads its rows to the bucket's batch, so a
request's token stream is bit-identical whether it decodes solo or fully
batched (the same GEMM shapes either way); ``--check`` re-decodes every
completed request solo and verifies exactly that.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ..configs import get_config
from ..models.lm import ParamTree, cast_params, init_caches, init_params
from ..runtime.server import LPFServer, synthetic_requests
from ..runtime.train_step import build_serve_buckets

__all__ = ["ModelDecodeEngine", "serve", "main"]


class ModelDecodeEngine:
    """Decode-engine protocol (see :class:`repro_torch.runtime.server
    .LPFServer`) over real model buckets: the greedy loop of each
    ``(batch, cache_len)`` shape, sharing one parameter tree cast once to
    the compute dtype.

    ``quarantine(bucket)`` only records the bucket in ``quarantined``.
    The JAX package drops a quarantined bucket from its jitted loop to
    per-token calls; here the loop is those eager per-token calls
    already, so there is one path, and the server's retry re-runs it."""

    def __init__(self, cfg, buckets: Sequence[Tuple[int, int]], *,
                 params: Optional[ParamTree] = None, device="cuda",
                 seed: int = 0, calibrate_tokens: int = 4):
        self._cfg = cfg
        self._steps = build_serve_buckets(cfg, buckets, device=device)
        self.device = next(iter(self._steps.values())).rt.device
        self._params = params if params is not None else cast_params(
            init_params(seed, cfg, device=self.device), cfg)
        self.quarantined: set = set()
        self._token_s: Dict[Tuple[int, int], float] = {}
        self._overhead_s: Dict[Tuple[int, int], float] = {}
        self._calibrate(calibrate_tokens)

    # -- protocol --------------------------------------------------------
    def buckets(self):
        return tuple(sorted(self._steps))

    def token_seconds(self, bucket):
        return self._token_s[tuple(bucket)]

    def overhead_seconds(self, bucket):
        return self._overhead_s[tuple(bucket)]

    def round_tokens(self, bucket, n: int) -> int:
        t = 1
        while t < n:
            t *= 2
        return min(t, bucket[1])

    def ledger_seconds(self, bucket, n_tokens: int) -> float:
        b = tuple(bucket)
        return self._overhead_s[b] + self._token_s[b] * n_tokens

    def quarantine(self, bucket) -> None:
        self.quarantined.add(tuple(bucket))

    def decode(self, bucket, reqs, n_tokens: int
               ) -> Dict[int, Tuple[int, ...]]:
        toks = self._decode_rows(
            tuple(bucket),
            [r.seed % self._cfg.vocab for r in reqs], n_tokens)
        return {r.rid: toks[i] for i, r in enumerate(reqs)}

    # -- internals -------------------------------------------------------
    def _decode_rows(self, bucket, seed_toks, n_tokens: int):
        """Decode ``n_tokens`` greedy tokens for rows seeded with
        ``seed_toks`` (one prompt token each); rows beyond the request
        count pad with token 0.  Returns per-row token tuples."""
        B, C = bucket
        ss = self._steps[bucket]
        caches = init_caches(self._cfg, B, C, device=self.device)
        row = [int(s) for s in seed_toks] + [0] * (B - len(seed_toks))
        tok = torch.tensor(row, dtype=torch.long, device=self.device)
        out, _caches = ss.decode_fn(n_tokens)(self._params, caches, tok, 0)
        out = out.cpu()                          # [T, B]; waits for the device
        return [tuple(int(t) for t in out[:, i]) for i in range(B)]

    def _calibrate(self, n_tokens: int) -> None:
        """Wall-calibrate the admission price per bucket: a warm-up decode
        of each length, then one 1-token and one ``n``-token decode — the
        slope is the per-token price, the intercept the per-call
        overhead."""
        for b in self.buckets():
            n = min(n_tokens, b[1])
            for t in (1, n):                    # warm up both lengths
                self._decode_rows(b, [0], t)
            t0 = time.perf_counter()
            self._decode_rows(b, [0], 1)
            t1 = time.perf_counter()
            self._decode_rows(b, [0], n)
            t2 = time.perf_counter()
            per_tok = max((t2 - t1) - (t1 - t0), 1e-9) / max(n - 1, 1)
            self._token_s[b] = per_tok
            self._overhead_s[b] = max((t1 - t0) - per_tok, 0.0)


def serve(eng: ModelDecodeEngine, *, requests: int = 8, seed: int = 0,
          max_queue: int = 16, deadline_scale: float = 40.0,
          tight_frac: float = 0.25, max_tokens: int = 32,
          check: bool = False, verbose: bool = True) -> Dict[str, Any]:
    """Serve ``requests`` synthetic requests through an :class:`LPFServer`
    over ``eng``, drain it, and hold it to its SLO gates: no admitted
    request misses its deadline on the admission clock, the drain leaves
    nothing queued, every refusal is classified and, with ``check``, every
    completed stream is bit-identical to a solo re-decode.  Raises
    ``SystemExit`` on a violation; returns the run's summary."""
    say = print if verbose else (lambda *a, **k: None)
    buckets = list(eng.buckets())
    srv = LPFServer(eng, max_queue=max_queue)
    reqs = synthetic_requests(
        requests, seed, buckets,
        token_cost_s=max(eng.token_seconds(b) for b in buckets),
        deadline_scale=deadline_scale, tight_frac=tight_frac,
        max_tokens=max_tokens)
    t0 = time.perf_counter()
    for r in reqs:
        out = srv.submit(r)
        if out.status != "admitted":
            say(f"  rid {r.rid}: {out.status} ({out.reason})")
    srv.run_until_idle()
    health = srv.drain()
    dt = time.perf_counter() - t0

    outs = srv.take_outcomes()
    done = [o for o in outs.values() if o.status == "completed"]
    ntok = sum(len(o.tokens) for o in done)
    say(f"\nserved {len(done)}/{requests} requests ({ntok} tokens) in "
        f"{dt:.3f}s wall ({ntok / dt:.1f} tok/s), vclock "
        f"{health['vclock_s']:.3f}s")
    for k in ("admitted", "completed", "rejected_total", "shed",
              "deadline_misses", "batches", "decode_fallbacks",
              "level_peak", "queue_peak"):
        say(f"  {k}: {health[k]}")
    if done:
        o = min(done, key=lambda o: o.rid)
        say(f"sample stream (rid {o.rid}):", list(o.tokens[:16]))

    # SLO accounting gates: an admitted request must never miss its
    # deadline on the admission clock, a drain must leave nothing queued,
    # and every non-completed request must carry a classified refusal
    if health["deadline_misses"]:
        raise SystemExit(f"SLO violation: {health['deadline_misses']} "
                         f"admitted request(s) missed their deadline")
    if health["queue_depth"] != 0 or not health["draining"]:
        raise SystemExit("drain left work queued")
    unclassified = [o.rid for o in outs.values()
                    if o.status != "completed" and not o.classified]
    if unclassified:
        raise SystemExit(f"unclassified refusals: rids {unclassified}")

    identical = None
    if check:
        bad = 0
        for o in sorted(done, key=lambda o: o.rid):
            r = next(r for r in reqs if r.rid == o.rid)
            solo = eng.decode(o.bucket, [r],
                              eng.round_tokens(o.bucket, r.n_tokens))
            if tuple(solo[r.rid][:r.n_tokens]) != tuple(o.tokens):
                bad += 1
                say(f"  CHECK FAILED rid {o.rid}: batched stream "
                    f"differs from solo decode")
        identical = len(done) - bad
        say(f"check: {identical}/{len(done)} completed requests "
            f"bit-identical to solo decode")
        if bad:
            raise SystemExit(1)
    return dict(requests=requests, completed=len(done), tokens=ntok,
                wall_s=dt, tokens_per_s=ntok / dt, health=health,
                outcomes=outs, solo_identical=identical)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--no-smoke", dest="smoke", action="store_false")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; refused without a card) or "
                         "cpu")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--tokens", type=int, default=32,
                    help="max tokens per request")
    ap.add_argument("--requests", type=int, default=8,
                    help="synthetic requests to serve")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-queue", type=int, default=16)
    ap.add_argument("--deadline-scale", type=float, default=40.0,
                    help="loose deadlines as multiples of the "
                         "calibrated per-token decode cost")
    ap.add_argument("--tight-frac", type=float, default=0.25,
                    help="fraction of deliberately unmeetable deadlines")
    ap.add_argument("--check", action="store_true",
                    help="re-decode every completed request solo and "
                         "assert the batched stream is bit-identical")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    cache_len = max(args.cache_len, args.tokens)
    buckets = sorted({(max(1, args.batch // 2), cache_len),
                      (args.batch, cache_len)})
    print(f"building decode buckets {buckets} on {args.device} ...")
    eng = ModelDecodeEngine(cfg, buckets, device=args.device,
                            seed=args.seed)
    for b in eng.buckets():
        print(f"  bucket {b}: {eng.token_seconds(b) * 1e3:.2f} ms/token"
              f" + {eng.overhead_seconds(b) * 1e3:.2f} ms/call")
    serve(eng, requests=args.requests, seed=args.seed,
          max_queue=args.max_queue, deadline_scale=args.deadline_scale,
          tight_frac=args.tight_frac, max_tokens=args.tokens,
          check=args.check)


if __name__ == "__main__":
    main()
