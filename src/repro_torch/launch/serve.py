"""Serving launcher: the hardened continuous-batching loop over real model
decode buckets, on one device.

``python -m repro_torch.launch.serve --device cpu --check`` serves the
llama3.2-1b smoke config on the CPU (``--arch`` picks another registered
model: ``gemma2-9b``, ``qwen3-14b``, ``qwen1.5-110b``, ``mamba2-130m``,
whose decode carries a recurrent state in place of a KV cache, the MoE
models ``granite-moe-3b-a800m`` and ``deepseek-v3-671b`` (MLA against its
compressed cache), the hybrid ``jamba-v0.1-52b``, the vision-prefix
``llava-next-mistral-7b`` or the encoder-decoder ``whisper-base``: all
ten architectures; the config is one card's, its ``ep_degree`` the
mesh's model axis, 1 by default); without
``--device`` it runs on the card (and refuses to start without one), and
``--no-smoke`` serves the full-width model, loaded with the weights cast
as they are drawn (:func:`repro_torch.models.load_params`).  Requests are
admitted by the model-priced controller
(:class:`repro_torch.runtime.server.LPFServer`), batched continuously
into ``(batch, cache_len)`` buckets and decoded greedily: on the card
through each bucket's captured step replayed once a token
(:func:`repro_torch.runtime.train_step.build_serve_buckets`), or, once a
bucket is quarantined (``--per-token`` quarantines every bucket), one
eager step per token.

Admission prices are *wall-calibrated* from warm-up decodes per bucket
on the path that serves it, as in the JAX package's
``repro.launch.serve``.  Greedy decode is row-independent and every call
pads its rows to the bucket's batch, so a request's token stream is
bit-identical whether it decodes solo or fully batched, captured or per
token (the same kernels on the same shapes); ``--check`` re-decodes every
completed request solo and verifies exactly that.

``--mesh DxM`` (or ``PxDxM``) serves over a mesh whose devices are
virtual shards on the one device (:mod:`repro_torch.launch.mesh`): each
bucket's batch over the pod and data axes where they divide it, its KV
cache's sequence over the model axis (over every axis where the batch
cannot shard), the MoE experts over the model axis.  ``--devices`` is
the JAX launcher's host-device count; one card has nothing to force, so
it is accepted and not read.  On the CPU: ``python -m
repro_torch.launch.serve --device cpu --mesh 1x2x4 --check``.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from . import one_card_config
from .mesh import VirtualMesh, make_mesh
from ..models.lm import ParamTree, init_caches, load_params
from ..runtime.server import LPFServer, synthetic_requests
from ..runtime.train_step import build_serve_buckets

__all__ = ["ModelDecodeEngine", "serve", "main"]


class ModelDecodeEngine:
    """Decode-engine protocol (see :class:`repro_torch.runtime.server
    .LPFServer`) over real model buckets, sharing one parameter tree in
    the compute dtype, with the JAX engine's two paths:

    * the loop (default): on the card each bucket's step captured once as
      a CUDA graph and replayed once a token (on the CPU the eager loop);
    * the per-token path, once ``quarantine(bucket)`` is called (the
      serve ladder does on a failed decode, ``--per-token`` for every
      bucket): one eager :func:`~repro_torch.models.decode_step` call a
      token, with a host-side position.

    Both give the same stream bit for bit.  ``captures``, ``replays`` and
    ``quarantines`` count graph captures, tokens decoded by a replay and
    quarantine calls.  An encoder-decoder model is fed what the JAX
    engine feeds it: an encoder output of zeros, ``[B, 64, d_model]`` in
    bf16, per bucket.  ``mesh``: each bucket's step over the mesh's
    virtual shards."""

    def __init__(self, cfg, buckets: Sequence[Tuple[int, int]], *,
                 params: Optional[ParamTree] = None, device="cuda",
                 seed: int = 0, calibrate_tokens: int = 4,
                 per_token: bool = False,
                 mesh: Optional[VirtualMesh] = None):
        self._cfg = cfg
        self._steps = build_serve_buckets(cfg, buckets, device=device,
                                          mesh=mesh)
        self.device = next(iter(self._steps.values())).rt.device
        self._params = params if params is not None else load_params(
            seed, cfg, device=self.device)
        self._enc = {b: (torch.zeros(b[0], 64, cfg.d_model,
                                     dtype=torch.bfloat16,
                                     device=self.device),)
                     if cfg.encoder_groups else () for b in self._steps}
        self.quarantined: set = set()
        self.quarantines = 0
        if per_token:
            for b in self.buckets():
                self.quarantine(b)
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
        """Move ``bucket`` to the per-token path."""
        self.quarantined.add(tuple(bucket))
        self.quarantines += 1

    def decode(self, bucket, reqs, n_tokens: int
               ) -> Dict[int, Tuple[int, ...]]:
        toks = self._decode_rows(
            tuple(bucket),
            [r.seed % self._cfg.vocab for r in reqs], n_tokens)
        return {r.rid: toks[i] for i, r in enumerate(reqs)}

    def serve_step(self, bucket):
        """The bucket's :class:`~repro_torch.runtime.train_step.ServeStep`
        (its eager step and, on the card, its captured step)."""
        return self._steps[tuple(bucket)]

    @property
    def captures(self) -> int:
        return sum(s.graph.captures for s in self._steps.values()
                   if s.graph is not None)

    @property
    def replays(self) -> int:
        return sum(s.graph.replays for s in self._steps.values()
                   if s.graph is not None)

    # -- internals -------------------------------------------------------
    def _decode_rows(self, bucket, seed_toks, n_tokens: int):
        """Decode ``n_tokens`` greedy tokens for rows seeded with
        ``seed_toks`` (one prompt token each); rows beyond the request
        count pad with token 0.  Returns per-row token tuples."""
        B, C = bucket
        ss = self._steps[bucket]
        row = [int(s) for s in seed_toks] + [0] * (B - len(seed_toks))
        tok = torch.tensor(row, dtype=torch.long, device=self.device)
        extra = self._enc[bucket]
        if bucket in self.quarantined:
            caches = init_caches(self._cfg, B, C, device=self.device)
            seq = []
            for pos in range(n_tokens):
                tok, caches = ss.step_fn(self._params, caches, tok, pos,
                                         *extra)
                seq.append(tok)
            out = torch.stack(seq)
        else:
            out, _caches = ss.decode_fn(n_tokens)(self._params, tok, 0,
                                                  *extra)
        out = out.cpu()                          # [T, B]; waits for the device
        return [tuple(int(t) for t in out[:, i]) for i in range(B)]

    def _calibrate(self, n_tokens: int) -> None:
        """Wall-calibrate the admission price per bucket on the path that
        serves it: a warm-up decode of each length (on the card the first
        captures the bucket's step), then one 1-token and one ``n``-token
        decode — the slope is the per-token price, the intercept the
        per-call overhead."""
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
    completed stream is bit-identical to a solo re-decode on the path that
    served it and, where that was the loop, to a solo re-decode on the
    per-token path.  Raises ``SystemExit`` on a violation; returns the
    run's summary (``quarantines``: the engine's quarantine calls during
    the run, before the check)."""
    say = print if verbose else (lambda *a, **k: None)
    buckets = list(eng.buckets())
    quarantines0 = eng.quarantines
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

    quarantines = eng.quarantines - quarantines0
    identical = per_token_identical = None
    if check:
        def solo_mismatches(path: str) -> int:
            bad = 0
            for o in sorted(done, key=lambda o: o.rid):
                r = next(r for r in reqs if r.rid == o.rid)
                solo = eng.decode(o.bucket, [r],
                                  eng.round_tokens(o.bucket, r.n_tokens))
                if tuple(solo[r.rid][:r.n_tokens]) != tuple(o.tokens):
                    bad += 1
                    say(f"  CHECK FAILED rid {o.rid}: batched stream "
                        f"differs from its solo decode {path}")
            return bad

        bad = solo_mismatches("")
        identical = len(done) - bad
        say(f"check: {identical}/{len(done)} completed requests "
            f"bit-identical to solo decode")
        if any(o.bucket not in eng.quarantined for o in done):
            # the same requests through the per-token path
            held = set(eng.quarantined)
            eng.quarantined.update(eng.buckets())
            try:
                bad_pt = solo_mismatches("on the per-token path")
            finally:
                eng.quarantined.clear()
                eng.quarantined.update(held)
            per_token_identical = len(done) - bad_pt
            say(f"check: {per_token_identical}/{len(done)} completed "
                f"requests bit-identical to solo per-token decode")
            bad += bad_pt
        if bad:
            raise SystemExit(1)
    return dict(requests=requests, completed=len(done), tokens=ntok,
                wall_s=dt, tokens_per_s=ntok / dt, health=health,
                outcomes=outs, solo_identical=identical,
                per_token_identical=per_token_identical,
                quarantines=quarantines)


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
    ap.add_argument("--mesh", default="1x1",
                    help="DxM (data x model), or PxDxM for multi-pod: "
                         "virtual shards on the one device")
    ap.add_argument("--devices", type=int, default=0,
                    help="the JAX launcher's host-device count; one card "
                         "has nothing to force, so it is not read")
    ap.add_argument("--requests", type=int, default=8,
                    help="synthetic requests to serve")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-queue", type=int, default=16)
    ap.add_argument("--deadline-scale", type=float, default=40.0,
                    help="loose deadlines as multiples of the "
                         "calibrated per-token decode cost")
    ap.add_argument("--tight-frac", type=float, default=0.25,
                    help="fraction of deliberately unmeetable deadlines")
    ap.add_argument("--per-token", action="store_true",
                    help="quarantine every bucket: one eager decode step "
                         "a token (the fallback path) instead of the "
                         "captured loop")
    ap.add_argument("--check", action="store_true",
                    help="re-decode every completed request solo and "
                         "assert the batched stream is bit-identical")
    args = ap.parse_args(argv)

    mesh = make_mesh(tuple(int(x) for x in args.mesh.split("x")))
    model = mesh.shape.get("model", 1)
    # a model axis pads the experts to a multiple of its size
    cfg = one_card_config(args.arch, args.smoke, model)
    cache_len = max(args.cache_len, args.tokens)
    buckets = sorted({(max(1, args.batch // 2), cache_len),
                      (args.batch, cache_len)})
    print(f"building decode buckets {buckets} on {args.device}, mesh "
          f"{mesh.shape} ...")
    eng = ModelDecodeEngine(cfg, buckets, device=args.device,
                            seed=args.seed, per_token=args.per_token,
                            mesh=mesh)
    path = "per token" if args.per_token else (
        "captured" if eng.device.type == "cuda" else "eager loop")
    for b in eng.buckets():
        rt = eng.serve_step(b).rt
        print(f"  bucket {b} ({path}): {eng.token_seconds(b) * 1e3:.2f} "
              f"ms/token + {eng.overhead_seconds(b) * 1e3:.2f} ms/call; "
              f"batch axes {rt.dp_axes}, sequence axes {rt.seq_axes}")
    return serve(eng, requests=args.requests, seed=args.seed,
          max_queue=args.max_queue, deadline_scale=args.deadline_scale,
          tight_frac=args.tight_frac, max_tokens=args.tokens,
          check=args.check)


if __name__ == "__main__":
    main()
