#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.  Run from the repository root with no arguments:

    python3 chip_smoke.py

It fails (nonzero exit, no result line) without a CUDA device, outside a
checkout of the repository, or when any check below fails; no phase's
failure is caught.  Phases:

1. the card's name and power limit (``nvidia-smi``);
2. build of every CUDA kernel from ``src/repro_torch/csrc`` (``nvcc``,
   ``sm_90a``), with the compiler's register/spill report;
3. each kernel against its plain PyTorch version on the card, forward and
   inverse, at the JAX package's test shapes and at the main path's shape:
   relative error, kernel / plain / ``torch.fft`` milliseconds (median of
   25 runs after warm-up, CUDA events);
4. the README quickstart (a one-superstep shift) through ``exec_`` at
   p = 8: values and ledger;
5. the main path: ``bsp_fft`` at N = 2^24 complex64 over p = 8 virtual
   processes with ``use_kernel=True``, ordered and unordered, forward then
   inverse: error against ``np.fft`` (complex128), the inverse round trip,
   the ledger (``fft.redistribute``/``fft.reorder``, ``fused``, 1 round,
   ``h_bytes == fft_h_bytes``) and the kernel's launch count on that run;
   then the end-to-end time with its programs (redistribute, reorder)
   compiled — each times its eager calls against its CUDA-graph replays
   and keeps the faster, and each way's time and the choice are printed
   — beside the same calls dispatched superstep by superstep
   (``LPF_COMPILE_PROGRAMS=0``), whose result must be bit-equal; no
   program may be quarantined, each must have replayed in its timed
   calls, and the device memory the program cache held is printed;
6. the fit of the virtual-process link's (g, l) from timed total
   exchanges of growing h (T(h) = g*h + l, the paper's Table-3
   estimators: g from the two ends of the sweep, l from the smallest);
7. a ``{"kernels": [...]}`` line, the card line again, and the final
   ``{"ok": true, "device": ...}`` line.

The llama3.2-1b serving path (random weights from ``SEED``, compute in
bf16) adds, between phases 6 and 7:

(a) the build of phase 2 covers ``flash_attention_fwd`` too (both sources
    compile in parallel, each with its ``-Xptxas -v`` report); each bf16
    forward's registers, spills, shared memory and whether ptxas
    serialised its wgmma (``build`` in (b)'s rows and the ``kernels`` line);
(b) ``flash_attention_fwd`` against its plain version on the card at the
    JAX kernel tests' seven shapes, the prefill's main shape
    [4, 32, 2048, 64] bf16, causal, Hkv 8, and gemma2-9b's attention at
    head dim 256, [1, 16, 8, 8192, 256] bf16 causal, as a local layer
    (window 4096, soft-cap 50) and as a global layer without them: o within
    2e-5 (f32) / 2e-2 (bf16), and in bf16 also each row's error within
    2^-6 of the row's largest |o_plain| (two bf16 ulps); lse within 1e-4;
    in bf16 the kernel against a plain version that rounds P to bf16 as
    the kernel does, beside the f32-P one (the kernel's exp is
    ``ex2.approx``: these errors include it); kernel, plain and SDPA
    milliseconds and the bound (SDPA is timed beside the kernel only; the
    port never calls it);
(c) prefill at full width (B 4, S 2048, ``attn_impl="flash"``): 16 kernel
    launches, last-position logits within 2e-2 (relative) of the same
    prefill with ``attn_impl="reference"``; host milliseconds and tokens/s;
(d) teacher-forced decode at full width (B 1): 64 ``decode_step`` calls
    against ``prefill`` of the 64-token prompt, and a 96-token prompt
    through a 64-slot rolling cache against prefill with window 65, each
    within 0.08 (relative);
(e) serving at full width: ``ModelDecodeEngine`` buckets (2, 256) and
    (4, 256) behind ``LPFServer``, 8 ``synthetic_requests`` (seed 0, at
    most 32 tokens): no deadline miss, an empty queue after the drain,
    every refusal classified, every completed stream bit-identical to a
    solo re-decode; ms per token of each bucket and tokens/s;
(f) last, ``torch.profiler`` over one prefill and one decode step:
    device time by kernel family, kernel launches, and the device's idle
    share.

The llama3.2-1b training path (f32 masters, bf16 compute, ``remat="full"``,
``attn_impl="flash"``) adds, after (f):

(g) the build of phase 2 covers ``flash_attention_bwd`` too; its two
    kernels (``flash_attention_bwd_dkv``, ``flash_attention_bwd_dq``)
    against the plain ``flash_attention_bwd_ref`` on the card at the same
    eight shapes (the training path's [4, 32, 2048, 64] bf16 causal, Hkv 8
    among them) and at head dim 256, [1, 16, 8, 4096, 256] bf16 causal: in
    f32 each gradient within 5e-4 of the largest plain one (the
    JAX backward test's bar); in bf16 each row of dq, dk, dv within 2^-6 of
    the row's largest |plain| (``grad_row_err``), also against the plain
    version with ``round_p=True``; each kernel's milliseconds, the pair's
    sum and, beside it, the wrapper's ``delta = rowsum(dO * o)`` (SDPA's
    backward computes its own inside the call it is timed by), the plain
    version's and SDPA's backward (timed beside the kernels only; the port
    never calls it; at the training shape the kernels that one profiled
    SDPA backward call launched are named), each kernel's bound, and each
    bf16 kernel's registers, spills and shared memory (``-Xptxas -v`` and
    the dynamic bytes its launch requests);
(h) training at full width: ``train_loop`` over ``build_train_step`` with
    AdamW (lr ``warmup_cosine(3e-3, 10, steps)``) on ``SyntheticStream``
    seed 0 at B 4 x S 2048 for ``TRAIN_STEPS`` steps: every loss finite,
    the step-0 loss within 1e-2 (relative) of ``loss_fn`` with
    ``attn_impl="reference"`` on the same batch and parameters, per step
    exactly 16 ``flash_attention_bwd_dkv`` and 16 ``flash_attention_bwd_dq``
    launches and 32 ``flash_attention_fwd`` launches (16 in the forward,
    16 in ``torch.utils.checkpoint``'s recompute); then at B 1 x S 2048 the
    flash model's gradients against the reference-attention model's, per
    leaf and as a global norm (``GRAD_BARS``); step milliseconds (host
    clock, median after ``TRAIN_WARMUP`` steps), tokens/s, model TFLOP/s
    (6 N D per step; the remat recompute is not counted) and the peak
    device memory, then the memory allocated at each stage of one more
    step (``step_memory``); last, the loss witness: ``WITNESS_STEPS``
    steps at B 1 of the flash and the reference-attention model under the
    same schedule, their losses within ``WITNESS_BAR`` of each other, and
    the flash model at B 4 under a 3e-4 peak, whose last loss must fall
    below the initial weights' loss on the same batch;
(i) last, ``torch.profiler`` over one training step: device time by
    kernel family, launches, and the device's idle share.

The mamba2-130m serving path (the published width, uncut, random weights
from ``SEED``, f32 parameters cast once to bf16 compute) adds, after (i):

(j) the build of phase 2 covers ``ssd_scan`` too (its four passes, each
    with its ``-Xptxas -v`` registers, spills and shared memory); the
    kernel against its plain version ``ssd_scan_plain`` on the card at the
    JAX kernel tests' four shapes, a ragged S (200, chunk 64), the
    prefill's main shape [4, 2048, 24, 64], G 1, N 128, chunk 128, in bf16
    and in f32 (the model hands the kernel f32), and the long prefill's
    [1, 16384, 24, 64] in f32: y and the final state within 1e-4 of the
    plain version's largest |value| (the JAX bar); in bf16 y is held
    against the plain version's f32 y within 1e-4 of its largest |value|
    plus half a bf16 ulp of each value (the output's rounding); each
    pass's scratch (cum, C B^T, the state entering each chunk) within 1e-4
    of ``ssd_scan_passes``; 4 CUDA launches a call; kernel, plain and
    ``_ssd_chunked`` (the JAX model's default path, batched einsums)
    milliseconds, the bound at the fastest split known to hold the bar
    (bf16 tensor cores), and for the record at the kernel's own split-TF32
    rate and at the f32 FMA rate;
(k) prefill at full width, B 4 x S 2048: exactly 24 ``ssd_scan`` calls (96
    CUDA launches) and no flash-attention launch; last-position logits
    against the same prefill through ``impl="chunked"`` (run on the card
    as a check only): within 2e-2 (relative) in f32 compute, and in bf16
    within 2e-2 or, where the chunked path's own spread (chunk 64 against
    128) is wider, twice that spread: the random model amplifies bf16
    rounding through its 24 layers; host milliseconds and tokens/s, the
    profile by kernel family with the device's idle share; then a B 1 x
    S 16384 prefill (128 chunks a call), timed and profiled, with its 24
    calls;
(l) teacher-forced decode over 64 tokens at B 1 against prefill: within
    0.08 in f32 compute, and in bf16 within 0.08 or, where the chunked
    path's own spread (chunk 16 against 64) is wider, twice that spread;
    serving behind ``LPFServer`` (buckets (2, 256) and (4, 256), 8
    requests): no deadline miss, an empty queue, streams bit-identical to
    solo re-decodes; ms per token per bucket, tokens/s, and the idle share
    of one decode step.

The BSP layer and the paper's second evaluation add, after (l), under
phase 6's fitted (g, l) of the ``"vp"`` link:

(m) every BSP collective through ``exec_`` at p = 8 on f32 data of
    2^22 elements a process (128 MiB stacked): allgather, alltoall,
    broadcast, reduce, allreduce (also with ``method="direct"``,
    ``"bruck"`` and ``"valiant"`` with a provisioned scratch, and on the
    int8 wire), exscan, and max/min allreduces of int32 data; then the
    allreduce at 2^25 (1 GiB stacked).  Each against a plain torch
    computation on the card (bit-equal for int32 and for the collectives
    that move data without summing it, 1e-6 relative for f32 sums, 0.05
    on the int8 wire), each ledger's methods and rounds (Bruck 3 rounds,
    Valiant 15, twice); CUDA-event and host milliseconds, the ledger's
    ``h_bytes``, wire bytes and predicted milliseconds, and measured over
    predicted (the paper's model compliance, on this card); every
    collective's programs flush through the program cache, compiled
    (each choosing eager calls or graph replay by their times, no key
    quarantined, every one replayed in its timed calls);
(n) PageRank (paper §4.3) on ``rmat_graph(2^22, 16 * 2^22, seed=1)``
    (Graph500's R-MAT parameters and edge factor) over p = 8 through
    ``lpf_pagerank`` at the JAX package's defaults (alpha 0.85, tol 1e-7,
    max_iter 200), and again through ``hook`` from a host function that
    holds the shards on the card (the paper's Algorithm 3): ranks within
    1e-3 (relative to the largest) of the float64 oracle, rank mass 1
    within 1e-4, the hooked run's ranks and iterations equal to the first
    run's bit for bit (the segment sum is deterministic), the ledger
    ``pr.init.rs``/``.ag``, ``pr.halo`` (``direct``,
    ``h_bytes == g.h_bytes()``), ``pr.reduce.rs``/``.ag``; the host build
    time of the graph, iterations and residual, the hooked run's
    milliseconds, one iteration's (median of 10) against its predicted
    communication, its ``torch.profiler`` breakdown and idle share, and
    ``dataflow_pagerank``'s ms an iteration on the same card (CUDA
    events, 25 iterations less 5, the edges on the card).  The loop's
    body runs as a CUDA graph from its second iteration: the ranks and
    iterations bit-equal to the same run with everything eager
    (``LPF_COMPILE_PROGRAMS=0``), the hooked run's context counting one
    replay an iteration after the first and no fallback, and the
    captured and the eager loop's ms an iteration (the median gap between
    host reads of the loop's condition, one an iteration, over 40
    iterations) and idle share (one profiled 12-iteration loop: the
    union of its kernels' intervals over the host wall of the same
    window, from the read before the third iteration to the last).  The
    program cache is kept across (m), (n) and (o); the device memory it
    holds and the peak above the memory before (m) are printed at the
    end;
(o) the program optimizer, its certificate and compiled replay, on the
    JAX package's canned traces at p = 8, int32, priced with phase 6's
    fit: 8 DDP buckets of 16 MiB a process, two FFT redistribute + reorder
    pairs of 8 MiB, the fragmented trace, the PageRank shape with a 2 MiB
    halo.  Each trace runs through a context (``bind_trace``) as one
    recorded program, dispatched and compiled (a CUDA graph): the
    context's schedule and signature equal ``optimize_program`` and
    ``program_signature`` of the trace on the host, its certificate
    passes, the values are bit-equal to recorded order (one eager
    superstep a step), after the capture and after the timed replays too,
    and the ledger is ``ledger_costs``; predicted ms of the searched
    schedule, the peephole and recorded order; CUDA-event ms end to end
    (recording and flush) and of the schedule alone, medians of 10, the
    compiled program's after it chose; its timed eager calls and graph
    replays (host ms, the fastest of each) and its choice; measured over
    predicted; the cache holds one program and, compiled, one artifact
    that replayed, nothing quarantined; the bytes a replay copies in and
    out and the device memory the cache held.  Neither (m), (n) nor (o)
    launches a kernel of ``csrc/``: the ``kernels`` line keeps its five
    rows.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
N_MAIN = 1 << 24          # BSP FFT length on the main path
P_MAIN = 8                # virtual processes
# the JAX kernel tests' shapes, the last one-pass row (2^12), the first
# two-pass row (2^13), the main path's rows, the first three-pass row (2^23)
KERNEL_SHAPES = [(1, 64), (4, 256), (8, 1024), (3, 4096), (2, 1 << 12),
                 (2, 1 << 13), (P_MAIN, N_MAIN // P_MAIN), (1, 1 << 23)]
# data-sheet peaks of one H100 SXM (at its 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12

ARCH = "llama3.2-1b"
PREFILL_B, PREFILL_S = 4, 2048          # the serving path's prefill
TEACHER_S, ROLL_S, ROLL_C = 64, 96, 64  # phase (d) prompts and cache
SERVE_BUCKETS = [(2, 256), (4, 256)]
# the JAX kernel tests' sweep (tests/test_kernels.py), then the prefill's
# main shape; B, H, Hkv, S, D, causal, window, softcap, dtype
FLASH_SHAPES = [
    (1, 2, 2, 128, 64, True, None, None, "float32"),
    (2, 4, 2, 256, 64, True, None, None, "float32"),
    (1, 4, 1, 128, 128, False, None, None, "float32"),
    (1, 2, 2, 256, 64, True, 64, None, "float32"),
    (1, 2, 2, 128, 64, True, None, 30.0, "float32"),
    (1, 2, 1, 192, 64, True, None, None, "float32"),
    (1, 2, 2, 128, 64, True, None, None, "bfloat16"),
    (PREFILL_B, 32, 8, PREFILL_S, 64, True, None, None, "bfloat16"),
]
# gemma2-9b's attention at head dim 256 (src/repro/configs/gemma2_9b.py:
# 16 heads over 8 kv, window 4096 on local layers, attention soft-cap 50),
# one sequence of 8192: a local layer, and a global layer without window
# and soft-cap so that SDPA computes the same function beside it
GEMMA_FWD_SHAPES = [
    (1, 16, 8, 8192, 256, True, 4096, 50.0, "bfloat16"),
    (1, 16, 8, 8192, 256, True, None, None, "bfloat16"),
]
# (g) adds a head-dim-256 backward shape, without window and soft-cap so
# that SDPA's backward computes the same gradients beside it
GEMMA_BWD_SHAPES = [(1, 16, 8, 4096, 256, True, None, None, "bfloat16")]
# the main path's shapes: the prefill (b) and the training step (g)
MAIN_FWD_SHAPE = [PREFILL_B, 32, 8, PREFILL_S, 64]
# bf16 o row by row: |o - o_plain| within 2^-6 of the row's largest
# |o_plain|, two bf16 ulps of it (rounding o gives one, rounding P less)
BF16_ROW_BAR = 2.0 ** -6
# the training path (h): B 4 x S 2048, TRAIN_STEPS steps, the first
# TRAIN_WARMUP left out of the step time
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_WARMUP = 4, 2048, 8, 2
MAIN_BWD_SHAPE = [TRAIN_B, 32, 8, TRAIN_S, 64]
# (h) at B 1 x S 2048: the flash model's gradients against the
# reference-attention model's, bf16 compute.  On the CPU at the smoke
# config (2 layers, S 256 and 1024, seeds 0 and 1) the largest per-leaf
# max|g_f - g_r| / max|g_r| was 1.1e-2, the global norms differed by
# 1.4e-4 and |g_f - g_r| / |g_r| was 6.5e-3; the bars leave room for 16
# layers: per leaf the JAX package's bf16 bar 0.08, the norm 1e-2, the
# difference 0.05
GRAD_BARS = dict(leaf=0.08, norm=1e-2, diff=0.05)
# the mamba2-130m path (j)-(l): the JAX kernel tests' sweep, a ragged S,
# then the prefill's main shape in bf16 and in f32, the dtype the bf16
# model hands the kernel, and the long prefill's; B, S, H, P, G, N, chunk,
# dtype
MAMBA_ARCH = "mamba2-130m"
LONG_S = 16384                          # (k)'s B 1 long-sequence prefill
SSD_SHAPES = [
    (1, 64, 2, 16, 1, 16, 16, "float32"),
    (2, 128, 4, 32, 2, 32, 32, "float32"),
    (1, 256, 2, 16, 1, 64, 64, "float32"),
    (1, 128, 4, 16, 1, 16, 128, "float32"),
    (1, 200, 2, 16, 1, 16, 64, "float32"),
    (PREFILL_B, PREFILL_S, 24, 64, 1, 128, 128, "bfloat16"),
    (PREFILL_B, PREFILL_S, 24, 64, 1, 128, 128, "float32"),
    (1, LONG_S, 24, 64, 1, 128, 128, "float32"),
]
MAIN_SSD_SHAPE = [PREFILL_B, PREFILL_S, 24, 64, 1, 128]
SSD_BAR = 1e-4
# the fastest arithmetic known to hold SSD_BAR for the SSD scan's products:
# bf16 tensor cores (BF16_FLOPS) over the products a split of each f32
# operand into two bf16 parts needs (f32 operands 3, one bf16 operand 2, C
# B^T of bf16 1); ``ref.split_bf16_mm`` through the passes holds the bar
# (tests/test_torch_ssd.py)
SSD_SPLIT_PRODUCTS = {4: (3, 3), 2: (1, 2)}   # itemsize: (C B^T, the rest)
# (h)'s loss witness: WITNESS_STEPS steps at B 1 x S 2048 of the flash and
# the reference-attention model under (h)'s schedule; each step's losses
# within WITNESS_BAR (relative) of each other, the step-0 bar's 1e-2
# widened for the steps' bf16 differences compounding through AdamW
WITNESS_STEPS, WITNESS_BAR = 4, 5e-2


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"CHECK FAILED: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median device milliseconds of ``fn()`` (CUDA events per run)."""
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


def host_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    """Median host milliseconds of ``fn()`` ending in a synchronize."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def complex_input(rng, shape) -> np.ndarray:
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def fft_bound_ms(batch: int, n: int) -> tuple:
    """Least time for a batched complex64 FFT: read and write every value
    once, or do 5 n log2 n fp32 flops per row, whichever is longer."""
    t_bytes = 2 * batch * n * 8 / HBM_BYTES_PER_S
    t_ops = batch * 5.0 * n * math.log2(n) / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def flash_bound_ms(B, H, Hkv, S, D, causal, window, itemsize) -> tuple:
    """Least time for flash attention on these inputs: q, k, v read and
    o, lse written once, or the two products over the (q, k) pairs the
    masks keep (4 D flops per pair) at the dtype's peak."""
    q = np.arange(S)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(S, int)
    hi = q + 1 if causal else np.full(S, S)
    pairs = float(np.sum(hi - lo))
    t_ops = 4.0 * B * H * D * pairs / (BF16_FLOPS if itemsize == 2
                                       else FP32_FLOPS)
    nbytes = (2 * B * H * S * D + 2 * B * Hkv * S * D) * itemsize \
        + B * H * S * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def row_err(o, o_p) -> float:
    """Largest |o - o_p| over its row's largest |o_p| (rows along D)."""
    o, o_p = o.float(), o_p.float()
    rmax = o_p.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    return ((o - o_p).abs() / rmax).max().item()


def flash_phase(rng, dev, build_log: str,
                shapes=FLASH_SHAPES + GEMMA_FWD_SHAPES) -> list:
    """(b): the CUDA kernel against its plain version at every shape."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    smem = build.load("flash_attention_fwd").flash_attention_fwd_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
    rows = []
    for B, H, Hkv, S, D, causal, window, softcap, dt in shapes:
        dtype = getattr(torch, dt)
        q, k, v = (torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(dev, dtype)
            for shape in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D)))
        kw = dict(causal=causal, window=window, softcap=softcap)
        o, lse = fa_kernel.flash_attention_fwd(q, k, v, **kw)
        o_p, lse_p = fa_ref.flash_attention_fwd_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (o.float() - o_p.float()).abs().max().item()
        lse_err = (lse - lse_p).abs().max().item()
        bar = 2e-5 if dt == "float32" else 2e-2
        bf16 = {}
        if dt == "bfloat16":
            # the kernel rounds P to bf16 before P V; the plain version
            # keeps it in f32 as the TPU kernel does.  The P-rounded plain
            # version shows that rounding's share of the error.
            o_r, _ = fa_ref.flash_attention_fwd_ref(q, k, v, round_p=True,
                                                    **kw)
            bf16 = dict(row_err=row_err(o, o_p),
                        round_p_shift=(o_r.float() - o_p.float()).abs()
                        .max().item(),
                        err_vs_round_p=(o.float() - o_r.float()).abs()
                        .max().item(),
                        row_err_vs_round_p=row_err(o, o_r))
            del o_r
        bound_ms, bound_by = flash_bound_ms(B, H, Hkv, S, D, causal, window,
                                            q.element_size())
        library_ms = None
        if window is None and softcap is None:
            # SDPA computes the same function only without window/softcap
            library_ms = cuda_ms(lambda: sdpa(q, k, v, is_causal=causal,
                                              enable_gqa=H != Hkv))
        row = dict(shape=[B, H, Hkv, S, D], causal=causal, window=window,
                   softcap=softcap, dtype=dt, max_abs_err=err,
                   lse_err=lse_err, bar=bar, **bf16,
                   ms=cuda_ms(lambda: fa_kernel.flash_attention_fwd(
                       q, k, v, **kw)),
                   plain_ms=cuda_ms(lambda: fa_ref.flash_attention_fwd_ref(
                       q, k, v, **kw), reps=5, warmup=1),
                   library_ms=library_ms, bound_ms=bound_ms,
                   bound_by=bound_by)
        if dt == "bfloat16":
            row["build"] = kernel_build_report(
                build_log, f"fa_fwd_bf16ILi{D}E", smem(D))
        rows.append(row)
        print("flash_attention_fwd " + json.dumps(row), flush=True)
        check(err < bar, f"flash_attention_fwd {row['shape']} {dt}: o err "
                         f"{err} >= {bar}")
        check(lse_err < 1e-4, f"flash_attention_fwd {row['shape']} {dt}: "
                              f"lse err {lse_err}")
        check(bf16.get("row_err", 0.0) <= BF16_ROW_BAR,
              f"flash_attention_fwd {row['shape']} {dt}: row error "
              f"{bf16.get('row_err')} > 2^-6 of the row's largest |o|")
        del q, k, v, o, lse, o_p, lse_p
    torch.cuda.empty_cache()
    return rows


def rel_err(a, ref) -> float:
    a, ref = a.float(), ref.float()
    return ((a - ref).abs().max() / ref.abs().max()).item()


def grad_row_err(a, ref) -> float:
    """Largest |a - ref| over its row's largest |ref| (rows along D), the
    row's scale floored at 1e-3 of the tensor's largest |ref|: a row whose
    gradient cancels to about 0 (the first query under the causal mask has
    dS = P (dP - delta) = 0) holds only rounding."""
    a, ref = a.float(), ref.float()
    scale = ref.abs().amax(dim=-1, keepdim=True).clamp_min(
        1e-3 * ref.abs().max().item())
    return ((a - ref).abs() / scale).max().item()


def kept_pairs(S, causal, window) -> float:
    """The (q, k) pairs the masks keep in one [S, S] score square."""
    q = np.arange(S)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(S, int)
    hi = q + 1 if causal else np.full(S, S)
    return float(np.sum(hi - lo))


def flash_bwd_bound_ms(B, H, Hkv, S, D, causal, window, itemsize) -> dict:
    """Least time of each backward kernel on these inputs: its products
    over the kept (q, k) pairs at the dtype's peak (dK/dV: S^T, dP^T, dV,
    dK, 8 D flops a pair; dQ: S, dP, dQ, 6 D), or its bytes at the memory
    rate (q, k, v, dO, lse and delta read once; dk and dv, or dq, written
    once), whichever is longer."""
    peak = BF16_FLOPS if itemsize == 2 else FP32_FLOPS
    pairs = B * H * kept_pairs(S, causal, window)
    ins = (2 * B * H * S * D + 2 * B * Hkv * S * D) * itemsize \
        + 2 * B * H * S * 4
    out = {}
    for name, flops, written in (
            ("flash_attention_bwd_dkv", 8.0 * D * pairs,
             2 * B * Hkv * S * D * itemsize),
            ("flash_attention_bwd_dq", 6.0 * D * pairs,
             B * H * S * D * itemsize)):
        t_ops, t_bytes = flops / peak, (ins + written) / HBM_BYTES_PER_S
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def kernel_build_report(log: str, marker: str, smem_dynamic: int) -> dict:
    """Registers, spills and shared memory of the kernel whose mangled name
    holds ``marker``, from an ``nvcc -Xptxas -v`` log, beside the dynamic
    shared memory its launch requests."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        if name is None or marker not in name:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out["spill_store_bytes"], out["spill_load_bytes"] = map(
                int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out["smem_static_bytes"] = int(m.group(1)) if m else 0
    check("registers" in out, f"no ptxas report for {marker}")
    out["smem_dynamic_bytes"] = smem_dynamic
    # ptxas's "wgmma.mma_async instructions are serialized" warning names
    # the function it found that in
    out["wgmma_serialized"] = any(
        "serialized" in line and marker in line for line in log.splitlines())
    return out


def device_kernels(run) -> list:
    """Names of the CUDA kernels one call of ``run`` launches (every
    device event the profiler recorded, whether or not it carries time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def flash_bwd_phase(rng, dev, build_log: str,
                    shapes=FLASH_SHAPES + GEMMA_BWD_SHAPES) -> list:
    """(g): the two backward kernels against their plain version."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    smem = build.load("flash_attention_bwd").flash_attention_bwd_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    rows = []
    for B, H, Hkv, S, D, causal, window, softcap, dt in shapes:
        dtype = getattr(torch, dt)
        q, k, v, do = (torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(dev, dtype)
            for shape in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D),
                          (B, H, S, D)))
        kw = dict(causal=causal, window=window, softcap=softcap)
        o, lse = fa_ref.flash_attention_fwd_ref(q, k, v, **kw)
        got = fa_kernel.flash_attention_bwd(q, k, v, o, do, lse, **kw)
        want = fa_ref.flash_attention_bwd_ref(q, k, v, o, do, lse, **kw)
        torch.cuda.synchronize()
        names = ("dq", "dk", "dv")
        err = {n: (a.float() - b.float()).abs().max().item()
               for n, a, b in zip(names, got, want)}
        row = dict(shape=[B, H, Hkv, S, D], causal=causal, window=window,
                   softcap=softcap, dtype=dt, max_abs_err=err)
        if dt == "float32":
            row["rel_err"] = {n: rel_err(a, b)
                              for n, a, b in zip(names, got, want)}
            bad = {n: e for n, e in row["rel_err"].items() if e >= 5e-4}
        else:
            # the kernels round P and dS to bf16 before their products;
            # the plain version with round_p=True does the same
            want_r = fa_ref.flash_attention_bwd_ref(q, k, v, o, do, lse,
                                                    round_p=True, **kw)
            row["row_err"] = {n: grad_row_err(a, b)
                              for n, a, b in zip(names, got, want)}
            row["row_err_vs_round_p"] = {
                n: grad_row_err(a, b) for n, a, b in zip(names, got, want_r)}
            row["round_p_shift"] = {
                n: (a.float() - b.float()).abs().max().item()
                for n, a, b in zip(names, want_r, want)}
            del want_r
            bad = {n: e for n, e in {**row["row_err"], **{
                f"{n} vs round_p": e for n, e in
                row["row_err_vs_round_p"].items()}}.items()
                if e > BF16_ROW_BAR}
        del got, want
        # the wrapper's delta (kernel.py's flash_attention_bwd), timed: SDPA's
        # backward does its own such pass inside the call it is timed by
        delta = (do.float() * o.float()).sum(dim=-1)
        row["delta_ms"] = cuda_ms(lambda: (do.float() * o.float()).sum(
            dim=-1))
        row["ms"] = {
            "flash_attention_bwd_dkv": cuda_ms(
                lambda: fa_kernel.flash_attention_bwd_dkv(
                    q, k, v, do, lse, delta, **kw)),
            "flash_attention_bwd_dq": cuda_ms(
                lambda: fa_kernel.flash_attention_bwd_dq(
                    q, k, v, do, lse, delta, **kw))}
        row["pair_ms"] = sum(row["ms"].values())
        row["pair_plus_delta_ms"] = row["pair_ms"] + row["delta_ms"]
        # the plain version computes dq, dk and dv in one call
        row["plain_ms"] = cuda_ms(lambda: fa_ref.flash_attention_bwd_ref(
            q, k, v, o, do, lse, **kw), reps=5, warmup=1)
        row["library_ms"] = None
        if window is None and softcap is None:
            # SDPA's backward computes the same (dq, dk, dv) only without
            # window/softcap; one autograd call for both kernels' work
            xs = [x.detach().requires_grad_() for x in (q, k, v)]
            o_lib = sdpa(*xs, is_causal=causal, enable_gqa=H != Hkv)
            sdpa_bwd = lambda: torch.autograd.grad(o_lib, xs, do,
                                                   retain_graph=True)
            row["library_ms"] = cuda_ms(sdpa_bwd)
            if [B, H, Hkv, S, D] == MAIN_BWD_SHAPE:
                # the yardstick's backend: the kernels one call launched
                row["library_kernels"] = device_kernels(sdpa_bwd)
            del xs, o_lib
        row["bound"] = flash_bwd_bound_ms(B, H, Hkv, S, D, causal, window,
                                          q.element_size())
        if dt == "bfloat16":
            row["build"] = {name: kernel_build_report(
                build_log, f"{fn}ILi{D}E", smem(pass_, D))
                for name, fn, pass_ in (
                    ("flash_attention_bwd_dkv", "fa_bwd_dkv_bf16", 0),
                    ("flash_attention_bwd_dq", "fa_bwd_dq_bf16", 1))}
        rows.append(row)
        print("flash_attention_bwd " + json.dumps(row), flush=True)
        check(not bad, f"flash_attention_bwd {row['shape']} {dt}: over the "
                       f"bar: {bad}")
        del q, k, v, do, o, lse, delta
    torch.cuda.empty_cache()
    return rows


def train_phases(dev) -> dict:
    """(h)-(i): llama3.2-1b training at full width."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.models import count_params, loss_fn, model_flops
    from repro_torch.optim import AdamWConfig, global_norm, warmup_cosine
    from repro_torch.runtime.train_loop import TrainLoopConfig, train_loop
    from repro_torch.runtime.train_step import build_train_step

    cfg = dataclasses.replace(get_config(ARCH), attn_impl="flash")
    ref_cfg = dataclasses.replace(cfg, attn_impl="reference")
    check(cfg.remat == "full" and cfg.param_dtype == "float32"
          and cfg.compute_dtype == "bfloat16", "training config")
    ts = build_train_step(cfg, opt_cfg=AdamWConfig(
        lr=warmup_cosine(3e-3, 10, TRAIN_STEPS)), device=dev)
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                                        global_batch=TRAIN_B, seed=0))
    out = {}

    # the reference-attention loss of step 0's batch at the initial weights
    # (train_loop starts from the same seed-0 parameters), and the flash
    # model's loss at those weights on each step's batch, the baseline
    # that says how much of a step's loss is its batch
    params = ts.init_fn(0)[0]
    b0 = {k: torch.from_numpy(v).to(dev) for k, v in stream.batch(0).items()}
    with torch.no_grad():
        ref_loss0 = loss_fn(params, b0, ref_cfg, ts.rt).item()
        init_losses = [loss_fn(params, {
            k: torch.from_numpy(v).to(dev)
            for k, v in stream.batch(i).items()}, cfg, ts.rt).item()
            for i in range(TRAIN_STEPS)]
    del params
    torch.cuda.empty_cache()

    # (h) the training loop, counts set to 0 just before it ---------------
    kernels = (fa_kernel.flash_attention_fwd,
               fa_kernel.flash_attention_bwd_dkv,
               fa_kernel.flash_attention_bwd_dq)
    for fn in kernels:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train_loop(ts, stream, TrainLoopConfig(steps=TRAIN_STEPS),
                     on_step=lambda step, loss, v: print(
                         f"train step {step}: loss {loss:.5f} "
                         f"{v.duration * 1e3:.2f} ms", flush=True))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}
    peak = torch.cuda.max_memory_allocated()
    losses = res["losses"]
    step_ms = statistics.median(
        v.duration * 1e3 for v in list(res["monitor"])[TRAIN_WARMUP:])
    tokens = TRAIN_B * TRAIN_S
    per_step = dict(flash_attention_fwd=2 * cfg.n_layers,
                    flash_attention_bwd_dkv=cfg.n_layers,
                    flash_attention_bwd_dq=cfg.n_layers)
    out["train"] = dict(
        batch=TRAIN_B, seq=TRAIN_S, steps=TRAIN_STEPS,
        n_params=count_params(cfg), losses=losses,
        ref_loss0=ref_loss0,
        loss0_rel_vs_reference=abs(losses[0] - ref_loss0) / abs(ref_loss0),
        launches=launches, step_ms=step_ms,
        step_ms_all=[v.duration * 1e3 for v in res["monitor"]],
        tokens_per_s=tokens / (step_ms * 1e-3),
        model_tflops=model_flops(cfg, tokens) / (step_ms * 1e-3) / 1e12,
        peak_mem_gb=peak / 1e9, loop_wall_s=wall_s)
    print("train " + json.dumps(out["train"]), flush=True)
    check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
          f"training losses {losses}")
    check(out["train"]["loss0_rel_vs_reference"] < 1e-2,
          f"step-0 loss {losses[0]} vs reference attention {ref_loss0}")
    for name, n in per_step.items():
        check(launches[name] == n * TRAIN_STEPS,
              f"{name}: {launches[name]} launches in {TRAIN_STEPS} steps, "
              f"not {n} per step")

    # (i) profile of one more step, last --------------------------------------
    params, opt = res["params"], res["opt"]
    del res
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in stream.batch(TRAIN_STEPS).items()}
    out["train_memory"] = step_memory(ts, params, opt, batch)

    def one_step():
        _p, _o, m = ts.step_fn(params, opt, batch)
        float(m["loss"])

    out["train_profile"] = profile_families("train step (B 4, S 2048)",
                                            one_step, step_ms)
    del params, opt
    torch.cuda.empty_cache()

    # the flash model's gradients against the reference model's at B 1 ----
    params = ts.init_fn(0)[0]
    b1 = {k: v[:1] for k, v in b0.items()}
    grads = []
    for c in (cfg, ref_cfg):
        loss = loss_fn(params, b1, c, ts.rt)
        grads.append(dict(zip([n for n, _ in params.named_parameters()],
                              torch.autograd.grad(loss,
                                                  list(params.parameters())))))
        del loss
    g_f, g_r = grads
    leaf = {n: rel_err(g_f[n], g_r[n]) for n in g_f}
    n_f, n_r = global_norm(g_f).item(), global_norm(g_r).item()
    diff = global_norm({n: g_f[n] - g_r[n] for n in g_f}).item() / n_r
    worst = max(leaf, key=leaf.get)
    out["grads_b1"] = dict(worst_leaf=worst, worst_leaf_rel=leaf[worst],
                           norm_flash=n_f, norm_reference=n_r,
                           norm_rel=abs(n_f - n_r) / n_r, diff_rel=diff,
                           bars=GRAD_BARS)
    print("train grads B1 flash vs reference " + json.dumps(out["grads_b1"]),
          flush=True)
    check(leaf[worst] < GRAD_BARS["leaf"]
          and abs(n_f - n_r) / n_r < GRAD_BARS["norm"]
          and diff < GRAD_BARS["diff"],
          f"B1 gradients flash vs reference: {out['grads_b1']}")
    del params, grads, g_f, g_r
    torch.cuda.empty_cache()

    # what makes the loss rise under the 3e-3 peak: the flash and the
    # reference-attention model from the same weights under the same
    # schedule at B 1; then the flash model at B 4 under a tenth of the
    # peak, whose last loss must fall below the initial weights' on the
    # same batch
    b1_stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                                           global_batch=1, seed=0))
    witness = {"init_weights_b4": init_losses}
    for name, c, lr, s, B in (
            ("flash_b1_3e-3", cfg, 3e-3, b1_stream, 1),
            ("reference_b1_3e-3", ref_cfg, 3e-3, b1_stream, 1),
            ("flash_b4_3e-4", cfg, 3e-4, stream, TRAIN_B)):
        steps = WITNESS_STEPS if B == 1 else TRAIN_STEPS
        ts_w = build_train_step(c, opt_cfg=AdamWConfig(
            lr=warmup_cosine(lr, 10, TRAIN_STEPS)), device=dev)
        witness[name] = train_loop(ts_w, s,
                                   TrainLoopConfig(steps=steps))["losses"]
        torch.cuda.empty_cache()
    f1, r1 = witness["flash_b1_3e-3"], witness["reference_b1_3e-3"]
    witness["flash_vs_reference_rel"] = [abs(a - b) / abs(b)
                                         for a, b in zip(f1, r1)]
    out["loss_witness"] = witness
    print("train loss witness " + json.dumps(witness), flush=True)
    check(all(map(math.isfinite, f1 + r1))
          and max(witness["flash_vs_reference_rel"]) < WITNESS_BAR,
          f"B1 losses flash {f1} vs reference attention {r1}")
    low = witness["flash_b4_3e-4"]
    check(all(map(math.isfinite, low)) and low[-1] < init_losses[-1],
          f"the flash model's loss under a 3e-4 peak {low} did not fall "
          f"below the initial weights' {init_losses}")
    return out


def step_memory(ts, params, opt, batch) -> dict:
    """GB allocated on the card through one training step, with the
    step's own ``loss_fn`` and ``adamw_update`` wrapped: at the step's start
    (parameters, AdamW state, batch), the forward's peak and what it leaves
    saved for the backward, the backward's peak and what reaches
    ``adamw_update`` (+ the f32 gradients), ``adamw_update``'s peak and its
    exit, and the step's end (the caller still holds the old state)."""
    import torch
    from repro_torch.runtime import train_step as ts_mod
    gb = 1e-9
    mem = {}

    def mark(peak_key, now_key):
        torch.cuda.synchronize()
        mem[peak_key] = torch.cuda.max_memory_allocated() * gb
        mem[now_key] = torch.cuda.memory_allocated() * gb
        torch.cuda.reset_peak_memory_stats()

    real_loss, real_update = ts_mod.loss_fn, ts_mod.adamw_update

    def loss_fn(*a, **kw):
        loss = real_loss(*a, **kw)
        mark("forward_peak", "after_forward")
        return loss

    def adamw_update(*a, **kw):
        mark("backward_peak", "adamw_entry")
        res = real_update(*a, **kw)
        mark("adamw_peak", "adamw_exit")
        return res

    n = sum(p.numel() for p in params.parameters())
    mem["f32_params"] = 4 * n * gb
    mem["f32_moments"] = 8 * n * gb
    torch.cuda.synchronize()
    mem["step_start"] = torch.cuda.memory_allocated() * gb
    torch.cuda.reset_peak_memory_stats()
    ts_mod.loss_fn, ts_mod.adamw_update = loss_fn, adamw_update
    try:
        res = ts.step_fn(params, opt, batch)
        float(res[2]["loss"])
    finally:
        ts_mod.loss_fn, ts_mod.adamw_update = real_loss, real_update
    mark("tail_peak", "step_end")
    del res
    print("train step memory (GB) " + json.dumps(mem), flush=True)
    return mem


def kernel_family(name: str) -> str:
    n = name.lower()
    if "fa_fwd" in n:
        return "flash_attention_fwd"
    if "fa_bwd_dkv" in n:
        return "flash_attention_bwd_dkv"
    if "fa_bwd_dq" in n:
        return "flash_attention_bwd_dq"
    if "ssd_" in n:
        return "ssd_scan"
    if any(t in n for t in ("gemm", "cutlass", "xmma", "nvjet", "cublas",
                            "sm90_")):
        return "gemm"
    if "reduce" in n:
        return "reduce (norm means)"
    if "copy" in n or "cat" in n or "index" in n or "gather" in n:
        return "copy, cast, gather (layout swaps, embedding)"
    if "elementwise" in n:
        return "elementwise (norm scale, rope, silu, residual)"
    return "other"


def profile_families(label: str, run, wall_ms: float) -> dict:
    """(f): where one call's device time goes, by kernel family, with its
    kernel launches, and the device's idle share of the call's
    unprofiled host wall time ``wall_ms``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    fam: dict = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and e.self_device_time_total > 0:
            f = fam.setdefault(kernel_family(e.key),
                               dict(kernels=0, launches=0, device_us=0.0))
            f["kernels"] += 1
            f["launches"] += e.count
            f["device_us"] += e.self_device_time_total
    busy_us = sum(f["device_us"] for f in fam.values())
    out = dict(wall_us=wall_ms * 1e3, device_busy_us=busy_us,
               launches=sum(f["launches"] for f in fam.values()),
               idle_share=1.0 - busy_us / (wall_ms * 1e3),
               families=dict(sorted(fam.items(),
                                    key=lambda kv: -kv[1]["device_us"])))
    print(f"{label} profile " + json.dumps(out), flush=True)
    check(busy_us > 0, f"profiler recorded no device time in {label}")
    return out


def serving_phases(rng, dev) -> dict:
    """(c)-(f): the llama3.2-1b serving path at full width."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.launch.serve import ModelDecodeEngine, serve
    from repro_torch.models import (Group, Runtime, cast_params,
                                    decode_step, init_caches, init_params,
                                    prefill)

    cfg = dataclasses.replace(get_config(ARCH), attn_impl="flash")
    ref_cfg = dataclasses.replace(cfg, attn_impl="reference")
    rt = Runtime(dev)
    t0 = time.perf_counter()
    params = cast_params(init_params(SEED, cfg, device=dev), cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"{ARCH}: {n_params} parameters, init + cast to "
          f"{cfg.compute_dtype} {time.perf_counter() - t0:.2f} s", flush=True)
    out = {}

    # (c) prefill at full width ------------------------------------------
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (PREFILL_B, PREFILL_S))).to(dev)}
    fa_kernel.flash_attention_fwd.launches = 0
    logits = prefill(params, batch, cfg, rt)
    torch.cuda.synchronize()
    launches = fa_kernel.flash_attention_fwd.launches
    ref_logits = prefill(params, batch, ref_cfg, rt)
    rel = rel_err(logits[:, :cfg.vocab], ref_logits[:, :cfg.vocab])
    check(logits.shape == (PREFILL_B, cfg.vocab_padded)
          and bool(torch.isfinite(logits[:, :cfg.vocab]).all()),
          "prefill logits shape/finite")
    check(launches == cfg.n_layers,
          f"prefill launched flash_attention_fwd {launches} times, not "
          f"{cfg.n_layers}")
    check(rel < 2e-2, f"prefill flash vs reference rel err {rel}")
    del ref_logits
    ms = host_ms(lambda: prefill(params, batch, cfg, rt))
    ref_ms = host_ms(lambda: prefill(params, batch, ref_cfg, rt), reps=3,
                     warmup=1)
    out["prefill"] = dict(
        batch=PREFILL_B, seq=PREFILL_S, flash_launches=launches,
        rel_err_vs_reference=rel, e2e_ms=ms,
        tokens_per_s=PREFILL_B * PREFILL_S / (ms * 1e-3),
        e2e_ms_reference_attention=ref_ms)
    print("prefill " + json.dumps(out["prefill"]), flush=True)

    # (d) teacher-forced decode against prefill ---------------------------
    def teacher(tcfg, S, cache_len):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, S))).to(dev)
        want = prefill(params, {"tokens": toks}, tcfg, rt)
        caches = init_caches(tcfg, 1, cache_len, device=dev)
        t1 = time.perf_counter()
        for t in range(S):
            _, got, caches = decode_step(params, toks[:, t], caches, t, tcfg,
                                         rt)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t1) * 1e3 / S
        return rel_err(got[:, :cfg.vocab], want[:, :cfg.vocab]), step_ms

    rel_t, step_ms = teacher(cfg, TEACHER_S, TEACHER_S)
    wcfg = dataclasses.replace(cfg, groups=tuple(
        Group(g.name, tuple(dataclasses.replace(b, window=ROLL_C + 1)
                            for b in g.blocks), g.repeats)
        for g in cfg.groups))
    rel_r, _ = teacher(wcfg, ROLL_S, ROLL_C)
    out["teacher"] = dict(prompt=TEACHER_S, rel_err=rel_t,
                          decode_ms_per_step_b1=step_ms,
                          rolling_prompt=ROLL_S, rolling_cache=ROLL_C,
                          rolling_rel_err=rel_r)
    print("teacher-forced decode " + json.dumps(out["teacher"]), flush=True)
    check(rel_t < 0.08, f"teacher-forced decode vs prefill rel err {rel_t}")
    check(rel_r < 0.08, f"rolling-cache decode vs windowed prefill rel err "
                        f"{rel_r}")

    # (e) serving behind LPFServer ----------------------------------------
    eng = ModelDecodeEngine(cfg, SERVE_BUCKETS, params=params, device=dev)
    buckets = {str(b): dict(ms_per_token=eng.token_seconds(b) * 1e3,
                            ms_per_call=eng.overhead_seconds(b) * 1e3)
               for b in eng.buckets()}
    res = serve(eng, requests=8, seed=0, max_tokens=32, check=True)
    health = res["health"]
    check(res["completed"] >= 1, "no request completed")
    check(res["solo_identical"] == res["completed"],
          "batched streams differ from solo decodes")
    out["serve"] = dict(buckets=buckets, completed=res["completed"],
                        tokens=res["tokens"], wall_s=res["wall_s"],
                        tokens_per_s=res["tokens_per_s"],
                        solo_identical=res["solo_identical"],
                        **{k: health[k] for k in (
                            "admitted", "rejected_total", "shed",
                            "deadline_misses", "batches", "queue_depth")})
    print("serve " + json.dumps(out["serve"]), flush=True)

    # (f) profiles last: after a torch.profiler session the host's eager
    # dispatch may run slower, which would skew the decode timings above
    out["profile"] = profile_families(
        "prefill", lambda: prefill(params, batch, cfg, rt), ms)
    B, C = SERVE_BUCKETS[-1]
    caches = init_caches(cfg, B, C, device=dev)
    tok = torch.zeros(B, dtype=torch.long, device=dev)
    step = lambda: decode_step(params, tok, caches, C // 2, cfg, rt)
    out["decode_profile"] = profile_families(
        f"decode step (B {B}, cache {C})", step, host_ms(step))
    return out


def ssd_flops(B, S, H, P, G, N, L) -> tuple:
    """The SSD scan's arithmetic on these inputs, (C B^T, the rest): per
    chunk of Lv rows, C B^T over the causal triangle's Lv (Lv + 1) / 2
    pairs once per (b, group), M x over the same pairs and the inter
    (C state) and state (B^T x) products, Lv N P each, per (b, h); 2 flops
    a multiply-add."""
    lengths = [L] * (S // L) + ([S % L] if S % L else [])
    cb = rest = 0.0
    for lv in lengths:
        pairs = lv * (lv + 1) / 2
        cb += 2.0 * B * G * pairs * N
        rest += 2.0 * B * H * (pairs * P + 2 * lv * N * P)
    return cb, rest


def ssd_bound_ms(B, S, H, P, G, N, L, itemsize) -> tuple:
    """Least time for the SSD scan on these inputs: x, dt, a, b, c read
    and y, the state written once, or the products at the fastest rate
    that holds the 1e-4 bar: bf16 tensor cores over the products each
    operand pair's split needs (:data:`SSD_SPLIT_PRODUCTS`).
    Returns (ms, "bytes" or "operations", the rate it assumed)."""
    cb, rest = ssd_flops(B, S, H, P, G, N, L)
    n_cb, n_rest = SSD_SPLIT_PRODUCTS[itemsize]
    t_ops = (cb * n_cb + rest * n_rest) / BF16_FLOPS
    rate = (f"bf16 989 TFLOP/s over {n_cb} product(s) (C B^T) and {n_rest}"
            f" (the rest): f32 operands split into two bf16 parts")
    nbytes = (2 * B * S * H * P + 2 * B * S * G * N) * itemsize \
        + B * S * H * 4 + H * 4 + B * H * N * P * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", rate)


def ssd_fma_bound_ms(B, S, H, P, G, N, L) -> float:
    """The same arithmetic at the f32 FMA rate (67 TFLOP/s), the bound of
    a kernel that runs the products as f32 FMAs on the CUDA cores."""
    return sum(ssd_flops(B, S, H, P, G, N, L)) / FP32_FLOPS * 1e3


def ssd_tf32_bound_ms(B, S, H, P, G, N, L, itemsize) -> float:
    """The same arithmetic at the kernel's own split-TF32 rate (495 TFLOP/s
    over the same number of products a pair), or the bytes if slower."""
    cb, rest = ssd_flops(B, S, H, P, G, N, L)
    n_cb, n_rest = SSD_SPLIT_PRODUCTS[itemsize]
    return max((cb * n_cb + rest * n_rest) / TF32_FLOPS * 1e3,
               ssd_bound_ms(B, S, H, P, G, N, L, itemsize)[0])


# the kernels of ``csrc/ssd_scan.cu`` by pass, as their mangled names
# begin (``ILb0E`` / ``ILb1E``: the f32 / bf16 instance)
SSD_PASS_KERNELS = {"ssd_cb": "ssd_cb_kernel",
                    "ssd_chunk_state": "ssd_chunk_state_kernel",
                    "ssd_state_pass": "ssd_state_pass_kernel",
                    "ssd_chunk_scan": "ssd_chunk_scan_kernel"}


def ssd_phase(rng, dev, build_log: str, shapes=SSD_SHAPES) -> list:
    """(j): the CUDA ssd_scan kernel against its plain version."""
    import torch
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.models.mamba import MambaConfig, _ssd_chunked
    rows = []
    for B, S, H, P, G, N, chunk, dt_name in shapes:
        dtype = getattr(torch, dt_name)
        x = torch.from_numpy(rng.standard_normal(
            (B, S, H, P), dtype=np.float32)).to(dev, dtype)
        dt = torch.from_numpy(rng.uniform(0.001, 0.1, (B, S, H)).astype(
            np.float32)).to(dev)
        a = torch.from_numpy(-rng.uniform(0.5, 2.0, (H,)).astype(
            np.float32)).to(dev)
        b, c = (torch.from_numpy(rng.standard_normal(
            (B, S, G, N), dtype=np.float32)).to(dev, dtype)
            for _ in range(2))
        L = min(chunk, S)
        before = (ssd_kernel.ssd_scan.launches,
                  ssd_kernel.ssd_scan.cuda_launches)
        out = ssd_kernel._run(x, dt, a, b, c, chunk)
        y, st = out["y"], out["state"]
        torch.cuda.synchronize()
        cuda_launches = ssd_kernel.ssd_scan.cuda_launches - before[1]
        check(ssd_kernel.ssd_scan.launches == before[0] + 1
              and cuda_launches == len(ssd_kernel.PASSES),
              f"ssd_scan launch count, {cuda_launches} CUDA launches")
        y_p, st_p = ssd_ref.ssd_scan_plain(x, dt, a, b, c, chunk=chunk)
        err = (y.float() - y_p.float()).abs().max().item()
        plan = ssd_kernel.grid_plan(B, S, H, P, G, N, chunk)
        row = dict(shape=[B, S, H, P, G, N], chunk=chunk, dtype=dt_name,
                   cuda_launches=cuda_launches, blocks=plan.blocks,
                   max_abs_err=err, rel_err=err / y_p.float().abs().max()
                   .item(), state_rel_err=rel_err(st, st_p), bar=SSD_BAR)
        # each pass's scratch against the plain passes (f32 inputs: the
        # kernel's arithmetic is f32 in either dtype)
        want = ssd_ref.ssd_scan_passes(x.float(), dt, a, b.float(),
                                       c.float(), chunk=chunk)
        row["pass_rel_err"] = dict(
            cum=rel_err(out["cum"][..., :L], want.cum),
            cb=rel_err(out["cb"][..., :L, :L].tril(), want.cb),
            states=rel_err(out["states"], want.states)
            if want.states.shape[1] > 1 else 0.0)
        ok = max(row["pass_rel_err"].values()) < SSD_BAR
        if dtype == torch.bfloat16:
            # y is rounded to bf16: hold it against the f32 y, within the
            # bar plus half a bf16 ulp of each value (at most 2^-8 of it)
            over = (y.float() - want.y).abs() - 2.0 ** -8 * want.y.abs()
            row["rel_err_vs_f32_less_rounding"] = \
                over.max().item() / want.y.abs().max().item()
            ok = ok and row["rel_err_vs_f32_less_rounding"] < SSD_BAR
            del over
        else:
            ok = ok and row["rel_err"] < SSD_BAR
        del want, out
        row["ms"] = cuda_ms(lambda: ssd_kernel.ssd_scan(x, dt, a, b, c,
                                                        chunk=chunk))
        row["plain_ms"] = cuda_ms(lambda: ssd_ref.ssd_scan_plain(
            x, dt, a, b, c, chunk=chunk), reps=5, warmup=1)
        row["chunked_ms"] = None
        if S % L == 0:
            mcfg = MambaConfig(d_model=H * P // 2, d_state=N, head_dim=P,
                               n_groups=G, chunk=chunk)
            row["chunked_ms"] = cuda_ms(lambda: _ssd_chunked(
                x, dt, a, b, c, mcfg), reps=5, warmup=1)
        row["bound_ms"], row["bound_by"], row["bound_rate"] = ssd_bound_ms(
            B, S, H, P, G, N, L, x.element_size())
        row["fma_bound_ms"] = ssd_fma_bound_ms(B, S, H, P, G, N, L)
        row["tf32_bound_ms"] = ssd_tf32_bound_ms(B, S, H, P, G, N, L,
                                                 x.element_size())
        bf16 = int(dtype == torch.bfloat16)
        smem = ssd_kernel._lib().ssd_smem_bytes
        row["build"] = {name: kernel_build_report(
            build_log,
            kern + ("" if name == "ssd_state_pass" else f"ILb{bf16}E"),
            smem(i, bf16, plan.Lp, plan.Np, P))
            for i, (name, kern) in enumerate(SSD_PASS_KERNELS.items())}
        rows.append(row)
        print("ssd_scan " + json.dumps(row), flush=True)
        check(ok and row["state_rel_err"] < SSD_BAR,
              f"ssd_scan {row['shape']} chunk {chunk} {dt_name}: {row}")
        del x, dt, a, b, c, y, st, y_p, st_p
        torch.cuda.empty_cache()
    return rows


def mamba_phases(rng, dev) -> dict:
    """(k)-(l): mamba2-130m prefill, decode and serving at full width."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.launch.serve import ModelDecodeEngine, serve
    from repro_torch.models import (Runtime, blocks, cast_params,
                                    decode_step, init_caches, init_params,
                                    prefill)

    cfg = get_config(MAMBA_ARCH)
    check(cfg.compute_dtype == "bfloat16" and cfg.n_layers == 24,
          "mamba2-130m config")
    rt = Runtime(dev)
    t0 = time.perf_counter()
    params = cast_params(init_params(SEED, cfg, device=dev), cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"{MAMBA_ARCH}: {n_params} parameters, init + cast to "
          f"{cfg.compute_dtype} {time.perf_counter() - t0:.2f} s", flush=True)
    out = {}

    def chunked_prefill(batch, chunk=None, p=params, c=cfg):
        """The same prefill with the blocks' scan through the JAX model's
        default path (``impl="chunked"``, optionally at another chunk
        length), a check only."""
        real = blocks.mamba_apply
        blocks.mamba_apply = lambda p_, h, mcfg, impl: real(
            p_, h, dataclasses.replace(mcfg, chunk=chunk or mcfg.chunk),
            impl="chunked")
        try:
            before = ssd_kernel.ssd_scan.launches
            out = prefill(p, batch, c, rt)
            check(ssd_kernel.ssd_scan.launches == before,
                  "the chunked prefill launched ssd_scan")
            return out
        finally:
            blocks.mamba_apply = real

    # (k) prefill at full width, counts set to 0 just before --------------
    V = cfg.vocab
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (PREFILL_B, PREFILL_S))).to(dev)}
    ssd_kernel.ssd_scan.launches = 0
    ssd_kernel.ssd_scan.cuda_launches = 0
    fa_kernel.flash_attention_fwd.launches = 0
    logits = prefill(params, batch, cfg, rt)
    torch.cuda.synchronize()
    launches = ssd_kernel.ssd_scan.launches
    cuda_launches = ssd_kernel.ssd_scan.cuda_launches
    flash = fa_kernel.flash_attention_fwd.launches
    check(logits.shape == (PREFILL_B, cfg.vocab_padded)
          and bool(torch.isfinite(logits[:, :V]).all()),
          "mamba2 prefill logits shape/finite")
    check(launches == cfg.n_layers and flash == 0,
          f"mamba2 prefill launched ssd_scan {launches} times (not "
          f"{cfg.n_layers}) and flash attention {flash} times")
    check(cuda_launches == launches * len(ssd_kernel.PASSES),
          f"mamba2 prefill: {cuda_launches} ssd_scan CUDA launches")
    # in bf16 the random-weight model amplifies rounding through its 24
    # layers: the chunked path at chunk 64 against itself at 128 (the same
    # algebra summed in another order) already differs by ~0.09.  Each
    # full-width comparison holds its bar in f32 compute; in bf16 the bar,
    # or where the reference algebra's own spread on the same inputs is
    # wider, twice that spread
    ref_logits = chunked_prefill(batch)
    rel = rel_err(logits[:, :V], ref_logits[:, :V])
    spread = rel_err(chunked_prefill(batch, chunk=64)[:, :V],
                     ref_logits[:, :V])
    del ref_logits
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    params32 = cast_params(init_params(SEED, cfg32, device=dev), cfg32)
    before = ssd_kernel.ssd_scan.launches
    logits32 = prefill(params32, batch, cfg32, rt)
    check(ssd_kernel.ssd_scan.launches == before + cfg.n_layers,
          "f32 prefill launches")
    rel32 = rel_err(logits32[:, :V], chunked_prefill(
        batch, p=params32, c=cfg32)[:, :V])
    del logits32
    check(rel32 < 2e-2, f"mamba2 f32 prefill kernel vs chunked rel err "
                        f"{rel32}")
    check(rel < 2e-2 or rel <= 2 * spread,
          f"mamba2 bf16 prefill kernel vs chunked rel err {rel}, over 2e-2 "
          f"and over twice the chunked path's own spread {spread}")
    ms = host_ms(lambda: prefill(params, batch, cfg, rt))
    chunked_ms = host_ms(lambda: chunked_prefill(batch), reps=3, warmup=1)
    long = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (1, LONG_S))).to(dev)}
    before = ssd_kernel.ssd_scan.launches
    long_logits = prefill(params, long, cfg, rt)
    torch.cuda.synchronize()
    long_launches = ssd_kernel.ssd_scan.launches - before
    check(long_launches == cfg.n_layers
          and bool(torch.isfinite(long_logits[:, :cfg.vocab]).all()),
          f"B 1 x S {LONG_S} prefill: {long_launches} launches, finite")
    long_ms = host_ms(lambda: prefill(params, long, cfg, rt), reps=3,
                      warmup=1)
    out["prefill"] = dict(
        batch=PREFILL_B, seq=PREFILL_S, ssd_launches=launches,
        ssd_cuda_launches=cuda_launches, flash_launches=flash,
        rel_err_vs_chunked=rel, chunked_64_vs_128_rel=spread,
        f32_rel_err_vs_chunked=rel32, e2e_ms=ms,
        tokens_per_s=PREFILL_B * PREFILL_S / (ms * 1e-3),
        e2e_ms_chunked=chunked_ms, long_seq=LONG_S,
        long_ssd_launches=long_launches, long_e2e_ms=long_ms,
        long_tokens_per_s=LONG_S / (long_ms * 1e-3))
    print("mamba2 prefill " + json.dumps(out["prefill"]), flush=True)

    # (l) teacher-forced decode against prefill ---------------------------
    toks = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (1, TEACHER_S))).to(dev)}

    def teacher(p, c):
        want = prefill(p, toks, c, rt)
        caches = init_caches(c, 1, TEACHER_S, device=dev)
        t1 = time.perf_counter()
        for t in range(TEACHER_S):
            _, got, caches = decode_step(p, toks["tokens"][:, t], caches, t,
                                         c, rt)
        torch.cuda.synchronize()
        return (rel_err(got[:, :V], want[:, :V]),
                (time.perf_counter() - t1) * 1e3 / TEACHER_S)

    rel_t, step_ms = teacher(params, cfg)
    rel_t32, _ = teacher(params32, cfg32)
    spread_t = rel_err(chunked_prefill(toks, chunk=16)[:, :V],
                       chunked_prefill(toks)[:, :V])
    del params32
    out["teacher"] = dict(prompt=TEACHER_S, rel_err=rel_t,
                          chunked_16_vs_64_rel=spread_t, f32_rel_err=rel_t32,
                          decode_ms_per_step_b1=step_ms)
    print("mamba2 teacher-forced decode " + json.dumps(out["teacher"]),
          flush=True)
    check(rel_t32 < 0.08, f"mamba2 f32 teacher-forced decode vs prefill "
                          f"rel err {rel_t32}")
    check(rel_t < 0.08 or rel_t <= 2 * spread_t,
          f"mamba2 teacher-forced decode vs prefill rel err {rel_t}, over "
          f"0.08 and over twice the chunked path's own spread {spread_t}")

    # serving behind LPFServer ---------------------------------------------
    eng = ModelDecodeEngine(cfg, SERVE_BUCKETS, params=params, device=dev)
    buckets = {str(b): dict(ms_per_token=eng.token_seconds(b) * 1e3,
                            ms_per_call=eng.overhead_seconds(b) * 1e3)
               for b in eng.buckets()}
    res = serve(eng, requests=8, seed=0, max_tokens=32, check=True)
    health = res["health"]
    check(res["completed"] >= 1, "mamba2: no request completed")
    check(res["solo_identical"] == res["completed"],
          "mamba2: batched streams differ from solo decodes")
    out["serve"] = dict(buckets=buckets, completed=res["completed"],
                        tokens=res["tokens"], wall_s=res["wall_s"],
                        tokens_per_s=res["tokens_per_s"],
                        solo_identical=res["solo_identical"],
                        **{k: health[k] for k in (
                            "admitted", "rejected_total", "shed",
                            "deadline_misses", "batches", "queue_depth")})
    print("mamba2 serve " + json.dumps(out["serve"]), flush=True)

    # profiles last, as in (f)
    out["profile"] = profile_families(
        "mamba2 prefill", lambda: prefill(params, batch, cfg, rt), ms)
    out["long_profile"] = profile_families(
        f"mamba2 prefill B 1 x S {LONG_S}",
        lambda: prefill(params, long, cfg, rt), long_ms)
    B, C = SERVE_BUCKETS[-1]
    caches = init_caches(cfg, B, C, device=dev)
    tok = torch.zeros(B, dtype=torch.long, device=dev)
    step = lambda: decode_step(params, tok, caches, 0, cfg, rt)
    out["decode_profile"] = profile_families(
        f"mamba2 decode step (B {B})", step, host_ms(step))
    del params, caches, logits, long_logits
    torch.cuda.empty_cache()
    return out


# (m) the BSP collectives at p = 8 over f32: 16 MiB a process (2^22
# elements, the JAX package's benchmarks/allreduce.py's largest size and
# the order of a DDP gradient bucket), and the allreduce at 2^25 (1 GiB
# stacked, about half of one llama3.2-1b layer's gradient)
COLL_N, COLL_N_BIG = 1 << 22, 1 << 25
COLL_F32_BAR, COLL_INT8_BAR = 1e-6, 0.05

# (n) PageRank, the paper's §4.3, on Graph500's R-MAT (a, b, c = 0.57,
# 0.19, 0.19, rmat_graph's defaults) at scale 22 and edge factor 16
PR_SCALE, PR_EDGE_FACTOR, PR_SEED = 22, 16, 1
PR_BAR, PR_MASS_BAR = 1e-3, 1e-4
# the loop's ms an iteration: the median of 40 iterations' gaps, and the
# device's busy time over the host wall of one profiled 12-iteration loop
PR_LOOP_ITERS, PR_LOOP_PROFILE = 40, 12


def fit_link(dev) -> dict:
    """6: (g, l) of the virtual-process link from timed total exchanges of
    growing h at p = 8, each superstep synchronised on its own, staging
    and planning included (T(h) = g*h + l, the paper's Table-3
    estimators: g from the two ends of the sweep, l as the time of the
    smallest exchange less its g*h)."""
    import torch
    from repro_torch import core as lpf
    ctx = lpf.LPFContext(P_MAIN, device=dev)
    p = P_MAIN
    hs, ts = [], []
    for w in (1, 64, 1024, 16384, 1 << 18, 1 << 21):
        ctx.resize_memory_register(2)
        ctx.resize_message_queue(p * p)
        a = ctx.register_global("a", torch.ones(p, p * w, device=dev))
        b = ctx.register_global("b", torch.zeros(p, p * w, device=dev))
        table = [(s, d, a, d * w, b, s * w, w)
                 for s in range(p) for d in range(p)]

        def exchange():
            ctx.put_msgs(table)
            ctx.sync(label="probe")

        ms = host_ms(exchange, reps=25)
        h = (p - 1) * w * 4
        hs.append(h)
        ts.append(ms * 1e-3)
        print(f"total exchange h={h} B: {ms * 1e3:.2f} us", flush=True)
        ctx.deregister(a)
        ctx.deregister(b)
    g = (ts[-1] - ts[0]) / (hs[-1] - hs[0])
    l = ts[0] - g * hs[0]
    frac = (p - 1) / p
    fit = dict(g_s_per_byte=float(g), l_s=float(l), p=p,
               link_bw=float(frac / g), link_latency=float(l / math.log2(p)),
               points=list(zip(hs, ts)))
    print("link fit " + json.dumps(fit), flush=True)
    check(g > 0 and l > 0, f"link fit g={g} l={l}")
    return fit


def fitted_machine(lpf, fit: dict):
    """Phase 6's (g, l) of the ``"vp"`` link as the BSP machine."""
    return lpf.LPFMachine(p=fit["p"], g=fit["g_s_per_byte"], l=fit["l_s"],
                          r=1.0 / FP32_FLOPS)


def collectives_phase(dev, fit: dict, n: int = COLL_N,
                      n_big: int = COLL_N_BIG) -> list:
    """(m): every collective at p = 8 against a plain torch computation on
    the card, its ledger's methods and rounds, device and host ms, and
    measured over the fitted machine's predicted seconds."""
    import torch
    from repro_torch import bsp
    from repro_torch import core as lpf
    p = P_MAIN
    machine = fitted_machine(lpf, fit)
    rng = np.random.default_rng([SEED, 6])
    x = torch.from_numpy(rng.standard_normal((p, n), dtype=np.float32)).to(dev)
    xi = torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, (p, n),
                                       dtype=np.int32)).to(dev)
    attrs = lpf.SyncAttributes
    total = x.sum(0, keepdim=True)

    def rows(v):
        return v.expand(p, -1)

    # name, input, call, plain result, bar (None: bit-equal), ledger
    fused_pair = [("fused_rs", 1), ("fused_ag", 1)]
    cases = [
        ("allgather", x, lambda ctx, a: bsp.allgather(ctx, a),
         lambda: rows(x.reshape(1, -1)), None, [("fused_ag", 1)]),
        ("alltoall", x, lambda ctx, a: bsp.alltoall(ctx, a),
         lambda: x.view(p, p, -1).transpose(0, 1).reshape(p, -1), None,
         [("fused", 1)]),
        ("broadcast", x, lambda ctx, a: bsp.broadcast(ctx, a, root=3),
         lambda: rows(x[3:4]), None, [("fused_scatter", 1), ("fused_ag", 1)]),
        ("reduce", x, lambda ctx, a: bsp.reduce(ctx, a, root=2),
         lambda: torch.where(torch.arange(p, device=dev)[:, None] == 2,
                             total, torch.zeros_like(x)), COLL_F32_BAR,
         [("fused_rs", 1), ("fused_gather", 1)]),
        ("allreduce", x, lambda ctx, a: bsp.allreduce(ctx, a),
         lambda: rows(total), COLL_F32_BAR, fused_pair),
        ("allreduce_direct", x, lambda ctx, a: bsp.allreduce(
            ctx, a, attrs=attrs(method="direct")), lambda: rows(total),
         COLL_F32_BAR, [("direct", 7), ("direct", 7)]),
        ("allreduce_bruck", x, lambda ctx, a: bsp.allreduce(
            ctx, a, attrs=attrs(method="bruck")), lambda: rows(total),
         COLL_F32_BAR, [("bruck", 3), ("bruck", 3)]),
        ("allreduce_valiant", x, lambda ctx, a: bsp.allreduce(
            ctx, a, attrs=attrs(method="valiant")), lambda: rows(total),
         COLL_F32_BAR, [("valiant", 15), ("valiant", 15)]),
        ("allreduce_int8", x, lambda ctx, a: bsp.allreduce(
            ctx, a, attrs=attrs(compress=lpf.CompressSpec(bits=8))),
         lambda: rows(total), COLL_INT8_BAR, [("fused", 1), ("fused_ag", 1)]),
        ("allreduce_max_int32", xi, lambda ctx, a: bsp.allreduce(
            ctx, a, op=torch.maximum), lambda: rows(xi.amax(0, keepdim=True)),
         None, fused_pair),
        ("allreduce_min_int32", xi, lambda ctx, a: bsp.allreduce(
            ctx, a, op=torch.minimum), lambda: rows(xi.amin(0, keepdim=True)),
         None, fused_pair),
        ("exscan", x, lambda ctx, a: bsp.exscan(ctx, a),
         lambda: torch.cat([torch.zeros_like(x[:1]), x.cumsum(0)[:-1]]),
         COLL_F32_BAR, [("fused_ag", 1)]),
    ]
    out = [collective_row(lpf, machine, *case) for case in cases]
    del x, xi, total
    torch.cuda.empty_cache()
    xb = torch.from_numpy(rng.standard_normal((p, n_big),
                                              dtype=np.float32)).to(dev)
    out.append(collective_row(
        lpf, machine, "allreduce", xb, lambda ctx, a: bsp.allreduce(ctx, a),
        lambda: rows(xb.sum(0, keepdim=True)), COLL_F32_BAR, fused_pair))
    del xb
    torch.cuda.empty_cache()
    return out


def collective_row(lpf, machine, name, a, call, plain, bar, want) -> dict:
    """One (m) case: run through ``exec_`` on the card, check values and
    ledger, time it."""
    import torch
    p = P_MAIN

    def spmd(ctx, s, p_, arg):
        # Valiant's intermediates hold at most p chunks of n/p (phase 1
        # of the exchange and the allgather alike): n elements a process
        ctx.resize_message_queue(p * p, valiant_payload=arg.shape[1])
        return call(ctx, arg)

    def run():
        return lpf.exec_(p, spmd, a, device=a.device)

    got, led = lpf.exec_(p, spmd, a, device=a.device, return_ledger=True)
    ref = plain()
    torch.cuda.synchronize()
    if bar is None:
        err = 0.0 if torch.equal(got, ref) else float("inf")
    else:
        err = ((got.double() - ref.double()).abs().max()
               / ref.double().abs().max()).item()
    recs = [(r.method, r.rounds) for r in led.records]
    pred_s = led.predicted_seconds(machine)
    row = dict(name=name, n=int(a.shape[1]), dtype=str(a.dtype)[6:],
               rel_err=err, bar=bar, ledger=recs, h_bytes=led.h_bytes,
               wire_bytes=led.wire_bytes, predicted_ms=pred_s * 1e3)
    del got, ref
    settle(lpf, run)
    row["device_ms"] = cuda_ms(run, reps=10, warmup=2)
    row["host_ms"] = host_ms(run, reps=5, warmup=1)
    row["measured_over_predicted"] = row["host_ms"] / row["predicted_ms"]
    row["device_over_predicted"] = row["device_ms"] / row["predicted_ms"]
    print("collective " + json.dumps(row), flush=True)
    check(err <= (bar or 0.0), f"{name} n={row['n']}: error {err} > {bar}")
    check(recs == want, f"{name}: ledger {recs}, want {want}")
    return row


def pagerank_phase(dev, fit: dict, scale: int = PR_SCALE) -> dict:
    """(n): PageRank on R-MAT at ``scale`` over p = 8 through
    ``lpf_pagerank`` and again through ``hook`` from a host function that
    holds the shards on the card, against the float64 oracle."""
    import torch
    from repro_torch import core as lpf
    from repro_torch.algorithms import (dataflow_pagerank, lpf_pagerank,
                                        pagerank_spmd, partition_graph,
                                        rmat_graph, shard_tensors,
                                        sparse_reference_pagerank)
    from repro_torch.algorithms import pagerank as pr
    p, n = P_MAIN, 1 << scale
    machine = fitted_machine(lpf, fit)
    t0 = time.perf_counter()
    edges = rmat_graph(n, PR_EDGE_FACTOR * n, seed=PR_SEED)
    t1 = time.perf_counter()
    g = partition_graph(edges, n, p)
    t2 = time.perf_counter()
    out = dict(scale=scale, n=n, edges=int(edges.shape[0]), p=p,
               nnz_max=g.nnz_max, halo_max=g.halo_max, msgs=len(g.msgs),
               h_bytes=g.h_bytes(), rmat_s=t1 - t0, partition_s=t2 - t1,
               build_s=t2 - t0)
    print("pagerank graph " + json.dumps(out), flush=True)

    # the run through exec_, the JAX package's defaults
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r, iters, res, led = lpf_pagerank(p, g, device=dev, return_ledger=True)
    torch.cuda.synchronize()
    out.update(iters=iters, residual=res,
               exec_s=time.perf_counter() - t0)
    ref, ref_iters = sparse_reference_pagerank(edges, n, device=dev)
    err = ((r.double() - ref).abs().max() / ref.max()).item()
    mass = abs(r.double().sum().item() - 1.0)
    labels = [(x.label, x.method) for x in led.records]
    halo = [x for x in led.records if x.label == "pr.halo"]
    out.update(rel_err=err, mass_err=mass, oracle_iters=ref_iters,
               ledger=[(x.label, x.method, x.rounds, x.h_bytes)
                       for x in led.records])
    check(bool(torch.isfinite(r).all()) and r.shape == (n,),
          "pagerank ranks shape/finite")
    check(err < PR_BAR, f"pagerank rel err {err} >= {PR_BAR}")
    check(mass < PR_MASS_BAR, f"pagerank rank mass off by {mass}")
    check([l for l, _ in labels] == ["pr.init.rs", "pr.init.ag", "pr.halo",
                                     "pr.reduce.rs", "pr.reduce.ag"],
          f"pagerank ledger {labels}")
    check(halo[0].method == "direct" and halo[0].h_bytes == g.h_bytes(),
          f"pr.halo {halo[0]}")
    del ref

    # the same run with the loop and its programs eager
    # (LPF_COMPILE_PROGRAMS=0): the captured body replays bit for bit
    os.environ["LPF_COMPILE_PROGRAMS"] = "0"
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r_eager, it_eager, _, led_eager = lpf_pagerank(
            p, g, device=dev, return_ledger=True)
        torch.cuda.synchronize()
        out["eager_exec_s"] = time.perf_counter() - t0
    finally:
        del os.environ["LPF_COMPILE_PROGRAMS"]
    check(torch.equal(r_eager, r) and it_eager == iters,
          f"pagerank: the captured loop's {iters} iterations differ from "
          f"the eager loop's {it_eager}")
    check(led_eager.records == led.records, "pagerank: eager ledger")
    del r_eager

    # Algorithm 3: a host function already holding the shards on the
    # card hooks the unmodified PageRank
    shards = shard_tensors(g, device=dev)

    hooked = []

    def host_analytics():
        local_nnz = (shards["vals"] > 0).sum(1)

        def spmd(ctx, s, p_, a):
            hooked.append(ctx)
            return pagerank_spmd(ctx, g, a)

        rh, ih, resh = lpf.hook(p, spmd, shards, device=dev)
        return rh.reshape(-1), ih, float(resh[0]), local_nnz

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rh, ih, resh, nnz = host_analytics()
    torch.cuda.synchronize()
    hook_s = time.perf_counter() - t0
    diff = ((rh - r).abs().max() / r.max()).item()
    out.update(hook_iters=ih, hook_residual=resh, hook_s=hook_s,
               hook_rel_diff=diff, run_ms_per_iter=hook_s * 1e3 / ih)
    check(int(nnz.sum()) == edges.shape[0], "hooked run's nonzeros")
    # the segment sum is deterministic: the same ranks, bit for bit
    check(torch.equal(rh, r) and ih == iters,
          f"hooked run: {ih} iterations, ranks differ by {diff}")
    hctx = hooked[-1]
    out.update(loop_graph_replays=hctx.loop_graph_replays,
               loop_graph_fallbacks=hctx.loop_graph_fallbacks)
    check(hctx.loop_graph_replays == ih - 1
          and hctx.loop_graph_fallbacks == 0,
          f"hooked run: {hctx.loop_graph_replays} replays of the captured "
          f"body in {ih} iterations, fallbacks "
          f"{hctx.loop_graph_errors}")

    # one iteration alone: wall time, predicted communication, profile
    spmv = pr._SpMV(g, shards)
    sh = dict(shards, pack_idx=shards["pack_idx"].long())
    r2 = rh.view(p, -1)
    dmass = torch.zeros(p, device=dev)

    def one_iteration():
        sub = lpf.LPFContext(p, device=dev)
        with sub.program("pr.iter"):
            pr._iteration(sub, g, spmv, sh, r2, dmass, 0.85,
                          lpf.LPF_SYNC_DEFAULT)
        return sub.ledger

    it_led = one_iteration()
    settle(lpf, one_iteration)
    iter_ms = host_ms(one_iteration, reps=10, warmup=2)
    pred_s = it_led.predicted_seconds(machine)
    out.update(iteration_ms=iter_ms, iteration_predicted_ms=pred_s * 1e3,
               iteration_measured_over_predicted=iter_ms / (pred_s * 1e3))
    out["iteration_profile"] = profile_families("pagerank iteration",
                                                one_iteration, iter_ms)

    # an iteration of the loop, captured and eager: the body of
    # pagerank_spmd through compile_loop with a cond that reads the
    # iteration count on the host, which waits for the iteration's work,
    # and stamps the host clock; an iteration's wall time is the median
    # gap between stamps past the eager first iteration and the capture.
    # The idle share from one profiled loop of PR_LOOP_PROFILE iterations
    # (window_busy)
    def timed_loop(n_it, stamps=None):
        ctx = lpf.LPFContext(p, device=dev)

        def cond(c):
            go = bool(c[2] < n_it)
            if stamps is not None:
                stamps.append(time.perf_counter())
            with torch.profiler.record_function("pr.cond"):
                pass
            return go

        def body(sub, c):
            r_, dm, it = c
            r_new, dnew, _ = pr._iteration(sub, g, spmv, sh, r_, dm, 0.85,
                                           lpf.LPF_SYNC_DEFAULT)
            return r_new, dnew, it + 1

        ctx.compile_loop(body, (r2, dmass, torch.zeros(
            (), dtype=torch.int64, device=dev)), cond=cond, label="pr.iter")
        return ctx

    for mode in ("captured", "eager"):
        if mode == "eager":
            os.environ["LPF_COMPILE_PROGRAMS"] = "0"
        try:
            stamps = []
            lctx = timed_loop(PR_LOOP_ITERS, stamps)
            busy_ms, wall_ms = window_busy(
                lambda: timed_loop(PR_LOOP_PROFILE), "pr.cond", 2)
        finally:
            os.environ.pop("LPF_COMPILE_PROGRAMS", None)
        gaps = np.diff(stamps)[2:] * 1e3
        it_ms = float(np.median(gaps))
        n_win = PR_LOOP_PROFILE - 2
        out[f"loop_{mode}_ms_per_iter"] = it_ms
        out[f"loop_{mode}_ms_per_iter_quartiles"] = [
            float(np.percentile(gaps, 25)), float(np.percentile(gaps, 75))]
        out[f"loop_{mode}_profiled_ms_per_iter"] = wall_ms / n_win
        out[f"loop_{mode}_busy_ms_per_iter"] = busy_ms / n_win
        out[f"loop_{mode}_idle_share"] = 1.0 - busy_ms / wall_ms
        out[f"loop_{mode}_replays"] = lctx.loop_graph_replays
    check(out["loop_captured_replays"] == PR_LOOP_ITERS - 1,
          f"the timed loop replayed {out['loop_captured_replays']} times")
    check(out["loop_captured_busy_ms_per_iter"] > 0,
          "the profiler saw no device time in the captured loop")

    # the paper's "pure Spark" baseline on the same card, the edges on
    # the card: the difference of 25 and 5 iterations leaves out its
    # set-up (out-degrees)
    e_dev = torch.from_numpy(edges).to(dev)
    t_few = cuda_ms(lambda: dataflow_pagerank(e_dev, n, 5, device=dev),
                    reps=5, warmup=1)
    t_many = cuda_ms(lambda: dataflow_pagerank(e_dev, n, 25, device=dev),
                     reps=5, warmup=1)
    out["dataflow_ms_per_iter"] = (t_many - t_few) / 20
    del e_dev
    print("pagerank " + json.dumps(out), flush=True)
    print(f"pagerank scale {scale}: {iters} iterations (hooked {ih}), "
          f"residual {res:.3e}, {iter_ms:.3f} ms an iteration (predicted "
          f"communication {pred_s * 1e3:.3f}; the hooked run "
          f"{hook_s * 1e3:.1f} ms, set-up included), captured loop "
          f"{out['loop_captured_ms_per_iter']:.3f} ms an iteration (idle "
          f"{out['loop_captured_idle_share']:.3f}), eager loop "
          f"{out['loop_eager_ms_per_iter']:.3f} (idle "
          f"{out['loop_eager_idle_share']:.3f}), dataflow "
          f"{out['dataflow_ms_per_iter']:.3f} ms an iteration; graph "
          f"{out['build_s']:.1f} s on the host", flush=True)
    del shards, spmv, sh, r, rh
    torch.cuda.empty_cache()
    return out



# (o) the program optimizer, its certificate and compiled replay on the
# JAX package's canned traces at the card's sizes, p = 8, int32 (sums are
# exact in any order): 8 DDP buckets of 16 MiB a process, two interleaved
# FFT redistribute + reorder pairs of 8 MiB a process, the fragmented
# trace the search reroutes through Valiant, and the PageRank iteration
# shape with a 2 MiB halo
CANNED_CARD = [
    ("bucketed_sync8", "canned_bucketed_trace", (P_MAIN, 8, 1 << 19)),
    ("fft_redistribute", "canned_fft_trace", (P_MAIN, 1 << 18)),
    ("fragmented_valiant", "canned_fragmented_trace", (P_MAIN,)),
    ("pagerank", "canned_pagerank_trace", (P_MAIN, 1 << 16)),
]
PROGRAM_REPLAYS = 10


def fitted_hardware(lpf, fit: dict):
    """H100_SXM with phase 6's fitted ``"vp"`` link: a context on it
    prices its schedules with the fit's (g, l)."""
    return dataclasses.replace(lpf.H100_SXM, links={"vp": lpf.LinkModel(
        bw=fit["link_bw"], latency=fit["link_latency"])})


def events_ms(fn) -> float:
    """CUDA-event milliseconds of one call of ``fn``."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def window_busy(fn, mark: str, first: int) -> tuple:
    """``(busy ms, wall ms)`` of one profiled call of ``fn`` over the
    window between its ``first``-th (0-based) and its last
    ``record_function(mark)``: busy is the union of the device kernels'
    intervals inside the window, wall the window's length on the same
    clock.  The marks must follow host reads that wait for the device."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    marks = sorted(e.time_range.start for e in events if e.name == mark)
    lo, hi = marks[first], marks[-1]
    spans = sorted((max(e.time_range.start, lo), min(e.time_range.end, hi))
                   for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.time_range.end > lo and e.time_range.start < hi)
    busy, end = 0.0, lo
    for a, b in spans:
        a = max(a, end)
        if b > a:
            busy, end = busy + b - a, b
    return busy / 1e3, (hi - lo) / 1e3


def same_schedule(a, b) -> bool:
    """Two SuperstepPrograms with the same groups, canonical tables,
    attrs, plans and counters."""
    return (a.groups() == b.groups() and a.n_recorded == b.n_recorded
            and (a.n_coalesced, a.n_eliminated, a.n_merged, a.n_overlapped,
                 a.n_rewritten, a.n_hoisted) == (
                b.n_coalesced, b.n_eliminated, b.n_merged, b.n_overlapped,
                b.n_rewritten, b.n_hoisted)
            and all(x.table == y.table and x.attrs == y.attrs
                    and x.merged_from == y.merged_from
                    and x.rewrite == y.rewrite
                    and x.plan.method == y.plan.method
                    and x.plan.cost == y.plan.cost
                    for x, y in zip(a.steps, b.steps)))


def program_phase(dev, fit: dict) -> list:
    """(o): each canned trace at the card's size through a context that
    prices with phase 6's fit: the searched schedule, its signature and
    certificate, values bit-equal to recorded-order execution and the
    ledger ``ledger_costs`` gives, dispatched against compiled (a CUDA
    graph) end to end and the schedule alone (CUDA events, median of
    ``PROGRAM_REPLAYS``), measured over predicted, and the cache's
    entries, artifacts and replays."""
    import torch
    from repro_torch import core as lpf
    from repro_torch.analysis import traces
    from repro_torch.core.program import TRIAL_CALLS
    hw = fitted_hardware(lpf, fit)
    out = []
    for name, builder, args in CANNED_CARD:
        p, slots, steps, scratch = getattr(traces, builder)(*args)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        init = {s.sid: torch.randint(-(1 << 20), 1 << 20, (p, s.size),
                                     dtype=torch.int32, device=dev,
                                     generator=gen) for s in slots}

        def bind(compiled):
            pc = lpf.ProgramCache()
            ctx = lpf.LPFContext(p, device=dev, hardware=hw,
                                 program_cache=pc)
            ctx.compile_programs = compiled
            return (ctx, pc) + traces.bind_trace(ctx, slots, steps, scratch,
                                                 init, label=name)

        def values(ctx, handles):
            return {sid: ctx.value(h) for sid, h in handles.items()}

        def equal(a, b):
            return all(torch.equal(a[k], b[k]) for k in a)

        ctx, _, run, _, handles, _ = bind(False)
        run(recorded=False)                 # recorded order, eager syncs
        ref = values(ctx, handles)
        machine = ctx._machine()
        t0 = time.perf_counter()
        searched = lpf.optimize_program(steps, p, machine, scratch=scratch)
        search_ms = (time.perf_counter() - t0) * 1e3
        peephole = lpf.optimize_program(steps, p, machine, scratch=scratch,
                                        search=False)
        row = dict(name=name, args=list(args), p=p,
                   g_s_per_byte=machine.g, l_s=machine.l,
                   mib_per_process=sum(s.size for s in slots) * 4 / 2**20,
                   groups=[list(g) for g in searched.groups()],
                   rewrites=[st.rewrite for st in searched.steps],
                   search_ms=search_ms,
                   predicted_ms=searched.predicted_seconds(machine) * 1e3,
                   peephole_ms=peephole.predicted_seconds(machine) * 1e3,
                   in_order_ms=searched.in_order_seconds(machine) * 1e3)
        del ctx
        for mode in ("dispatched", "compiled"):
            ctx, pc, run, reset, handles, bound = bind(mode == "compiled")
            labels = [st.label for st in bound]
            n0 = len(ctx.ledger.records)
            run()
            prog = ctx.last_program
            order, sig = pc.canonicalize(bound, p, ctx._scratch)
            check(equal(values(ctx, handles), ref),
                  f"{name} {mode}: values differ from recorded order")
            check(ctx.ledger.records[n0:] == prog.ledger_costs(labels, order),
                  f"{name} {mode}: ledger is not ledger_costs")
            check(same_schedule(prog, searched),
                  f"{name} {mode}: schedule differs from the host's search")
            check(sig == lpf.program_signature(steps, p, scratch),
                  f"{name} {mode}: signature differs from the host's")
            cert = pc.certificate(pc.keys()[0])
            check(cert is not None and cert.ok, f"{name}: certificate {cert}")
            if mode == "compiled":
                (cp,) = pc.artifacts()
                # the timed eager calls, the capture and the timed
                # replays, until the program has chosen
                while cp.use_graph is None and cp.n_calls < 4 * TRIAL_CALLS:
                    reset()
                    run()
                    check(equal(values(ctx, handles), ref),
                          f"{name}: call {cp.n_calls} (replays "
                          f"{cp.n_replays}) differs from recorded order")
                check(cp.use_graph is not None and cp.n_replays > 0,
                      f"{name}: {cp.n_calls} calls, {cp.n_replays} replays, "
                      f"no choice")
            reset()
            times = [events_ms(run) for _ in range(PROGRAM_REPLAYS)]
            reset()
            run()
            check(equal(values(ctx, handles), ref),
                  f"{name} {mode}: replayed values differ")
            # the schedule alone: the compiled artifact's copies and
            # replay, or the dispatched execute_schedule on the registry
            slot_list = lpf.trace_slot_map(bound, order)
            if mode == "compiled":
                vals = [ctx.registry.value(s) for s in slot_list]
                sv = ctx.registry.value(ctx._scratch) \
                    if cp.scratch is not None else None
                sched = [events_ms(lambda: cp(vals, sv))
                         for _ in range(PROGRAM_REPLAYS)]
                check(len(pc) == 1 and len(pc.artifacts()) == 1,
                      f"{name}: {len(pc)} programs, "
                      f"{len(pc.artifacts())} artifacts")
                row.update(n_calls=cp.n_calls, n_replays=cp.n_replays,
                           use_graph=cp.use_graph,
                           trial_eager_ms=min(cp.eager_s) * 1e3,
                           trial_graph_ms=min(cp.replay_s) * 1e3,
                           copy_bytes=cp.copy_bytes,
                           copy_bound_ms=2 * cp.copy_bytes
                           / HBM_BYTES_PER_S * 1e3)
                del cp, vals, sv
                torch.cuda.synchronize()
                held = torch.cuda.memory_allocated()
                pc.clear()
                row["cache_held_mb"] = \
                    (held - torch.cuda.memory_allocated()) / 1e6
            else:
                entries = prog.materialize(bound, labels, order=order)
                sched = [events_ms(lambda: lpf.execute_schedule(
                    entries, prog.groups(), ctx.registry,
                    scratch=ctx._scratch)) for _ in range(PROGRAM_REPLAYS)]
                check(len(pc) == 1 and not pc.artifacts(),
                      f"{name}: dispatched cache {len(pc)}")
            check(not pc.quarantined and pc.stats.compile_fallbacks == 0,
                  f"{name} {mode}: quarantined {pc.compile_errors}")
            row[f"{mode}_ms"] = statistics.median(times)
            row[f"{mode}_schedule_ms"] = statistics.median(sched)
            row[f"{mode}_over_predicted"] = \
                row[f"{mode}_ms"] / row["predicted_ms"]
            row[f"{mode}_schedule_over_predicted"] = \
                row[f"{mode}_schedule_ms"] / row["predicted_ms"]
            if mode == "compiled":
                row["explain"] = prog.explain(machine)
            del ctx, pc, run, reset, handles, bound
            torch.cuda.empty_cache()
        out.append(row)
        print("program " + json.dumps(row), flush=True)
        print(f"program {name}: predicted {row['predicted_ms']:.3f} ms "
              f"(peephole {row['peephole_ms']:.3f}, in order "
              f"{row['in_order_ms']:.3f}); dispatched "
              f"{row['dispatched_ms']:.3f} ms, compiled "
              f"{row['compiled_ms']:.3f} ms; the schedule alone "
              f"{row['dispatched_schedule_ms']:.3f} / "
              f"{row['compiled_schedule_ms']:.3f} ms; timed calls eager "
              f"{row['trial_eager_ms']:.3f}, graph "
              f"{row['trial_graph_ms']:.3f} ms: "
              f"{'graph' if row['use_graph'] else 'eager'}", flush=True)
        del init, ref
        torch.cuda.empty_cache()
    return out


def settle(lpf, fn, limit: int = 12) -> None:
    """Call ``fn`` until every compiled program it runs has timed its
    eager calls against its graph replays and chosen (at most ``limit``
    calls), so the timings that follow see the chosen way."""
    pc = lpf.global_program_cache()
    calls = {id(a): a.n_calls for a in pc.artifacts()}
    fn()
    mine = [a for a in pc.artifacts() if a.n_calls > calls.get(id(a), 0)]
    for _ in range(limit):
        if all(a.use_graph is not None for a in mine):
            return
        fn()


def programs_replayed(lpf, path: str, seen: set) -> dict:
    """The compiled programs ``path`` added to the process-wide cache
    (those whose ids are not in ``seen``, which gains them): each one's
    calls, replays, timed eager and graph ms and choice, and the device
    memory allocated now.  Fails if a key is quarantined, if a program
    that chose never replayed, or if none replayed."""
    import torch
    pc = lpf.global_program_cache()
    arts = [a for a in pc.artifacts() if id(a) not in seen]
    seen.update(id(a) for a in arts)

    def fastest(ts):
        return min(ts) * 1e3 if ts else None

    out = dict(path=path, programs=len(pc), artifacts=len(arts),
               kept_graphs=sum(a.captured for a in arts),
               replays=sum(a.n_replays for a in arts),
               calls=sum(a.n_calls for a in arts),
               quarantined=len(pc.quarantined),
               allocated_gb=torch.cuda.memory_allocated() / 1e9,
               each=[dict(steps=[st.label for st in a.prog.steps],
                          calls=a.n_calls, replays=a.n_replays,
                          graph=a.use_graph, eager_ms=fastest(a.eager_s),
                          graph_ms=fastest(a.replay_s),
                          copy_bytes=a.copy_bytes) for a in arts])
    print("program cache " + json.dumps(out), flush=True)
    check(not pc.quarantined and pc.stats.compile_fallbacks == 0,
          f"{path}: quarantined programs {pc.compile_errors}")
    check(all(a.n_replays > 0 for a in arts if a.use_graph is not None),
          f"{path}: a program chose without replaying")
    check(out["replays"] > 0, f"{path}: no compiled program replayed")
    return out


def cache_footprint(lpf, label: str, base: int = None) -> dict:
    """The device memory the process-wide program cache holds — what
    emptying it frees: kept graphs with their memory pools and input
    buffers — and, from ``base``, the peak allocated above it since the
    peak was last reset; then empties the cache."""
    import gc
    import torch
    pc = lpf.global_program_cache()
    arts = pc.artifacts()
    out = dict(label=label, programs=len(pc), artifacts=len(arts),
               kept_graphs=sum(a.captured for a in arts))
    del arts
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    pc.clear()
    gc.collect()
    out["held_gb"] = (held - torch.cuda.memory_allocated()) / 1e9
    if base is not None:
        out["peak_above_base_gb"] = \
            (torch.cuda.max_memory_allocated() - base) / 1e9
    print("program cache memory " + json.dumps(out), flush=True)
    return out


def profile_bsp_fft(bsp_fft, x, wall_ms: float) -> dict:
    """Where one ordered ``bsp_fft`` call's time goes: device time of each
    kernel (``torch.profiler``, device-side events only), and the device's
    idle share of the call's unprofiled host wall time ``wall_ms``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        bsp_fft(x, p=P_MAIN, ordered=True, use_kernel=True, device="cuda")
        torch.cuda.synchronize()
    kernels = sorted(((e.key[:90], e.count, e.self_device_time_total)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda t: -t[2])
    busy_us = sum(t for _, _, t in kernels)
    out = dict(wall_us=wall_ms * 1e3, device_busy_us=busy_us,
               idle_share=1.0 - busy_us / (wall_ms * 1e3),
               kernels=[dict(kernel=k, count=c, device_us=t)
                        for k, c, t in kernels])
    print("bsp_fft profile " + json.dumps(out), flush=True)
    check(busy_us > 0, "profiler recorded no device time")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch import core as lpf
    from repro_torch.algorithms import bsp_fft, fft_h_bytes
    from repro_torch.kernels import build
    from repro_torch.kernels.fft_stage import kernel as fft_kernel
    from repro_torch.kernels.fft_stage import ref as fft_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. the card ---------------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} count {torch.cuda.device_count()}", flush=True)

    # 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build(["fft_stage", "flash_attention_fwd",
                         "flash_attention_bwd", "ssd_scan"])
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s ({', '.join(built)})", flush=True)
    for res in built.values():
        print(res.log.strip(), flush=True)

    # 3. kernel against its plain version ------------------------------------
    rng = np.random.default_rng(SEED)
    rows = []
    fft_log = built["fft_stage"].log
    for batch, n in KERNEL_SHAPES:
        x = torch.from_numpy(complex_input(rng, (batch, n))).to(dev)
        plan = fft_kernel.pass_plan(n)
        for inverse in (False, True):
            before = fft_kernel.fft_planes.cuda_launches
            y_k = fft_kernel.fft_planes(x, inverse=inverse)
            launches = fft_kernel.fft_planes.cuda_launches - before
            y_p = fft_ref.stockham(x, inverse=inverse)
            torch.cuda.synchronize()
            err = (y_k - y_p).abs().max().item()
            rel = err / y_p.abs().max().item()
            bar = 2e-5 if n >= N_MAIN // P_MAIN else 1e-5
            lib = torch.fft.ifft if inverse else torch.fft.fft
            row = dict(
                batch=batch, n=n, inverse=inverse, max_abs_err=err,
                rel_err=rel, bar=bar, cuda_launches=launches,
                passes=[dict(kind=q.kind, t=q.t, c=q.c) for q in plan],
                bytes=2 * launches * batch * n * 8,
                ms=cuda_ms(lambda: fft_kernel.fft_planes(x, inverse=inverse)),
                plain_ms=cuda_ms(lambda: fft_ref.stockham(x, inverse=inverse)),
                library_ms=cuda_ms(lambda: lib(x)))
            row["tb_per_s"] = row["bytes"] / (row["ms"] * 1e-3) / 1e12
            # one kernel a pass kind and T (csrc/fft_stage.cu)
            row["build"] = [kernel_build_report(
                fft_log, f"four_step_passILb{int(q.kind == 'col')}"
                f"ELi{q.t.bit_length() - 1}E", q.smem_bytes) for q in plan]
            rows.append(row)
            print("fft_planes " + json.dumps(row), flush=True)
            check(rel < bar, f"fft_planes {batch}x{n} inverse={inverse}: "
                             f"rel err {rel} >= {bar}")
            check(launches == len(plan), f"fft_planes {batch}x{n}: "
                  f"{launches} CUDA launches, plan {len(plan)}")
            if n == N_MAIN // P_MAIN:
                check(launches <= 2, f"fft_planes {batch}x{n}: {launches} "
                                     f"CUDA launches a call, more than 2")
            del y_k, y_p
    flash_rows = flash_phase(np.random.default_rng([SEED, 1]), dev,
                             built["flash_attention_fwd"].log)

    # 4. README quickstart through exec_ on the card -------------------------
    def quickstart(ctx, s, p, args):
        ctx.resize_memory_register(2)
        ctx.resize_message_queue(p)
        a = ctx.register_global("a", torch.arange(4.0, device=ctx.device)
                                + 10 * ctx.pid)
        b = ctx.register_global("b", ctx.replicate(torch.zeros(4)))
        ctx.put(a, b, to=lambda s: (s + 1) % p)
        ctx.sync(label="shift")
        return ctx.value(b)

    out, ledger = lpf.exec_(P_MAIN, quickstart, None, device="cuda",
                            return_ledger=True)
    want = (torch.arange(4.0) + 10 * ((torch.arange(P_MAIN) - 1) % P_MAIN)
            .reshape(-1, 1))
    check(out.is_cuda and torch.equal(out.cpu(), want),
          "quickstart values")
    recs = [(r.label, r.method, r.h_bytes, r.rounds, r.n_msgs)
            for r in ledger.records]
    check(recs == [("shift", "direct", 16, 1, P_MAIN)],
          f"quickstart ledger {recs}")
    print(f"quickstart: ok, ledger {recs}", flush=True)

    # 5. the main path: bsp_fft at N = 2^24 over p = 8, use_kernel=True -----
    x_np = complex_input(rng, N_MAIN)
    ref = np.fft.fft(x_np.astype(np.complex128))
    ref_max = np.abs(ref).max()
    x = torch.from_numpy(x_np).to(dev)
    main_rows = []
    fft_kernel.fft_planes.launches = 0
    fft_kernel.fft_planes.cuda_launches = 0
    for ordered in (True, False):
        y, led = bsp_fft(x, p=P_MAIN, ordered=ordered, use_kernel=True,
                         device="cuda", return_ledger=True)
        xi = bsp_fft(y, p=P_MAIN, ordered=ordered, use_kernel=True,
                     inverse=True, device="cuda")
        torch.cuda.synchronize()
        y_np = y.cpu().numpy()
        rel = float(np.abs(y_np - ref).max() / ref_max)
        rt = float((xi - x).abs().max().item())
        recs = [(r.label, r.method, r.rounds) for r in led.records]
        want_recs = [("fft.redistribute", "fused", 1)] + (
            [("fft.reorder", "fused", 1)] if ordered else [])
        row = dict(ordered=ordered, rel_err=rel, roundtrip_err=rt,
                   h_bytes=led.h_bytes,
                   want_h_bytes=fft_h_bytes(N_MAIN, P_MAIN, ordered),
                   ledger=recs)
        main_rows.append(row)
        print("bsp_fft " + json.dumps(row), flush=True)
        check(y.is_cuda and y.shape == (N_MAIN,) and bool(
            torch.isfinite(y).all()), "bsp_fft output shape/finite")
        check(rel < 2e-4, f"bsp_fft ordered={ordered} rel err {rel}")
        check(rt < 2e-3, f"bsp_fft ordered={ordered} round trip {rt}")
        check(recs == want_recs, f"bsp_fft ledger {recs}")
        check(led.h_bytes == fft_h_bytes(N_MAIN, P_MAIN, ordered),
              f"bsp_fft h_bytes {led.h_bytes}")
        del y, xi
    launches = fft_kernel.fft_planes.launches
    cuda_launches = fft_kernel.fft_planes.cuda_launches
    print(f"main path: fft_planes launches {launches}, CUDA launches "
          f"{cuda_launches}", flush=True)
    check(launches > 0, "the main path never launched fft_planes")
    for row in main_rows:
        ordered = row["ordered"]

        def fft_run():
            return bsp_fft(x, p=P_MAIN, ordered=ordered, use_kernel=True,
                           device="cuda")

        settle(lpf, fft_run)
        row["e2e_ms"] = host_ms(fft_run)
        y_compiled = fft_run()
        # the same calls with every program dispatched superstep by
        # superstep (LPF_COMPILE_PROGRAMS=0)
        os.environ["LPF_COMPILE_PROGRAMS"] = "0"
        try:
            row["e2e_ms_dispatched"] = host_ms(fft_run)
            y_dispatched = fft_run()
        finally:
            del os.environ["LPF_COMPILE_PROGRAMS"]
        check(torch.equal(y_compiled, y_dispatched),
              f"bsp_fft ordered={ordered}: compiled replay differs from "
              f"the dispatched schedule")
        row["e2e_ms_plain_local_fft"] = host_ms(lambda: bsp_fft(
            x, p=P_MAIN, ordered=ordered, use_kernel=False, device="cuda"))
        print(f"bsp_fft N=2^24 p=8 ordered={ordered}: {row['e2e_ms']:.3f} "
              f"ms with fft_stage (compiled programs; dispatched "
              f"{row['e2e_ms_dispatched']:.3f}), "
              f"{row['e2e_ms_plain_local_fft']:.3f} ms with torch.fft",
              flush=True)
        del y_compiled, y_dispatched
    programs_replayed(lpf, "bsp_fft", set())
    cache_footprint(lpf, "bsp_fft")
    profile_bsp_fft(bsp_fft, x, main_rows[0]["e2e_ms"])

    # 6. (g, l) of the virtual-process link ----------------------------------
    fit = fit_link(dev)

    # (c)-(f) the llama3.2-1b serving path ---------------------------------
    serving = serving_phases(np.random.default_rng([SEED, 2]), dev)

    # (g)-(i) the llama3.2-1b training path ---------------------------------
    bwd_rows = flash_bwd_phase(np.random.default_rng([SEED, 3]), dev,
                               built["flash_attention_bwd"].log)
    training = train_phases(dev)

    # (j)-(l) the mamba2-130m serving path -----------------------------------
    ssd_rows = ssd_phase(np.random.default_rng([SEED, 4]), dev,
                         built["ssd_scan"].log)
    mamba = mamba_phases(np.random.default_rng([SEED, 5]), dev)

    # (m) the BSP collectives, (n) PageRank, (o) the canned programs ------
    # one process-wide program cache across (m) and (n), emptied only
    # after (o): what it holds, and the peak above the memory before (m)
    lpf.global_program_cache().clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    seen = set()
    collectives_phase(dev, fit)
    programs_replayed(lpf, "collectives", seen)
    pagerank_phase(dev, fit)
    programs_replayed(lpf, "pagerank", seen)
    program_phase(dev, fit)
    cache_footprint(lpf, "collectives and pagerank", base)

    # 7. result lines ----------------------------------------------------------
    big = [r for r in rows if r["n"] == N_MAIN // P_MAIN and not r["inverse"]][0]
    bound_ms, bound_by = fft_bound_ms(big["batch"], big["n"])
    # "replaces" names each TPU kernel's pallas_call line; "launches" is
    # the count from this slice's main path, the training loop (h); the
    # flash rows are the main path's shapes, chosen by shape
    main_fwd = [r for r in flash_rows if r["shape"] == MAIN_FWD_SHAPE
                and r["dtype"] == "bfloat16"][0]
    main_bwd = [r for r in bwd_rows if r["shape"] == MAIN_BWD_SHAPE
                and r["dtype"] == "bfloat16"][0]
    train_launches = training["train"]["launches"]
    main_ssd = [r for r in ssd_rows if r["shape"] == MAIN_SSD_SHAPE
                and r["dtype"] == "float32"][0]
    kernels = {"kernels": [dict(
        name="fft_planes", route="cuda",
        source="src/repro_torch/csrc/fft_stage.cu",
        replaces="src/repro/kernels/fft_stage/kernel.py:72",
        launches=launches, cuda_launches=cuda_launches,
        max_abs_err=big["max_abs_err"], ms=big["ms"],
        plain_ms=big["plain_ms"], bound_ms=bound_ms, bound_by=bound_by,
        library_ms=big["library_ms"], tb_per_s=big["tb_per_s"],
        passes=big["passes"], build=big["build"]), dict(
        name="flash_attention_fwd", route="cuda",
        source="src/repro_torch/csrc/flash_attention_fwd.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:111",
        launches=train_launches["flash_attention_fwd"],
        launches_prefill=serving["prefill"]["flash_launches"],
        max_abs_err=main_fwd["max_abs_err"], ms=main_fwd["ms"],
        plain_ms=main_fwd["plain_ms"], bound_ms=main_fwd["bound_ms"],
        bound_by=main_fwd["bound_by"], library_ms=main_fwd["library_ms"],
        row_err=main_fwd["row_err"], build=main_fwd["build"])] + [dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/flash_attention_bwd.cu",
            replaces=f"src/repro/kernels/flash_attention/kernel.py:{line}",
            launches=train_launches[name],
            max_abs_err=max(main_bwd["max_abs_err"][g] for g in grads),
            ms=main_bwd["ms"][name], plain_ms=main_bwd["plain_ms"],
            bound_ms=main_bwd["bound"][name][0],
            bound_by=main_bwd["bound"][name][1],
            library_ms=main_bwd["library_ms"],
            pair_ms=main_bwd["pair_ms"], delta_ms=main_bwd["delta_ms"],
            build=main_bwd["build"][name])
        for name, line, grads in (
            ("flash_attention_bwd_dkv", 272, ("dk", "dv")),
            ("flash_attention_bwd_dq", 303, ("dq",)))] + [dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:101",
        launches=mamba["prefill"]["ssd_launches"],
        cuda_launches=mamba["prefill"]["ssd_cuda_launches"],
        max_abs_err=main_ssd["max_abs_err"], ms=main_ssd["ms"],
        plain_ms=main_ssd["plain_ms"], chunked_ms=main_ssd["chunked_ms"],
        bound_ms=main_ssd["bound_ms"], bound_by=main_ssd["bound_by"],
        bound_rate=main_ssd["bound_rate"], library_ms=None,
        build=main_ssd["build"])]}
    print(json.dumps(kernels), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
