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
    [4, 32, 2048, 64] bf16, causal, Hkv 8, gemma2-9b's attention at
    head dim 256, [1, 16, 8, 8192, 256] bf16 causal, as a local layer
    (window 4096, soft-cap 50) and as a global layer without them, and
    qwen3-14b's [4, 40, 8, 2048, 128] (a GQA group of 5) and
    qwen1.5-110b's [1, 64, 8, 2048, 128] (group 8), causal: o within
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
    (4, 256), each bucket's decode step captured once as a CUDA graph and
    replayed once a token, behind ``LPFServer``, 8 ``synthetic_requests``
    (seed 0, at most 32 tokens): no deadline miss, no quarantine, one
    capture a bucket, an empty queue after the drain, every refusal
    classified, every completed stream bit-identical to a solo re-decode
    on the captured path and to one on the per-token path (one eager step
    a token); ms per token of each bucket on each path (a full batch of
    64 tokens, the median of 3 calls captured and one call per token,
    the two paths' streams equal),
    beside each engine's admission price, and tokens/s (``serve_paths``);
    then the (4, 256) bucket on a virtual (pod, data, model) = (1, 2, 4)
    mesh (``MESH_SHAPE``: the batch over 2 shards, the KV cache's
    sequence over 4 shards of 64 slots, ``decode_attention``) against
    the same bucket on a 1x1 mesh: 64 teacher-forced steps' logits within
    ``MESH_DECODE_BAR``, the control (each cache shard's slot offset
    dropped from ``valid``) beyond it, the mesh bucket's captured greedy
    decode equal to its eager steps, and ms per token captured beside
    the 1x1 bucket's and the engine's (``mesh_decode``);
(f) last, ``torch.profiler`` over one prefill, one eager decode step and
    one replay of the captured step: device time by kernel family,
    kernel launches, and the device's idle share.

The llama3.2-1b training path (f32 masters, bf16 compute, ``remat="full"``,
``attn_impl="flash"``) adds, after (f):

(g) the build of phase 2 covers ``flash_attention_bwd`` too; its two
    kernels (``flash_attention_bwd_dkv``, ``flash_attention_bwd_dq``)
    against the plain ``flash_attention_bwd_ref`` on the card at the same
    eight shapes (the training path's [4, 32, 2048, 64] bf16 causal, Hkv 8
    among them) and at (ae)'s training shapes (``STACK_BWD_SHAPES``:
    gemma2-9b's local layer, window 4096 and soft-cap 50, and its global
    layer at [1, 16, 8, 8192, 256]; llava's [4, 32, 8, 2048, 128];
    qwen3-14b's [4, 40, 8, 2048, 128]; whisper-base's [16, 8, 8, 1500, 64]
    non-causal and causal; ``VLM_SHAPES``), all bf16: in
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
    solo re-decodes on the captured and the per-token path, no
    quarantine; ms per token per bucket on each path, tokens/s, and the
    launches and idle share of one eager and one captured decode step.

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

The dense configs at their published widths (seed-0 weights drawn by
``load_params``, each matrix cast to bf16 as it is drawn; each model's
load seconds and peak device memory printed, and each model freed before
the next; their depth cut to keep the whole script inside its time, every
block kind kept) add, after (o):

(p) gemma2-9b, its depth cut to ``GEMMA_LAYERS`` of 42 layers (whole
    pairs of local, window 4096, and global attention; soft-caps 50 and
    30, sandwich norms, head dim 256): prefill at B 1 x S 8192 with the
    counts set to 0 just before, one ``flash_attention_fwd`` launch a
    layer, last-position
    logits within 5e-2 (relative) of ``attn_impl="reference"``, host ms and
    tokens/s; the bar's readings at this shape: the bf16 reference
    prefill against the same in f32 compute must pass it, and flash
    prefills of a wrong kernel's function (K/V heads of the next group;
    the local layers without their window) must fail it; 64
    teacher-forced decode steps at B 1 within 0.08 of
    prefill; serving as in (e), and one eager against one captured decode
    step as in (f);
(q) qwen3-14b (40 heads over 8 kv heads, qk-norm), its depth cut to
    ``QWEN3_LAYERS`` of 40: the same at prefill B 4 x S 2048;
(r) qwen1.5-110b at its published widths with the depth cut to
    ``QWEN110_LAYERS`` of its 80 layers (its 222 GB of bf16 weights do
    not fit one card): prefill only, B 1 x S 2048, against reference
    attention;
(s) ``ProgramDecodeEngine`` at p = 8 on ``scripts/serve_latency.py``'s
    workload (120 requests in bursts of 6, buckets (2, 16), (4, 16), (4,
    32)), priced on H100_SXM with phase 6's fitted link: zero deadline
    misses, every completed request within its
    predicted model-clock time, loop-graph replays and no fallback, at
    least two programs pinned, no quarantine; p50/p99 of wall and
    model-clock latency per bucket; then one bucket's streams solo,
    batched and on the per-token fallback, bit-identical.

The MoE slice (seed-0 weights from ``load_params``, bf16 compute; each
model's config as the launchers build it on one card, ``ep_degree=1``)
adds, after (s); (b) and (j) gain its kernel shapes (granite's attention
[4, 24, 8, 2048, 64], jamba's [1, 32, 8, 8192, 128]; jamba's scan [1,
8192, 128, 64], G 1, N 16, chunk 128, in f32 and bf16):

(t) mamba2-130m training at its published width, uncut:
    ``MAMBA_TRAIN_STEPS`` steps of (h)'s loop and checks (its witness
    at B 1 ``MAMBA_WITNESS_STEPS``) with the ``ssd_scan`` kernel in place of flash attention and
    the chunked path (``impl="chunked"``) as the reference: every loss
    finite, the step-0 loss within 1e-2 of the chunked path's, exactly 48
    ``ssd_scan`` calls (192 CUDA launches) a step (24 forward, 24 in the
    remat recompute) and no flash launch, the B 1 gradients against the
    chunked path's (``GRAD_BARS``, or twice the chunked path's own spread
    at chunk 64 against 128 where wider, as in (k)), the loss witness;
    step ms, tokens/s, model TFLOP/s, peak memory, one step's memory by
    stage, and one profiled step with the device time inside the SSD
    scan's VJP (the ``ssd_scan.vjp`` range) and its share;
(u) granite-moe-3b-a800m whole, this slice's main path (32 layers, 40
    experts top-8): load seconds and peak; one MoE layer at B 1 x S 512 in
    f32 on the card against the same call on the CPU (within 1e-5, the
    same tokens routed to each expert); prefill at B 4 x S 2048 as in (p)
    (32 flash launches, the reference and both sides of the gate checked;
    the gate widens to twice the sound run's reading for an MoE model:
    a bf16 rounding difference can route a near-tie token to another
    expert), its capacity drops, host ms, tokens/s and profile with the
    MoE block's share (the ``moe_single`` range); 64 teacher-forced decode
    steps at a capacity that drops nothing (``raised_capacity``, both
    sides) with the published factor's drops of the prompt beside;
    serving as in (e); one eager against one captured step with the MoE
    block's share of each; then on the virtual ``MESH_SHAPE`` mesh
    (``ep_degree`` 4: 40 experts, 10 a model shard, no padding): one MoE
    layer (layer 0, f32, B 2 x S 512, tokens sharing one direction so
    that the capacity binds) through ``moe_apply`` against the same call
    on the CPU and against its batch shards' ``moe_single`` calls, each
    within 1e-5, with ``moe_single`` over the whole batch as the control
    and each shard's drops (``moe_mesh_check``); the B 4 x S 2048
    prefill on the mesh (32 flash launches), each batch shard's drops
    beside the one-card prefill's, host ms beside the one-card
    prefill's, the forward's logits against its batch shards' one-card
    forwards (the median position) within ``MESH_PREFILL_BAR`` in bf16
    and ``MESH_PREFILL_F32_BAR`` in f32, the whole batch on one card
    beyond each (``mesh_prefill``);
(v) jamba-v0.1-52b at its published widths with its depth cut to one
    8-layer period (7 Mamba and 1 attention layer, 4 MoE and 4 dense
    FFNs; 13.27 B; 103 GB of bf16 weights at full depth do not fit): the
    same as (u) at prefill B 1 x S 8192 (1 flash launch and 7
    ``ssd_scan`` calls, the reference taking the chunked scan too).

The rest of the model stack (seed-0 weights from ``load_params``, bf16
compute, each model freed before the next, the card's name and power
limit printed with each phase's numbers) adds, after (v); (b) gains
llava's attention [4, 32, 8, 2048, 128] causal and whisper's encoder
[16, 8, 8, 1500, 64] non-causal (1500 = 11 x 128 + 92 keys: the last key
tile masked by length alone) and its decoder's, causal; (b) and (g) also
hold the benchmark's llava cell with its vision tower (``VLM_SHAPES``):
the tower's [10, 16, 16, 577, 64] non-causal (577 = 4 x 128 + 65) and the
decoder's [2, 32, 8, 4096, 128] causal:

(w) llava-next-mistral-7b whole, this slice's main path (32 layers, d
    4096, GQA 32/8, head dim 128, 7.24 B): load seconds and peak; prefill
    at B 4 x S 2048, the 576-position vision prefix (``embeds``) drawn by
    ``SyntheticStream`` from the numpy seed before 1472 text tokens, with
    the counts set to 0 just before: 32 flash launches, the gate of (p)
    with both its sides (controls: K/V heads rolled, and the prefix
    rolled along the batch, which shows that the prefix is read), host
    ms, tokens/s and the profile by kernel family; 64 teacher-forced
    decode steps against a text-only prefill (the JAX package's decode
    takes no prefix); serving as in (e); one eager against one captured
    step;
(x) whisper-base whole (6 + 6 layers, d 512, 0.100 B): prefill at B 16
    with 1500 frames and 1500 tokens from the stream (as many frames as
    tokens: the reference's blocked attention builds its mask from the
    query length), 18 flash launches (6 encoder, 6 decoder, 6
    cross-attention), the gate with its controls (the frames rolled along
    the batch; the encoder's K/V heads rolled); teacher-forced decode at B
    1 over all 1500 positions under ``attn_impl="blocked"`` (the flash
    kernel takes no key length other than the query's: decode's
    cross-attention has one query) with the prefill's own encoder output
    of 1500 frames as ``enc_out``, against the flash prefill; serving
    through ``ModelDecodeEngine`` (64 zero frames, as the JAX engine
    feeds), captured and per token, streams bit-identical; one eager
    against one captured step;
(y) deepseek-v3-671b at its published widths (d 7168, 128 heads of MLA,
    q_lora 1536, kv_lora 512, 256 experts top-8 and the shared expert,
    vocab 129280) with its depth cut to one dense MLA layer, one MoE MLA
    layer and the MTP block (25.55 B, 51.1 GB of bf16 weights; 682.6 B
    at full depth): load seconds and peak (under the card's memory); one
    dense MLA layer at B 1 x S 512 in f32 on the card against the same
    call on the CPU (within 1e-5); the forward at B 1 x S 4096, blocked
    (MLA's value width differs from its query/key width, which the flash
    kernel does not take: no kernel of ``csrc/`` launches), its logits and
    the MTP head's finite, the capacity drops, host ms and tokens/s; 64
    teacher-forced steps of the absorbed decode against the decompressed
    prefill at ``raised_capacity``; serving as in (e); one eager against
    one captured step;
(z) granite-moe-3b-a800m training at full width (``one_card_config``:
    ``ep_degree=1``; f32 masters, bf16 compute, AdamW, ``remat="full"``,
    flash attention at its GQA group of 3), ``GRANITE_TRAIN_STEPS`` steps
    at B ``GRANITE_TRAIN_B`` x S 2048 with the counts set to 0 just
    before: 64 forward, 32 dK/dV and 32 dQ launches a step, every loss
    finite, the step-0 loss within 1e-2 of ``attn_impl="reference"`` on
    the same batch; the step ms, the peak memory and step 0's MoE drop
    share; the B 1 gradients against reference attention with every
    expert routed (a bf16 top-k flips near-tie tokens) under (h)'s bars;
    the steps donate their state (AdamW in place), so 52.8 GB of f32
    state is held once; then, from that donated state, ``MESH_STEPS``
    steps on the virtual ``MESH_SHAPE`` mesh (capacity per batch shard,
    experts over 4 model shards) with the counts set to 0 just before
    (64 / 32 / 32 launches a step), their ms and peak, and the forward
    loss on the mesh against the mean of its batch shards' one-card
    losses within ``MESH_LOSS_BAR`` (the control, each shard's capacity
    from the global batch, beyond it; the whole batch's one-card loss
    beside), and the per-token losses in f32 against the shards' (the
    median token) within ``MESH_TOKEN_BAR``, that control and the whole
    batch on one card beyond it (``granite_mesh_steps``);
(aa) the paper's main path warm-starting from disk: ``bsp_fft`` at N =
    2^24, p = 8, ``use_kernel=True`` in a context with ``persist_dir`` a
    fresh directory, then with new plan and program caches on the same
    directory: output bit-equal, equal ledger, every stored program a
    disk hit certified again, no program- or plan-cache miss; cold and
    warm ms to the first flush; then ``scripts/warm_start.py --device
    cuda`` (its recording and its warm child processes);
(ab) fault plans on the card: ``python -m repro_torch.runtime.faults
    --smoke`` and ``--chaos --seeds 16`` (``--device cuda``), every run
    ``identical`` or ``classified``; a child process of (aa)'s
    ``bsp_fft`` under ``LPF_FAULT_PLAN="compile@0;straggler@1=0.005"``
    (bit-equal output and ledger, the program quarantined to the
    dispatched path) and one under ``persist_load@0:bitflip`` over (aa)'s
    store (``invalidated`` >= 1, bit-equal);
(ac) ``python -m repro_torch.analysis`` on the port's machine (exit 0),
    then ``--record-cache`` and ``--cache-dir`` on one directory (exit 0,
    every entry verified);
(ad) this slice's main path: llama3.2-1b at full width (16 layers, d
    2048; f32 masters, bf16 compute, ``remat="full"``, flash attention,
    AdamW donated) over a ``2x1x1`` virtual mesh, B 4 x S 2048 (2 rows a
    pod): the pod step under ``rs+ag`` against the plain one-card step on
    the same batch from the same weights (loss, ``grad_norm``, every
    parameter; the control: the pods' sum in place of their mean, whose
    ``grad_norm`` must miss the bar), ``bucketed_overlap`` at 2^28-byte
    buckets against ``rs+ag`` (parameters, loss and ``grad_norm``), the
    compressed int16 ring's gradients within the int16 bound of the
    uncompressed ones leaf by leaf (the control: 63 levels in place of
    127 must miss it); then ``POD_STEPS`` timed steps of each method, with
    the counts set to 0 just before the first: 64 forward, 32 dK/dV and
    32 dQ launches a step; each method's step ms and peak; one profiled
    step of ``rs+ag`` and of ``bucketed_overlap``: the ``train.pod_sync``
    span's share of the step's device time; the ``bucket_sync`` program
    (``build_cross_pod_sync``) over the last ``POD_SYNC_LAYERS`` layers'
    gradients on one stream, dispatched and compiled, and on the
    side-stream pool, compiled (dispatched, overlap groups stay on one
    stream), bit-equal; a 4-step local-SGD ``train_loop``
    (``sync_every=2``), whose ledger grows only on the first synced
    step; then ``scripts/program_replay.py``'s overlap measurement
    (fenced against overlapped buckets at p = 4 and 8, one stream
    dispatched and compiled, the pool compiled, values bit-equal, ledgers
    as planned);
(ae) (run first of the model phases, after (b), where the allocator
    holds least) training on the card for the four other attention
    families (``STACK_TRAIN``; f32 masters, bf16 compute, ``remat="full"``, flash
    attention, AdamW donated): whisper-base whole (6 + 6 layers, B 16 x
    1500 tokens and 1500 frames from the stream built with the model's
    config: encoder self-attention, cross-attention at 1500 keys and the
    causal decoder, head dim 64), llava-next-mistral-7b cut to 4 of 32
    layers (B 4 x its 576-position prefix and 1472 tokens; head dim 128,
    group 4), gemma2-9b cut to 4 of 42 (2 local + 2 global; B 1 x S 8192,
    so that the window of 4096 masks inside the backward; head dim 256,
    soft-caps, tied embeddings) and qwen3-14b cut to 4 of 40 (B
    ``QWEN3_TRAIN_B`` x S 2048; group 5, q/k norms), each with (z)'s
    checks: ``STACK_TRAIN_STEPS`` steps with the counts set to 0 just
    before (two forward launches an attention or cross-attention layer a
    step, one of each backward kernel), every loss finite, the step-0
    loss within 1e-2 of reference attention, the B 1 gradients under
    ``GRAD_BARS`` (gemma2-9b's at S ``GEMMA_GRAD_S``, where the window
    still masks: at 8192 the reference ran out of memory); step ms,
    tokens/s and the peak;
(af) this slice's main path, the examples (``repro_torch.examples``) on
    the card: ``quickstart`` at ``QUICKSTART_CASES`` (error codes, rows,
    ledgers, priced on phase 6's fitted link), ``fft_spectral`` (the RMS
    error halved at least, ``h_bytes == fft_h_bytes``),
    ``pagerank_interop`` (13 iterations, error under 1e-3) and
    ``train_lm`` (``LM_STEPS`` steps, then again from the checkpoint of
    step ``LM_FIRST``, the last one a run stopped there leaves: its losses
    within ``LM_RESUME_BAR`` of the uninterrupted run's; the loss
    falling).
"""

from __future__ import annotations

import contextlib
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
# serve_paths' ms per token: full-batch decodes of DECODE_TOKENS tokens,
# the median of DECODE_CALLS calls on the captured path and one call on
# the per-token path (whose repeats took ~200 s of the script on a slow
# host: one eager step a token, 9 models, 2 buckets)
DECODE_TOKENS, DECODE_CALLS = 64, 3
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
# qwen3-14b's prefill attention (40 heads over 8 kv: a GQA group of 5, B 4
# x S 2048) and qwen1.5-110b's (64 over 8, B 1 x S 2048), causal
DENSE_FWD_SHAPES = [
    (4, 40, 8, 2048, 128, True, None, None, "bfloat16"),
    (1, 64, 8, 2048, 128, True, None, None, "bfloat16"),
]
# the benchmark's llava-next-mistral-7b cell with its vision tower
# (lpfbench llava-train-b2s4096-672px, in (b) and (g)): the tower's
# non-causal attention over 10 tiles (2 images of 5) of 577 = 4 x 128 + 65
# positions, 16 heads of 64, and the decoder's causal at B 2 x S 4096
VLM_SHAPES = [
    (10, 16, 16, 577, 64, False, None, None, "bfloat16"),
    (2, 32, 8, 4096, 128, True, None, None, "bfloat16"),
]
# (g) adds the backward shapes of (ae)'s training paths: gemma2-9b's local
# layer (window 4096, soft-cap 50) and global layer at B 1 x S 8192 (head
# dim 256), llava-next-mistral-7b's (group 4) and qwen3-14b's (group 5) at
# B 4 x S 2048 (head dim 128), whisper-base's encoder and cross-attention
# (non-causal, 1500 = 11 x 128 + 92 keys) and decoder (causal) at B 16;
# SDPA's backward beside each that has neither window nor soft-cap
STACK_BWD_SHAPES = [
    (1, 16, 8, 8192, 256, True, 4096, 50.0, "bfloat16"),
    (1, 16, 8, 8192, 256, True, None, None, "bfloat16"),
    (4, 32, 8, 2048, 128, True, None, None, "bfloat16"),
    (4, 40, 8, 2048, 128, True, None, None, "bfloat16"),
    (16, 8, 8, 1500, 64, False, None, None, "bfloat16"),
    (16, 8, 8, 1500, 64, True, None, None, "bfloat16"),
] + VLM_SHAPES
# the main path's shapes: the prefill (b) and the training step (g)
MAIN_FWD_SHAPE = [PREFILL_B, 32, 8, PREFILL_S, 64]
# bf16 o row by row: |o - o_plain| within 2^-6 of the row's largest
# |o_plain|, two bf16 ulps of it (rounding o gives one, rounding P less)
BF16_ROW_BAR = 2.0 ** -6
# the training path (h): B 4 x S 2048, TRAIN_STEPS steps, the first
# TRAIN_WARMUP left out of the step time; mamba2-130m's (t) runs
# MAMBA_TRAIN_STEPS (its loop, the initial weights' losses and the 3e-4
# witness run) and MAMBA_WITNESS_STEPS at B 1, cut from 8 and 4 to keep
# the script in time (the chunked reference takes ~3.5 s a B 1 step)
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_WARMUP = 4, 2048, 8, 2
MAMBA_TRAIN_STEPS, MAMBA_WITNESS_STEPS = 4, 2
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
# the dense configs at full width (p)-(r): gemma2-9b's prefill at B 1 x S
# 8192 (over its local layers' window of 4096, so the window masks),
# qwen3-14b's at B 4 x S 2048, and qwen1.5-110b's published widths with
# its depth cut from 80 layers to QWEN110_LAYERS (its 222 GB of bf16
# weights do not fit one card's 80 GB), prefill only at B 1 x S 2048
# last-position logits of the flash prefill against reference attention,
# relative.  Set between its two readings at the committed shapes (NVIDIA
# H100 80GB HBM3, 700 W): a sound run (the bf16 reference against f32
# compute) reads 1.0-1.7e-2 and the flash prefill 1.2-1.96e-2, a wrong
# kernel's function 0.59-1.47; dense_prefill checks both sides each run
DENSE_PREFILL_BAR = 5e-2
# gemma2-9b and qwen3-14b are cut in depth too (every block kind and
# width kept), to keep the whole script inside its time limit: gemma2-9b
# to GEMMA_LAYERS of 42 (whole local/global pairs), qwen3-14b to
# QWEN3_LAYERS of 40
GEMMA_ARCH, GEMMA_B, GEMMA_S, GEMMA_LAYERS = "gemma2-9b", 1, 8192, 4
QWEN3_ARCH, QWEN3_B, QWEN3_S, QWEN3_LAYERS = "qwen3-14b", 4, 2048, 4
QWEN110_ARCH, QWEN110_B, QWEN110_S, QWEN110_LAYERS = "qwen1.5-110b", 1, \
    2048, 2
# the MoE configs (u)-(v): granite-moe-3b-a800m whole (32 layers, 40
# experts top-8 at ep_degree 1) with its prefill at B 4 x S 2048, one MoE
# layer card against CPU at B 1 x S 512; jamba-v0.1-52b's published widths
# with its depth cut from 4 periods of 8 layers to JAMBA_PERIODS (103 GB of
# bf16 weights at full depth, over one card's 80 GB), prefill at B 1 x S
# 8192
GRANITE_ARCH, GRANITE_B, GRANITE_S, MOE_LAYER_S = "granite-moe-3b-a800m", \
    4, 2048, 512
JAMBA_ARCH, JAMBA_B, JAMBA_S, JAMBA_PERIODS = "jamba-v0.1-52b", 1, 8192, 1
# (z) granite-moe-3b-a800m training at S TRAIN_S: 3.30 B parameters, so
# 52.8 GB of f32 masters, gradients and AdamW moments before activations
# (its steps donate their state: one copy of it).  A step's peak on an
# NVIDIA H100 80GB HBM3 (700 W) is 56.9 GB at B 2 and 4 and 58.7 GB at B
# 8, where the allocator reserves 80.2 GB; B 4 keeps the script in time
GRANITE_TRAIN_B, GRANITE_TRAIN_STEPS = 4, 4
# one MoE layer on the card against the same call on the CPU, in f32
MOE_LAYER_BAR = 1e-5
# their attention in (b): granite's 24 heads over 8 (group 3, head dim
# 64) and jamba's 32 over 8 (group 4, head dim 128, no RoPE), causal
MOE_FWD_SHAPES = [
    (GRANITE_B, 24, 8, GRANITE_S, 64, True, None, None, "bfloat16"),
    (JAMBA_B, 32, 8, JAMBA_S, 128, True, None, None, "bfloat16"),
]
# jamba's scan in (j): 128 heads of 64, N 16, chunk 128, in f32 (what the
# model hands the kernel) and bf16
JAMBA_SSD_SHAPES = [
    (JAMBA_B, JAMBA_S, 128, 64, 1, 16, 128, "float32"),
    (JAMBA_B, JAMBA_S, 128, 64, 1, 16, 128, "bfloat16"),
]
# the rest of the model stack (w)-(y): llava-next-mistral-7b whole (its
# 576-position vision prefix before 1472 text tokens, B 4), whisper-base
# whole (B 16, 1500 frames and 1500 tokens: the repo's encoder length),
# deepseek-v3-671b's published widths with its depth cut to one dense and
# one MoE MLA layer and the MTP block (682.6 B at full depth), its forward
# at B 1 x S 4096
LLAVA_ARCH, LLAVA_B, LLAVA_TEXT = "llava-next-mistral-7b", 4, 1472
WHISPER_ARCH, WHISPER_B, WHISPER_S = "whisper-base", 16, 1500
DEEPSEEK_ARCH, DEEPSEEK_B, DEEPSEEK_S = "deepseek-v3-671b", 1, 4096
# one dense MLA layer on the card against the same call on the CPU, f32
MLA_LAYER_S, MLA_LAYER_BAR = 512, 1e-5
# their attention in (b): llava's 32 heads over 8 (group 4, head dim 128)
# causal, whisper's 8 heads of 64 at 1500 keys non-causal (the encoder)
# and causal (the decoder)
STACK_FWD_SHAPES = [
    (LLAVA_B, 32, 8, 2048, 128, True, None, None, "bfloat16"),
    (WHISPER_B, 8, 8, WHISPER_S, 64, False, None, None, "bfloat16"),
    (WHISPER_B, 8, 8, WHISPER_S, 64, True, None, None, "bfloat16"),
] + VLM_SHAPES
# (ae) training on the card for the four other attention families, each
# arch's (layers kept or None for whole, B, text tokens): whisper-base
# whole at B 16 x 1500 tokens and 1500 frames, as (x);
# llava-next-mistral-7b cut to 4 of 32 layers at B 4 x (its 576-position
# prefix + 1472 tokens), as (w); gemma2-9b cut to 4 of 42 (2 local + 2
# global) at B 1 x S 8192, as (p), so that the window of 4096 masks inside
# the backward; qwen3-14b cut to 4 of 40 at B QWEN3_TRAIN_B x S 2048, as
# (q).  STACK_TRAIN_STEPS steps each, the first left out of the step time
QWEN3_TRAIN_B = 4
STACK_TRAIN = {
    WHISPER_ARCH: (None, WHISPER_B, WHISPER_S),
    LLAVA_ARCH: (4, LLAVA_B, LLAVA_TEXT),
    GEMMA_ARCH: (GEMMA_LAYERS, GEMMA_B, GEMMA_S),
    QWEN3_ARCH: (QWEN3_LAYERS, QWEN3_TRAIN_B, QWEN3_S),
}
STACK_TRAIN_STEPS, STACK_TRAIN_WARMUP = 3, 1
# gemma2-9b's B 1 gradients against reference attention at S
# GEMMA_GRAD_S, where the window of 4096 still masks: at S 8192 the
# reference's f32 [16, S, S] scores and the [S, 256000] f32 logits beside
# the f32 parameters and two gradient trees ran out of memory (52 GB
# allocated, 25 GB reserved in fragments; NVIDIA H100 80GB HBM3, 700 W)
GEMMA_GRAD_S = 6144
# (af) the examples on the card: quickstart's (m, n, error code, rows per
# process); train_lm's run length, the step it resumes from (its
# checkpoints after it removed) and its checkpoint period, and the
# resumed losses' bar against the uninterrupted run's (relative)
QUICKSTART_CASES = [(1024, 512, 0, [128] * 8),
                    (5, 512, 1, [1, 1, 1, 1, 1, 0, 0, 0]),
                    (0, 512, 1, [0] * 8)]
LM_FIRST, LM_STEPS, LM_CKPT_EVERY, LM_RESUME_BAR = 40, 60, 20, 1e-5
# (ad) llama3.2-1b over 2 virtual pods: 2^28-byte buckets (a layer's f32
# gradients are ~243 MB: about one bucket a layer), POD_STEPS timed steps
# a method; the stream check syncs the last POD_SYNC_LAYERS layers'
# gradients (a bucket each).  Bars: the pod step's grad_norm against the
# plain step's (the pods' sum in place of their mean doubles it), and the
# int16 ring's error over its bound, half a quantum (63 levels in place
# of 127 double the quantum)
POD_MESH, POD_BUCKET_BYTES, POD_STEPS, POD_SYNC_LAYERS = (2, 1, 1), \
    1 << 28, 3, 4
POD_NORM_BAR, POD_INT16_BAR = 1e-2, 1.0
# the virtual (pod, data, model) mesh of (e), (u) and (z): 2 batch shards
# and 4 model shards (granite's 40 experts 10 a shard at ep_degree 4, no
# padding; llama3.2-1b's (4, 256) bucket's cache 4 shards of 64 slots)
MESH_SHAPE, MESH_BUCKET, MESH_LAYER_B, MESH_STEPS = (1, 2, 4), (4, 256), \
    2, 2
# (e): the mesh bucket's teacher-forced logits against the 1x1 bucket's
# (largest relative error over 64 steps), between a sound reading (the
# same bf16 model with its 4 cache partials merged in another order) and
# the control that drops each cache shard's slot offset from ``valid``;
# (z): the forward loss on the mesh against the mean of the one-card
# losses of its 2 batch shards (relative), between a sound reading and
# the control that takes each shard's capacity from the global batch
MESH_DECODE_BAR, MESH_LOSS_BAR = 5e-2, 1e-3
# Rounding flips near-tie routes and capacity cut-offs (a cut-off among
# 4,096 tokens leaves gaps of ~1e-4), and a flipped token moves every
# later position of its sequence: in bf16 nearly every position, in f32
# a few sequences.  So the mesh checks below read the median over
# positions, which a capacity taken over the wrong tokens moves at every
# position.  (z): the same state's per-token losses in f32 on the mesh
# against its batch shards' one-card ones (the median |difference| over
# the mean loss), below the bar, both controls (each shard's capacity
# from the global batch; the whole batch on one card) above it
MESH_TOKEN_BAR = 5e-5
# (u): the B 4 x S 2048 forward's logits on the mesh against its batch
# shards' one-card forwards (the median over positions of a position's
# largest |difference| over its largest |logit|), in f32 and in bf16,
# each below its bar, the whole batch on one card (the control) above
MESH_PREFILL_F32_BAR, MESH_PREFILL_BAR = 3e-3, 8e-2


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
                shapes=FLASH_SHAPES + GEMMA_FWD_SHAPES + DENSE_FWD_SHAPES
                ) -> list:
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


def median_row_err(a, ref) -> float:
    """The median over rows (every dimension but the last) of a row's
    largest |a - ref| over its largest |ref|."""
    a, ref = a.float(), ref.float()
    return ((a - ref).abs().amax(-1) / ref.abs().amax(-1)).median().item()


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


def device_kernels(run) -> list:
    """Names of the CUDA kernels one call of ``run`` launches (every
    device event the profiler recorded, whether or not it carries time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sorted({e.name for e in device_work(prof, prof.events())})


def flash_bwd_phase(rng, dev, build_log: str,
                    shapes=FLASH_SHAPES + STACK_BWD_SHAPES) -> list:
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


def f32_cfg(cfg):
    """``cfg`` computing in f32 (its bf16 or f32 weights upcast as they
    are read), with plain blocked attention: the flash kernel is bf16."""
    return dataclasses.replace(cfg, compute_dtype="float32",
                               attn_impl="blocked")


def token_losses(params, batch, cfg, rt):
    """Each position's next-token cross-entropy [B, S] (f32; 0 where the
    label is -1): ``loss_fn``'s terms before their mean."""
    import torch
    from repro_torch.models import forward
    logits = forward(params, batch, cfg, rt)
    labels = batch["labels"].long()
    picked = logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - picked) * (labels >= 0)


def granite_mesh_steps(label: str, cfg, params, opt, stream, dev) -> dict:
    """(z) on the virtual ``MESH_SHAPE`` mesh from the donated state the
    one-card loop left: ``MESH_STEPS`` steps of ``build_train_step`` on
    the mesh (donated, so the state is still held once) with the counts
    set to 0 just before (64 forward, 32 dK/dV and 32 dQ launches a
    step), each step's ms and the peak; then, at the state they leave,
    the forward loss on the mesh against the mean of the one-card losses
    of its batch shards (the same capacity a shard), within
    ``MESH_LOSS_BAR``, the control (each shard's capacity from the global
    batch) beyond it, and the one-card loss of the whole batch (1x1
    mesh) beside; then the per-token losses in f32 on the mesh against
    its shards' (the median token) within ``MESH_TOKEN_BAR``, both the global-capacity
    control and the whole batch on one card beyond it."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import loss_fn, moe
    from repro_torch.optim import AdamWConfig, warmup_cosine
    from repro_torch.runtime.train_step import build_train_step
    mcfg = mesh_cfg(cfg)
    ts = build_train_step(mcfg, make_mesh(MESH_SHAPE), opt_cfg=AdamWConfig(
        lr=warmup_cosine(3e-3, 10, GRANITE_TRAIN_STEPS)), donate=True,
        device=dev)
    n_dp = MESH_SHAPE[0] * MESH_SHAPE[1]
    check(ts.rt.distributed and ts.batch_axes == ("pod", "data"),
          f"{label} mesh runtime {ts.rt.__dict__}")
    dev_batch = lambda i: {k: torch.from_numpy(v).to(dev)
                           for k, v in stream.batch(i).items()}
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for i in range(MESH_STEPS):
        b = dev_batch(GRANITE_TRAIN_STEPS + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = ts.step_fn(params, opt, b)
        losses.append(float(m["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    per_step = expected_counts(mcfg, forward_calls=2, backward=True)
    b = dev_batch(GRANITE_TRAIN_STEPS + MESH_STEPS)
    rt1 = mesh_runtime(dev, (1, 1))
    with torch.no_grad():
        loss_mesh = loss_fn(params, b, mcfg, ts.rt).item()
        loss_1x1 = loss_fn(params, b, cfg, rt1).item()
        loss_shards = statistics.fmean(
            loss_fn(params, {k: v.chunk(n_dp)[i] for k, v in b.items()},
                    cfg, rt1).item() for i in range(n_dp))
        tok_mesh = token_losses(params, b, f32_cfg(mcfg), ts.rt)
        tok_shards = torch.cat([
            token_losses(params, {k: v.chunk(n_dp)[i] for k, v in
                                  b.items()}, f32_cfg(cfg), rt1)
            for i in range(n_dp)])
        tok_1x1 = token_losses(params, b, f32_cfg(cfg), rt1)
        real = moe.moe_capacity
        moe.moe_capacity = lambda T, E, c: real(T * n_dp, E, c)
        try:
            loss_control = loss_fn(params, b, mcfg, ts.rt).item()
            tok_control = token_losses(params, b, f32_cfg(mcfg), ts.rt)
        finally:
            moe.moe_capacity = real
    tok_rel = lambda t: ((t - tok_shards).abs().median()
                         / tok_shards.abs().mean()).item()
    out = dict(mesh=list(MESH_SHAPE), batch=GRANITE_TRAIN_B, seq=TRAIN_S,
               steps=MESH_STEPS, losses=losses, step_ms=step_ms,
               peak_mem_gb=peak, launches=launches,
               launches_per_step=per_step, loss_mesh=loss_mesh,
               loss_shards=loss_shards, loss_1x1=loss_1x1,
               loss_control_global_capacity=loss_control,
               rel_vs_shards=abs(loss_mesh - loss_shards) / loss_shards,
               rel_vs_1x1=abs(loss_mesh - loss_1x1) / loss_1x1,
               control_rel_vs_shards=abs(loss_control - loss_shards)
               / loss_shards, bar=MESH_LOSS_BAR,
               token_rel_vs_shards_f32=tok_rel(tok_mesh),
               control_token_rel_global_capacity_f32=tok_rel(tok_control),
               control_token_rel_1x1_f32=tok_rel(tok_1x1),
               token_bar=MESH_TOKEN_BAR, card=card_line())
    print(f"{label} on the {MESH_SHAPE} mesh " + json.dumps(out),
          flush=True)
    check(all(map(math.isfinite, losses)), f"{label} mesh losses {losses}")
    for name, n in per_step.items():
        check(launches[name] == n * MESH_STEPS,
              f"{label} mesh {name}: {launches[name]} launches in "
              f"{MESH_STEPS} steps, not {n} per step")
    check(out["rel_vs_shards"] < MESH_LOSS_BAR
          < out["control_rel_vs_shards"],
          f"{label}: the mesh loss against its shards' {out}")
    check(out["token_rel_vs_shards_f32"] < MESH_TOKEN_BAR
          < min(out["control_token_rel_global_capacity_f32"],
                out["control_token_rel_1x1_f32"]),
          f"{label}: the mesh's f32 token losses against its shards' {out}")
    return out


def train_phases(dev, arch: str = ARCH) -> dict:
    """(h)-(i): llama3.2-1b training at full width, flash attention
    against reference attention; (ae) whisper-base's,
    llava-next-mistral-7b's, gemma2-9b's and qwen3-14b's as
    ``STACK_TRAIN`` gives them (depth cut by ``cut_depth``, the stream
    built with the model's config so that it gives ``embeds`` or
    ``frames``), their steps donating their state, without the step
    profile and the loss witness; (t) mamba2-130m's, the ``ssd_scan``
    kernel against the chunked path (``chunked_mamba``), whose own
    spread (the chunked path at chunk 64 against 128, the same algebra
    summed in another order) widens the B 1 gradient bars as in (k);
    (z) granite-moe-3b-a800m's at ``one_card_config`` (``ep_degree=1``,
    flash against reference attention, B ``GRANITE_TRAIN_B``), its steps
    donating their state (AdamW in place: 52.8 GB of f32 state fits the
    card once, not twice), with the MoE drop share of step 0's batch, and
    neither the step profile nor the loss witness; its B 1 gradients
    compare with every expert routed (a bf16 top-k flips near-tie tokens
    between flash and reference attention)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch import one_card_config
    from repro_torch.models import count_params, loss_fn, model_flops
    from repro_torch.optim import AdamWConfig, global_norm, warmup_cosine
    from repro_torch.runtime.train_loop import TrainLoopConfig, train_loop
    from repro_torch.runtime.train_step import build_train_step

    mamba, moe = arch == MAMBA_ARCH, arch == GRANITE_ARCH
    stack = arch in STACK_TRAIN
    layers, B, S = STACK_TRAIN[arch] if stack else (None, TRAIN_B, TRAIN_S)
    steps, warmup = TRAIN_STEPS, TRAIN_WARMUP
    if moe:
        B, steps = GRANITE_TRAIN_B, GRANITE_TRAIN_STEPS
    elif mamba:
        steps = MAMBA_TRAIN_STEPS
    elif stack:
        steps, warmup = STACK_TRAIN_STEPS, STACK_TRAIN_WARMUP
    if mamba:
        label, cfg = "mamba2 train", get_config(arch)
        ref_cfg, reference = cfg, chunked_mamba
        ranges = (ssd_ops.VJP_RANGE,)
    else:
        label = "granite train" if moe else f"{arch} train" if stack \
            else "train"
        base = one_card_config(arch, smoke=False) if moe else \
            get_config(arch)
        if layers:
            base = cut_depth(base, layers)
        cfg = dataclasses.replace(base, attn_impl="flash")
        ref_cfg = dataclasses.replace(cfg, attn_impl="reference")
        reference, ranges = contextlib.nullcontext, ()
    check(cfg.remat == "full" and cfg.param_dtype == "float32"
          and cfg.compute_dtype == "bfloat16", "training config")
    donate = moe or stack
    ts = build_train_step(cfg, opt_cfg=AdamWConfig(
        lr=warmup_cosine(3e-3, 10, steps)), donate=donate, device=dev)
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=S,
                                        global_batch=B, seed=0),
                             cfg if stack else None)
    out = {}
    # host seconds of each part of the phase, printed at its end
    seconds, t_lap = {}, [time.perf_counter()]

    def lap(part: str) -> None:
        now = time.perf_counter()
        seconds[part] = now - t_lap[0]
        t_lap[0] = now

    # the reference's loss of step 0's batch at the initial weights
    # (train_loop starts from the same seed-0 parameters), and the kernel
    # model's loss at those weights on each step's batch, the baseline
    # that says how much of a step's loss is its batch (the witness's);
    # for the MoE model the capacity drops of step 0's batch
    params = ts.init_fn(0)[0]
    b0 = {k: torch.from_numpy(v).to(dev) for k, v in stream.batch(0).items()}
    with torch.no_grad():
        with reference():
            ref_loss0 = loss_fn(params, b0, ref_cfg, ts.rt).item()
        init_losses = [] if moe or stack else [loss_fn(params, {
            k: torch.from_numpy(v).to(dev)
            for k, v in stream.batch(i).items()}, cfg, ts.rt).item()
            for i in range(steps)]
        if moe:
            drops = moe_drops(params, b0, cfg, ts.rt)
            drops["share"] = drops["dropped"] / drops["routed"]
            out["moe_drops_step0"] = drops
            print(f"{label} step-0 MoE drops " + json.dumps(drops),
                  flush=True)
    del params
    torch.cuda.empty_cache()
    lap("reference_and_initial_losses")

    # the training loop, counts set to 0 just before it ------------------
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train_loop(ts, stream, TrainLoopConfig(steps=steps),
                     on_step=lambda step, loss, v: print(
                         f"{label} step {step}: loss {loss:.5f} "
                         f"{v.duration * 1e3:.2f} ms", flush=True))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = res["losses"]
    step_ms = statistics.median(
        v.duration * 1e3 for v in list(res["monitor"])[warmup:])
    tokens = B * S
    # remat="full": each step runs the forward twice (the recompute)
    per_step = expected_counts(cfg, forward_calls=2, backward=True)
    out["train"] = dict(
        arch=arch, layers=sum(g.repeats * len(g.blocks) for g in
                              cfg.groups + cfg.encoder_groups),
        batch=B, seq=S, batch_keys=sorted(b0), steps=steps,
        n_params=count_params(cfg), losses=losses,
        ref_loss0=ref_loss0,
        loss0_rel_vs_reference=abs(losses[0] - ref_loss0) / abs(ref_loss0),
        launches=launches, launches_per_step=per_step, step_ms=step_ms,
        step_ms_all=[v.duration * 1e3 for v in res["monitor"]],
        tokens_per_s=tokens / (step_ms * 1e-3),
        model_tflops=model_flops(cfg, tokens) / (step_ms * 1e-3) / 1e12,
        peak_mem_gb=peak / 1e9, loop_wall_s=wall_s, donated=donate,
        card=card_line())
    print(f"{label} " + json.dumps(out["train"]), flush=True)
    check(len(losses) == steps and all(map(math.isfinite, losses)),
          f"{label} losses {losses}")
    check(out["train"]["loss0_rel_vs_reference"] < 1e-2,
          f"{label} step-0 loss {losses[0]} vs the reference {ref_loss0}")
    for name, n in per_step.items():
        check(launches[name] == n * steps,
              f"{label} {name}: {launches[name]} launches in {steps} "
              f"steps, not {n} per step")
    check(not stack or launches["flash_attention_bwd_dkv"] > 0,
          f"{label}: the backward kernels never launched")
    lap("loop")

    if moe or stack:
        if moe:
            # one step on the virtual mesh from the donated state, last
            # before the gradients
            out["mesh"] = granite_mesh_steps(label, cfg, res["params"],
                                             res["opt"], stream, dev)
            lap("mesh")
        del res
        torch.cuda.empty_cache()
        # every expert routed at B 1: no top-k flip between the two
        # attentions, so every leaf compares
        gcfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, top_k=cfg.moe.n_experts)) if moe else cfg
        out["grads_b1"] = grads_b1(label, ts, b0, gcfg, dataclasses.replace(
            gcfg, attn_impl="reference"), reference, GRAD_BARS,
            seq=GEMMA_GRAD_S if arch == GEMMA_ARCH else None)
        lap("grads_b1")
        out["seconds"] = seconds
        print(f"{label} seconds " + json.dumps(seconds), flush=True)
        return out

    # the profile of one more step, last ----------------------------------
    params, opt = res["params"], res["opt"]
    del res
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in stream.batch(steps).items()}
    out["train_memory"] = step_memory(ts, params, opt, batch)
    lap("step_memory")

    def one_step():
        _p, _o, m = ts.step_fn(params, opt, batch)
        float(m["loss"])

    out["train_profile"] = profile_families(
        f"{label} step (B {B}, S {S})", one_step, step_ms,
        ranges=ranges)
    del params, opt
    torch.cuda.empty_cache()
    lap("profile")

    # the kernel model's gradients against the reference's at B 1 ----------
    out["grads_b1"] = grads_b1(
        label, ts, b0, cfg, ref_cfg, reference, GRAD_BARS,
        spread=(lambda: chunked_mamba(64)) if mamba else None)
    lap("grads_b1")

    # what makes the loss rise under the 3e-3 peak: the kernel and the
    # reference model from the same weights under the same schedule at
    # B 1; then the kernel model at B 4 under a tenth of the peak, whose
    # last loss must fall below the initial weights' on the same batch
    b1_stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                                           global_batch=1, seed=0))
    witness = {"init_weights_b4": init_losses}
    train_steps = steps
    for name, c, ctx, lr, s, B in (
            ("kernel_b1_3e-3", cfg, contextlib.nullcontext, 3e-3,
             b1_stream, 1),
            ("reference_b1_3e-3", ref_cfg, reference, 3e-3, b1_stream, 1),
            ("kernel_b4_3e-4", cfg, contextlib.nullcontext, 3e-4, stream,
             TRAIN_B)):
        steps = train_steps if B > 1 else \
            MAMBA_WITNESS_STEPS if mamba else WITNESS_STEPS
        ts_w = build_train_step(c, opt_cfg=AdamWConfig(
            lr=warmup_cosine(lr, 10, train_steps)), device=dev)
        with ctx():
            witness[name] = train_loop(
                ts_w, s, TrainLoopConfig(steps=steps))["losses"]
        torch.cuda.empty_cache()
        lap(f"witness_{name}")
    f1, r1 = witness["kernel_b1_3e-3"], witness["reference_b1_3e-3"]
    witness["kernel_vs_reference_rel"] = [abs(a - b) / abs(b)
                                          for a, b in zip(f1, r1)]
    out["loss_witness"] = witness
    print(f"{label} loss witness " + json.dumps(witness), flush=True)
    check(all(map(math.isfinite, f1 + r1))
          and max(witness["kernel_vs_reference_rel"]) < WITNESS_BAR,
          f"{label} B1 losses kernel {f1} vs reference {r1}")
    low = witness["kernel_b4_3e-4"]
    check(all(map(math.isfinite, low)) and low[-1] < init_losses[-1],
          f"{label}: the kernel model's loss under a 3e-4 peak {low} did "
          f"not fall below the initial weights' {init_losses}")
    out["seconds"] = seconds
    print(f"{label} seconds " + json.dumps(seconds), flush=True)
    return out


def grads_b1(label: str, ts, b0, cfg, ref_cfg, reference, bars,
             spread=None, seq: int = None) -> dict:
    """The kernel model's gradients against the reference's at B 1 from
    the seed-0 weights: the worst leaf's relative error, the global norms'
    and the difference's norm, each under its bar.  ``spread`` (a context
    for a second reference run) widens the bars to twice that run's
    reading; ``seq`` keeps the first ``seq`` tokens of the row."""
    import torch
    from repro_torch.models import loss_fn
    from repro_torch.optim import global_norm
    params = ts.init_fn(0)[0]
    b1 = {k: v[:1, :seq] if k in ("tokens", "labels") else v[:1]
          for k, v in b0.items()}
    names = [n for n, _ in params.named_parameters()]

    def grads_of(c, ctx):
        with ctx():
            loss = loss_fn(params, b1, c, ts.rt)
            return dict(zip(names, torch.autograd.grad(
                loss, list(params.parameters()))))

    def compare(g_a, g_b):
        leaf = {n: rel_err(g_a[n], g_b[n]) for n in g_a}
        n_a, n_b = global_norm(g_a).item(), global_norm(g_b).item()
        worst = max(leaf, key=leaf.get)
        return dict(worst_leaf=worst, leaf=leaf[worst], norm_kernel=n_a,
                    norm_reference=n_b, norm=abs(n_a - n_b) / n_b,
                    diff=global_norm({n: g_a[n] - g_b[n] for n in g_a})
                    .item() / n_b)

    g_r = grads_of(ref_cfg, reference)
    cmp = compare(grads_of(cfg, contextlib.nullcontext), g_r)
    bars = dict(bars)
    if spread is not None:
        wide = compare(grads_of(cfg, spread), g_r)
        cmp["chunked_64_vs_128"] = wide
        bars = {k: max(v, 2 * wide[k]) for k, v in bars.items()}
    cmp["bars"] = bars
    cmp["seq"] = int(b1["tokens"].shape[1])
    print(f"{label} grads B1 kernel vs reference " + json.dumps(cmp),
          flush=True)
    check(all(cmp[k] < bars[k] for k in bars),
          f"{label} B1 gradients kernel vs reference: {cmp}")
    del params, g_r
    torch.cuda.empty_cache()
    return cmp


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


def launch_counts() -> dict:
    """Every kernel wrapper's launch count: flash forward and backward
    (one CUDA launch a call each), ``ssd_scan`` calls and their CUDA
    launches (four a call)."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    return dict(
        flash_attention_fwd=fa_kernel.flash_attention_fwd.launches,
        flash_attention_bwd_dkv=fa_kernel.flash_attention_bwd_dkv.launches,
        flash_attention_bwd_dq=fa_kernel.flash_attention_bwd_dq.launches,
        ssd_scan=ssd_kernel.ssd_scan.launches,
        ssd_scan_cuda=ssd_kernel.ssd_scan.cuda_launches)


def zero_counts() -> None:
    """Set every count of :func:`launch_counts` to 0."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    for fn in (fa_kernel.flash_attention_fwd,
               fa_kernel.flash_attention_bwd_dkv,
               fa_kernel.flash_attention_bwd_dq):
        fn.launches = 0
    ssd_kernel.ssd_scan.launches = ssd_kernel.ssd_scan.cuda_launches = 0


def expected_counts(cfg, forward_calls: int = 1, backward: bool = False
                    ) -> dict:
    """:func:`launch_counts` of ``forward_calls`` forwards of ``cfg`` (and
    one backward): a flash launch an attention block a forward, an
    ``ssd_scan`` call (4 CUDA launches) a Mamba block a forward, and with
    the backward one launch of each flash backward kernel an attention
    block (the SSD scan's backward is plain PyTorch)."""
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    attn = blocks_of(cfg, "attn") + blocks_of(cfg, "cross_attn")
    mamba = blocks_of(cfg, "mamba")
    return dict(flash_attention_fwd=forward_calls * attn,
                flash_attention_bwd_dkv=attn if backward else 0,
                flash_attention_bwd_dq=attn if backward else 0,
                ssd_scan=forward_calls * mamba,
                ssd_scan_cuda=forward_calls * mamba * len(ssd_kernel.PASSES))


def blocks_of(cfg, mixer: str) -> int:
    """The blocks of ``cfg`` (decoder and encoder) whose mixer is
    ``mixer``; ``"cross_attn"`` counts the cross-attention blocks."""
    def has(b):
        return b.cross_attn if mixer == "cross_attn" else b.mixer == mixer
    return sum(g.repeats * sum(has(b) for b in g.blocks)
               for g in cfg.groups + cfg.encoder_groups)


@contextlib.contextmanager
def chunked_mamba(chunk: int = None):
    """While open, every Mamba block's scan takes the JAX model's default
    path (``impl="chunked"``, optionally at another chunk length), a
    check only: it must launch no ``ssd_scan``.  Models without Mamba
    blocks are untouched."""
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.models import blocks
    real = blocks.mamba_apply
    blocks.mamba_apply = lambda p, h, mcfg, impl: real(
        p, h, dataclasses.replace(mcfg, chunk=chunk or mcfg.chunk),
        impl="chunked")
    before = ssd_kernel.ssd_scan.launches
    try:
        yield
    finally:
        blocks.mamba_apply = real
    check(ssd_kernel.ssd_scan.launches == before,
          "the chunked path launched ssd_scan")


def raised_capacity(cfg):
    """``cfg`` with every expert taking every token of a call (capacity
    factor E: cap = T), so no token is dropped.  Capacity drops make a
    token's output depend on the call's other tokens (the reference's
    semantics): a 64-token prompt on granite has cap 16 against a mean
    load of 12.8, where one-token decode (cap = T) never drops.  Decode
    is held to prefill at this capacity, on both sides."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.padded_experts)))


def moe_drops(params, batch, cfg, rt) -> dict:
    """The (token, expert) pairs one prefill routes, and how many of them
    its capacity drops: ``expert_load`` on each MoE block's input, summed
    on the card; under a mesh runtime (``moe_apply``), also each batch
    shard's drops (``per_shard``)."""
    import torch
    from repro_torch.models import blocks, moe, prefill
    name = "moe_apply" if rt.distributed else "moe_single"
    real = getattr(blocks, name)
    dropped, routed = [], []

    def counted(p, x, mcfg, **kw):
        load, cap = moe.expert_load(p, x, mcfg, mesh=rt.mesh,
                                    dp_axes=rt.dp_axes) \
            if rt.distributed else moe.expert_load(p, x, mcfg)
        dropped.append((load - cap).clamp_min(0).sum(-1))
        routed.append(load.sum(-1))
        return real(p, x, mcfg, **kw)

    setattr(blocks, name, counted)
    try:
        prefill(params, batch, cfg, rt)
    finally:
        setattr(blocks, name, real)
    per_shard = torch.stack(dropped).sum(0)
    out = dict(dropped=int(per_shard.sum()),
               routed=int(torch.stack(routed).sum()),
               moe_blocks=len(dropped))
    if rt.distributed:
        out["per_shard"] = per_shard.tolist()
    return out


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


def profile_families(label: str, run, wall_ms: float, ranges=()) -> dict:
    """(f): where one call's device time goes, by kernel family, with its
    kernel launches, and the device's idle share of the call's
    unprofiled host wall time ``wall_ms``.  Each ``torch.profiler`` range
    named in ``ranges`` gets the device time of the kernels its ops
    launched and that time's share of the busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    fam: dict = {}
    for e in device_work(prof, prof.key_averages()):
        if e.self_device_time_total > 0:
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
    if ranges:
        cpu = torch.autograd.DeviceType.CPU
        out["ranges"] = {}
        for name in ranges:
            spans = [e for e in prof.events()
                     if e.name == name and e.device_type == cpu]
            us = sum(e.device_time_total for e in spans)
            out["ranges"][name] = dict(calls=len(spans), device_us=us,
                                       share_of_busy=us / busy_us)
    print(f"{label} profile " + json.dumps(out), flush=True)
    check(busy_us > 0, f"profiler recorded no device time in {label}")
    for name, r in out.get("ranges", {}).items():
        check(r["calls"] > 0 and r["device_us"] > 0,
              f"{label}: no device time inside the range {name}")
    return out


def mesh_decode(label: str, rng, cfg, params, dev,
                one_card_ms: float) -> dict:
    """(e) on the virtual ``MESH_SHAPE`` mesh: the ``MESH_BUCKET`` bucket
    (batch over the pod and data axes, the cache's sequence over the 4
    model shards) against the same bucket on a 1x1 mesh, both as
    ``build_serve_step`` builds them.  ``DECODE_TOKENS`` teacher-forced
    steps: the logits' largest relative error within
    ``MESH_DECODE_BAR``, and the control (every cache shard's slots
    counted from 0, ``attention.shard_slots``) beyond it; then the
    bucket's captured decode of ``DECODE_TOKENS`` greedy tokens equal to
    its eager steps', and its ms per token (the median of
    ``DECODE_CALLS`` calls) beside the 1x1 bucket's captured ms and the
    one-card engine's (``serve_paths``)."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import attention, decode_step, init_caches
    from repro_torch.runtime.train_step import build_serve_step
    B, C = MESH_BUCKET
    V, T = cfg.vocab, DECODE_TOKENS
    ss = build_serve_step(cfg, make_mesh(MESH_SHAPE), global_batch=B,
                          cache_len=C, device=dev)
    ss1 = build_serve_step(cfg, make_mesh((1, 1)), global_batch=B,
                           cache_len=C, device=dev)
    check(ss.rt.dp_axes == ("pod", "data") and ss.rt.seq_axes == ("model",),
          f"{label} mesh bucket axes {ss.rt.dp_axes} {ss.rt.seq_axes}")
    toks = torch.from_numpy(rng.integers(0, V, (B, T))).to(dev)

    def teacher(rt):
        caches = init_caches(cfg, B, C, device=dev)
        out = []
        for t in range(T):
            _, lg, caches = decode_step(params, toks[:, t], caches, t, cfg,
                                        rt)
            out.append(lg[:, :V].float())
        return torch.stack(out)

    want = teacher(ss1.rt)
    got = teacher(ss.rt)
    reading = max(rel_err(g, w) for g, w in zip(got, want))
    real = attention.shard_slots
    attention.shard_slots = lambda n, Sc, device: real(1, Sc, device) \
        .expand(n, Sc)
    try:
        ctrl = teacher(ss.rt)
    finally:
        attention.shard_slots = real
    control = max(rel_err(g, w) for g, w in zip(ctrl, want))
    del got, want, ctrl
    # greedy: the captured decode against the eager steps on the mesh
    tok, caches, eager = toks[:, 0], init_caches(cfg, B, C, device=dev), []
    for t in range(T):
        tok, caches = ss.step_fn(params, caches, tok, t)
        eager.append(tok)
    captured, _ = ss.decode_fn(T)(params, toks[:, 0], 0)
    same = bool(torch.equal(captured, torch.stack(eager)))

    def per_token_ms(step):
        fn = step.decode_fn(T)
        times = []
        for _ in range(DECODE_CALLS + 1):
            t0 = time.perf_counter()
            fn(params, toks[:, 0], 0)[0].cpu()
            times.append((time.perf_counter() - t0) * 1e3 / T)
        return statistics.median(times[1:])       # the first captures

    out = dict(mesh=list(MESH_SHAPE), bucket=list(MESH_BUCKET),
               batch_axes=list(ss.rt.dp_axes), seq_axes=list(ss.rt.seq_axes),
               cache_shard_slots=C // MESH_SHAPE[-1], steps=T,
               rel_err_vs_1x1=reading, control_slot_offset_dropped=control,
               bar=MESH_DECODE_BAR, captured_equals_eager=same,
               captured_ms_per_token=per_token_ms(ss),
               captured_ms_per_token_1x1=per_token_ms(ss1),
               one_card_engine_ms_per_token=one_card_ms,
               captures=ss.graph.captures if ss.graph else 0,
               card=card_line())
    print(f"{label} bucket {MESH_BUCKET} on the {MESH_SHAPE} mesh " +
          json.dumps(out), flush=True)
    check(reading < MESH_DECODE_BAR < control,
          f"{label}: the mesh bucket's decode against the 1x1 bucket's {out}")
    check(same, f"{label}: the mesh bucket's captured decode differs from "
                f"its eager steps")
    return out


def serving_phases(rng, dev) -> dict:
    """(c)-(f): the llama3.2-1b serving path at full width."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.models import (Group, Runtime, decode_step, init_caches,
                                    prefill)

    cfg = dataclasses.replace(get_config(ARCH), attn_impl="flash")
    ref_cfg = dataclasses.replace(cfg, attn_impl="reference")
    rt = Runtime(dev)
    params, load = load_model(ARCH, cfg, dev)
    out = dict(load=load)

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

    # (e) serving behind LPFServer, captured and per token, then the
    # (4, 256) bucket on the virtual mesh ----------------------------------
    out["serve"], eng = serve_paths(ARCH, cfg, params, dev)
    out["mesh_decode"] = mesh_decode(
        ARCH, rng, cfg, params, dev,
        out["serve"]["buckets"][str(MESH_BUCKET)]["captured_ms_per_token"])

    # (f) profiles last: after a torch.profiler session the host's eager
    # dispatch may run slower, which would skew the decode timings above
    out["profile"] = profile_families(
        "prefill", lambda: prefill(params, batch, cfg, rt), ms)
    out["decode_profile"], out["captured_decode_profile"] = step_profiles(
        ARCH, cfg, params, eng, dev)
    del eng
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
    from repro_torch.models import (Runtime, cast_params, decode_step,
                                    init_caches, init_params, prefill)

    cfg = get_config(MAMBA_ARCH)
    check(cfg.compute_dtype == "bfloat16" and cfg.n_layers == 24,
          "mamba2-130m config")
    rt = Runtime(dev)
    params, load = load_model(MAMBA_ARCH, cfg, dev)
    out = dict(load=load)

    def chunked_prefill(batch, chunk=None, p=params, c=cfg):
        """The same prefill with the blocks' scan through the JAX model's
        default path (``impl="chunked"``, optionally at another chunk
        length), a check only."""
        with chunked_mamba(chunk):
            return prefill(p, batch, c, rt)

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

    # serving behind LPFServer, captured and per token ---------------------
    out["serve"], eng = serve_paths(MAMBA_ARCH, cfg, params, dev)

    # profiles last, as in (f)
    out["profile"] = profile_families(
        "mamba2 prefill", lambda: prefill(params, batch, cfg, rt), ms)
    out["long_profile"] = profile_families(
        f"mamba2 prefill B 1 x S {LONG_S}",
        lambda: prefill(params, long, cfg, rt), long_ms)
    out["decode_profile"], out["captured_decode_profile"] = step_profiles(
        MAMBA_ARCH, cfg, params, eng, dev)
    del params, eng, logits, long_logits
    torch.cuda.empty_cache()
    return out


def timed_decode(eng, bucket, calls: int = DECODE_CALLS) -> tuple:
    """Host ms per token of a full-batch ``DECODE_TOKENS``-token decode of
    ``bucket`` through ``eng``: the median of ``calls`` calls (each
    waiting for its tokens) and each call's, and the streams of the last
    call."""
    from repro_torch.runtime.server import ServeRequest
    n = DECODE_TOKENS
    reqs = [ServeRequest(rid=i, n_tokens=n, deadline_s=1.0, seed=1000 + i)
            for i in range(bucket[0])]
    ts = []
    for _ in range(calls):
        t0 = time.perf_counter()
        streams = eng.decode(bucket, reqs, n)
        ts.append(time.perf_counter() - t0)
    per_call = [t * 1e3 / n for t in ts]
    return statistics.median(per_call), per_call, streams


def serve_paths(label: str, cfg, params, dev, buckets=SERVE_BUCKETS):
    """Serving behind ``LPFServer`` through both decode paths: the engine
    as a user builds it (each bucket's step captured as a CUDA graph and
    replayed once a token), and beside it one whose buckets are all
    quarantined (one eager step a token).  Each bucket's ms per token on
    each path is ``timed_decode``'s (a full batch, ``DECODE_TOKENS``
    tokens; the median of ``DECODE_CALLS`` calls captured, one call per
    token), whose streams must be
    the same on both paths; each engine's admission price (the slope and
    intercept its warm-up calibration fits) is printed beside it.
    8 ``synthetic_requests`` (seed 0, at most 32 tokens) through the
    captured engine: no deadline miss, no quarantine, one capture a
    bucket, and every completed stream bit-identical to its solo decode on
    the captured path and on the per-token path.  Returns (the summary,
    the captured engine)."""
    from repro_torch.launch.serve import ModelDecodeEngine, serve
    eng = ModelDecodeEngine(cfg, buckets, params=params, device=dev)
    per_token = ModelDecodeEngine(cfg, buckets, params=params, device=dev,
                                  per_token=True)
    check(eng.captures == len(buckets) and per_token.captures == 0,
          f"{label}: {eng.captures} captures for {len(buckets)} buckets, "
          f"{per_token.captures} on the per-token engine")
    ms = {}
    for b in eng.buckets():
        cap_ms, cap_calls, cap = timed_decode(eng, b)
        pt_ms, pt_calls, pt = timed_decode(per_token, b, calls=1)
        check(cap == pt, f"{label} bucket {b}: the captured {DECODE_TOKENS}"
                         f"-token decode differs from the per-token one")
        ms[str(b)] = dict(
            captured_ms_per_token=cap_ms, per_token_ms_per_token=pt_ms,
            captured_calls=cap_calls, per_token_calls=pt_calls,
            captured_price_ms_per_token=eng.token_seconds(b) * 1e3,
            captured_price_ms_per_call=eng.overhead_seconds(b) * 1e3,
            per_token_price_ms_per_token=per_token.token_seconds(b) * 1e3,
            per_token_price_ms_per_call=per_token.overhead_seconds(b) * 1e3)
    del per_token
    res = serve(eng, requests=8, seed=0, max_tokens=32, check=True)
    health = res["health"]
    check(res["completed"] >= 1, f"{label}: no request completed")
    check(res["solo_identical"] == res["completed"],
          f"{label}: batched streams differ from solo decodes")
    check(res["per_token_identical"] == res["completed"],
          f"{label}: captured streams differ from per-token decodes")
    check(health["deadline_misses"] == 0, f"{label}: deadline misses")
    check(res["quarantines"] == 0 and not eng.quarantined
          and health["decode_fallbacks"] == 0,
          f"{label}: {res['quarantines']} quarantines in the serving run")
    out = dict(buckets=ms, completed=res["completed"],
               tokens=res["tokens"], wall_s=res["wall_s"],
               tokens_per_s=res["tokens_per_s"],
               solo_identical=res["solo_identical"],
               per_token_identical=res["per_token_identical"],
               quarantines=res["quarantines"], captures=eng.captures,
               replays=eng.replays,
               **{k: health[k] for k in (
                   "admitted", "rejected_total", "shed", "deadline_misses",
                   "batches", "decode_fallbacks", "queue_depth")})
    print(f"{label} serve " + json.dumps(out), flush=True)
    return out, eng


def step_profiles(label: str, cfg, params, eng, dev,
                  bucket=SERVE_BUCKETS[-1], ranges=()) -> tuple:
    """One eager decode step and one replay of the bucket's captured step
    at position C / 2 (``torch.profiler``): device time by kernel family,
    kernels launched, and the device's idle share of each one's
    unprofiled host wall time; the eager step's ``ranges`` too (a replay
    runs no host ops, so none shows in it)."""
    import torch
    from repro_torch.models import Runtime, decode_step, init_caches
    B, C = bucket
    rt = Runtime(dev)
    caches = init_caches(cfg, B, C, device=dev)
    tok = torch.zeros(B, dtype=torch.long, device=dev)
    enc = eng._enc[tuple(bucket)]          # an encoder-decoder's zeros
    step = lambda: decode_step(params, tok, caches, C // 2, cfg, rt, *enc)
    eager = profile_families(f"{label} eager decode step (B {B}, cache {C})",
                             step, host_ms(step), ranges=ranges)
    g = eng.serve_step(bucket).graph
    g.pos.fill_(C // 2)
    replay = g.graph.replay
    captured = profile_families(
        f"{label} captured decode step (B {B}, cache {C})", replay,
        host_ms(replay))
    return eager, captured


def load_model(label: str, cfg, dev) -> tuple:
    """Full-width weights from ``SEED`` through ``load_params`` (each
    matrix cast to the compute dtype as it is drawn): seconds, the
    weights' bytes and the peak device memory of the load."""
    import torch
    from repro_torch.models import load_params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = load_params(SEED, cfg, device=dev)
    torch.cuda.synchronize()
    info = dict(
        parameters=sum(p.numel() for p in params.parameters()),
        weights_gb=sum(p.numel() * p.element_size()
                       for p in params.parameters()) / 1e9,
        load_s=time.perf_counter() - t0,
        load_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        allocated_before_gb=base / 1e9)
    print(f"{label} load " + json.dumps(info), flush=True)
    return params, info


def rolled(params, names, shift: int, under: str = None):
    """``params`` with each leaf named in ``names`` rolled by ``shift``
    along its last (output) axis (only inside the top-level subtree
    ``under``, where given: ``"enc_enc"`` is whisper's encoder).  K and
    V projections rolled by one KV head (``("wk", "wv", "bk", "bv")``,
    head dim): a prefill on them
    computes what a flash kernel that reads each query group's keys and
    values from the next group's head computes; Mamba's x projection
    rolled by one head (``("in_x",)``, the Mamba head dim): what an SSD
    scan that reads each head's x from the next head computes."""
    from repro_torch.models import ParamTree
    import torch

    def roll(tree):
        return {k: roll(v) if isinstance(v, dict) else (
            torch.roll(v, shift, dims=-1) if k in names else v)
            for k, v in tree.items()}
    tree = params.tree()
    if under is None:
        return ParamTree(roll(tree))
    return ParamTree({**tree, under: roll(tree[under])})


def without_window(cfg):
    """``cfg`` with every block's sliding window dropped."""
    return dataclasses.replace(cfg, groups=tuple(dataclasses.replace(
        g, blocks=tuple(dataclasses.replace(b, window=None)
                        for b in g.blocks)) for g in cfg.groups))


def dense_prefill(label: str, rng, cfg, params, dev, B: int, S: int,
                  ranges=None, batch=None, extra_controls=None) -> dict:
    """Prefill at full width with every count set to 0 just before: one
    ``flash_attention_fwd`` launch an attention block and one ``ssd_scan``
    call a Mamba block (``expected_counts``), finite last-position logits
    within the gate of the same prefill with ``attn_impl="reference"`` and
    the chunked scan (``chunked_mamba``); host milliseconds and tokens/s.
    The gate's two readings at this shape, each checked: a sound run (the
    reference prefill in bf16 against the same in f32 compute on the same
    weights: what bf16 rounding alone moves) passes it, and each control
    (a flash prefill of a wrong kernel's function: K/V heads of the next
    group; without the local layers' window where the model has one)
    fails it (and, for a model with Mamba blocks, a prefill whose scan
    reads each head's x from the next head).  The gate is
    ``DENSE_PREFILL_BAR``; for an MoE model the bar
    or twice the sound run's reading, whichever is wider: routing is a
    top-k, so a rounding difference can send a near-tie token to another
    expert, which moves its output by a whole expert's share (the
    smallest move a wrong kernel makes is the controls' reading).  An MoE
    model also prints the prefill's capacity drops (``moe_drops``).  With
    ``ranges``, one more prefill is profiled (``profile_families``).
    ``batch``: the prefill's batch on the card (a vision prefix's
    ``embeds``, an encoder's ``frames``), else ``B x S`` tokens from
    ``rng``; ``extra_controls``: ``{name: (params, batch)}`` of more flash
    prefills that must fail the gate."""
    import torch
    from repro_torch.models import Runtime, prefill
    rt = Runtime(dev)
    V = cfg.vocab
    if batch is None:
        batch = {"tokens": torch.from_numpy(rng.integers(0, V, (B, S)))
                 .to(dev)}
    zero_counts()
    logits = prefill(params, batch, cfg, rt)
    torch.cuda.synchronize()
    counts = launch_counts()
    ref_cfg = dataclasses.replace(cfg, attn_impl="reference")
    with chunked_mamba():
        ref = prefill(params, batch, ref_cfg, rt)[:, :V]
        f32 = prefill(params, batch, dataclasses.replace(
            ref_cfg, compute_dtype="float32"), rt)[:, :V]
    rel = rel_err(logits[:, :V], ref)
    controls = {"kv_heads_rolled": rel_err(prefill(
        rolled(params, ("wk", "wv", "bk", "bv"), cfg.hd), batch, cfg,
        rt)[:, :V], ref)}
    if any(b.window for g in cfg.groups for b in g.blocks):
        controls["window_dropped"] = rel_err(prefill(
            params, batch, without_window(cfg), rt)[:, :V], ref)
    if blocks_of(cfg, "mamba"):
        controls["ssd_x_heads_rolled"] = rel_err(prefill(
            rolled(params, ("in_x",), cfg.mamba.head_dim), batch, cfg,
            rt)[:, :V], ref)
    for name, (c_params, c_batch) in (extra_controls or {}).items():
        controls[name] = rel_err(prefill(c_params, c_batch, cfg, rt)[:, :V],
                                 ref)
    sound = rel_err(ref, f32)
    gate = DENSE_PREFILL_BAR if cfg.moe is None else max(
        DENSE_PREFILL_BAR, 2 * sound)
    readings = dict(bar=DENSE_PREFILL_BAR, gate=gate,
                    sound_bf16_vs_f32=sound,
                    flash_vs_f32=rel_err(logits[:, :V], f32),
                    controls=controls)
    print(f"{label} prefill bar " + json.dumps(readings), flush=True)
    want = expected_counts(cfg)
    check(logits.shape == (B, cfg.vocab_padded)
          and bool(torch.isfinite(logits[:, :V]).all()),
          f"{label} prefill logits shape/finite")
    check(counts == want, f"{label} prefill launched {counts}, not {want}")
    check(rel < gate, f"{label} prefill flash vs reference rel err {rel}, "
                      f"gate {gate}")
    check(cfg.moe is not None or sound < gate,
          f"{label} prefill bar under a sound run's {sound}")
    check(all(c > gate for c in controls.values()),
          f"{label} prefill gate {gate} passes a control: {controls}")
    del ref, f32
    drops = moe_drops(params, batch, cfg, rt) if cfg.moe else None
    torch.cuda.reset_peak_memory_stats()
    ms = host_ms(lambda: prefill(params, batch, cfg, rt), reps=3, warmup=1)
    out = dict(batch=B, seq=S, layers=cfg.n_layers, card=card_line(),
               flash_launches=counts["flash_attention_fwd"],
               ssd_launches=counts["ssd_scan"],
               ssd_cuda_launches=counts["ssd_scan_cuda"],
               rel_err_vs_reference=rel, bar_readings=readings, e2e_ms=ms,
               tokens_per_s=B * S / (ms * 1e-3), capacity_drops=drops,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"{label} prefill " + json.dumps(out), flush=True)
    if ranges is not None:
        # last, as in (f): a profiler session may slow later host work
        out["profile"] = profile_families(
            f"{label} prefill (B {B}, S {S})",
            lambda: prefill(params, batch, cfg, rt), ms, ranges=ranges)
    return out


def teacher_forced(label: str, rng, cfg, params, dev, S: int = TEACHER_S,
                   published=None) -> dict:
    """``S`` ``decode_step`` calls at B 1 against ``prefill`` of the same
    prompt: last logits within 0.08 (relative); ms a step.  A model with
    Mamba blocks is held as in (l): in f32 compute within 0.08, in bf16
    within 0.08 or, where the chunked path's own spread on the same
    prompt (chunk 16 against the config's) is wider, twice that spread.
    ``published``: the MoE config whose capacity ``cfg`` raised, whose
    drops on the same prompt are printed beside."""
    import torch
    from repro_torch.models import Runtime, decode_step, init_caches, prefill
    rt = Runtime(dev)
    V = cfg.vocab
    toks = torch.from_numpy(rng.integers(0, V, (1, S))).to(dev)

    def run(c):
        want = prefill(params, {"tokens": toks}, c, rt)
        caches = init_caches(c, 1, S, device=dev)
        t0 = time.perf_counter()
        for t in range(S):
            _, got, caches = decode_step(params, toks[:, t], caches, t, c,
                                         rt)
        torch.cuda.synchronize()
        return (rel_err(got[:, :V], want[:, :V]),
                (time.perf_counter() - t0) * 1e3 / S)

    rel, step_ms = run(cfg)
    out = dict(prompt=S, rel_err=rel, decode_ms_per_step_b1=step_ms)
    bar = 0.08
    if blocks_of(cfg, "mamba"):
        out["f32_rel_err"], _ = run(dataclasses.replace(
            cfg, compute_dtype="float32"))
        with chunked_mamba(16):
            fine = prefill(params, {"tokens": toks}, cfg, rt)[:, :V]
        with chunked_mamba():
            out["chunked_16_vs_default_rel"] = rel_err(
                fine, prefill(params, {"tokens": toks}, cfg, rt)[:, :V])
        bar = max(bar, 2 * out["chunked_16_vs_default_rel"])
        check(out["f32_rel_err"] < 0.08,
              f"{label} f32 teacher-forced decode vs prefill rel err "
              f"{out['f32_rel_err']}")
    if published is not None:
        out["capacity_factor"] = cfg.moe.capacity_factor
        out["published_factor_drops"] = moe_drops(
            params, {"tokens": toks}, published, rt)
    out["bar"] = bar
    print(f"{label} teacher-forced decode " + json.dumps(out), flush=True)
    check(rel < bar, f"{label} teacher-forced decode vs prefill rel err "
                     f"{rel}, bar {bar}")
    return out


def cut_depth(cfg, layers: int):
    """``cfg`` with its one group cut to ``layers`` layers (whole units of
    the group's pattern), every width and block kind kept."""
    from repro_torch.models import Group
    (g,) = cfg.groups
    check(layers % len(g.blocks) == 0, f"{cfg.name}: {layers} layers is not "
          f"a whole number of its {len(g.blocks)}-block unit")
    return dataclasses.replace(cfg, groups=(Group(
        g.name, g.blocks, layers // len(g.blocks)),))


def dense_phases(dev) -> dict:
    """(p)-(r): gemma2-9b and qwen3-14b at full width and qwen1.5-110b at
    its published widths, each cut in depth; each model freed before the
    next."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    out = {}
    for arch, B, S, seed, layers, full in (
            (GEMMA_ARCH, GEMMA_B, GEMMA_S, 7, GEMMA_LAYERS, 42),
            (QWEN3_ARCH, QWEN3_B, QWEN3_S, 8, QWEN3_LAYERS, 40)):
        rng = np.random.default_rng([SEED, seed])
        cfg = cut_depth(dataclasses.replace(get_config(arch),
                                            attn_impl="flash"), layers)
        print(f"{arch}: published widths, depth cut to {layers} of {full} "
              f"layers (every block kind kept), to keep the whole script "
              f"inside its time", flush=True)
        params, load = load_model(arch, cfg, dev)
        res = dict(load=load)
        res["prefill"] = dense_prefill(arch, rng, cfg, params, dev, B, S)
        res["teacher"] = teacher_forced(arch, rng, cfg, params, dev)
        res["serve"], eng = serve_paths(arch, cfg, params, dev)
        res["decode_profile"], res["captured_decode_profile"] = \
            step_profiles(arch, cfg, params, eng, dev)
        out[arch] = res
        del params, eng
        torch.cuda.empty_cache()
    cfg = cut_depth(dataclasses.replace(get_config(QWEN110_ARCH),
                                        attn_impl="flash"), QWEN110_LAYERS)
    print(f"{QWEN110_ARCH}: published widths, depth cut to "
          f"{QWEN110_LAYERS} of 80 layers (222 GB of bf16 weights at full "
          f"depth, over one card's 80 GB)", flush=True)
    params, load = load_model(QWEN110_ARCH, cfg, dev)
    out[QWEN110_ARCH] = dict(load=load, layers=QWEN110_LAYERS,
                             prefill=dense_prefill(
                                 QWEN110_ARCH, np.random.default_rng(
                                     [SEED, 9]), cfg, params, dev,
                                 QWEN110_B, QWEN110_S))
    del params
    torch.cuda.empty_cache()
    return out


def moe_layer_check(params, cfg, rng, dev) -> dict:
    """One MoE layer (layer 0's weights, upcast to f32) at B 1 x S
    ``MOE_LAYER_S`` in f32 on the card against the same call on the CPU:
    the output within ``MOE_LAYER_BAR`` (relative), the tokens routed to
    each expert equal, and the card's milliseconds for it."""
    import torch
    from repro_torch.models import moe
    tree = params.tree()["dec_body"]["b0"]["moe"]
    p = {k: v[0].float() for k, v in tree.items()}
    p_cpu = {k: v.cpu() for k, v in p.items()}
    x = torch.from_numpy(rng.standard_normal(
        (1, MOE_LAYER_S, cfg.d_model), dtype=np.float32))
    xd = x.to(dev)
    y = moe.moe_single(p, xd, cfg.moe)
    load, cap = moe.expert_load(p, xd, cfg.moe)
    y_cpu = moe.moe_single(p_cpu, x, cfg.moe)
    load_cpu, _ = moe.expert_load(p_cpu, x, cfg.moe)
    out = dict(shape=[1, MOE_LAYER_S, cfg.d_model],
               experts=p["w_gate"].shape[0], top_k=cfg.moe.top_k,
               capacity=cap, rel_err=rel_err(y.cpu(), y_cpu),
               bar=MOE_LAYER_BAR, routed=load.tolist(),
               same_routing=load.cpu().tolist() == load_cpu.tolist(),
               dropped=int((load - cap).clamp_min(0).sum()),
               ms_f32=cuda_ms(lambda: moe.moe_single(p, xd, cfg.moe)))
    print(f"{cfg.name} one MoE layer card vs CPU " + json.dumps(out),
          flush=True)
    check(out["rel_err"] < MOE_LAYER_BAR and out["same_routing"],
          f"{cfg.name}: one MoE layer on the card vs the CPU {out}")
    return out


def mesh_cfg(cfg):
    """``cfg`` with its experts padded for ``MESH_SHAPE``'s model axis
    (``ep_degree``, as the launchers set it from the mesh)."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, ep_degree=MESH_SHAPE[-1]))


def mesh_runtime(dev, shape=MESH_SHAPE):
    """The runtime ``build_train_step`` gives a mesh of ``shape``
    (``axis_roles="fsdp_tp"``)."""
    from repro_torch.launch.mesh import dp_axes_of, make_mesh
    from repro_torch.models import Runtime
    mesh = make_mesh(shape)
    return Runtime(dev, mesh, dp_axes=dp_axes_of(mesh), model_axis="model")


def moe_mesh_check(params, cfg, rng, dev) -> dict:
    """One MoE layer (layer 0's weights, upcast to f32) at B
    ``MESH_LAYER_B`` x S ``MOE_LAYER_S`` in f32 through ``moe_apply`` on
    the virtual ``MESH_SHAPE`` mesh (a batch shard a row, 10 experts a
    model shard): against the same call on the CPU, and against the
    identity ``moe_apply`` on (1, D, M) = D ``moe_single`` calls on the
    batch shards, each within ``MOE_LAYER_BAR``; the control,
    ``moe_single`` over the whole batch (one capacity for all its
    tokens), printed beside and beyond the bar wherever the shards drop
    other counts than the whole batch does; each batch shard's drops, and
    the card's milliseconds of both calls."""
    import torch
    from repro_torch.models import moe
    mcfg = mesh_cfg(cfg).moe
    rt = mesh_runtime(dev)
    check(mcfg.padded_experts == mcfg.n_experts,
          f"{cfg.name}: {mcfg.padded_experts} experts over "
          f"{MESH_SHAPE[-1]} model shards, not {mcfg.n_experts}")
    tree = params.tree()["dec_body"]["b0"]["moe"]
    p = {k: v[0].float() for k, v in tree.items()}
    p_cpu = {k: v.cpu() for k, v in p.items()}
    # tokens that share one direction, as a model's hidden states do:
    # isotropic noise routes evenly and drops nothing at this size
    shared = rng.standard_normal(cfg.d_model, dtype=np.float32)
    x = torch.from_numpy(rng.standard_normal(
        (MESH_LAYER_B, MOE_LAYER_S, cfg.d_model), dtype=np.float32)
        + shared)
    xd = x.to(dev)
    kw = dict(mesh=rt.mesh, dp_axes=rt.dp_axes)
    y = moe.moe_apply(p, xd, mcfg, **kw)
    y_cpu = moe.moe_apply(p_cpu, x, mcfg, **kw)
    shards = torch.cat([moe.moe_single(p, xs, mcfg)
                        for xs in xd.chunk(MESH_SHAPE[0] * MESH_SHAPE[1])])
    whole = moe.moe_single(p, xd, mcfg)
    load, cap = moe.expert_load(p, xd, mcfg, **kw)
    load1, cap1 = moe.expert_load(p, xd, mcfg)
    drops = (load - cap).clamp_min(0).sum(1).tolist()
    drops1 = int((load1 - cap1).clamp_min(0).sum())
    out = dict(mesh=list(MESH_SHAPE), shape=list(x.shape),
               experts=p["w_gate"].shape[0], top_k=mcfg.top_k,
               shard_capacity=cap, capacity=cap1, drops_per_shard=drops,
               drops_whole_batch=drops1,
               rel_err_vs_cpu=rel_err(y.cpu(), y_cpu),
               rel_err_vs_shards=rel_err(y, shards),
               control_moe_single_whole_batch=rel_err(whole, shards),
               bar=MOE_LAYER_BAR,
               ms_f32=cuda_ms(lambda: moe.moe_apply(p, xd, mcfg, **kw)),
               moe_single_ms_f32=cuda_ms(
                   lambda: moe.moe_single(p, xd, mcfg)),
               card=card_line())
    print(f"{cfg.name} one MoE layer on the {MESH_SHAPE} mesh " +
          json.dumps(out), flush=True)
    check(out["rel_err_vs_cpu"] < MOE_LAYER_BAR
          and out["rel_err_vs_shards"] < MOE_LAYER_BAR,
          f"{cfg.name}: moe_apply on the mesh {out}")
    check(sum(drops) > 0, f"{cfg.name}: the shards drop nothing {out}")
    check(sum(drops) == drops1
          or out["control_moe_single_whole_batch"] > MOE_LAYER_BAR,
          f"{cfg.name}: the whole batch's capacity passes the bar of the "
          f"shards' {out}")
    return out


def mesh_prefill(label: str, rng, cfg, params, dev, B: int, S: int,
                 one_card_drops: dict) -> dict:
    """The B x S prefill on the virtual ``MESH_SHAPE`` mesh with the
    counts set to 0 just before (the one-card prefill's launches), its
    logits finite, each batch shard's capacity drops beside the one-card
    prefill's, and host ms beside the one-card prefill's in the same
    call; then the forward's logits at every position (the median
    position's error, :func:`median_row_err`) against its batch shards'
    one-card forwards within ``MESH_PREFILL_BAR``, and the same in f32
    within ``MESH_PREFILL_F32_BAR``, the whole batch's one-card forward
    (one capacity for all its tokens), the control, beyond each."""
    import torch
    from repro_torch.models import Runtime, forward, prefill
    mcfg, rt, rt1 = mesh_cfg(cfg), mesh_runtime(dev), Runtime(dev)
    V = cfg.vocab
    batch = {"tokens": torch.from_numpy(rng.integers(0, V, (B, S))).to(dev)}
    zero_counts()
    logits = prefill(params, batch, mcfg, rt)
    torch.cuda.synchronize()
    counts = launch_counts()
    check(counts == expected_counts(mcfg),
          f"{label} mesh prefill launched {counts}")
    check(bool(torch.isfinite(logits[:, :V]).all()),
          f"{label} mesh prefill logits finite")
    drops = moe_drops(params, batch, mcfg, rt)

    def against_shards(c_mesh, c_one) -> tuple:
        """The mesh's and the whole batch's one-card forward against the
        batch shards' one-card forwards, each a median row error."""
        ref = torch.cat([forward(params, {"tokens": t}, c_one, rt1)[..., :V]
                         for t in batch["tokens"].chunk(
                             MESH_SHAPE[0] * MESH_SHAPE[1])])
        errs = tuple(median_row_err(forward(params, batch, c, r)[..., :V],
                                    ref) for c, r in ((c_mesh, rt),
                                                      (c_one, rt1)))
        del ref
        torch.cuda.empty_cache()
        return errs

    err, control = against_shards(mcfg, cfg)
    err32, control32 = against_shards(f32_cfg(mcfg), f32_cfg(cfg))
    out = dict(mesh=list(MESH_SHAPE), batch=B, seq=S,
               flash_launches=counts["flash_attention_fwd"],
               capacity_drops=drops, one_card_capacity_drops=one_card_drops,
               row_err_vs_shards=err, control_row_err_whole_batch=control,
               row_err_vs_shards_f32=err32,
               control_row_err_whole_batch_f32=control32,
               bar=MESH_PREFILL_BAR, bar_f32=MESH_PREFILL_F32_BAR,
               e2e_ms=host_ms(lambda: prefill(params, batch, mcfg, rt),
                              reps=3, warmup=1),
               one_card_e2e_ms=host_ms(lambda: prefill(params, batch, cfg,
                                                       rt1),
                                       reps=3, warmup=1),
               card=card_line())
    print(f"{label} prefill on the {MESH_SHAPE} mesh " + json.dumps(out),
          flush=True)
    check(out["row_err_vs_shards_f32"] < MESH_PREFILL_F32_BAR
          < out["control_row_err_whole_batch_f32"],
          f"{label}: the f32 mesh forward against its shards' {out}")
    check(out["row_err_vs_shards"] < MESH_PREFILL_BAR
          < out["control_row_err_whole_batch"],
          f"{label}: the mesh forward against its shards' {out}")
    return out


def moe_phases(dev) -> dict:
    """(u) granite-moe-3b-a800m whole, this slice's main path; (v)
    jamba-v0.1-52b at its published widths, its depth cut to
    ``JAMBA_PERIODS`` of 4 periods.  Each model freed before the next."""
    import torch
    from repro_torch.launch import one_card_config
    from repro_torch.models import Group, count_params, moe
    out = {}
    for arch, B, S, seed in ((GRANITE_ARCH, GRANITE_B, GRANITE_S, 10),
                             (JAMBA_ARCH, JAMBA_B, JAMBA_S, 11)):
        rng = np.random.default_rng([SEED, seed])
        cfg = dataclasses.replace(one_card_config(arch, smoke=False),
                                  attn_impl="flash")
        res = {}
        if arch == JAMBA_ARCH:
            cfg = dataclasses.replace(cfg, groups=tuple(
                Group(g.name, g.blocks, JAMBA_PERIODS) for g in cfg.groups))
            print(f"{arch}: published widths, depth cut to {JAMBA_PERIODS} "
                  f"of 4 periods of 8 layers ({cfg.n_layers} layers, "
                  f"{count_params(cfg) / 1e9:.2f} B parameters; 103 GB of "
                  f"bf16 weights at full depth, over one card's 80 GB)",
                  flush=True)
        check(cfg.moe.padded_experts == cfg.moe.n_experts,
              f"{arch}: {cfg.moe.padded_experts} experts on one card, not "
              f"{cfg.moe.n_experts}")
        params, res["load"] = load_model(arch, cfg, dev)
        if arch == GRANITE_ARCH:
            res["moe_layer"] = moe_layer_check(params, cfg, rng, dev)
        ranges = (moe.MOE_RANGE,)
        res["prefill"] = dense_prefill(arch, rng, cfg, params, dev, B, S,
                                       ranges=ranges)
        if arch == GRANITE_ARCH:
            res["mesh_layer"] = moe_mesh_check(params, cfg, rng, dev)
            res["mesh_prefill"] = mesh_prefill(
                arch, rng, cfg, params, dev, B, S,
                res["prefill"]["capacity_drops"])
        # decode against prefill at a capacity that drops nothing (a
        # 64-token prompt drops at the published factor; one-token decode
        # never does), beside the published factor's drops of that prompt
        res["teacher"] = teacher_forced(arch, rng, raised_capacity(cfg),
                                        params, dev, published=cfg)
        res["serve"], eng = serve_paths(arch, cfg, params, dev)
        res["decode_profile"], res["captured_decode_profile"] = \
            step_profiles(arch, cfg, params, eng, dev, ranges=ranges)
        # the MoE block's device time in one eager step over the captured
        # step's busy time: a replay runs the eager step's kernels
        moe_us = res["decode_profile"]["ranges"][moe.MOE_RANGE]["device_us"]
        res["moe_share"] = dict(
            prefill=res["prefill"]["profile"]["ranges"][moe.MOE_RANGE][
                "share_of_busy"],
            eager_step=res["decode_profile"]["ranges"][moe.MOE_RANGE][
                "share_of_busy"],
            captured_step=moe_us / res["captured_decode_profile"][
                "device_busy_us"])
        print(f"{arch} MoE share of device time " +
              json.dumps(res["moe_share"]), flush=True)
        out[arch] = res
        del params, eng
        torch.cuda.empty_cache()
    return out


def stack_stream(cfg, B: int, S: int, dev) -> dict:
    """Step 0 of ``SyntheticStream`` (seed ``SEED``) for ``cfg`` on the
    card: ``B x S`` tokens and the model's modality stub (a vision
    prefix's ``embeds``, an encoder's ``frames``), drawn from the numpy
    seed as the stream draws them."""
    import torch
    from repro_torch.data import DataConfig, SyntheticStream
    b = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=S,
                                   global_batch=B, seed=SEED),
                        cfg).batch(0)
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()
            if k != "labels"}


def llava_phase(dev) -> dict:
    """(w): llava-next-mistral-7b whole, this slice's main path."""
    import torch
    from repro_torch.configs import get_config
    rng = np.random.default_rng([SEED, 12])
    cfg = dataclasses.replace(get_config(LLAVA_ARCH), attn_impl="flash")
    params, load = load_model(LLAVA_ARCH, cfg, dev)
    res = dict(load=load)
    batch = stack_stream(cfg, LLAVA_B, LLAVA_TEXT, dev)
    check(batch["embeds"].shape == (LLAVA_B, cfg.stub_prefix, cfg.d_model),
          f"{LLAVA_ARCH}: embeds {tuple(batch['embeds'].shape)}")
    S = cfg.stub_prefix + LLAVA_TEXT
    res["prefill"] = dense_prefill(
        LLAVA_ARCH, rng, cfg, params, dev, LLAVA_B, S, ranges=(),
        batch=batch, extra_controls={"prefix_rolled_along_batch": (
            params, dict(batch, embeds=torch.roll(batch["embeds"], 1,
                                                  dims=0)))})
    res["teacher"] = teacher_forced(LLAVA_ARCH, rng, cfg, params, dev)
    res["serve"], eng = serve_paths(LLAVA_ARCH, cfg, params, dev)
    res["decode_profile"], res["captured_decode_profile"] = \
        step_profiles(LLAVA_ARCH, cfg, params, eng, dev)
    del params, eng
    torch.cuda.empty_cache()
    return res


def whisper_teacher(label: str, cfg, params, batch, dev) -> dict:
    """Teacher-forced decode at B 1 over every position of the prefill's
    first row, under ``attn_impl="blocked"`` (a decode step's
    cross-attention has one query, which the flash kernel does not take),
    each step reading the prefill's own encoder output (all its frames)
    as ``enc_out``: the last logits against the flash prefill's, within
    0.08 (relative); ms a step."""
    import torch
    from repro_torch.models import Runtime, decode_step, init_caches, prefill
    from repro_torch.models.lm import _run_encoder
    rt = Runtime(dev)
    V = cfg.vocab
    row = {k: v[:1] for k, v in batch.items()}
    S = row["tokens"].shape[1]
    want = prefill(params, row, cfg, rt)
    dcfg = dataclasses.replace(cfg, attn_impl="blocked")
    enc = _run_encoder(params, row["frames"], dcfg, rt)
    caches = init_caches(dcfg, 1, S, device=dev)
    t0 = time.perf_counter()
    for t in range(S):
        _, got, caches = decode_step(params, row["tokens"][:, t], caches, t,
                                     dcfg, rt, enc)
    torch.cuda.synchronize()
    out = dict(prompt=S, enc_frames=enc.shape[1],
               rel_err=rel_err(got[:, :V], want[:, :V]),
               decode_ms_per_step_b1=(time.perf_counter() - t0) * 1e3 / S,
               bar=0.08, card=card_line())
    print(f"{label} teacher-forced decode " + json.dumps(out), flush=True)
    check(out["rel_err"] < 0.08, f"{label} teacher-forced decode vs flash "
                                 f"prefill rel err {out['rel_err']}")
    return out


def whisper_phase(dev) -> dict:
    """(x): whisper-base whole, an encoder-decoder."""
    import torch
    from repro_torch.configs import get_config
    rng = np.random.default_rng([SEED, 13])
    cfg = dataclasses.replace(get_config(WHISPER_ARCH), attn_impl="flash")
    params, load = load_model(WHISPER_ARCH, cfg, dev)
    res = dict(load=load)
    batch = stack_stream(cfg, WHISPER_B, WHISPER_S, dev)
    res["prefill"] = dense_prefill(
        WHISPER_ARCH, rng, cfg, params, dev, WHISPER_B, WHISPER_S,
        ranges=(), batch=batch, extra_controls={
            "frames_rolled_along_batch": (params, dict(
                batch, frames=torch.roll(batch["frames"], 1, dims=0))),
            "encoder_kv_heads_rolled": (rolled(
                params, ("wk", "wv"), cfg.hd, under="enc_enc"), batch)})
    res["teacher"] = whisper_teacher(WHISPER_ARCH, cfg, params, batch, dev)
    scfg = dataclasses.replace(cfg, attn_impl="blocked")
    res["serve"], eng = serve_paths(WHISPER_ARCH, scfg, params, dev)
    res["decode_profile"], res["captured_decode_profile"] = \
        step_profiles(WHISPER_ARCH, scfg, params, eng, dev)
    del params, eng
    torch.cuda.empty_cache()
    return res


def mla_layer_check(params, cfg, rng, dev) -> dict:
    """Layer 0 of the dense group (MLA and the dense MLP, upcast to f32) at
    B 1 x ``MLA_LAYER_S`` in f32 on the card against the same call on the
    CPU, within ``MLA_LAYER_BAR`` (relative); the card's milliseconds."""
    import torch
    from repro_torch.models import Runtime, blocks
    tree = params.tree()["dec_dense"]["b0"]
    p = {k: {n: t[0].float() for n, t in v.items()} for k, v in tree.items()}
    p_cpu = {k: {n: t.cpu() for n, t in v.items()} for k, v in p.items()}
    bcfg = cfg.groups[0].blocks[0]
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    x = torch.from_numpy(rng.standard_normal(
        (1, MLA_LAYER_S, cfg.d_model), dtype=np.float32))
    pos = torch.arange(MLA_LAYER_S)[None]
    xd, posd, rt = x.to(dev), pos.to(dev), Runtime(dev)
    y = blocks.block_apply(p, xd, bcfg, f32, rt, posd)
    y_cpu = blocks.block_apply(p_cpu, x, bcfg, f32, Runtime("cpu"), pos)
    out = dict(shape=[1, MLA_LAYER_S, cfg.d_model], heads=cfg.n_heads,
               mla=dataclasses.asdict(cfg.mla),
               rel_err=rel_err(y.cpu(), y_cpu), bar=MLA_LAYER_BAR,
               ms_f32=cuda_ms(lambda: blocks.block_apply(
                   p, xd, bcfg, f32, rt, posd), reps=5, warmup=1),
               card=card_line())
    print(f"{cfg.name} one dense MLA layer card vs CPU " + json.dumps(out),
          flush=True)
    check(out["rel_err"] < MLA_LAYER_BAR,
          f"{cfg.name}: one MLA layer on the card vs the CPU {out}")
    return out


def deepseek_phase(dev) -> dict:
    """(y): deepseek-v3-671b at its published widths, cut in depth."""
    import torch
    from repro_torch.launch import one_card_config
    from repro_torch.models import (Group, Runtime, count_params, forward,
                                    moe)
    rng = np.random.default_rng([SEED, 14])
    full = one_card_config(DEEPSEEK_ARCH, smoke=False)
    cfg = dataclasses.replace(full, groups=tuple(
        Group(g.name, g.blocks, 1) for g in full.groups))
    n = count_params(cfg)
    cut = dict(layers=cfg.n_layers, parameters_b=n / 1e9,
               bf16_weights_gb=2 * n / 1e9,
               full_parameters_b=count_params(full) / 1e9,
               attn_impl=cfg.attn_impl)
    print(f"{DEEPSEEK_ARCH}: published widths, depth cut to one dense and "
          f"one MoE MLA layer and the MTP block " + json.dumps(cut),
          flush=True)
    params, load = load_model(DEEPSEEK_ARCH, cfg, dev)
    total = torch.cuda.get_device_properties(dev).total_memory / 1e9
    check(load["load_peak_gb"] < total, f"{DEEPSEEK_ARCH}: load peak "
          f"{load['load_peak_gb']} GB over the card's {total} GB")
    res = dict(cut=cut, load=load, card_memory_gb=total)
    res["mla_layer"] = mla_layer_check(params, cfg, rng, dev)
    rt = Runtime(dev)
    V = cfg.vocab
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, V, (DEEPSEEK_B, DEEPSEEK_S))).to(dev)}
    zero_counts()
    logits, logits_mtp = forward(params, batch, cfg, rt)
    torch.cuda.synchronize()
    counts = launch_counts()
    check(all(c == 0 for c in counts.values()),
          f"{DEEPSEEK_ARCH}: the blocked MLA forward launched {counts}")
    finite = dict(
        logits=bool(torch.isfinite(logits[..., :V]).all()),
        logits_mtp=bool(torch.isfinite(logits_mtp[..., :V]).all()))
    shape_ok = logits.shape == logits_mtp.shape == (
        DEEPSEEK_B, DEEPSEEK_S, cfg.vocab_padded)
    del logits, logits_mtp
    torch.cuda.reset_peak_memory_stats()
    ms = host_ms(lambda: forward(params, batch, cfg, rt), reps=3, warmup=1)
    res["forward"] = dict(
        batch=DEEPSEEK_B, seq=DEEPSEEK_S, launches=counts, finite=finite,
        capacity_drops=moe_drops(params, batch, cfg, rt), e2e_ms=ms,
        tokens_per_s=DEEPSEEK_B * DEEPSEEK_S / (ms * 1e-3),
        peak_gb=torch.cuda.max_memory_allocated() / 1e9, card=card_line())
    print(f"{DEEPSEEK_ARCH} forward " + json.dumps(res["forward"]),
          flush=True)
    check(shape_ok and all(finite.values()),
          f"{DEEPSEEK_ARCH}: forward logits shape/finite {finite}")
    res["forward"]["profile"] = profile_families(
        f"{DEEPSEEK_ARCH} forward (B {DEEPSEEK_B}, S {DEEPSEEK_S})",
        lambda: forward(params, batch, cfg, rt), ms, ranges=(moe.MOE_RANGE,))
    res["teacher"] = teacher_forced(DEEPSEEK_ARCH, rng, raised_capacity(cfg),
                                    params, dev, published=cfg)
    res["serve"], eng = serve_paths(DEEPSEEK_ARCH, cfg, params, dev)
    res["decode_profile"], res["captured_decode_profile"] = \
        step_profiles(DEEPSEEK_ARCH, cfg, params, eng, dev,
                      ranges=(moe.MOE_RANGE,))
    del params, eng
    torch.cuda.empty_cache()
    return res


def warm_start_script():
    """``scripts/warm_start.py`` as a module: the bsp_fft workload, its
    input and the child processes of (aa)-(ab)."""
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import warm_start
    return warm_start


def store_phase(dev) -> dict:
    """(aa) the paper's main path warm-starting from disk: ``bsp_fft`` at
    N = 2^24, p = 8 through ``fft_planes``, first in a context with a new
    ``PlanCache`` and ``ProgramCache`` and ``persist_dir`` a fresh
    directory, then again with new caches on the same directory: the
    second run's output bit-equal (SHA-256 of its bytes), its ledger equal,
    every program a disk hit certified again before it replays, no program
    or plan cache miss (no schedule search, no re-plan); cold and warm ms
    to the end of the first flush.  Then ``scripts/warm_start.py`` as its
    two child processes on the card."""
    import tempfile
    from repro_torch import core as lpf
    ws = warm_start_script()
    store = tempfile.mkdtemp(prefix="lpf_fft_store_")
    runs = {}
    for name in ("cold", "warm"):
        runs[name] = ws.run_workload(
            "bsp_fft", dev, N_MAIN.bit_length() - 1,
            plan_cache=lpf.PlanCache(), program_cache=lpf.ProgramCache(),
            persist_dir=store)
        print(f"store {name} " + json.dumps(
            {k: v for k, v in runs[name].items() if k != "ledger"}),
            flush=True)
    cold, warm = runs["cold"], runs["warm"]
    check(cold["device"].startswith(str(dev)) and cold["program_misses"]
          == cold["programs"] >= 1 and cold["program_disk_hits"] == 0,
          f"store: the cold run searched {cold['program_misses']} of "
          f"{cold['programs']} programs")
    check(warm["program_misses"] == 0 and warm["plan_misses"] == 0,
          f"store: the warm run searched {warm['program_misses']} programs "
          f"and planned {warm['plan_misses']} supersteps")
    check(warm["program_disk_hits"] == warm["programs"] == cold["programs"]
          and warm["certified"] == warm["programs"]
          and warm["program_invalidated"] == 0,
          f"store: {warm['program_disk_hits']} disk hits, "
          f"{warm['certified']} certified of {warm['programs']} programs")
    check(warm["digest"] == cold["digest"] and warm["ledger"]
          == cold["ledger"], "store: the warm run's output or ledger "
          "differs from the cold run's")
    out = dict(cold_first_flush_ms=cold["first_flush_ms"],
               warm_first_flush_ms=warm["first_flush_ms"],
               cold_wall_ms=cold["wall_ms"], warm_wall_ms=warm["wall_ms"],
               programs=warm["programs"], flushes=len(warm["ledger"]),
               disk_hits=warm["program_disk_hits"], store=store,
               digest=cold["digest"], ledger=cold["ledger"])
    print(f"bsp_fft from the store: cold {cold['first_flush_ms']:.3f} ms, "
          f"warm {warm['first_flush_ms']:.3f} ms to the first flush",
          flush=True)
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, os.path.join(
        HERE, "scripts", "warm_start.py"), "--device", str(dev)],
        capture_output=True, text=True, timeout=300)
    print(res.stdout + res.stderr, flush=True)
    check(res.returncode == 0, f"scripts/warm_start.py exited "
          f"{res.returncode}")
    line = [x for x in res.stdout.splitlines()
            if x.startswith("warm_start {")][-1]
    out["script"] = json.loads(line.split(" ", 1)[1])
    out["script"]["seconds"] = time.perf_counter() - t0
    return out


def fault_phase(dev, store: dict) -> dict:
    """(ab) fault plans on the card: ``python -m repro_torch.runtime.faults
    --smoke --device cuda`` (its ``chaos_main``, in this process: each of
    the 15 ``SMOKE_PLANS`` must end ``identical`` or ``classified``) and
    ``--chaos --seeds 16``; then two child processes of (aa)'s bsp_fft at
    once: ``LPF_FAULT_PLAN="compile@0;straggler@1=0.005"`` on a fresh
    store (output and ledger bit-equal to (aa)'s, ``compile_fallbacks`` >=
    1, the program quarantined to the dispatched path, both faults fired)
    and ``persist_load@0:bitflip`` over (aa)'s store (``invalidated`` >=
    1, the same output and ledger)."""
    import io
    import tempfile
    from repro_torch.runtime import faults
    import shutil
    out = {}
    for mode, argv in (("smoke", ["--smoke"]),
                       ("chaos", ["--chaos", "--seeds", "16"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = faults.chaos_main(argv + ["--device", str(dev)])
        text = buf.getvalue()
        print(text, flush=True)
        tally = json.loads(text.rsplit("chaos summary: ", 1)[1]
                           .splitlines()[0].replace("'", '"'))
        out[mode] = tally
        check(rc == 0 and set(tally) <= {"identical", "classified"},
              f"faults --{mode}: exit {rc}, verdicts {tally}")
    check(sum(out["smoke"].values()) == len(faults.SMOKE_PLANS),
          f"faults --smoke ran {out['smoke']}")
    check(faults.active() is None, "a fault plan stayed armed")
    ws = warm_start_script()
    log2n = N_MAIN.bit_length() - 1
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {"compile_straggler": ("compile@0;straggler@1=0.005",
                                      os.path.join(tmp, "store")),
                "load_bitflip": ("persist_load@0:bitflip", store["store"])}
        procs = {}
        for name, (plan, cache_dir) in jobs.items():
            env = dict(os.environ, LPF_PROGRAM_CACHE_DIR=cache_dir,
                       LPF_FAULT_PLAN=plan)
            procs[name] = subprocess.Popen(
                [sys.executable, os.path.join(HERE, "scripts",
                                              "warm_start.py"),
                 "--phase", "run", "--workload", "bsp_fft", "--log2n",
                 str(log2n), "--device", str(dev), "--out",
                 os.path.join(tmp, f"{name}.json")], env=env)
        for name, proc in procs.items():
            check(proc.wait(timeout=300) == 0, f"fault child {name} "
                  f"exited {proc.returncode}")
            with open(os.path.join(tmp, f"{name}.json")) as fh:
                out[name] = json.load(fh)
    for name in jobs:
        r = out[name]
        print(f"fault child {name} " + json.dumps(
            {k: v for k, v in r.items() if k != "ledger"}), flush=True)
        check(r["digest"] == store["digest"] and r["ledger"]
              == store["ledger"], f"fault child {name}: output or ledger "
              f"differs from the unfaulted run's")
        del r["ledger"]
    cs, lb = out["compile_straggler"], out["load_bitflip"]
    check(cs["compile_fallbacks"] >= 1 and cs["quarantined"] >= 1
          and ["compile", 0, "default"] in cs["faults_fired"]
          and ["straggler", 1, "default"] in cs["faults_fired"],
          f"compile/straggler child: {cs}")
    check(lb["program_invalidated"] >= 1
          and ["persist_load", 0, "bitflip"] in lb["faults_fired"],
          f"bitflip child: {lb}")
    shutil.rmtree(store["store"])
    return out


def analysis_phase() -> dict:
    """(ac) the analysis CLI on the port's machine (the ``"vp"`` link of 8
    processes on one H100): ``python -m repro_torch.analysis`` (its
    ``main``, in this process: every canned trace lints, optimizes and
    verifies), then ``--record-cache`` and ``--cache-dir`` on one
    directory: exit 0 each, every entry verified."""
    import io
    import tempfile
    from repro_torch.analysis.__main__ import main as analysis_main
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, argv in (("lint_verify", []),
                           ("record", ["--record-cache", tmp]),
                           ("audit", ["--cache-dir", tmp])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = analysis_main(argv)
            print(buf.getvalue(), flush=True)
            out[name] = rc
            check(rc == 0, f"python -m repro_torch.analysis {argv}: exit "
                           f"{rc}")
        audit = re.search(r"cache audit: (\d+) entries, (\d+) verified",
                          buf.getvalue())
        check(audit is not None and audit.group(1) == audit.group(2)
              != "0", f"cache audit: {audit and audit.group(0)}")
        out["entries"] = int(audit.group(1))
    return out


def program_engine_phase(fit: dict) -> dict:
    """(s): ``ProgramDecodeEngine`` at p = 8 on ``scripts/serve_latency.py``'s
    workload (120 requests in bursts of 6, buckets (2, 16), (4, 16), (4,
    32)), priced on H100_SXM with phase 6's fitted ``"vp"`` link: no
    deadline miss, every completed request within its predicted
    model-clock time, loop-graph replays and no fallback, at least two
    programs pinned, no quarantine; then one bucket's streams solo,
    batched and on the per-token fallback, bit-identical."""
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import serve_latency
    from repro_torch import core as lpf
    from repro_torch.runtime.server import ServeRequest
    res = serve_latency.run(device="cuda", hardware=fitted_hardware(lpf, fit))
    t = res["total"]
    check(t["completed"] >= 1 and t["deadline_misses"] == 0,
          f"program engine: {t['completed']} completed, "
          f"{t['deadline_misses']} deadline misses")
    check(t["completed_after_predicted"] == 0,
          "program engine: requests completed after their predicted time")
    check(t["loop_graph_replays"] > 0 and t["loop_graph_fallbacks"] == 0,
          f"program engine: {t['loop_graph_replays']} loop-graph replays, "
          f"{t['loop_graph_fallbacks']} fallbacks")
    check(t["program_pinned"] >= 2 and t["quarantines"] == 0
          and t["program_quarantined"] == 0,
          f"program engine: {t['program_pinned']} pinned, "
          f"{t['quarantines']} quarantines")
    eng = res["engine"]
    bucket = (4, 32)
    reqs = [ServeRequest(rid=i, n_tokens=32, deadline_s=1.0, seed=s)
            for i, s in enumerate((1234, 777, 5, 31337))]
    batched = eng.decode(bucket, reqs, 32)
    solo = {r.rid: eng.decode(bucket, [r], 32)[r.rid] for r in reqs}
    eng.quarantine(bucket)
    per_token = eng.decode(bucket, reqs, 32)
    eng.quarantined.clear()
    check(batched == solo == per_token,
          "program engine: solo, batched and per-token streams differ")
    out = dict(rows=res["rows"], total=t, identical_streams=len(reqs))
    print("program engine " + json.dumps(out), flush=True)
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
                   for e in device_work(prof, events)
                   if e.time_range.end > lo and e.time_range.start < hi)
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
                      for e in device_work(prof, prof.key_averages())
                      if e.self_device_time_total > 0),
                     key=lambda t: -t[2])
    busy_us = sum(t for _, _, t in kernels)
    out = dict(wall_us=wall_ms * 1e3, device_busy_us=busy_us,
               idle_share=1.0 - busy_us / (wall_ms * 1e3),
               kernels=[dict(kernel=k, count=c, device_us=t)
                        for k, c, t in kernels])
    print("bsp_fft profile " + json.dumps(out), flush=True)
    check(busy_us > 0, "profiler recorded no device time")
    return out


def pod_phase(dev) -> dict:
    """(ad): llama3.2-1b at full width over a 2x1x1 virtual mesh (module
    docstring)."""
    import dataclasses
    import torch
    from repro_torch import core as lpf
    from repro_torch.bsp import build_cross_pod_sync, pod_sync
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import AdamWConfig, warmup_cosine
    from repro_torch.runtime import train_step as ts_mod
    from repro_torch.runtime.train_loop import TrainLoopConfig, train_loop

    cfg = dataclasses.replace(get_config(ARCH), attn_impl="flash")
    check(cfg.remat == "full" and cfg.param_dtype == "float32"
          and cfg.compute_dtype == "bfloat16", "pod training config")
    mesh = make_mesh(POD_MESH)
    npods = POD_MESH[0]
    lr = warmup_cosine(3e-3, 10, 1 + POD_STEPS)
    int16 = lpf.SyncAttributes(compress=lpf.CompressSpec(bits=8))
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                                        global_batch=TRAIN_B, seed=0))

    def batch(i):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in stream.batch(i).items()}

    def build(method="rs+ag", attrs=lpf.LPF_SYNC_DEFAULT, grad_sync="lpf",
              on=mesh):
        return ts_mod.build_train_step(
            cfg, on, opt_cfg=AdamWConfig(lr=lr), grad_sync=grad_sync,
            sync_attrs=attrs, grad_sync_method=method,
            grad_bucket_bytes=POD_BUCKET_BYTES
            if method == "bucketed_overlap" else None,
            donate=True, device=dev)

    steps = {"rs+ag": build(), "bucketed_overlap": build("bucketed_overlap"),
             "int16_ring": build("ring", int16)}
    torch.cuda.empty_cache()
    out = {"start_gb": dict(allocated=torch.cuda.memory_allocated() / 1e9,
                            reserved=torch.cuda.memory_reserved() / 1e9)}
    print("pod phase start " + json.dumps(out["start_gb"]), flush=True)
    b0 = batch(0)

    # the rs+ag pod step, donated, from the seed-0 weights.  Its sync is
    # watched: leaf by leaf, the pods' sum (the control's gradients) and
    # the int16 ring against what the sync returns (in place, one leaf's
    # temporaries at a time); a copy of the last POD_SYNC_LAYERS layers'
    # stacked gradients for the stream check
    real = ts_mod.pod_allreduce
    seen = {}

    def watched(tree, q, *a, **kw):
        res = real(tree, q, *a, **kw)
        sq, ratios, ctrl = 0.0, [], []
        for leaf, got in zip(pod_sync.tree_flatten(tree)[0],
                             pod_sync.tree_flatten(res)[0]):
            summed = real({"g": leaf}, q, method="rs+ag", mean=False)["g"]
            sq += summed[0].float().square().sum().item()
            del summed
            ring = real({"g": leaf}, q, attrs=int16, method="ring")["g"]
            amax = leaf.float().abs().amax()
            half_q = amax.item() / 127.0 / 2
            # the rows of a sync's result are one tensor (stride 0)
            ratios.append((ring[0].sub_(got[0]).abs_().max().item()
                           + 1e-30) / (half_q + 1e-30))
            del ring
            # the control: the same ring at 63 levels
            s63 = amax / 63.0 + 1e-30
            coarse = (leaf.float() / s63).round_().clamp_(-63, 63).sum(
                0).mul_(s63 / q)
            ctrl.append(coarse.sub_(got[0]).abs_().max().item()
                        / (half_q + 1e-30))
            del coarse
        # one leaf a layer (named layer first, so buckets follow layers)
        layers = {}
        for key, sub in tree.items():
            if key.startswith("dec_"):
                for name, leaf in _named(sub):
                    L = leaf.shape[1]
                    for i in range(L - POD_SYNC_LAYERS, L):
                        layers[f"l{i:02d}.{key}.{name}"] = \
                            leaf[:, i].clone()
        seen.update(control_grad_norm=math.sqrt(sq),
                    int16_over_bound=max(ratios),
                    int16_control_over_bound=max(ctrl), grads=layers)
        return res

    torch.cuda.empty_cache()
    p0, o0 = steps["rs+ag"].init_fn(0)
    ts_mod.pod_allreduce = watched
    try:
        p_rs, o_rs, m_rs = steps["rs+ag"].step_fn(p0, o0, b0)
    finally:
        ts_mod.pod_allreduce = real
    del p0, o0, o_rs
    torch.cuda.empty_cache()

    # the plain one-card step (donated too) from the same weights
    plain = build(on=None)
    p_plain, o_plain, m_plain = plain.step_fn(*plain.init_fn(0), b0)
    del o_plain
    torch.cuda.empty_cache()
    diffs = [(a - b).abs() for a, b in zip(p_rs.parameters(),
                                           p_plain.parameters())]
    lr1 = lr(1)
    gn, gn_plain = float(m_rs["grad_norm"]), float(m_plain["grad_norm"])
    vs_plain = dict(
        loss=float(m_rs["loss"]), loss_plain=float(m_plain["loss"]),
        loss_rel=abs(float(m_rs["loss"]) - float(m_plain["loss"]))
        / abs(float(m_plain["loss"])),
        grad_norm=gn, grad_norm_plain=gn_plain,
        grad_norm_rel=abs(gn - gn_plain) / gn_plain,
        control_grad_norm_rel=abs(seen["control_grad_norm"] - gn_plain)
        / gn_plain, bar=POD_NORM_BAR,
        param_max_abs_diff=max(d.max().item() for d in diffs),
        param_share_over_half_lr=sum((d > lr1 / 2).sum().item()
                                     for d in diffs)
        / sum(d.numel() for d in diffs), lr=lr1)
    del diffs, p_plain
    out["vs_plain"] = vs_plain
    print("pod vs plain step " + json.dumps(vs_plain), flush=True)
    check(vs_plain["loss_rel"] < 1e-2, f"pod step loss vs plain {vs_plain}")
    check(vs_plain["grad_norm_rel"] < POD_NORM_BAR <
          vs_plain["control_grad_norm_rel"],
          f"pod step grad_norm vs plain, and its control: {vs_plain}")
    # one AdamW step moves a parameter by about lr; a gradient near zero
    # may change sign between the two batchings
    check(vs_plain["param_max_abs_diff"] <= 2 * lr1 * (1 + 1e-3)
          and vs_plain["param_share_over_half_lr"] < 1e-2,
          f"pod step parameters vs plain: {vs_plain}")
    comp = dict(over_bound=seen["int16_over_bound"],
                control_over_bound=seen["int16_control_over_bound"],
                bar=POD_INT16_BAR)
    out["int16_vs_uncompressed"] = comp
    print("pod int16 ring vs uncompressed " + json.dumps(comp), flush=True)
    check(comp["over_bound"] <= POD_INT16_BAR < comp["control_over_bound"],
          f"int16 ring gradients against the uncompressed ones: {comp}")

    # bucketed_overlap from the same weights, against rs+ag
    p1, o1 = steps["bucketed_overlap"].init_fn(0)
    p_ov, o_ov, m_ov = steps["bucketed_overlap"].step_fn(p1, o1, b0)
    worst = max((a - b).abs().max().item()
                for a, b in zip(p_ov.parameters(), p_rs.parameters()))
    ovl = dict(param_max_abs_diff=worst,
               bit_equal=worst == 0 and torch.equal(m_ov["loss"],
                                                    m_rs["loss"])
               and torch.equal(m_ov["grad_norm"], m_rs["grad_norm"]),
               ledger=[(r.label, r.method) for r in
                       steps["bucketed_overlap"].ledger.records])
    out["overlap_vs_flat"] = ovl
    print("pod bucketed_overlap vs rs+ag " + json.dumps(
        {k: v for k, v in ovl.items() if k != "ledger"})
        + f", {len(ovl['ledger'])} ledger records", flush=True)
    check(worst < 1e-6, f"bucketed_overlap vs rs+ag parameters: {worst}")
    del p_rs
    torch.cuda.empty_cache()

    # timed steps of each method, on one state
    p, o = p_ov, o_ov
    del p_ov, o_ov
    timed = {}
    for name, ts in steps.items():
        # the cached blocks of the last method's streams go back, so this
        # method's (bucketed_overlap's side stream too) start from fresh
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 1e9
        ms = []
        for i in range(1, 1 + POD_STEPS):
            if name == "rs+ag" and i == 1:
                zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, o, m = ts.step_fn(p, o, batch(i))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if name == "rs+ag" and i == 1:
                launches = launch_counts()
            check(math.isfinite(float(m["loss"])),
                  f"pod {name} step {i} loss {float(m['loss'])}")
        timed[name] = dict(step_ms=ms, median_ms=statistics.median(ms),
                           held_before_gb=held,
                           peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                           loss=float(m["loss"]),
                           ledger=[dict(label=r.label, method=r.method,
                                        wire_bytes=r.wire_bytes)
                                   for r in ts.ledger.records][:4])
        print(f"pod {name} steps " + json.dumps(timed[name]), flush=True)
    out["timed"] = timed
    per_step = {k: npods * v for k, v in expected_counts(
        cfg, forward_calls=2, backward=True).items()}
    out["launches"] = dict(measured=launches, expected=per_step)
    print("pod step launches " + json.dumps(out["launches"]), flush=True)
    for k, n in per_step.items():
        check(launches[k] == n, f"pod step {k}: {launches[k]} launches, "
                                f"not {n}")

    # the sync's share of the step's device time
    out["profiles"] = {}
    for name in ("rs+ag", "bucketed_overlap"):
        b = batch(1 + POD_STEPS)
        box = [p, o]

        def one_step(name=name, b=b, box=box):
            box[0], box[1], m = steps[name].step_fn(box[0], box[1], b)
            float(m["loss"])

        out["profiles"][name] = profile_families(
            f"pod {name} step", one_step, timed[name]["median_ms"],
            ranges=("train.pod_sync",))
        p, o = box
    del steps, p, o, box
    torch.cuda.empty_cache()

    # the bucket_sync program over the last layers' gradients: one stream,
    # dispatched and compiled, against the side-stream pool, compiled
    # (dispatched, overlap groups stay on one stream)
    grads = seen.pop("grads")
    sync = build_cross_pod_sync(mesh, None, bucket_bytes=POD_BUCKET_BYTES)
    replay = replay_script()
    ref, rows = None, []
    for pool, route in replay.stream_routes(("dispatched", "compiled")):
        env = dict(LPF_OVERLAP_STREAMS=None if pool else "0",
                   LPF_COMPILE_PROGRAMS="1" if route == "compiled" else "0")
        with replay.environ(env):
            lpf.global_program_cache().clear()
            for _ in range(8):            # the compiled program's trial
                got = sync(grads)
                if ref is None:
                    ref = {k: v.clone() for k, v in got.items()}
                check(all(torch.equal(got[k], ref[k]) for k in ref),
                      f"bucket_sync pool={pool} {route} differs from one "
                      f"stream, dispatched")
            prog = lpf.global_program_cache().artifacts()
            rows.append(dict(
                streams="pool" if pool else "one", route=route,
                ms=host_ms(lambda: sync(grads)),
                graphs=sum(bool(a.use_graph) for a in prog)))
    out["bucket_sync_streams"] = rows
    print(f"pod bucket_sync over {len(grads)} leaves of the last "
          f"{POD_SYNC_LAYERS} layers " + json.dumps(rows), flush=True)
    del grads, ref, got
    lpf.global_program_cache().clear()
    torch.cuda.empty_cache()

    # local SGD: sync_every=2, the no-sync step the GSPMD one
    ts_l, ts_n = build(), build(grad_sync="gspmd")
    grew = []
    res = train_loop(ts_l, stream, TrainLoopConfig(steps=4, sync_every=2),
                     step_fn_nosync=ts_n.step_fn,
                     on_step=lambda step, loss, v: grew.append(
                         len(ts_l.ledger.records)))
    out["local_sgd"] = dict(losses=res["losses"], ledger_records=grew)
    print("pod local SGD " + json.dumps(out["local_sgd"]), flush=True)
    check(all(map(math.isfinite, res["losses"])) and grew == [0, 1, 1, 1]
          and not ts_n.ledger.records,
          f"local SGD losses {res['losses']}, ledger records {grew}")
    del res, ts_l, ts_n
    torch.cuda.empty_cache()
    return out


def _named(tree, prefix=""):
    """(dotted name, leaf) of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def replay_script():
    """``scripts/program_replay.py`` as a module."""
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import program_replay
    return program_replay


def program_replay_overlap(dev) -> list:
    """``scripts/program_replay.py``'s overlap measurement (fenced
    against overlapped buckets, p = 4 and 8, one stream and the pool,
    dispatched and compiled)."""
    return replay_script().overlap_phase(dev)


def stack_train_launches(stack_train: dict, name: str) -> dict:
    """``name``'s launches on each of (ae)'s training paths, by path."""
    return {f"{arch} training, {r['train']['layers']} layers, "
            f"{r['train']['steps']} steps (ae)": r["train"]["launches"][name]
            for arch, r in stack_train.items()}


def examples_phase(dev, fit: dict) -> dict:
    """(af): the four examples' ``run(..., device="cuda")``:
    ``quickstart`` at ``QUICKSTART_CASES`` (error code, rows, ledger;
    priced on phase 6's fitted link), ``fft_spectral`` (the RMS error
    halved at least, ``h_bytes == fft_h_bytes``), ``pagerank_interop``
    (13 iterations, error against the dense oracle under 1e-3) and
    ``train_lm``: ``LM_STEPS`` steps into a fresh directory, its
    checkpoints after ``LM_FIRST`` removed, then again to ``LM_STEPS``
    from the newest one left (the resumed run starts at ``LM_FIRST``,
    its losses within ``LM_RESUME_BAR`` of the uninterrupted run's; the
    mean of the last 10 losses below the first 10's)."""
    import shutil
    import tempfile
    import torch
    from repro_torch import core as lpf
    from repro_torch.examples import (fft_spectral, pagerank_interop,
                                      quickstart, train_lm)
    hw = fitted_hardware(lpf, fit)
    out = dict(card=card_line())
    t0 = time.perf_counter()
    out["quickstart"] = []
    for m, n, error, rows in QUICKSTART_CASES:
        res = quickstart.run(m, n, device=dev, hardware=hw)
        recs = [(r.label, r.method, r.h_bytes, r.rounds, r.n_msgs)
                for r in res["ledger"].records]
        row = dict(m=m, n=n, error=res["error"], rows=res["rows"],
                   ledger=recs, predicted_us=res["ledger"].predicted_seconds(
                       res["machine"]) * 1e6,
                   priced_on=f"{res['hardware']}, phase 6's fitted vp link")
        out["quickstart"].append(row)
        print("example quickstart " + json.dumps(row), flush=True)
        check(res["errors"] == [error] * 8 and res["rows"] == rows,
              f"quickstart {m} {n}: {res['errors']} {res['rows']}")
        check(recs == [("fetch-dims", "direct", 56, 7, 8),
                       ("error-broadcast", "direct", 28, 13, 64)],
              f"quickstart {m} {n} ledger {recs}")
    res = fft_spectral.run(device=dev)
    check(res["spectrum"].is_cuda, "fft_spectral ran off the card")
    out["fft_spectral"] = {k: res[k] for k in (
        "n", "p", "rms_before", "rms_after", "h_bytes", "predicted_h_bytes")}
    print("example fft_spectral " + json.dumps(out["fft_spectral"]),
          flush=True)
    check(res["rms_after"] < res["rms_before"] / 2
          and res["h_bytes"] == res["predicted_h_bytes"],
          f"fft_spectral {out['fft_spectral']}")
    res = pagerank_interop.run(device=dev)
    out["pagerank_interop"] = {k: res[k] for k in (
        "iterations", "rel_err", "mass", "top5", "nnz_per_process")}
    print("example pagerank_interop " + json.dumps(out["pagerank_interop"]),
          flush=True)
    check(res["iterations"] == 13 and res["rel_err"] < 1e-3,
          f"pagerank_interop {out['pagerank_interop']}")
    log = lambda line: print(f"example train_lm {line}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        full = train_lm.run(LM_STEPS, tmp, device=dev,
                            ckpt_every=LM_CKPT_EVERY, log=log)
        full_s = time.perf_counter() - t1
        # what a run stopped after step LM_FIRST leaves: its checkpoints up
        # to that step (a run to LM_FIRST alone would train under another
        # schedule: warmup_cosine spans --steps, as in the JAX example)
        for name in os.listdir(tmp):
            if name.startswith("step_") and int(name[5:]) > LM_FIRST:
                shutil.rmtree(os.path.join(tmp, name))
        again = train_lm.run(LM_STEPS, tmp, device=dev,
                             ckpt_every=LM_CKPT_EVERY, log=log)
    check(next(full["params"].parameters()).is_cuda,
          "train_lm ran off the card")
    want = full["losses"][LM_FIRST:]
    rel = [abs(a - b) / abs(b) for a, b in zip(again["losses"], want)]
    losses = full["losses"]
    out["train_lm"] = dict(
        steps=LM_STEPS, resumed_from=again["start"],
        first_10=statistics.fmean(losses[:10]),
        last_10=statistics.fmean(losses[-10:]),
        resumed_rel_max=max(rel), bar=LM_RESUME_BAR,
        resumed_bit_equal=again["losses"] == want,
        uninterrupted_s=full_s,
        step_ms_median=statistics.median(
            v.duration * 1e3 for v in list(full["monitor"])[1:]))
    print("example train_lm " + json.dumps(out["train_lm"]), flush=True)
    check(all(map(math.isfinite, losses)) and again["start"] == LM_FIRST
          and len(again["losses"]) == LM_STEPS - LM_FIRST
          and max(rel) < LM_RESUME_BAR,
          f"train_lm resume {out['train_lm']}")
    check(out["train_lm"]["last_10"] < out["train_lm"]["first_10"],
          f"train_lm loss did not fall {out['train_lm']}")
    out["seconds"] = time.perf_counter() - t0
    del full, again
    torch.cuda.empty_cache()
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

    # the host seconds each group of phases took, printed as they end and
    # together before the result lines
    marks = {}
    start = time.perf_counter()

    def done(group: str) -> None:
        marks[group] = time.perf_counter() - start - sum(marks.values())
        print(f"phases {group}: {marks[group]:.1f} s", flush=True)

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
    flash_rows = flash_phase(
        np.random.default_rng([SEED, 1]), dev,
        built["flash_attention_fwd"].log,
        FLASH_SHAPES + GEMMA_FWD_SHAPES + DENSE_FWD_SHAPES + MOE_FWD_SHAPES
        + STACK_FWD_SHAPES)

    done("1-3, b")

    # (ae) training on the card for whisper-base, llava-next-mistral-7b,
    # gemma2-9b and qwen3-14b (this slice's kernel path), first of the
    # model phases: gemma2-9b's steps peak at 73 GB, and after (ad) the
    # allocator's fragments (60 GB reserved around 17 GB in use) left no
    # room for a 4.65 GB block
    stack_train = {arch: train_phases(dev, arch) for arch in STACK_TRAIN}
    done("ae")

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
    done("4-6")

    # (c)-(f) the llama3.2-1b serving path ---------------------------------
    serving = serving_phases(np.random.default_rng([SEED, 2]), dev)
    done("c-f")

    # (g)-(i) the llama3.2-1b training path ---------------------------------
    bwd_rows = flash_bwd_phase(np.random.default_rng([SEED, 3]), dev,
                               built["flash_attention_bwd"].log)
    training = train_phases(dev)
    done("g-i")

    # (j)-(l) the mamba2-130m serving path -----------------------------------
    ssd_rows = ssd_phase(np.random.default_rng([SEED, 4]), dev,
                         built["ssd_scan"].log, SSD_SHAPES + JAMBA_SSD_SHAPES)
    mamba = mamba_phases(np.random.default_rng([SEED, 5]), dev)
    done("j-l")

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
    done("m-o")

    # (p)-(r) the dense configs at full width (gemma2-9b's serving is this
    # slice's main path), (s) the pure-LPF program engine -------------------
    torch.cuda.empty_cache()
    dense = dense_phases(dev)
    done("p-r")
    program_engine_phase(fit)
    done("s")

    # (t) mamba2-130m training, (u) granite-moe-3b-a800m (this slice's
    # main path), (v) jamba-v0.1-52b ---------------------------------------
    mamba_train = train_phases(dev, MAMBA_ARCH)
    done("t")
    moes = moe_phases(dev)
    done("u-v")

    # (w) llava-next-mistral-7b (this slice's main path), (x) whisper-base,
    # (y) deepseek-v3-671b ----------------------------------------------------
    stack = {LLAVA_ARCH: llava_phase(dev)}
    done("w")
    stack[WHISPER_ARCH] = whisper_phase(dev)
    done("x")
    stack[DEEPSEEK_ARCH] = deepseek_phase(dev)
    done("y")

    # (z) granite-moe-3b-a800m training (this slice's kernel path), (aa)
    # bsp_fft from the persistent store, (ab) fault plans, (ac) the
    # analysis CLI (this slice's main path) -----------------------------------
    granite_train = train_phases(dev, GRANITE_ARCH)
    done("z")

    store = store_phase(dev)
    persisted = dict(store=store, faults=fault_phase(dev, store),
                     analysis=analysis_phase())
    print("store and faults " + json.dumps(
        {k: v for k, v in persisted.items() if k != "store"}
        | {"store": {k: v for k, v in store.items() if k != "ledger"}}),
        flush=True)
    done("aa-ac")

    # (ad) llama3.2-1b over 2 virtual pods (this slice's main path), and
    # the split-phase overlap on the side-stream pool ---------------------
    torch.cuda.empty_cache()
    pods = pod_phase(dev)
    pods["program_replay_overlap"] = program_replay_overlap(dev)
    done("ad")

    # (af) the examples (this slice's main path) ------------------------------
    examples = examples_phase(dev, fit)
    done("af")

    # 7. result lines ----------------------------------------------------------
    big = [r for r in rows if r["n"] == N_MAIN // P_MAIN and not r["inverse"]][0]
    bound_ms, bound_by = fft_bound_ms(big["batch"], big["n"])
    # "replaces" names each TPU kernel's pallas_call line; "launches" is
    # the count from each kernel's own path: fft_planes the BSP FFT (5),
    # flash_attention_fwd this slice's main path, the llava-next-mistral-7b
    # prefill (w), with every other path's count beside it, the backward
    # kernels the training loop (h), ssd_scan the mamba2-130m training
    # loop (t), with its other paths beside it.  The flash and ssd_scan
    # rows' times are the llama3.2-1b and mamba2-130m prefills' shapes,
    # chosen by shape, as in earlier slices; ``shapes`` adds the other
    # configs'
    train_launches = training["train"]["launches"]
    mamba_launches = mamba_train["train"]["launches"]
    main_fwd = [r for r in flash_rows if r["shape"] == MAIN_FWD_SHAPE
                and r["dtype"] == "bfloat16"][0]
    slice_shapes = [list(sh[:5]) for sh in GEMMA_FWD_SHAPES
                    + DENSE_FWD_SHAPES + MOE_FWD_SHAPES + STACK_FWD_SHAPES]
    slice_fwd = [dict((k, r[k]) for k in (
        "shape", "causal", "window", "softcap", "max_abs_err", "row_err",
        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by"))
        for r in flash_rows if r["dtype"] == "bfloat16"
        and r["shape"] in slice_shapes]
    prefill_launches = {
        "llama3.2-1b prefill (c)": serving["prefill"]["flash_launches"],
        "llama3.2-1b training step (h)":
            train_launches["flash_attention_fwd"],
        **{f"{arch} prefill": dense[arch]["prefill"]["flash_launches"]
           for arch in (GEMMA_ARCH, QWEN3_ARCH, QWEN110_ARCH)},
        **{f"{arch} prefill": moes[arch]["prefill"]["flash_launches"]
           for arch in (GRANITE_ARCH, JAMBA_ARCH)},
        **{f"{arch} prefill": stack[arch]["prefill"]["flash_launches"]
           for arch in (LLAVA_ARCH, WHISPER_ARCH)},
        f"{DEEPSEEK_ARCH} forward (blocked MLA)": stack[DEEPSEEK_ARCH][
            "forward"]["launches"]["flash_attention_fwd"],
        f"{GRANITE_ARCH} training, {GRANITE_TRAIN_STEPS} steps (z)":
            granite_train["train"]["launches"]["flash_attention_fwd"],
        "llama3.2-1b over 2 pods, one step (ad)":
            pods["launches"]["measured"]["flash_attention_fwd"],
        **stack_train_launches(stack_train, "flash_attention_fwd")}
    ssd_launches = {
        "mamba2-130m prefill (k)": mamba["prefill"]["ssd_launches"],
        f"mamba2-130m training, {MAMBA_TRAIN_STEPS} steps (t)":
            mamba_launches["ssd_scan"],
        f"{JAMBA_ARCH} prefill (v)":
            moes[JAMBA_ARCH]["prefill"]["ssd_launches"]}
    jamba_ssd = [dict((k, r[k]) for k in (
        "shape", "chunk", "dtype", "max_abs_err", "ms", "plain_ms",
        "chunked_ms", "bound_ms", "bound_by"))
        for r in ssd_rows if r["shape"] == list(JAMBA_SSD_SHAPES[0][:6])]
    main_bwd = [r for r in bwd_rows if r["shape"] == MAIN_BWD_SHAPE
                and r["dtype"] == "bfloat16"][0]
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
        launches=stack[LLAVA_ARCH]["prefill"]["flash_launches"],
        launches_by_path=prefill_launches,
        max_abs_err=main_fwd["max_abs_err"], ms=main_fwd["ms"],
        plain_ms=main_fwd["plain_ms"], bound_ms=main_fwd["bound_ms"],
        bound_by=main_fwd["bound_by"], library_ms=main_fwd["library_ms"],
        row_err=main_fwd["row_err"], build=main_fwd["build"],
        shapes=slice_fwd)] + [dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/flash_attention_bwd.cu",
            replaces=f"src/repro/kernels/flash_attention/kernel.py:{line}",
            launches=train_launches[name],
            launches_by_path={
                f"llama3.2-1b training, {TRAIN_STEPS} steps (h)":
                    train_launches[name],
                f"{GRANITE_ARCH} training, {GRANITE_TRAIN_STEPS} steps (z)":
                    granite_train["train"]["launches"][name],
                "llama3.2-1b over 2 pods, one step (ad)":
                    pods["launches"]["measured"][name],
                **stack_train_launches(stack_train, name)},
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
        launches=mamba_launches["ssd_scan"],
        cuda_launches=mamba_launches["ssd_scan_cuda"],
        launches_by_path=ssd_launches, shapes=jamba_ssd,
        max_abs_err=main_ssd["max_abs_err"], ms=main_ssd["ms"],
        plain_ms=main_ssd["plain_ms"], chunked_ms=main_ssd["chunked_ms"],
        bound_ms=main_ssd["bound_ms"], bound_by=main_ssd["bound_by"],
        bound_rate=main_ssd["bound_rate"], library_ms=None,
        build=main_ssd["build"])]}
    print("phase seconds " + json.dumps(marks), flush=True)
    print(json.dumps(kernels), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
