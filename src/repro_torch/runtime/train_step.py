"""Train- and serve-step builders on one device — the JAX package's
``repro.runtime.train_step`` (``TrainStep``, ``build_train_step``,
``ServeStep``, ``build_serve_step``, ``build_serve_buckets``).

The JAX package jits its steps with parameter, optimizer and cache
shardings over a mesh.  On one card there are no shardings and nothing is
jitted: each step is eager PyTorch.

*Training.*  ``step_fn(params, opt, batch) -> (params, opt, metrics)`` is
the loss and its gradients (``torch.autograd.grad`` through
:func:`~repro_torch.models.lm.loss_fn`: the flash-attention kernels'
forward and backward on the card) followed by
:func:`~repro_torch.optim.adamw_update`, functional as in JAX: the
arguments are left as they were and new trees are returned.
``grad_accum`` loops over microbatches and averages their gradients in
f32; ``steps_per_call`` rolls K steps into one call over a batch with a
leading ``[K]`` axis and returns ``[K]`` metrics.  Under a profiler a
step is the span ``train.step`` around ``train.forward`` and
``train.backward`` (one of each a microbatch), a pod step's
``train.pod_sync``, and ``train.optimizer`` (:mod:`repro_torch.core.trace`).

*Meshes.*  A mesh (:mod:`repro_torch.core.mesh`) runs its devices as
virtual shards on the one device.  Its data and model axes act through
the step's :class:`~repro_torch.models.blocks.Runtime`, resolved from
``axis_roles`` as in JAX: ``"fsdp_tp"`` (the default) batches over the
pod and data axes with the model axis for the experts and the cache, so
the MoE block is ``moe_apply`` (capacity per ``(pod, data)`` shard);
``"dp_all"`` batches over every axis with no model axis, so it is
``moe_single`` over the whole batch.  Parameter layouts (FSDP specs,
sequence parallelism) do not change values and have no counterpart
here.  ``grad_sync="gspmd"`` is the plain step over the whole batch under
that runtime, as JAX's GSPMD step: XLA reduces the gradient over every
batch axis, so the pods never drift apart, and the local-SGD "no-sync"
step differs from the synced one only in its route and its ledger.

*Pods.*  A mesh with ``q`` pods holds them as ``q`` virtual processes.
Under ``grad_sync="lpf"`` each pod takes the loss and gradients of its
own rows of the batch (rows ``[i·B/q, (i+1)·B/q)``, JAX's ``P("pod")``;
``grad_accum`` inside the pod) under a runtime without a mesh (JAX's
``rt_pod``: the pod body's MoE block is ``moe_single`` over the pod's
rows), the pods' gradients stack ``[q, ...]`` and cross the pod hop
through :func:`~repro_torch.bsp.pod_sync.pod_allreduce` (the method,
buckets and sync attributes as in JAX; with ``grad_bucket_bytes`` the
stacked layer groups split at layer boundaries first), the loss is the
pods' mean, and AdamW runs once on the replicated parameters and state,
which are held once.  Its records go to :attr:`TrainStep.ledger` on a
batch shape's first step only: JAX ledgers while it traces, once a
compiled step.

*Serving.*  ``step_fn`` is one eager decode step.  A bucket's
``decode_fn(n)`` is the counterpart of the JAX package's one-``While``
decode loop: on the card its step is captured once as a CUDA graph over
the bucket's own static caches, token, position and outputs
(:class:`CapturedDecode`), and an ``n``-token call replays it ``n`` times
with no host write between replays; the graph itself advances the
position.  On the CPU ``decode_fn(n)`` is the eager loop over
``step_fn``.  Both paths give the same tokens bit for bit: the captured
step runs the eager step's kernels on the same shapes.  On a mesh the
serve step resolves its batch and sequence axes as JAX's does (a batch
that the data-parallel shards do not divide widens the sequence axes to
every axis), and its runtime carries them.  An
encoder-decoder's steps take the encoder output ``enc_out`` [B, Se, D],
as the JAX package's do; the captured step reads it from a buffer of its
own, into which each call copies it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

from ..bsp.pod_sync import pod_allreduce, tree_flatten
from ..core import CostLedger, LPF_SYNC_DEFAULT, SyncAttributes
from ..core.errors import LPFError, LPFFatalError, LPFTransientError
from ..core.mesh import (VirtualMesh, dp_axes_of, mesh_shards,
                           model_axis_of, virtual_pods)
from ..core.trace import span
from ..models.blocks import Runtime
from ..models.config import ModelConfig
from ..models.lm import (ParamTree, decode_step, init_caches, init_params,
                         loss_fn)
from ..optim import AdamWConfig, adamw_init, adamw_update

__all__ = ["TrainStep", "build_train_step", "ServeStep", "CapturedDecode",
           "build_serve_step", "build_serve_buckets", "serve_axes"]

Tree = Dict[str, Any]


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

@dataclasses.dataclass
class TrainStep:
    #: (params, opt, batch) -> (params, opt, metrics)
    step_fn: Callable
    #: (seed) -> (params, opt): trainable f32 parameters and AdamW state
    init_fn: Callable
    #: () -> (params, opt) on the meta device: the structure, shapes and
    #: dtypes a checkpoint restores onto, with nothing allocated
    like_fn: Callable
    rt: Runtime
    #: the cross-pod sync's superstep records (one step's, as JAX's trace)
    ledger: CostLedger = dataclasses.field(default_factory=CostLedger)
    #: the mesh axes the batch is split over (JAX's batch spec): the
    #: runtime's data-parallel axes, over which MoE capacity is per shard
    batch_axes: Tuple[str, ...] = ()


def _fill(tree: Tree, values) -> Tree:
    """``tree``'s structure with its leaves taken in order from the
    iterator ``values``."""
    return {k: _fill(v, values) if isinstance(v, dict) else next(values)
            for k, v in tree.items()}


def _map(fn, *trees):
    """``fn`` over the leaves of congruent nested dicts and lists."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, list):
        return [_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def _split_scan_layers(grads: Tree, cfg: ModelConfig):
    """Split the pod-stacked scan-group gradient leaves ``[q, L, ...]``
    into L per-layer subtrees of ``[q, ...]`` views, so bucket boundaries
    (``bucketize`` packs leaves greedily, never splitting one) can fall on
    layer boundaries — the granularity at which the backward pass
    materialises gradients.  Returns the split tree plus the set of keys
    to restack.  Leaves whose layer axis is not the group's repeat count
    (or groups of one repeat) pass through unsplit."""
    repeats = {f"dec_{g.name}": g.repeats for g in cfg.groups}
    repeats.update({f"enc_{g.name}": g.repeats for g in cfg.encoder_groups})
    split, split_keys = {}, set()
    for key, sub in grads.items():
        r = repeats.get(key, 0)
        if r > 1:
            leaves = tree_flatten(sub)[0]
            if leaves and all(l.ndim >= 2 and l.shape[1] == r
                              for l in leaves):
                split[key] = [_map(lambda l, i=i: l[:, i], sub)
                              for i in range(r)]
                split_keys.add(key)
                continue
        split[key] = sub
    return split, split_keys


def _restack_scan_layers(split: Tree, split_keys) -> Tree:
    """The inverse of :func:`_split_scan_layers` on one pod's leaves:
    each split group's per-layer leaves stacked ``[L, ...]`` again."""
    return {key: _map(lambda *xs: torch.stack(xs), *sub)
            if key in split_keys else sub
            for key, sub in split.items()}


def build_train_step(cfg: ModelConfig, mesh: Optional[VirtualMesh] = None,
                     *, opt_cfg: AdamWConfig = AdamWConfig(),
                     grad_sync: str = "gspmd",
                     sync_attrs: SyncAttributes = LPF_SYNC_DEFAULT,
                     grad_sync_method: str = "auto",
                     grad_bucket_bytes: Optional[int] = None,
                     grad_accum: int = 1,
                     steps_per_call: int = 1,
                     axis_roles: str = "fsdp_tp",
                     donate: bool = False,
                     device="cuda") -> TrainStep:
    """The training step of ``cfg`` on ``device`` (the card unless the
    caller asks for the CPU).  ``mesh=None`` is one device; a mesh's
    shards are virtual (module docstring), its data and model axes acting
    as ``axis_roles`` says.  ``donate=True`` consumes the parameters
    and optimizer state a step is given (the JAX package's
    ``donate_argnums``, its default there): AdamW updates them in place,
    so a step holds one copy of the state; the caller must use only what
    the step returns."""
    if grad_sync not in ("gspmd", "lpf"):
        raise LPFFatalError(f"grad_sync={grad_sync!r}: expected gspmd or "
                            f"lpf")
    if grad_accum < 1 or steps_per_call < 1:
        raise LPFFatalError(f"grad_accum={grad_accum} and steps_per_call="
                            f"{steps_per_call} must be >= 1")
    if axis_roles not in ("fsdp_tp", "dp_all"):
        raise LPFFatalError(f"axis_roles={axis_roles!r}: expected fsdp_tp "
                            f"or dp_all")
    npods = virtual_pods(mesh)
    batch_axes = ()
    if mesh is None:
        rt = Runtime(device)
    elif axis_roles == "dp_all":
        # the model axis carries extra data parallelism
        batch_axes = tuple(a for a in ("pod", "data", "model")
                           if a in mesh.axis_names)
        rt = Runtime(device, mesh, dp_axes=batch_axes, model_axis=None)
    else:
        batch_axes = dp_axes_of(mesh)
        rt = Runtime(device, mesh, dp_axes=batch_axes,
                     model_axis=model_axis_of(mesh))
    # the lpf pod body runs without a mesh (JAX's ``rt_pod``)
    rt_pod = Runtime(device)
    ledger = CostLedger()

    def loss_and_grads(params: ParamTree, batch: dict, rt_: Runtime = rt):
        """Microbatched (gradient-accumulated) loss and f32 gradients."""
        tree = params.tree()
        # parameters() walks the module in the order tree() nests it
        leaves = list(params.parameters())

        def one(mb):
            with span("train.forward"):
                loss = loss_fn(params, mb, cfg, rt_)
            with span("train.backward"):
                grads = torch.autograd.grad(loss, leaves)
            return loss.detach(), grads

        if grad_accum == 1:
            loss, grads = one(batch)
            return loss, _fill(tree, iter(grads))
        micro = {k: v.reshape((grad_accum, v.shape[0] // grad_accum)
                              + tuple(v.shape[1:])) for k, v in batch.items()}
        loss_sum = torch.zeros((), dtype=torch.float32, device=rt.device)
        g_sum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves]
        for i in range(grad_accum):
            loss, grads = one({k: v[i] for k, v in micro.items()})
            loss_sum += loss
            for a, g in zip(g_sum, grads):
                a += g.float()
        return loss_sum / grad_accum, _fill(tree, (g / grad_accum
                                                   for g in g_sum))

    @span("train.step")
    def plain_step(params: ParamTree, opt: Tree, batch: dict):
        loss, grads = loss_and_grads(params, batch)
        with span("train.optimizer"):
            new, opt, metrics = adamw_update(grads, opt, params.tree(),
                                             opt_cfg, donate=donate)
        metrics["loss"] = loss
        return ParamTree(new, trainable=True), opt, metrics

    #: the batch signatures whose first step ledgered (JAX: one trace each)
    traced = set()

    @span("train.step")
    def pod_step(params: ParamTree, opt: Tree, batch: dict):
        rows = next(iter(batch.values())).shape[0]
        if rows % npods:
            raise LPFFatalError(f"a batch of {rows} rows does not split "
                                f"over {npods} pods")
        sig = tuple((k, tuple(v.shape), str(v.dtype))
                    for k, v in sorted(batch.items()))
        led = None if sig in traced else ledger
        traced.add(sig)
        per = rows // npods
        stacked, losses = None, []
        for i in range(npods):
            loss, grads = loss_and_grads(
                params, {k: v[i * per:(i + 1) * per]
                         for k, v in batch.items()}, rt_pod)
            if stacked is None:
                stacked = _map(lambda g: g.new_empty((npods, *g.shape)),
                               grads)
            _map(lambda dst, g, i=i: dst[i].copy_(g), stacked, grads)
            losses.append(loss)
            del grads
        # ``auto`` picks the overlapped bucket pipeline when
        # ``grad_bucket_bytes`` is set, one reduce-scatter + all-gather
        # pair for uncompressed gradients otherwise, the int16 ring under
        # compression
        bucketing = grad_bucket_bytes is not None and grad_sync_method in (
            "auto", "bucketed", "bucketed_fenced", "bucketed_overlap")
        keys = set()
        if bucketing:
            # bucket boundaries on layer boundaries: the stacked [q, L, ...]
            # group leaves split into per-layer [q, ...] views
            stacked, keys = _split_scan_layers(stacked, cfg)
        with span("train.pod_sync"):
            synced = pod_allreduce(stacked, npods, "pod", attrs=sync_attrs,
                                   mean=True, ledger=led,
                                   method=grad_sync_method,
                                   bucket_bytes=grad_bucket_bytes)
        del stacked
        # every pod holds the same gradients: the replicated state takes
        # one pod's row, as P() holds it once
        grads = _restack_scan_layers(_map(lambda g: g[0], synced), keys)
        del synced
        loss = torch.stack(losses).sum() / npods
        with span("train.optimizer"):
            new, opt, metrics = adamw_update(grads, opt, params.tree(),
                                             opt_cfg, donate=donate)
        metrics["loss"] = loss
        return ParamTree(new, trainable=True), opt, metrics

    step = pod_step if grad_sync == "lpf" and npods > 1 else plain_step

    def multi(params: ParamTree, opt: Tree, batches: dict):
        """``steps_per_call`` steps over batches with a leading [K] axis;
        each metric stacked [K]."""
        history = []
        for i in range(steps_per_call):
            params, opt, m = step(params, opt,
                                  {k: v[i] for k, v in batches.items()})
            history.append(m)
        return params, opt, {k: torch.stack([torch.as_tensor(
            m[k], dtype=torch.float32, device=rt.device) for m in history])
            for k in history[0]}

    def init_fn(key):
        params = init_params(key, cfg, device=rt.device, trainable=True)
        return params, adamw_init(params.tree(), opt_cfg)

    def like_fn():
        params = init_params(0, cfg, device="meta", trainable=True)
        return params, adamw_init(params.tree(), opt_cfg)

    return TrainStep(step_fn=multi if steps_per_call > 1 else step,
                     init_fn=init_fn, like_fn=like_fn, rt=rt, ledger=ledger,
                     batch_axes=batch_axes)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

class CapturedDecode:
    """One decode bucket's greedy step as a CUDA graph over static
    buffers: the caches, the token ``[B]``, the position (a 0-d long
    tensor) and the outputs ``[C, B]``, all owned by the bucket.  One
    replay decodes a token at the position the buffer holds, writes it to
    the outputs' next row, feeds it back as the next input and advances
    the position, so ``n`` replays decode ``n`` tokens with no host write
    between them.

    The graph is captured on the first call (and again for another
    parameter tree, whose addresses it reads): one eager warm-up step on
    a side stream, then the capture into the graph's own memory pool.  A
    capture that fails raises :class:`LPFTransientError`, which the serve
    ladder answers by moving the bucket to the per-token path; it never
    runs eagerly in its place."""

    def __init__(self, cfg: ModelConfig, rt: Runtime, batch: int,
                 cache_len: int):
        self.cfg, self.rt = cfg, rt
        #: the encoder output the graph reads (an encoder-decoder's),
        #: allocated by the first call that brings one, of its shape
        self.enc: Optional[torch.Tensor] = None
        self.batch, self.cache_len = batch, cache_len
        dev = rt.device
        self.caches = init_caches(cfg, batch, cache_len, device=dev)
        self.tok = torch.zeros(batch, dtype=torch.long, device=dev)
        self.pos = torch.zeros((), dtype=torch.long, device=dev)
        #: the outputs' next row (the replay count modulo ``cache_len``)
        self.row = torch.zeros((), dtype=torch.long, device=dev)
        self.out = torch.zeros(cache_len, batch, dtype=torch.long,
                               device=dev)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.params: Optional[ParamTree] = None
        #: graphs captured, and replays (tokens decoded through a graph)
        self.captures = 0
        self.replays = 0

    def _step(self) -> None:
        nxt, _logits, _ = decode_step(self.params, self.tok, self.caches,
                                      self.pos, self.cfg, self.rt, self.enc)
        self.out.index_copy_(0, self.row.reshape(1), nxt[None])
        self.tok.copy_(nxt)
        self.pos.add_(1)
        self.row.copy_((self.row + 1) % self.cache_len)

    def _capture(self, params: ParamTree) -> None:
        self.graph = None             # the old graph and its pool go first
        self.params = params
        try:
            side = torch.cuda.Stream(self.rt.device)
            side.wait_stream(torch.cuda.current_stream(self.rt.device))
            with torch.cuda.stream(side):
                self._step()          # warm-up: handles, workspaces, pool
            torch.cuda.current_stream(self.rt.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self._step()
        except LPFError:
            self.params = None
            raise
        except Exception as e:
            self.params = None
            raise LPFTransientError(
                f"decode bucket ({self.batch}, {self.cache_len}) of "
                f"{self.cfg.name}: the CUDA-graph capture of its step "
                f"failed: {type(e).__name__}: {e}") from e
        self.graph = graph
        self.captures += 1

    def decode(self, params: ParamTree, tok0, pos0, n_tokens: int,
               enc_out: Optional[torch.Tensor] = None):
        """``n_tokens`` greedy tokens from ``tok0`` [B] at position
        ``pos0``, from zeroed caches; an encoder-decoder's ``enc_out`` is
        copied into the bucket's own buffer first (a buffer of another
        shape or dtype is replaced, and the step captured again).
        Returns (toks [n_tokens, B], the bucket's caches, valid until its
        next call)."""
        if bool(self.cfg.encoder_groups) != (enc_out is not None):
            raise LPFFatalError(
                f"{self.cfg.name}: an encoder-decoder's decode takes "
                f"enc_out, any other model's none")
        if enc_out is not None:
            if self.enc is None or self.enc.shape != enc_out.shape \
                    or self.enc.dtype != enc_out.dtype:
                self.graph = None
                self.enc = torch.empty_like(enc_out, device=self.rt.device)
            self.enc.copy_(enc_out)
        if self.graph is None or params is not self.params:
            self._capture(params)
        for c in pytree.tree_leaves(self.caches):
            c.zero_()
        self.tok.copy_(torch.as_tensor(tok0))
        self.pos.copy_(torch.as_tensor(pos0))
        self.row.zero_()
        C, toks = self.cache_len, []
        for k in range(1, n_tokens + 1):
            self.graph.replay()
            self.replays += 1
            if k % C == 0 or k == n_tokens:
                # the rows written since the last read
                toks.append(self.out[:(k - 1) % C + 1].clone())
        out = torch.cat(toks) if toks else self.out[:0].clone()
        return out, self.caches


@dataclasses.dataclass
class ServeStep:
    #: (params, caches, token [B], pos, enc_out=None) -> (next_token [B],
    #: caches): one eager step
    step_fn: Callable
    rt: Runtime
    #: (n_tokens) -> fn(params, tok0 [B], pos0, enc_out=None) -> (toks
    #: [n_tokens, B], caches): the greedy loop from zeroed caches of the
    #: bucket's shape,
    #: on the card the bucket's captured step replayed (the JAX package's
    #: takes the caller's caches and donates them; no caller here has any)
    decode_fn: Callable
    #: the bucket's captured step on the card, None on the CPU
    graph: Optional[CapturedDecode] = None


def serve_axes(mesh: VirtualMesh, global_batch: int,
               batch_axes: Optional[Tuple[str, ...]] = None,
               seq_axes: Optional[Tuple[str, ...]] = None
               ) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """The batch and cache-sequence axes of a serve step on ``mesh``, as
    the JAX package resolves them: the batch over the pod and data axes
    where their shards divide it, else over none, and then the sequence
    over every axis (pod, data, model) in place of the model axis."""
    axes = tuple(mesh.axis_names)
    if batch_axes is None:
        dp = dp_axes_of(mesh)
        total = mesh_shards(mesh, dp)
        batch_axes = dp if dp and global_batch % total == 0 else ()
    if seq_axes is None:
        seq_axes = ("model",) if "model" in axes else ()
        if not batch_axes:   # batch can't shard -> widen sequence sharding
            seq_axes = tuple(a for a in ("pod", "data", "model")
                             if a in axes)
    return tuple(batch_axes), tuple(seq_axes)


def build_serve_step(cfg: ModelConfig, mesh: Optional[VirtualMesh] = None,
                     *, global_batch: int, cache_len: int,
                     batch_axes: Optional[Tuple[str, ...]] = None,
                     seq_axes: Optional[Tuple[str, ...]] = None,
                     donate_cache: bool = True, device="cuda") -> ServeStep:
    """One ``(global_batch, cache_len)`` decode bucket's step functions on
    ``device`` (the card unless the caller asks for the CPU), over
    ``mesh``'s virtual shards where one is given (the axes as
    :func:`serve_axes` resolves them; a 1x1 mesh decodes the tokens
    ``mesh=None`` does, bit for bit).  On the card ``decode_fn`` replays
    the bucket's captured step (:class:`CapturedDecode`); on the CPU it
    is the eager loop over ``step_fn``.  ``step_fn`` writes the caches it
    is given in place (JAX's donation); ``donate_cache=False`` writes a
    copy and leaves the caller's caches as they were."""
    if mesh is None:
        rt = Runtime(device)
    else:
        batch_axes, seq_axes = serve_axes(mesh, global_batch, batch_axes,
                                          seq_axes)
        rt = Runtime(device, mesh, dp_axes=batch_axes,
                     model_axis=model_axis_of(mesh), seq_axes=seq_axes)
    graph = None
    if rt.device.type == "cuda":
        graph = CapturedDecode(cfg, rt, global_batch, cache_len)

    def serve(params, caches, token, pos, enc_out=None):
        if not donate_cache:
            caches = pytree.tree_map(torch.clone, caches)
        nxt, _logits, caches = decode_step(params, token, caches, pos, cfg,
                                           rt, enc_out)
        return nxt, caches

    def decode_fn(n_tokens: int):
        """Greedy decode of ``n_tokens`` tokens from ``tok0`` at ``pos0``,
        from zeroed caches."""
        def eager(params, tok0, pos0, enc_out=None):
            caches = init_caches(cfg, global_batch, cache_len,
                                 device=rt.device)
            tok, toks = tok0, []
            for i in range(n_tokens):
                tok, _logits, caches = decode_step(
                    params, tok, caches, int(pos0) + i, cfg, rt, enc_out)
                toks.append(tok)
            return torch.stack(toks), caches      # [n_tokens, B]

        def captured(params, tok0, pos0, enc_out=None):
            return graph.decode(params, tok0, pos0, n_tokens, enc_out)

        return eager if graph is None else captured

    return ServeStep(step_fn=serve, rt=rt, decode_fn=decode_fn, graph=graph)


def build_serve_buckets(cfg: ModelConfig,
                        buckets: Sequence[Tuple[int, int]], *,
                        device="cuda", mesh: Optional[VirtualMesh] = None,
                        **kwargs) -> Dict[Tuple[int, int], ServeStep]:
    """The continuous-batching server's decode buckets: one
    :class:`ServeStep` per ``(global_batch, cache_len)`` shape, each with
    its own captured step on the card (``mesh`` and ``kwargs`` as
    :func:`build_serve_step` takes them).  Buckets never share buffers:
    each owns its caches, token, position, outputs, graph and memory
    pool, so quarantining one bucket's captured path cannot corrupt
    another's."""
    return {(b, c): build_serve_step(cfg, mesh, device=device,
                                     global_batch=b, cache_len=c, **kwargs)
            for b, c in buckets}
