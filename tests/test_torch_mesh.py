"""The data and model mesh axes as virtual shards (``repro_torch.launch
.mesh``) against the JAX package's ``shard_map`` bodies on the CPU's 8
host devices.

* ``moe_apply`` on (pod, data, model) meshes (1, 2, 2), (1, 1, 4),
  (2, 2, 1) and (1, 1, 1), granite-moe-3b-a800m's smoke MoE with
  ``ep_degree`` the model axis (6 experts padded to 8 at 4), in f32 at
  1e-5 (``tests/test_torch_moe.py``'s ``MOE_F32_BAR``); each batch
  shard's drops equal a numpy count from the same router logits; one
  shard of each kind is ``moe_single`` bit for bit.
* ``decode_attention`` on (1, 2, 2), (2, 2, 2) and (1, 1, 4), the
  position in the first, a middle and the last cache shard, soft-cap on
  and off, a GQA group of 4, and a batch that cannot shard (the sequence
  over all three axes), in f32 at 1e-5.
* ``build_serve_step`` on JAX's ``mesh_pdm`` (2, 2, 2): the tokens of
  ``tests/test_train_integration.py``'s two serve cases against JAX's,
  the resolved axes against JAX's ``ss.rt``, ``donate_cache=False``, and
  a 1x1 mesh bit-equal to no mesh.
* ``build_train_step`` on ``mesh_dm`` (2, 2): the integration file's
  mesh cases (loss decrease, checkpoint resume, gradient accumulation,
  ``steps_per_call``) at small sizes; granite's smoke step against JAX's
  on (2, 2), (1, 2, 2) and (2, 1, 1) under ``gspmd`` and ``lpf`` for
  both ``axis_roles`` (loss 1e-5 relative, parameters 1e-4, as
  ``tests/test_torch_train.py``'s step parity).
* The launchers' ``--mesh`` on the CPU, and ``configs.shapes`` cell for
  cell against the JAX package's for all ten architectures.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import applicable as jax_applicable
from repro.configs import get_config as jax_get_config
from repro.configs import input_specs as jax_input_specs
from repro.core import compat
from repro.models import init_params as jax_init_params
from repro.models.attention import decode_attention as jax_decode_attention
from repro.models.moe import MoEConfig as JaxMoEConfig
from repro.models.moe import moe_apply as jax_moe_apply
from repro.models.moe import moe_params as jax_moe_params
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.runtime.train_step import build_serve_step as jax_build_serve_step
from repro.runtime.train_step import build_train_step as jax_build_train_step
from repro_torch import configs as tconfigs
from repro_torch.configs import get_config
from repro_torch.core import LPFFatalError
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.interop import opt_state_from_jax, params_from_jax
from repro_torch.launch.mesh import make_mesh, mesh_shards, merge, split
from repro_torch.models import (decode_step, init_caches, init_params,
                                moe)
from repro_torch.models.attention import decode_attention
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.train_loop import TrainLoopConfig, train_loop
from repro_torch.runtime.train_step import (build_serve_step,
                                            build_train_step, serve_axes)

F32_BAR = 1e-5
#: steps of the mesh's loss-decrease run (granite's smoke config)
LOSS_STEPS = 12
GRANITE = "granite-moe-3b-a800m"
LLAMA = "llama3.2-1b"
AXES = ("pod", "data", "model")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tests run tiny shapes, and the suite runs under several
    workers on shared cores, where torch's intra-op threads only contend:
    one thread for this module, the setting restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jmesh(shape):
    n = int(np.prod(shape))
    return compat.make_mesh(shape, AXES[-len(shape):],
                            devices=jax.devices()[:n])


def rel(a, ref):
    a, ref = np.asarray(a, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(a - ref).max() / (np.abs(ref).max() + 1e-9))


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(
                v.detach().float() if isinstance(v, torch.Tensor) else v,
                np.float32)
    return out


# --------------------------------------------------------------------------
# the virtual mesh's helpers
# --------------------------------------------------------------------------

def test_shards_split_and_merge_as_partition_specs_lay_out():
    """Shard ``i`` of a dimension over several axes is the row-major
    index in the order the axes are named (JAX's ``P((a, b))``)."""
    mesh = make_mesh((2, 2, 2))
    assert mesh_shards(mesh, ("pod", "data")) == 4
    assert mesh_shards(mesh, ()) == 1
    with pytest.raises(LPFFatalError, match="no axis"):
        mesh_shards(make_mesh((2, 2)), ("pod",))
    x = torch.arange(24).reshape(2, 12)
    s = split(x, 1, 4)
    assert s.shape == (2, 4, 3) and torch.equal(s[:, 1], x[:, 3:6])
    assert torch.equal(merge(s, 1), x)
    with pytest.raises(LPFFatalError, match="does not split"):
        split(x, 1, 5, "the cache")


# --------------------------------------------------------------------------
# moe_apply
# --------------------------------------------------------------------------

MOE_MESHES = [(1, 2, 2), (1, 1, 4), (2, 2, 1), (1, 1, 1)]


def moe_case(M, seed=2, B=4, S=32, **kw):
    """(config with ``ep_degree=M``, JAX tree, port tree, x [B, S, D])."""
    mcfg = dataclasses.replace(get_config(GRANITE, smoke=True).moe,
                               ep_degree=M, **kw)
    tree = jax.tree.map(np.asarray, jax_moe_params(
        jax.random.PRNGKey(seed), JaxMoEConfig(**dataclasses.asdict(mcfg))))
    tp = {k: torch.from_numpy(np.array(v, np.float32))
          for k, v in tree.items()}
    x = np.random.default_rng(seed).standard_normal(
        (B, S, mcfg.d_model)).astype(np.float32)
    return mcfg, tree, tp, x


def numpy_drops(tree, x, mcfg, n_dp):
    """Each batch shard's dropped (token, expert) pairs, counted in numpy
    from the router logits: per expert ``max(routed - cap, 0)``."""
    B, S, D = x.shape
    T = B // n_dp * S
    logits = x.reshape(n_dp, T, D).astype(np.float64) @ tree["router"]
    E = logits.shape[-1]
    logits[..., mcfg.n_experts:] = -1e30
    top = np.argsort(-logits, axis=-1)[..., :mcfg.top_k]
    cap = max(1, min(T, max(8, int(mcfg.capacity_factor * mcfg.top_k * T
                                   / E))))
    load = np.stack([np.bincount(t.reshape(-1), minlength=E) for t in top])
    return np.maximum(load - cap, 0).sum(axis=1).tolist(), cap


@pytest.mark.parametrize("shape", MOE_MESHES)
def test_moe_apply_matches_jax_shard_map(shape):
    M = shape[-1]
    mcfg, tree, tp, x = moe_case(M)
    jm = jmesh(shape)
    want = jax.jit(lambda p, x: jax_moe_apply(p, x, mcfg, mesh=jm))(
        tree, jnp.asarray(x))
    mesh = make_mesh(shape)
    got = moe.moe_apply(tp, torch.from_numpy(x), mcfg, mesh=mesh)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert rel(got, want) < F32_BAR
    n_dp = shape[0] * shape[1]
    load, cap = moe.expert_load(tp, torch.from_numpy(x), mcfg, mesh=mesh)
    drops, want_cap = numpy_drops(tree, x, mcfg, n_dp)
    assert load.shape == (n_dp, tp["w_gate"].shape[0]) and cap == want_cap
    assert (load - cap).clamp_min(0).sum(1).tolist() == drops
    # the capacity binds on every mesh but one shard of 6 experts
    assert (sum(drops) > 0) == (shape != (1, 1, 1))
    if n_dp > 1:
        # the control: moe_single routes the whole batch with its own
        # capacity and misses JAX's per-shard drops
        single = moe.moe_single(tp, torch.from_numpy(x), mcfg)
        assert rel(single, want) > 100 * F32_BAR


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_apply_on_one_shard_is_moe_single(dtype):
    mcfg, _, tp, x = moe_case(1)
    tp = {k: v.to(dtype) if k != "router" else v for k, v in tp.items()}
    xt = torch.from_numpy(x).to(dtype)
    got = moe.moe_apply(tp, xt, mcfg, mesh=make_mesh((1, 1, 1)))
    assert torch.equal(got, moe.moe_single(tp, xt, mcfg))


def test_moe_apply_is_the_shards_moe_single_calls():
    """On (1, D, 1) each batch shard is ``moe_single`` of its rows."""
    mcfg, _, tp, x = moe_case(1)
    xt = torch.from_numpy(x)
    got = moe.moe_apply(tp, xt, mcfg, mesh=make_mesh((1, 2, 1)))
    want = torch.cat([moe.moe_single(tp, xt[:2], mcfg),
                      moe.moe_single(tp, xt[2:], mcfg)])
    assert rel(got, want) < F32_BAR


def test_moe_apply_refuses_what_jax_cannot_lay_out():
    mcfg, _, tp, x = moe_case(1)
    xt = torch.from_numpy(x)
    with pytest.raises(LPFFatalError, match="moe_single"):
        moe.moe_apply(tp, xt, mcfg, mesh=None)
    with pytest.raises(LPFFatalError, match="'model' axis"):
        moe.moe_apply(tp, xt, mcfg, mesh=make_mesh((2,), ("data",)))
    with pytest.raises(LPFFatalError, match="ep_degree=4"):
        moe.moe_apply(tp, xt, mcfg, mesh=make_mesh((1, 1, 4)))
    with pytest.raises(LPFFatalError, match="batch"):
        moe.moe_apply(tp, xt[:3], mcfg, mesh=make_mesh((1, 2, 2)))


# --------------------------------------------------------------------------
# decode_attention
# --------------------------------------------------------------------------

DECODE_MESHES = [(1, 2, 2), (2, 2, 2), (1, 1, 4)]
B_DEC, S_DEC, H_DEC, HKV_DEC, D_DEC = 4, 32, 8, 2, 16


def decode_inputs(B, seed=5):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H_DEC, D_DEC)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, S_DEC, HKV_DEC, D_DEC))
              .astype(np.float32) for _ in range(2))
    kn, vn = (rng.standard_normal((B, 1, HKV_DEC, D_DEC)).astype(np.float32)
              for _ in range(2))
    return q, kc, vc, kn, vn


def positions(n_s):
    """A position in the first shard, one in a middle shard, the last."""
    Sc = S_DEC // n_s
    return {"first": Sc // 2, "middle": (n_s // 2) * Sc + Sc // 2 + 1,
            "last": S_DEC - 1}


def decode_both(shape, B, pos, softcap, batch_axes, seq_axes):
    args = decode_inputs(B)
    jm = jmesh(shape)
    want = jax.jit(lambda *a: jax_decode_attention(
        *a, mesh=jm, seq_axes=seq_axes, batch_axes=batch_axes,
        softcap=softcap, pos=pos))(*map(jnp.asarray, args))
    got = decode_attention(*map(torch.from_numpy, args),
                           mesh=make_mesh(shape), seq_axes=seq_axes,
                           batch_axes=batch_axes, softcap=softcap, pos=pos)
    return got, want


@pytest.mark.parametrize("softcap", [None, 2.0])
@pytest.mark.parametrize("where", ["first", "middle", "last"])
@pytest.mark.parametrize("shape", DECODE_MESHES)
def test_decode_attention_matches_jax_shard_map(shape, where, softcap):
    mesh = make_mesh(shape)
    batch_axes, seq_axes = serve_axes(mesh, B_DEC)
    assert seq_axes == ("model",)
    pos = positions(mesh_shards(mesh, seq_axes))[where]
    got, want = decode_both(shape, B_DEC, pos, softcap, batch_axes,
                            seq_axes)
    assert got.shape == (B_DEC, H_DEC, D_DEC)
    assert rel(got, want) < F32_BAR


@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_decode_attention_widens_the_sequence_for_a_batch_that_cannot_shard(
        where):
    mesh = make_mesh((2, 2, 2))
    batch_axes, seq_axes = serve_axes(mesh, 3)
    assert batch_axes == () and seq_axes == AXES
    pos = positions(8)[where]
    got, want = decode_both((2, 2, 2), 3, pos, None, batch_axes, seq_axes)
    assert rel(got, want) < F32_BAR


def test_decode_attention_shards_merge_to_the_one_shard_decode():
    """Four cache shards merge to the one-shard decode; the shard offset
    matters: a slot index without it (every shard counting from 0) reads
    unwritten slots of the later shards."""
    from repro_torch.models import attention
    args = [torch.from_numpy(a) for a in decode_inputs(B_DEC)]
    pos = 5
    one = decode_attention(*args, mesh=make_mesh((1, 1)),
                           batch_axes=("data",), pos=pos)
    four = decode_attention(*args, mesh=make_mesh((1, 4)),
                            batch_axes=("data",), pos=pos)
    assert rel(four, one) < F32_BAR
    real = attention.shard_slots
    attention.shard_slots = lambda n, Sc, device: real(1, Sc, device) \
        .expand(n, Sc)
    try:
        control = decode_attention(*args, mesh=make_mesh((1, 4)),
                                   batch_axes=("data",), pos=pos)
    finally:
        attention.shard_slots = real
    assert rel(control, one) > 100 * F32_BAR


def test_decode_attention_refuses_what_jax_cannot_lay_out():
    q, kc, vc, kn, vn = (torch.from_numpy(a) for a in decode_inputs(B_DEC))
    mesh = make_mesh((1, 2, 4))
    with pytest.raises(LPFFatalError, match="cache length"):
        decode_attention(q, kc[:, :30], vc[:, :30], kn, vn, mesh=mesh,
                         batch_axes=("data",), pos=3)
    with pytest.raises(LPFFatalError, match="batch"):
        decode_attention(q[:3], kc[:3], vc[:3], kn[:3], vn[:3], mesh=mesh,
                         batch_axes=("data",), pos=3)
    with pytest.raises(LPFFatalError, match="mesh=None"):
        decode_attention(q, kc, vc, kn, vn, mesh=None, pos=3)


# --------------------------------------------------------------------------
# build_serve_step on mesh_pdm
# --------------------------------------------------------------------------

def serve_cfgs(arch=LLAMA, **kw):
    kw = dict(vocab=256, compute_dtype="float32", **kw)
    return (dataclasses.replace(jax_get_config(arch, smoke=True), **kw),
            dataclasses.replace(get_config(arch, smoke=True), **kw))


@pytest.fixture(scope="module")
def llama_tree():
    jcfg, _ = serve_cfgs()
    return jax.tree.map(np.asarray,
                        jax_init_params(jax.random.PRNGKey(1), jcfg))


def test_serve_step_distributed_matches_jax(mesh_pdm, llama_tree):
    jcfg, cfg = serve_cfgs()
    ss = jax_build_serve_step(jcfg, mesh_pdm, global_batch=4, cache_len=16)
    from repro.models import init_caches as jax_init_caches
    jp = jax.device_put(jax.tree.map(jnp.asarray, llama_tree),
                        ss.param_sharding)
    caches = jax.device_put(jax_init_caches(jcfg, 4, 16), ss.cache_sharding)
    tok, want = jnp.asarray([3, 7, 11, 0], jnp.int32), []
    for pos in range(3):
        tok, caches = ss.step_fn(jp, caches, tok, jnp.int32(pos))
        want.append(np.asarray(tok))
    ts = build_serve_step(cfg, make_mesh((2, 2, 2)), global_batch=4,
                          cache_len=16, device="cpu")
    assert (ts.rt.dp_axes, ts.rt.seq_axes) == (ss.rt.dp_axes,
                                               ss.rt.seq_axes)
    params = params_from_jax(llama_tree, device="cpu")
    tc = init_caches(cfg, 4, 16, device="cpu")
    t, got = torch.tensor([3, 7, 11, 0]), []
    for pos in range(3):
        t, tc = ts.step_fn(params, tc, t, pos)
        got.append(t.numpy())
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    assert t.shape == (4,) and int(t.max()) < cfg.vocab


def test_serve_decode_fn_matches_per_token_and_jax(mesh_pdm, llama_tree):
    jcfg, cfg = serve_cfgs()
    B, L, T = 4, 32, 6
    jss = jax_build_serve_step(jcfg, mesh_pdm, global_batch=B, cache_len=L,
                               donate_cache=False)
    from repro.models import init_caches as jax_init_caches
    jp = jax.device_put(jax.tree.map(jnp.asarray, llama_tree),
                        jss.param_sharding)
    jtoks, _ = jss.decode_fn(T)(
        jp, jax.device_put(jax_init_caches(jcfg, B, L), jss.cache_sharding),
        jnp.zeros((B,), jnp.int32), jnp.int32(0))
    ss = build_serve_step(cfg, make_mesh((2, 2, 2)), global_batch=B,
                          cache_len=L, donate_cache=False, device="cpu")
    params = params_from_jax(llama_tree, device="cpu")
    caches0 = init_caches(cfg, B, L, device="cpu")
    tok, caches, seq = torch.zeros(B, dtype=torch.long), caches0, []
    for pos in range(T):
        tok, caches = ss.step_fn(params, caches, tok, pos)
        seq.append(tok)
    toks, _ = ss.decode_fn(T)(params, torch.zeros(B, dtype=torch.long), 0)
    assert torch.equal(toks, torch.stack(seq))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    # donate_cache=False: the caller's caches are as they were
    assert all(not c.any() for c in torch.utils._pytree.tree_leaves(
        caches0))


def test_serve_step_donates_its_caches_by_default(llama_tree):
    _, cfg = serve_cfgs()
    ss = build_serve_step(cfg, make_mesh((2, 2, 2)), global_batch=4,
                          cache_len=8, device="cpu")
    params = params_from_jax(llama_tree, device="cpu")
    caches = init_caches(cfg, 4, 8, device="cpu")
    _, out = ss.step_fn(params, caches, torch.zeros(4, dtype=torch.long), 0)
    leaves = torch.utils._pytree.tree_leaves(caches)
    assert any(c.any() for c in leaves)
    assert all(a is b for a, b in zip(
        leaves, torch.utils._pytree.tree_leaves(out)))


SERVE_AXES_CASES = [((2, 2, 2), 4), ((2, 2, 2), 3), ((1, 2, 4), 4),
                    ((1, 2, 4), 1), ((2, 2), 2), ((2, 2), 1), ((8,), 4),
                    ((1, 1), 1)]


@pytest.mark.parametrize("shape,batch", SERVE_AXES_CASES)
def test_serve_axes_resolve_as_jax(shape, batch):
    jcfg, cfg = serve_cfgs()
    axes = ("x",) if len(shape) == 1 else None
    jm = compat.make_mesh(shape, axes or AXES[-len(shape):],
                          devices=jax.devices()[:int(np.prod(shape))])
    jss = jax_build_serve_step(jcfg, jm, global_batch=batch, cache_len=16)
    ss = build_serve_step(cfg, make_mesh(shape, axes), global_batch=batch,
                          cache_len=16, device="cpu")
    assert ss.rt.dp_axes == tuple(jss.rt.dp_axes)
    assert ss.rt.seq_axes == tuple(jss.rt.seq_axes)
    assert ss.rt.model_axis == jss.rt.model_axis
    assert ss.rt.distributed == jss.rt.distributed


@pytest.mark.parametrize("arch", [LLAMA, GRANITE])
def test_one_by_one_mesh_decodes_the_tokens_of_no_mesh(arch):
    """A 1x1 mesh runs ``decode_attention`` and ``moe_apply`` with one
    shard each: the bf16 model's logits are bit for bit no mesh's."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), vocab=256)
    params = init_params(3, cfg, device="cpu")
    outs = []
    for mesh in (None, make_mesh((1, 1))):
        ss = build_serve_step(cfg, mesh, global_batch=2, cache_len=16,
                              device="cpu")
        caches = init_caches(cfg, 2, 16, device="cpu")
        tok, logits = torch.tensor([5, 9]), []
        for pos in range(4):
            tok, lg, caches = decode_step(params, tok, caches, pos, cfg,
                                          ss.rt)
            logits.append(lg)
        outs.append(torch.stack(logits))
    assert ss.rt.distributed
    assert torch.equal(outs[0], outs[1])


# --------------------------------------------------------------------------
# build_train_step on mesh_dm, and granite's step against JAX's
# --------------------------------------------------------------------------

def tiny_cfg(arch=LLAMA):
    return dataclasses.replace(get_config(arch, smoke=True), vocab=256)


def stream_for(cfg, B=8, S=32):
    return SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=S,
                                      global_batch=B, seed=0), cfg)


def test_train_loss_decreases_on_mesh_dm():
    cfg = tiny_cfg(GRANITE)
    ts = build_train_step(cfg, make_mesh((2, 2)),
                          opt_cfg=AdamWConfig(lr=3e-3), device="cpu")
    assert ts.rt.distributed and ts.batch_axes == ("data",)
    out = train_loop(ts, stream_for(cfg, B=4, S=16),
                     TrainLoopConfig(steps=LOSS_STEPS, ckpt_dir=None))
    first = np.mean(out["losses"][:5])
    last = np.mean(out["losses"][-5:])
    assert np.isfinite(last)
    assert last < first - 0.2, (first, last)


def test_checkpoint_resume_bitexact_on_mesh_dm(tmp_path):
    cfg = tiny_cfg(GRANITE)
    ts = build_train_step(cfg, make_mesh((2, 2)),
                          opt_cfg=AdamWConfig(lr=1e-3), donate=True,
                          device="cpu")
    stream = stream_for(cfg, B=4, S=16)
    out_a = train_loop(ts, stream, TrainLoopConfig(
        steps=4, ckpt_dir=str(tmp_path / "a"), ckpt_every=2))
    shutil.rmtree(tmp_path / "a" / "step_4")
    out_c = train_loop(ts, stream, TrainLoopConfig(
        steps=4, ckpt_dir=str(tmp_path / "a"), ckpt_every=100))
    assert out_a["losses"][2:] == out_c["losses"]
    for a, c in zip(out_a["params"].parameters(),
                    out_c["params"].parameters()):
        assert torch.equal(a, c)


def test_grad_accumulation_equivalence_on_mesh_dm():
    cfg = tiny_cfg()
    mesh = make_mesh((2, 2))
    ts1 = build_train_step(cfg, mesh, opt_cfg=AdamWConfig(lr=1e-3),
                           grad_accum=1, device="cpu")
    ts4 = build_train_step(cfg, mesh, opt_cfg=AdamWConfig(lr=1e-3),
                           grad_accum=4, device="cpu")
    batch = stream_for(cfg, S=16).batch(0)
    p1, _, m1 = ts1.step_fn(*ts1.init_fn(0), batch)
    p4, _, m4 = ts4.step_fn(*ts4.init_fn(0), batch)
    assert abs(m1["loss"].item() - m4["loss"].item()) < 5e-3
    for a, b in zip(p1.parameters(), p4.parameters()):
        assert (a - b).abs().max().item() < 5e-3


def test_steps_per_call_matches_iterated_single_steps_on_mesh_dm():
    cfg = tiny_cfg(GRANITE)
    mesh = make_mesh((2, 2))
    ts1 = build_train_step(cfg, mesh, opt_cfg=AdamWConfig(lr=1e-3),
                           device="cpu")
    ts3 = build_train_step(cfg, mesh, opt_cfg=AdamWConfig(lr=1e-3),
                           steps_per_call=3, device="cpu")
    stream = stream_for(cfg, B=4, S=16)
    batches = [stream.batch(i) for i in range(3)]
    p, o = ts1.init_fn(0)
    losses = []
    for b in batches:
        p, o, m = ts1.step_fn(p, o, b)
        losses.append(m["loss"].item())
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    p3, o3, metrics = ts3.step_fn(*ts3.init_fn(0), stacked)
    assert metrics["loss"].shape == (3,) and o3["step"] == 3
    np.testing.assert_allclose(metrics["loss"].numpy(), losses, atol=5e-3)
    for a, b in zip(p.parameters(), p3.parameters()):
        assert (a - b).abs().max().item() < 5e-3


def granite_cfgs():
    kw = dict(vocab=256, compute_dtype="float32")
    return (dataclasses.replace(jax_get_config(GRANITE, smoke=True), **kw),
            dataclasses.replace(get_config(GRANITE, smoke=True), **kw))


@pytest.fixture(scope="module")
def granite_init():
    jcfg, _ = granite_cfgs()
    jp = jax_init_params(jax.random.PRNGKey(1), jcfg)
    return (jax.tree.map(np.asarray, jp),
            jax.tree.map(np.asarray, jax_adamw_init(jp)))


def granite_batch():
    return SyntheticStream(DataConfig(vocab=256, seq_len=32,
                                      global_batch=4)).batch(0)


_JAX_STEPS = {}


def jax_granite_step(init, shape, grad_sync, axis_roles):
    """One JAX step of granite's smoke config; memoised by what the step
    computes: JAX's ``lpf`` step without pods is its GSPMD step, and its
    pod body runs without a mesh whatever the axis roles
    (``repro/runtime/train_step.py``)."""
    pods = dict(zip(AXES[-len(shape):], shape)).get("pod", 1)
    key = (shape, "pods" if grad_sync == "lpf" and pods > 1 else
           ("gspmd", axis_roles))
    if key not in _JAX_STEPS:
        jcfg, _ = granite_cfgs()
        jts = jax_build_train_step(jcfg, jmesh(shape),
                                   opt_cfg=JaxAdamWConfig(lr=1e-3),
                                   grad_sync=grad_sync,
                                   axis_roles=axis_roles, donate=False)
        p, _o, m = jts.step_fn(
            jax.tree.map(jnp.asarray, init[0]),
            jax.tree.map(jnp.asarray, init[1]),
            {k: jnp.asarray(v) for k, v in granite_batch().items()})
        _JAX_STEPS[key] = ({k: float(v) for k, v in m.items()},
                           flat(jax.tree.map(np.asarray, p)))
    return _JAX_STEPS[key]


@pytest.mark.parametrize("axis_roles", ["fsdp_tp", "dp_all"])
@pytest.mark.parametrize("grad_sync", ["gspmd", "lpf"])
@pytest.mark.parametrize("shape", [(2, 2), (1, 2, 2), (2, 1, 1)])
def test_granite_step_on_a_mesh_matches_jax(granite_init, shape, grad_sync,
                                            axis_roles):
    """One step at ``tests/test_torch_train.py``'s bars: loss 1e-5
    relative, grad norm 1e-4 relative, every parameter 1e-4."""
    _, cfg = granite_cfgs()
    jm, jparams = jax_granite_step(granite_init, shape, grad_sync,
                                   axis_roles)
    ts = build_train_step(cfg, make_mesh(shape),
                          opt_cfg=AdamWConfig(lr=1e-3), grad_sync=grad_sync,
                          axis_roles=axis_roles, device="cpu")
    p, _o, m = ts.step_fn(
        params_from_jax(granite_init[0], device="cpu", trainable=True),
        opt_state_from_jax(granite_init[1], device="cpu"), granite_batch())
    assert abs(float(m["loss"]) - jm["loss"]) < 1e-5 * abs(jm["loss"])
    assert abs(float(m["grad_norm"]) - jm["grad_norm"]) < \
        1e-4 * jm["grad_norm"]
    got = flat(p.tree())
    assert got.keys() == jparams.keys()
    for name, x in got.items():
        assert np.abs(x - jparams[name]).max() < 1e-4, name


# --------------------------------------------------------------------------
# launchers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", ["2x2", "1x2x2"])
def test_train_launcher_runs_granite_on_a_mesh(mesh, capsys):
    from repro_torch.launch import train
    out = train.main(["--device", "cpu", "--arch", GRANITE, "--mesh", mesh,
                      "--steps", "1", "--batch", "4", "--seq", "16",
                      "--devices", "8"])
    text = capsys.readouterr().out
    assert len(out["losses"]) == 1 and np.isfinite(out["final_loss"])
    assert "mesh {" in text


def test_serve_launcher_checks_on_a_1x2x4_mesh(capsys):
    from repro_torch.launch import serve
    res = serve.main(["--device", "cpu", "--mesh", "1x2x4", "--check",
                      "--devices", "8", "--requests", "4", "--tokens",
                      "8", "--cache-len", "16"])
    text = capsys.readouterr().out
    assert "deadline_misses: 0" in text
    assert "bit-identical to solo decode" in text
    assert res["solo_identical"] == res["completed"] > 0
    # bucket (2, C) shards its batch, (4, C) too
    assert "batch axes ('pod', 'data'), sequence axes ('model',)" in text


# --------------------------------------------------------------------------
# configs.shapes
# --------------------------------------------------------------------------

def test_shape_cells_match_jax():
    assert set(tconfigs.SHAPES) == set(JAX_SHAPES)
    for name, cell in tconfigs.SHAPES.items():
        assert dataclasses.asdict(cell) == dataclasses.asdict(
            JAX_SHAPES[name])
    from repro.configs.shapes import SUBQUADRATIC
    from repro_torch.configs.shapes import SUBQUADRATIC as T_SUBQUADRATIC
    assert T_SUBQUADRATIC == SUBQUADRATIC
    assert tuple(tconfigs.ARCHS) == tuple(JAX_ARCHS)


@pytest.mark.parametrize("shape", sorted(JAX_SHAPES))
@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_input_specs_match_jax(arch, shape):
    assert tconfigs.applicable(arch, shape) == jax_applicable(arch, shape)
    want = jax_input_specs(jax_get_config(arch), shape)
    got = tconfigs.input_specs(get_config(arch), shape)
    assert got.keys() == want.keys()
    for k, spec in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(spec.shape), k
        assert str(got[k].dtype).split(".")[-1] == str(spec.dtype), k
