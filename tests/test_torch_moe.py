"""Parity of the port's MoE block and its two models (granite-moe-3b-a800m,
jamba-v0.1-52b) with the JAX reference on the CPU.

The MoE block is held to the JAX package's single-device path
``_moe_single`` on the same numpy inputs, at the granite smoke config's
widths (d 128, expert ff 64, 6 experts top-2) and two variants: the
expert count padded (``ep_degree=4``: 8 experts, 2 of them padding) and a
capacity that drops tokens (``capacity_factor=0.5``).  Bars: relative
error (max |port - jax| / max |jax|) below 1e-5 in f32 (both run f32
math), below 0.08 in bf16 (the JAX package's own bf16 bar), gradients
within 5e-4 of ``jax.vjp``'s (the JAX backward tests' bar).

The models run at their smoke configs with the JAX package's
``init_params`` tree carried across by ``params_from_jax``: the forward,
the prefill and 12 teacher-forced decode steps in f32 below 1e-4, and
three ``build_train_step`` steps against the JAX package's on a (1, 1)
mesh (losses 1e-5, parameters 1e-4; see :func:`assert_params_match` for
the elements whose gradient is at AdamW's eps scale).  In bf16 the models are compared
with every expert routed (``top_k = n_experts``): routing is a top-k, so
a rounding difference upstream can flip a near-tie token to another
expert, which moves that token's output by a whole expert's share.  At
the published top-2 the JAX package's own bf16 forward differs from its
f32 forward by 0.31 at one of 128 positions of a granite smoke call (the
port's bf16 from the JAX bf16 by 0.10 there, the median position by
6.6e-3), so no rounding bar separates right from wrong there; with every
expert routed the block is continuous and the bf16 bar 0.08 holds.  The
f32 runs hold the published routing.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import checkpoint

from repro.configs import get_config as jax_get_config
from repro.core import compat
from repro.models import Runtime as JaxRuntime
from repro.models import count_params as jax_count_params
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_caches as jax_init_caches
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro.models import prefill as jax_prefill
from repro.models.blocks import _moe_single as jax_moe_single
from repro.models.blocks import block_apply as jax_block_apply
from repro.models.blocks import block_params as jax_block_params
from repro.models.lm import _cast_params as jax_cast_params
from repro.models.moe import MoEConfig as JaxMoEConfig
from repro.models.moe import moe_params as jax_moe_params
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.runtime.train_step import build_train_step as jax_build_train_step
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import LPFFatalError
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.interop import (opt_state_from_jax, params_from_jax,
                                 params_to_numpy)
from repro_torch.launch import one_card_config
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import (BlockCfg, Group, Runtime, cast_params,
                                count_params, decode_step, forward,
                                init_caches, init_params, load_params,
                                model_flops, prefill)
from repro_torch.models import blocks, lm, moe
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.train_step import build_train_step

MOE_ARCHS = ("granite-moe-3b-a800m", "jamba-v0.1-52b")
F32_BAR = 1e-4
MOE_F32_BAR = 1e-5
BF16_BAR = 0.08
GRAD_BAR = 5e-4
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CPU = Runtime("cpu")

#: the granite smoke config's MoE, with its expert count padded, and with
#: a capacity under the mean load (64 tokens: cap 10 against 21.3)
MOE_CASES = {
    "granite-smoke": dict(),
    "padded": dict(ep_degree=4),
    "drops": dict(capacity_factor=0.5),
}


def rel(a, ref):
    a = np.asarray(a, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(a - ref).max() / (np.abs(ref).max() + 1e-9))


def flat(tree, prefix=""):
    """{dotted name: numpy leaf} of a nested dict (JAX or port)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(
                v.detach().float() if isinstance(v, torch.Tensor) else v,
                np.float32)
    return out


def moe_cfg(case):
    base = get_config("granite-moe-3b-a800m", smoke=True).moe
    return dataclasses.replace(base, **MOE_CASES[case])


def moe_block(case, compute, seed=2):
    """(the config, the JAX block's parameters cast to ``compute`` as the
    layer body casts them, the same values in the port, x [2, 32, 128]
    in ``compute``)."""
    mcfg = moe_cfg(case)
    jdt, tdt = DTYPES[compute]
    tree = jax_cast_params(jax.tree.map(np.asarray, jax_moe_params(
        jax.random.PRNGKey(seed), JaxMoEConfig(**dataclasses.asdict(mcfg)))),
        jdt)
    tp = {k: torch.from_numpy(np.array(v, np.float32)).to(tdt)
          for k, v in tree.items()}
    x = np.random.default_rng(seed).standard_normal(
        (2, 32, mcfg.d_model)).astype(np.float32)
    return mcfg, tree, tp, jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def configs(arch, **kw):
    """The smoke config in both packages, with the same replacements."""
    return (dataclasses.replace(jax_get_config(arch, smoke=True), **kw),
            dataclasses.replace(get_config(arch, smoke=True), **kw))


def all_routed(cfg):
    """``cfg`` with every expert routed to every token (see the module
    docstring: the bf16 comparisons)."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, top_k=cfg.moe.n_experts))


@pytest.fixture(scope="module", params=MOE_ARCHS)
def model(request):
    """(arch, the JAX smoke tree as numpy, the same tree in the port)."""
    arch = request.param
    jcfg, _ = configs(arch)
    tree = jax.tree.map(np.asarray,
                        jax_init_params(jax.random.PRNGKey(0), jcfg))
    return arch, tree, params_from_jax(tree, device="cpu")


def tokens(seed, B, S, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, S),
                                                dtype=np.int32)


# --------------------------------------------------------------------------
# configuration, parameters, launchers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_config_matches_jax(arch, smoke):
    assert arch in ARCHS
    assert dataclasses.asdict(get_config(arch, smoke=smoke)) == \
        dataclasses.asdict(jax_get_config(arch, smoke=smoke))
    assert dataclasses.asdict(get_config(arch, ep_degree=1)) == \
        dataclasses.asdict(jax_get_config(arch, ep_degree=1))


@pytest.mark.parametrize("active_only", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_matches_jax_at_full_width(arch, active_only):
    cfg = get_config(arch)
    want = jax_count_params(jax_get_config(arch), active_only=active_only)
    assert count_params(cfg, active_only=active_only) == want
    if cfg.moe is None:
        assert count_params(cfg, active_only=True) == count_params(cfg)
    assert model_flops(cfg, 10) == 6.0 * count_params(
        cfg, active_only=True) * 10


def test_published_moe_sizes():
    """granite 3.90 B at the registry's ep_degree 16 (48 experts, 8 of
    them padding), 3.30 B on one card; jamba 51.46 B, 12.0 B active."""
    granite = get_config("granite-moe-3b-a800m")
    assert granite.moe.padded_experts == 48
    assert round(count_params(granite) / 1e9, 2) == 3.90
    one = one_card_config("granite-moe-3b-a800m", smoke=False)
    assert one.moe.padded_experts == 40
    assert round(count_params(one) / 1e9, 2) == 3.30
    jamba = get_config("jamba-v0.1-52b")
    assert round(count_params(jamba) / 1e9, 2) == 51.46
    assert round(count_params(jamba, active_only=True) / 1e9, 1) == 12.0


def test_launchers_build_one_card_configs(monkeypatch, capsys):
    """Both launchers build their config with ep_degree=1, the model axis
    of one card: granite runs 40 experts, not the registry's 48."""
    from repro_torch.launch import train as train_mod
    assert one_card_config("granite-moe-3b-a800m",
                           smoke=False).moe.padded_experts == 40
    seen = []

    def spy(arch, smoke, model=1):
        cfg = one_card_config(arch, smoke, model)
        seen.append((arch, smoke, cfg.moe.ep_degree))
        return cfg

    for mod in (serve_mod, train_mod):
        monkeypatch.setattr(mod, "one_card_config", spy)
    serve_mod.main(["--arch", "granite-moe-3b-a800m", "--device", "cpu",
                    "--requests", "2", "--tokens", "4"])
    train_mod.main(["--arch", "granite-moe-3b-a800m", "--device", "cpu",
                    "--steps", "1", "--batch", "2", "--seq", "16"])
    assert seen == [("granite-moe-3b-a800m", True, 1)] * 2


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_params_cross_exactly(arch):
    """The MoE leaves (``moe.router`` [L, D, E], ``moe.w_gate`` [L, E, D,
    F], ...) cross from the JAX tree and back bit for bit, and the port's
    own tree has the JAX tree's names, shapes and dtypes."""
    jcfg, cfg = configs(arch)
    tree = jax.tree.map(np.asarray,
                        jax_init_params(jax.random.PRNGKey(0), jcfg))
    back = params_to_numpy(params_from_jax(tree, device="cpu"))
    a, b = flat(tree), flat(back)
    assert a.keys() == b.keys()
    for name in a:
        assert np.array_equal(a[name], b[name]), name
    moe_names = [n for n in a if ".moe." in n]
    assert moe_names and all(n.split(".")[-1] in ("router", "w_gate", "w_up",
                                                  "w_down")
                             for n in moe_names)
    jshape = jax.eval_shape(lambda: jax_init_params(
        jax.random.PRNGKey(0), jax_get_config(arch)))
    want = {jax.tree_util.keystr(k): (v.shape, np.dtype(v.dtype).name)
            for k, v in jax.tree_util.tree_flatten_with_path(jshape)[0]}
    got = {"".join(f"['{s}']" for s in n.split(".")):
           (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for n, t in init_params(0, get_config(arch),
                                   device="meta").named_parameters()}
    assert got == want


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_load_params_equals_cast_of_init(arch):
    """The serving load, each block cast as it is drawn: the values of
    ``cast_params(init_params(...))``, the router cast to bf16 as JAX's
    layer body casts it."""
    cfg = get_config(arch, smoke=True)
    want = dict(cast_params(init_params(3, cfg, device="cpu"),
                            cfg).named_parameters())
    got = dict(load_params(3, cfg, device="cpu").named_parameters())
    assert want.keys() == got.keys()
    for name, t in want.items():
        assert got[name].dtype == t.dtype and torch.equal(got[name], t), name
    routers = [n for n in got if n.endswith("moe.router")]
    assert routers and all(got[n].dtype == torch.bfloat16 for n in routers)


@pytest.mark.parametrize("block", [
    BlockCfg("attn", "moe", cross_attn=True), BlockCfg("mla", "moe")],
    ids=["cross_attn", "mla"])
def test_moe_with_other_mixers_matches_jax(block):
    """An MoE block behind cross-attention or MLA (the mixers that used to
    be refused) builds as the JAX package's does and its block apply
    matches the JAX package's in f32."""
    jcfg, cfg = configs("granite-moe-3b-a800m", compute_dtype="float32")
    mla = get_config("deepseek-v3-671b", smoke=True).mla
    kw = dict(groups=(Group("body", (block,), 1),), mla=mla)
    jcfg = dataclasses.replace(jcfg, **kw)
    cfg = dataclasses.replace(cfg, **kw)
    jp = jax.tree.map(np.asarray, jax_block_params(
        jax.random.PRNGKey(3), block, jcfg, jnp.float32))
    tp = params_from_jax(jp, device="cpu").tree()
    mine = blocks.block_params(torch.Generator().manual_seed(0), block,
                               cfg, torch.float32, "cpu")
    assert flat(mine).keys() == flat(tp).keys()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 128)).astype(np.float32)
    enc = rng.standard_normal((2, 16, 128)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16), (2, 16))
    want = jax_block_apply(jp, jnp.asarray(x), block, jcfg, JaxRuntime(),
                           jnp.asarray(pos), jnp.asarray(enc))
    got = blocks.block_apply(tp, torch.from_numpy(x), block, cfg, CPU,
                             torch.from_numpy(pos.copy()),
                             torch.from_numpy(enc))
    assert rel(got, want) < MOE_F32_BAR * 10


def test_moe_apply_needs_a_mesh():
    """Expert parallelism runs over a mesh's model axis (virtual shards,
    ``tests/test_torch_mesh.py``); without a mesh it refuses, as JAX's
    ``shard_map`` cannot run without one."""
    mcfg, _, tp, _, x = moe_block("granite-smoke", "float32")
    with pytest.raises(LPFFatalError, match="moe_single"):
        moe.moe_apply(tp, x, mcfg, mesh=None)


# --------------------------------------------------------------------------
# the MoE block
# --------------------------------------------------------------------------

@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_block_matches_jax(case, compute):
    mcfg, tree, tp, jx, tx = moe_block(case, compute)
    want = jax_moe_single(tree, jx, mcfg)
    got = moe.moe_single(tp, tx, mcfg)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert rel(got.float(), np.asarray(want, np.float32)) < (
        MOE_F32_BAR if compute == "float32" else BF16_BAR)


@pytest.mark.parametrize("case", MOE_CASES)
def test_expert_load_matches_jax_routing(case):
    """Tokens routed to each expert, against the JAX package's routing
    (``lax.top_k`` of the f32 logits); padded experts take none, and the
    drops case drops what the capacity says."""
    mcfg, tree, tp, jx, tx = moe_block(case, "float32")
    logits = np.array(jx.reshape(-1, mcfg.d_model) @ tree["router"])
    E = tp["w_gate"].shape[0]
    logits[:, mcfg.n_experts:] = -1e30
    idx = np.asarray(jax.lax.top_k(jnp.asarray(logits), mcfg.top_k)[1])
    routed, cap = moe.expert_load(tp, tx, mcfg)
    assert routed.tolist() == np.bincount(idx.ravel(), minlength=E).tolist()
    assert cap == moe.moe_capacity(64, E, mcfg)
    assert not routed[mcfg.n_experts:].any()
    if case == "drops":
        assert int((routed - cap).clamp_min(0).sum()) > 0, (routed, cap)


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_gradients_match_jax_vjp(case):
    mcfg, tree, tp, jx, tx = moe_block(case, "float32")
    dy = np.random.default_rng(9).standard_normal(
        tx.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda p, x: jax_moe_single(p, x, mcfg),
                     jax.tree.map(jnp.asarray, tree), jx)
    jg_p, jg_x = vjp(jnp.asarray(dy))
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    x = tx.clone().requires_grad_()
    out = moe.moe_single(leaves, x, mcfg)
    out.backward(torch.from_numpy(dy))
    assert rel(x.grad, jg_x) < GRAD_BAR
    for k, v in leaves.items():
        assert rel(v.grad, jg_p[k]) < GRAD_BAR, k


@pytest.mark.parametrize("shared", [False, True])
def test_moe_block_apply_matches_jax(shared):
    """A whole ``attn``/``moe`` block in f32, with the expert-sized shared
    expert where the config has one (deepseek's ``shared_expert``)."""
    jcfg, cfg = configs("granite-moe-3b-a800m", compute_dtype="float32",
                        shared_expert=shared)
    bcfg = cfg.groups[0].blocks[0]
    jp = jax.tree.map(np.asarray, jax_block_params(
        jax.random.PRNGKey(4), bcfg, jcfg, jnp.float32))
    tp = lm._map(lambda a: torch.from_numpy(np.array(a)), jp)
    assert ("shared_mlp" in tp) == shared
    if shared:
        assert tp["shared_mlp"]["w_gate"].shape == (128, cfg.moe.d_ff)
    x = np.random.default_rng(4).standard_normal((2, 32, 128)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(32), (2, 32))
    want = jax_block_apply(jp, jnp.asarray(x), bcfg, jcfg, JaxRuntime(),
                           jnp.asarray(pos))
    got = blocks.block_apply(tp, torch.from_numpy(x), bcfg, cfg, CPU,
                             torch.from_numpy(pos.copy()))
    assert rel(got, want) < MOE_F32_BAR * 10


# --------------------------------------------------------------------------
# the combine: one autograd op whose backward is one gather
# --------------------------------------------------------------------------

def loop_combine(y, rows, n_model, n_rows):
    """The combine recorded op by op: each model shard's experts added
    into its f32 partial with one ``index_add_`` each, in expert order,
    the partials summed in shard order.  Its backward selects each
    ``y[e]``'s gradient out of a zero-filled gradient of all of ``y``."""
    E, _, D = y.shape
    per = E // n_model
    out = None
    for m in range(n_model):
        part = torch.zeros(n_rows, D, dtype=torch.float32, device=y.device)
        for e in range(m * per, (m + 1) * per):
            part.index_add_(0, rows[e], y[e])
        out = part if out is None else out + part
    return out


#: (MoE case, mesh or None for ``moe_single``, top_k or None for the
#: case's): one device, and the virtual meshes whose model shards each
#: sum a partial (2 and 4) or whose batch shards each route their own
#: tokens.  At top-4 a token's output sums 4 experts' outputs, so the
#: order of the adds shows in the rounding (at top-2 it cannot)
COMBINE_CASES = {
    **{f"single-{c}": (c, None, None) for c in MOE_CASES},
    "single-top4": ("granite-smoke", None, 4),
    "model2": ("granite-smoke", (1, 1, 2), None),
    "model4": ("granite-smoke", (1, 1, 4), None),
    "model4-top4": ("granite-smoke", (1, 1, 4), 4),
    "dp2": ("granite-smoke", (1, 2, 1), None),
    "dp2-model2": ("drops", (1, 2, 2), None),
}


def _combine_case(name):
    """(the block's function of (leaves, x), port leaves, x [2, 32, 128])
    in f32 for a case of ``COMBINE_CASES``."""
    case, shape, top_k = COMBINE_CASES[name]
    mcfg = moe_cfg(case)
    if top_k is not None:
        mcfg = dataclasses.replace(mcfg, top_k=top_k)
    if shape is not None:
        mcfg = dataclasses.replace(mcfg, ep_degree=max(mcfg.ep_degree,
                                                       shape[-1]))
    tp = moe.moe_params(torch.Generator().manual_seed(7), mcfg,
                        torch.float32, "cpu")
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 32, mcfg.d_model)).astype(np.float32))
    if shape is None:
        return (lambda p, x: moe.moe_single(p, x, mcfg)), tp, x
    mesh = make_mesh(shape)
    return (lambda p, x: moe.moe_apply(p, x, mcfg, mesh=mesh)), tp, x


@pytest.mark.parametrize("name", COMBINE_CASES)
def test_combine_is_bit_identical_to_the_per_expert_loop(name, monkeypatch):
    """The block's output and the gradients of every leaf and of ``x``
    equal, bit for bit, those of the combine recorded op by op."""
    fn, tp, x0 = _combine_case(name)
    dy = torch.from_numpy(np.random.default_rng(8).standard_normal(
        tuple(x0.shape)).astype(np.float32))

    def run():
        leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
        x = x0.clone().requires_grad_()
        out = fn(leaves, x)
        out.backward(dy)
        return out.detach(), x.grad, {k: v.grad for k, v in leaves.items()}

    out, gx, gp = run()
    with monkeypatch.context() as mp:
        mp.setattr(moe._Combine, "apply", loop_combine)
        want, want_gx, want_gp = run()
    assert torch.equal(out, want)
    assert torch.equal(gx, want_gx)
    assert gp.keys() == want_gp.keys()
    for k in gp:
        assert torch.equal(gp[k], want_gp[k]), k


def _nodes(out):
    """Every autograd node behind ``out``, each once."""
    seen, todo = {}, [out.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or id(node) in seen:
            continue
        seen[id(node)] = node
        todo.extend(nxt for nxt, _ in node.next_functions)
    return list(seen.values())


def test_combine_is_one_autograd_node():
    """The combine's backward is one node, fed by the gate product: no
    ``SelectBackward0`` of ``y`` (each one fills a gradient of all of
    ``y``) and no chain of per-expert ``IndexAddBackward0``."""
    fn, tp, x = _combine_case("single-padded")
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    nodes = _nodes(fn(leaves, x))
    names = [n.name() for n in nodes]
    assert names.count("_CombineBackward") == 1
    assert "SelectBackward0" not in names
    assert "IndexAddBackward0" not in names
    node = nodes[names.index("_CombineBackward")]
    assert [nxt.name() for nxt, _ in node.next_functions
            if nxt is not None] == ["MulBackward0"]


@pytest.mark.parametrize("n_model", [1, 2])
def test_combine_gradcheck_with_padded_experts_and_drops(n_model,
                                                         monkeypatch):
    """``torch.autograd.gradcheck`` of the op in f64, at the rows of a
    real call with 2 padded experts and a capacity that drops tokens
    (the widths cut to 4, so the Jacobians stay small)."""
    mcfg = dataclasses.replace(moe_cfg("drops"), ep_degree=4)
    tp = moe.moe_params(torch.Generator().manual_seed(3), mcfg,
                        torch.float32, "cpu")
    x = torch.randn(2, 32, mcfg.d_model,
                    generator=torch.Generator().manual_seed(3))
    seen = []
    real = moe._Combine.apply
    monkeypatch.setattr(moe._Combine, "apply",
                        lambda *a: seen.append(a) or real(*a))
    moe.moe_single(tp, x, mcfg)
    _, rows, _, n_rows = seen[0]
    E, cap = rows.shape
    assert E == 8 > mcfg.n_experts
    assert len(rows.unique()) < n_rows        # some tokens go nowhere
    y = torch.randn(E, cap, 4, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(4),
                    requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda y: real(y, rows, n_model, n_rows), (y,))


@pytest.mark.parametrize("remat", ["none", "full"])
def test_combine_backward_is_in_the_combine_range(remat):
    """Under the profiler, the op's backward node belongs to the
    ``moe.combine`` range and the block's (``moe_combine_share``,
    ``moe_share``), with the block run plainly and under a remat
    checkpoint as the train step runs it."""
    from lpfbench import harness
    fn, tp, x = _combine_case("single-drops")
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}

    def step():
        if remat == "full":
            out = checkpoint.checkpoint(fn, leaves, x, use_reentrant=False)
        else:
            out = fn(leaves, x)
        out.square().sum().backward()

    with harness.Window(time.perf_counter(), 60.0, torch.device("cpu"),
                        trace=True) as w:
        step()
    node = "autograd::engine::evaluate_function: _CombineBackward"
    for name in ("moe.combine", moe.MOE_RANGE):
        names = [e.name for e in w.profile.range_ops(name)]
        assert names.count(node) == 1, name
    # the forward's (and the recompute's) per-expert adds are the range's
    combine = [e.name for e in w.profile.range_ops("moe.combine")]
    assert combine.count("aten::index_add_") == tp["w_gate"].shape[0] * (
        2 if remat == "full" else 1)


# --------------------------------------------------------------------------
# the models
# --------------------------------------------------------------------------

@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_forward_and_prefill_match_jax(model, compute):
    arch, tree, params = model
    jcfg, cfg = configs(arch, compute_dtype=compute)
    if compute == "bfloat16":
        jcfg, cfg = all_routed(jcfg), all_routed(cfg)
    toks = tokens(5, 2, 64)
    want = np.asarray(jax_forward(tree, {"tokens": jnp.asarray(toks)}, jcfg,
                                  JaxRuntime()))
    got = forward(params, {"tokens": toks}, cfg, CPU)
    assert got.shape == (2, 64, cfg.vocab_padded)
    bar = F32_BAR if compute == "float32" else BF16_BAR
    v = cfg.vocab
    assert rel(got[..., :v], want[..., :v]) < bar
    last = prefill(params, {"tokens": toks}, cfg, CPU)
    want_last = np.asarray(jax_prefill(tree, {"tokens": jnp.asarray(toks)},
                                       jcfg, JaxRuntime()))
    assert rel(last[:, :v], want_last[:, :v]) < bar


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_teacher_forced_decode_matches_jax(model, compute):
    """12 steps of the same tokens into an 8-slot cache (attention slots
    roll from step 8 on, the Mamba state carries): the logits of every
    step, and in f32 the greedy tokens and the caches."""
    arch, tree, params = model
    jcfg, cfg = configs(arch, compute_dtype=compute)
    if compute == "bfloat16":
        jcfg, cfg = all_routed(jcfg), all_routed(cfg)
    B, C = 2, 8
    toks = tokens(6, B, 12)
    jc = jax_init_caches(jcfg, B, C)
    tc = init_caches(cfg, B, C, device="cpu")
    bar = F32_BAR if compute == "float32" else BF16_BAR
    for pos in range(12):
        jt, jl, jc = jax_decode_step(tree, jnp.asarray(toks[:, pos]), jc,
                                     jnp.int32(pos), jcfg, JaxRuntime())
        tt, tl, tc = decode_step(params, torch.from_numpy(toks[:, pos]), tc,
                                 pos, cfg, CPU)
        assert rel(tl[:, :cfg.vocab], np.asarray(jl)[:, :cfg.vocab]) < bar, \
            pos
        if compute == "float32":
            assert tt.tolist() == np.asarray(jt).tolist(), pos
    if compute == "float32":
        for b, blk in tc["body"].items():
            for name, c in blk.items():
                assert rel(c, np.asarray(jc["body"][b][name])) < F32_BAR, \
                    (b, name)


def assert_params_match(got, want, grads0, lr, steps):
    """Parameters after ``steps`` AdamW steps within 1e-4 of the JAX
    package's, but where the step-0 gradient is below 1e-6 of its leaf's
    largest: AdamW divides each element's moment by its own root mean
    square, so at that scale (eps 1e-8) the two frameworks' f32 rounding
    of the gradient (here ~1e-5 relative: jamba's Mamba blocks run the
    chunked algebra in JAX, the kernel's plain version in the port) moves
    the element by up to lr a step either way; there, within 2 lr a step.
    Measured: one element of jamba smoke's ``b0.mamba.conv_w`` (step-0
    |g| 2.4e-8 against a leaf max of 0.21) differs by 2.1e-4, every other
    element by at most 8.8e-5."""
    assert got.keys() == want.keys()
    for name, x in got.items():
        g = np.abs(grads0[name])
        d = np.abs(x - want[name])
        tiny = g < 1e-6 * g.max()
        assert d[~tiny].max(initial=0.0) < 1e-4, name
        assert d.max() <= 2 * lr * steps, name


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_three_train_steps_match_jax(arch):
    jcfg, cfg = configs(arch, compute_dtype="float32", vocab=256)
    jparams = jax.tree.map(jnp.asarray, jax_init_params(
        jax.random.PRNGKey(1), jcfg))
    jopt = jax_adamw_init(jparams)
    jts = jax_build_train_step(jcfg, compat.make_mesh((1, 1), ("data",
                                                               "model")),
                               opt_cfg=JaxAdamWConfig(lr=1e-3),
                               donate=False)
    ts = build_train_step(cfg, opt_cfg=AdamWConfig(lr=1e-3), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             device="cpu", trainable=True)
    opt = opt_state_from_jax(jax.tree.map(np.asarray, jopt), device="cpu")
    stream = SyntheticStream(DataConfig(vocab=256, seq_len=32,
                                        global_batch=4))
    grads0 = flat(jax.tree.map(np.asarray, jax.grad(
        lambda p: jax_loss_fn(p, {k: jnp.asarray(v) for k, v in
                                  stream.batch(0).items()}, jcfg,
                              JaxRuntime()))(jparams)))
    for step in range(3):
        b = stream.batch(step)
        jparams, jopt, jm = jts.step_fn(
            jparams, jopt, {k: jnp.asarray(v) for k, v in b.items()})
        params, opt, m = ts.step_fn(params, opt, b)
        assert abs(m["loss"].item() - float(jm["loss"])) < 1e-5 * abs(
            float(jm["loss"])), step
    assert_params_match(flat(params.tree()),
                        flat(jax.tree.map(np.asarray, jparams)), grads0,
                        lr=1e-3, steps=3)


def test_moe_step_has_static_shapes_and_no_host_reads(monkeypatch):
    """What a captured decode step needs of the block: no ``nonzero``,
    boolean-mask indexing or ``.item()`` (each waits for the device), and
    the same capacity for a bucket's every call (``cap = T`` for the
    serving buckets' rows, at most 8, of both models)."""
    for arch in MOE_ARCHS:
        mcfg = get_config(arch).moe
        E = mcfg.padded_experts
        assert all(moe.moe_capacity(T, E, mcfg) == T for T in range(1, 9))
    mcfg, _, tp, _, tx = moe_block("padded", "float32")

    def refuse(*a, **k):
        raise AssertionError("a host read in the MoE block")

    monkeypatch.setattr(torch.Tensor, "item", refuse)
    monkeypatch.setattr(torch.Tensor, "nonzero", refuse)
    monkeypatch.setattr(torch, "nonzero", refuse)
    monkeypatch.setattr(torch.Tensor, "tolist", refuse)
    out = moe.moe_single(tp, tx, mcfg)
    assert out.shape == tx.shape


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_launcher_checks_on_cpu(arch, capsys):
    serve_mod.main(["--arch", arch, "--device", "cpu", "--check"])
    out = capsys.readouterr().out
    assert "deadline_misses: 0" in out
    assert "bit-identical to solo decode" in out
