"""deepseek-v3-671b in the port against the JAX package on the CPU: MLA
blocks (decompressed K/V at prefill, the absorbed decode against the
compressed ``ckv``/``krope`` cache), the shared expert and multi-token
prediction (MTP).

The config equals the JAX package's field for field, smoke and full, and
its parameter count is the JAX tree's (682.64 B, 38.24 B active).  At the
smoke config (one dense MLA layer and two MoE MLA layers, d 128, 4 heads,
q_lora 64, kv_lora 32, nope 32 + rope 16 against v 32, 6 experts top-2)
the JAX package's ``init_params`` tree is carried across with
``params_from_jax``, and the forward (both heads), the prefill, the loss
with its gradients and 12 teacher-forced decode steps into a rolling
8-slot cache are held to the JAX package's: relative error (max |port -
jax| / max |jax|) below 1e-4 in f32 and 0.08 in bf16.  In bf16 every
expert is routed (``top_k = n_experts``), as ``tests/test_torch_moe.py``
explains: a top-k flips near-tie tokens under rounding.  MLA runs
``attn_impl="blocked"``: its query/key width differs from its value
width, which the flash kernels of neither package compute.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Runtime as JaxRuntime
from repro.models import count_params as jax_count_params
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_caches as jax_init_caches
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro.models import prefill as jax_prefill
from repro.models.blocks import block_apply as jax_block_apply
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import LPFFatalError
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.launch import serve as serve_mod
from repro_torch.models import (Runtime, cast_params, count_params,
                                decode_step, forward, init_caches,
                                init_params, load_params, loss_fn, prefill)
from repro_torch.models import blocks

ARCH = "deepseek-v3-671b"
F32_BAR = 1e-4
BF16_BAR = 0.08
CPU = Runtime("cpu")


def rel(a, ref):
    a = np.asarray(a, np.float32)
    ref = np.asarray(ref, np.float32)
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


def configs(**kw):
    return (dataclasses.replace(jax_get_config(ARCH, smoke=True), **kw),
            dataclasses.replace(get_config(ARCH, smoke=True), **kw))


def all_routed(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, top_k=cfg.moe.n_experts))


def with_compute(compute):
    jcfg, cfg = configs(compute_dtype=compute)
    if compute == "bfloat16":
        jcfg, cfg = all_routed(jcfg), all_routed(cfg)
    return jcfg, cfg


@pytest.fixture(scope="module")
def jax_tree():
    jcfg, _ = configs()
    return jax.tree.map(np.asarray, jax.jit(
        jax_init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg))


@pytest.fixture(scope="module")
def params(jax_tree):
    return params_from_jax(jax_tree, device="cpu")


def tokens(seed, B, S, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, S),
                                                dtype=np.int32)


# --------------------------------------------------------------------------
# configuration and parameters
# --------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [True, False])
def test_config_matches_jax(smoke):
    assert ARCH in ARCHS
    assert dataclasses.asdict(get_config(ARCH, smoke=smoke)) == \
        dataclasses.asdict(jax_get_config(ARCH, smoke=smoke))
    assert dataclasses.asdict(get_config(ARCH, ep_degree=1)) == \
        dataclasses.asdict(jax_get_config(ARCH, ep_degree=1))


@pytest.mark.parametrize("active_only", [False, True])
def test_count_params_matches_jax(active_only):
    want = jax_count_params(jax_get_config(ARCH), active_only=active_only)
    assert count_params(get_config(ARCH), active_only=active_only) == want
    assert round(want / 1e9, 2) == (38.24 if active_only else 682.64)


def test_params_round_trip_exactly(jax_tree, params):
    back = params_to_numpy(params)
    a, b = flat(jax_tree), flat(back)
    assert a.keys() == b.keys()
    raw = {n: t for n, t in params.named_parameters()}
    for name in a:
        assert np.array_equal(a[name], b[name]), name
    assert {"mtp_proj", "mtp_block.attn.wkv_b", "mtp_block.moe.w_gate",
            "mtp_block.shared_mlp.w_down", "dec_dense.b0.attn.wq_a",
            "dec_moe.b0.attn.kv_norm"} <= set(raw)
    assert raw["dec_moe.b0.attn.wkv_b"].shape == (2, 32, 4 * (32 + 32))
    assert raw["mtp_proj"].shape == (256, 128)
    # the port's own tree has the JAX tree's names, shapes and dtypes
    mine = {n: (tuple(t.shape), t.dtype) for n, t in init_params(
        0, get_config(ARCH, smoke=True), device="meta").named_parameters()}
    assert mine == {n: (tuple(t.shape), t.dtype) for n, t in raw.items()}


def test_load_params_equals_cast_of_init():
    cfg = get_config(ARCH, smoke=True)
    want = dict(cast_params(init_params(3, cfg, device="cpu"),
                            cfg).named_parameters())
    got = dict(load_params(3, cfg, device="cpu").named_parameters())
    assert want.keys() == got.keys()
    for name, t in want.items():
        assert got[name].dtype == t.dtype and torch.equal(got[name], t), name
    assert got["mtp_block.attn.wq_a"].dtype == torch.bfloat16
    assert got["mtp_block.attn.q_norm"].dtype == torch.float32


# --------------------------------------------------------------------------
# the MLA block
# --------------------------------------------------------------------------

@pytest.mark.parametrize("ffn", ["dense", "moe"])
def test_mla_block_matches_jax(jax_tree, ffn):
    jcfg, cfg = configs(compute_dtype="float32")
    group = "dec_dense" if ffn == "dense" else "dec_moe"
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), jax_tree[group]["b0"])
    tp = {k: v for k, v in params_from_jax(
        jax.tree.map(lambda a: a[0], jax_tree[group]["b0"]),
        device="cpu").tree().items()}
    bcfg = cfg.groups[0 if ffn == "dense" else 1].blocks[0]
    x = np.random.default_rng(4).standard_normal((2, 32, 128)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(32), (2, 32))
    want = jax_block_apply(jp, jnp.asarray(x), bcfg, jcfg, JaxRuntime(),
                           jnp.asarray(pos))
    got = blocks.block_apply(tp, torch.from_numpy(x), bcfg, cfg, CPU,
                             torch.from_numpy(pos.copy()))
    assert rel(got, want) < F32_BAR


def test_flash_refuses_mla_by_name(params, jax_tree):
    """The value width (32) is not the query/key width (48): the port
    refuses ``attn_impl="flash"`` on both devices' routes by name; the
    JAX package's forward fails too (its kernel's output takes q's width,
    which the MLA output projection cannot reshape)."""
    jcfg, cfg = configs(attn_impl="flash")
    toks = tokens(1, 1, 32)
    with pytest.raises(LPFFatalError, match="head dim"):
        forward(params, {"tokens": toks}, cfg, CPU)
    with pytest.raises(Exception):
        jax_forward(jax_tree, {"tokens": jnp.asarray(toks)}, jcfg,
                    JaxRuntime())


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_forward_and_prefill_match_jax(jax_tree, params, compute):
    jcfg, cfg = with_compute(compute)
    toks = tokens(5, 2, 48)
    want, want_mtp = jax_forward(jax_tree, {"tokens": jnp.asarray(toks)},
                                 jcfg, JaxRuntime())
    got, got_mtp = forward(params, {"tokens": toks}, cfg, CPU)
    assert got.shape == got_mtp.shape == (2, 48, cfg.vocab_padded)
    bar = F32_BAR if compute == "float32" else BF16_BAR
    v = cfg.vocab
    assert rel(got[..., :v], np.asarray(want)[..., :v]) < bar
    assert rel(got_mtp[..., :v], np.asarray(want_mtp)[..., :v]) < bar
    last = prefill(params, {"tokens": toks}, cfg, CPU)
    want_last = np.asarray(jax_prefill(jax_tree, {"tokens": jnp.asarray(
        toks)}, jcfg, JaxRuntime()))
    assert rel(last[:, :v], want_last[:, :v]) < bar
    assert torch.equal(last, got[:, -1])


def test_loss_and_gradients_match_jax(jax_tree):
    """f32: the loss with MTP's 0.3 term and every leaf's gradient."""
    jcfg, cfg = configs(compute_dtype="float32")
    toks = tokens(2, 2, 33)
    labels = toks[:, 1:].copy()
    labels[0, -4:] = -1
    batch = {"tokens": toks[:, :-1], "labels": labels}
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jax_loss_fn(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg,
        JaxRuntime())))(jax.tree.map(jnp.asarray, jax_tree))
    tparams = params_from_jax(jax_tree, device="cpu", trainable=True)
    loss = loss_fn(tparams, batch, cfg, CPU)
    names = [n for n, _ in tparams.named_parameters()]
    grads = torch.autograd.grad(loss, list(tparams.parameters()))
    assert abs(loss.item() - float(jloss)) < 1e-5 * abs(float(jloss))
    # the MTP term is in it: without it the loss is another number
    no_mtp = loss_fn(tparams, batch, dataclasses.replace(cfg, mtp=False),
                     CPU)
    assert abs(no_mtp.item() - loss.item()) > 0.1
    want = flat(jax.tree.map(np.asarray, jgrads))
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        assert rel(g, want[name]) < F32_BAR, name
    assert float(np.abs(want["mtp_proj"]).max()) > 0


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_teacher_forced_decode_matches_jax(jax_tree, params, compute):
    """12 steps of the absorbed MLA decode into an 8-slot compressed cache
    (slots roll from step 8 on): each step's logits, and in f32 the greedy
    tokens and the ``ckv``/``krope`` caches."""
    jcfg, cfg = with_compute(compute)
    B, C = 2, 8
    toks = tokens(6, B, 12)
    jc = jax_init_caches(jcfg, B, C)
    tc = init_caches(cfg, B, C, device="cpu")
    assert tc["moe"]["b0"]["ckv"].shape == (2, B, C, 32)
    assert tc["moe"]["b0"]["krope"].shape == (2, B, C, 16)
    bar = F32_BAR if compute == "float32" else BF16_BAR
    jstep = jax.jit(lambda t, c, p: jax_decode_step(jax_tree, t, c, p, jcfg,
                                                    JaxRuntime()))
    for pos in range(12):
        jt, jl, jc = jstep(jnp.asarray(toks[:, pos]), jc, jnp.int32(pos))
        tt, tl, tc = decode_step(params, torch.from_numpy(toks[:, pos]), tc,
                                 pos, cfg, CPU)
        assert rel(tl[:, :cfg.vocab], np.asarray(jl)[:, :cfg.vocab]) < bar, \
            pos
        if compute == "float32":
            assert tt.tolist() == np.asarray(jt).tolist(), pos
    if compute == "float32":
        for g in ("dense", "moe"):
            for name in ("ckv", "krope"):
                assert rel(tc[g]["b0"][name], np.asarray(
                    jc[g]["b0"][name])) < F32_BAR, (g, name)


def test_decode_matches_prefill(params):
    """8 teacher-forced steps of the absorbed decode against the
    decompressed prefill of the same prompt (f32, no capacity drop at 8
    tokens)."""
    _, cfg = configs(compute_dtype="float32")
    toks = tokens(7, 1, 8)
    want = prefill(params, {"tokens": toks}, cfg, CPU)
    caches = init_caches(cfg, 1, 8, device="cpu")
    for t in range(8):
        _, got, caches = decode_step(params, torch.from_numpy(toks[:, t]),
                                     caches, t, cfg, CPU)
    assert rel(got[:, :cfg.vocab], want[:, :cfg.vocab]) < F32_BAR


def test_decode_with_tensor_pos_equals_int_pos(params):
    """The position as a 0-d tensor (what a captured step replays) gives
    the int path's logits and compressed caches bit for bit."""
    _, cfg = configs(compute_dtype="float32")
    toks = tokens(8, 2, 10)
    a = init_caches(cfg, 2, 8, device="cpu")
    b = init_caches(cfg, 2, 8, device="cpu")
    for pos in range(10):
        _, la, a = decode_step(params, torch.from_numpy(toks[:, pos]), a,
                               pos, cfg, CPU)
        _, lb, b = decode_step(params, torch.from_numpy(toks[:, pos]), b,
                               torch.tensor(pos), cfg, CPU)
        assert torch.equal(la, lb), pos
    assert all(torch.equal(a[g]["b0"][n], b[g]["b0"][n])
               for g in ("dense", "moe") for n in ("ckv", "krope"))


def test_serve_launcher_checks_on_cpu(capsys):
    serve_mod.main(["--arch", ARCH, "--device", "cpu", "--check",
                    "--requests", "4", "--tokens", "8", "--cache-len", "16"])
    out = capsys.readouterr().out
    assert "deadline_misses: 0" in out
    assert "bit-identical to solo decode" in out
