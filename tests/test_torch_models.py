"""Parity of the port's llama3.2-1b serving stack with the JAX reference on
the CPU, at the smoke config (2 layers, d 128, 4 heads over 2 kv heads,
head dim 32, vocab 512).

The JAX package's ``init_params`` tree is carried across with
``params_from_jax``; token inputs come from numpy.  Where the JAX model
reaches the Pallas kernel (``attn_impl="flash"``) it runs in interpret
mode, as its own tests run it; the port takes the kernel's plain version
for a CPU tensor.  Bars: relative error (max |port - jax| / max |jax|)
below 1e-4 with ``compute_dtype="float32"``; below 0.08 in bf16, the JAX
package's own bf16 bar (``tests/test_models_smoke.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.models import Runtime as JaxRuntime
from repro.models import common as jax_common
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_caches as jax_init_caches
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models.attention import blocked_attention as jax_blocked
from repro_torch.configs import get_config
from repro_torch.core import LPFFatalError
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.models import (BlockCfg, Group, Runtime, cast_params,
                                common, decode_step, forward, init_caches,
                                init_params, prefill)
from repro_torch.models.attention import blocked_attention

ARCH = "llama3.2-1b"
F32_BAR = 1e-4
BF16_BAR = 0.08


def rel(a, ref):
    a = np.asarray(a, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(a - ref).max() / (np.abs(ref).max() + 1e-9))


def configs(**kw):
    """The smoke config in both packages, with the same replacements."""
    return (dataclasses.replace(jax_get_config(ARCH, smoke=True), **kw),
            dataclasses.replace(get_config(ARCH, smoke=True), **kw))


@pytest.fixture(scope="module")
def jax_tree():
    jcfg, _ = configs()
    return jax.tree.map(np.asarray,
                        jax_init_params(jax.random.PRNGKey(0), jcfg))


@pytest.fixture(scope="module")
def port_params(jax_tree):
    return params_from_jax(jax_tree, device="cpu")


def tokens(seed, B, S, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, S),
                                                dtype=np.int32)


# --------------------------------------------------------------------------
# configuration and parameters
# --------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [True, False])
def test_config_matches_jax(smoke):
    assert dataclasses.asdict(get_config(ARCH, smoke=smoke)) == \
        dataclasses.asdict(jax_get_config(ARCH, smoke=smoke))


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_every_jax_arch_resolves_in_the_port(arch):
    """Every architecture of the JAX registry resolves here, smoke and
    full, with the JAX config field for field, and its smoke model
    builds (the MLA, encoder, vision and MTP blocks included)."""
    for smoke in (True, False):
        assert dataclasses.asdict(get_config(arch, smoke=smoke)) == \
            dataclasses.asdict(jax_get_config(arch, smoke=smoke))
    params = init_params(0, get_config(arch, smoke=True), device="meta")
    assert sum(p.numel() for p in params.parameters()) > 0


def test_params_round_trip_exactly(jax_tree, port_params):
    back = params_to_numpy(port_params)

    def leaves(t, prefix=""):
        for k, v in sorted(t.items()):
            if isinstance(v, dict):
                yield from leaves(v, prefix + k + ".")
            else:
                yield prefix + k, v
    a, b = dict(leaves(jax_tree)), dict(leaves(back))
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        assert np.array_equal(a[name], b[name]), name
    names = {n for n, _ in port_params.named_parameters()}
    assert {"embed", "final_norm.w", "dec_body.b0.attn.wq",
            "dec_body.b0.mlp.w_down", "dec_body.b0.ln1.w"} <= names
    assert port_params.dec_body.b0.attn.wq.shape == (2, 128, 128)


def test_init_params_layout_and_norm_weights():
    cfg = get_config(ARCH, smoke=True)
    p = init_params(0, cfg, device="cpu")
    jshape = jax.eval_shape(lambda: jax_init_params(
        jax.random.PRNGKey(0), jax_get_config(ARCH, smoke=True)))
    flat = {jax.tree_util.keystr(k): v.shape for k, v in
            jax.tree_util.tree_flatten_with_path(jshape)[0]}
    got = {"".join(f"['{s}']" for s in n.split(".")): tuple(t.shape)
           for n, t in p.named_parameters()}
    assert got == flat
    # block norms store w = 0 (applied as 1 + w); the final norm stores 1
    assert torch.all(p.dec_body.b0.ln1.w == 0)
    assert torch.all(p.final_norm.w == 1)
    std = p.dec_body.b0.attn.wq.std().item()
    assert abs(std - 0.88 / np.sqrt(128)) < 0.01   # N(0,1) cut at +-2


# --------------------------------------------------------------------------
# shared machinery
# --------------------------------------------------------------------------

def test_dtype_policy_matches_jax():
    """``DtypePolicy``'s defaults are the JAX package's field for field
    (by dtype name), and ``cast_in`` casts to the compute dtype as
    JAX's does."""
    assert "DtypePolicy" in common.__all__ and \
        "DtypePolicy" in jax_common.__all__
    jpol, pol = jax_common.DtypePolicy(), common.DtypePolicy()
    jfields = {f.name: jnp.dtype(getattr(jpol, f.name)).name
               for f in dataclasses.fields(jpol)}
    fields = {f.name: str(getattr(pol, f.name)).removeprefix("torch.")
              for f in dataclasses.fields(pol)}
    assert fields == jfields == {"param": "float32", "compute": "bfloat16",
                                 "accum": "float32"}
    x = np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32)
    got = pol.cast_in(torch.from_numpy(x))
    want = np.asarray(jpol.cast_in(jnp.asarray(x)))
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    assert np.array_equal(got.float().numpy(), want.astype(np.float32))
    with pytest.raises(dataclasses.FrozenInstanceError):
        pol.compute = torch.float16


@pytest.mark.parametrize("plus_one", [False, True])
def test_rms_norm_matches_jax(plus_one):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    want = jax_common.rms_norm(jnp.asarray(x), jnp.asarray(w),
                               plus_one=plus_one)
    got = common.rms_norm(torch.from_numpy(x), torch.from_numpy(w),
                          plus_one=plus_one)
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-5


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(2)
    x, w, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((4, 96), (96,), (96,)))
    want = jax_common.layer_norm(*map(jnp.asarray, (x, w, b)))
    got = common.layer_norm(*map(torch.from_numpy, (x, w, b)))
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_jax(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, 4, 32)).astype(np.float32)
    pos = np.stack([np.arange(40), np.arange(100, 140)]).astype(np.int32)
    want = jax_common.apply_rope(jnp.asarray(x, dtype), jnp.asarray(pos),
                                 500_000.0)
    got = common.apply_rope(torch.from_numpy(x).to(common.dtype_of(dtype)),
                            torch.from_numpy(pos), 500_000.0)
    tol = 1e-5 if dtype == "float32" else 1.6e-2     # one bf16 ulp at |x|~4
    assert np.abs(got.float().numpy()
                  - np.asarray(want, np.float32)).max() < tol


@pytest.mark.parametrize("dtype,causal,window,softcap", [
    ("float32", True, None, None),
    ("float32", True, 9, None),
    ("float32", False, None, 20.0),
    ("bfloat16", True, None, None),
])
def test_blocked_attention_matches_jax(dtype, causal, window, softcap):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 40, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 40, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 40, 2, 32)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=softcap, q_chunk=16)
    want = jax_blocked(*(jnp.asarray(a, dtype) for a in (q, k, v)), **kw)
    tdt = common.dtype_of(dtype)
    got = blocked_attention(*(torch.from_numpy(a).to(tdt)
                              for a in (q, k, v)), **kw)
    assert got.dtype == tdt and got.shape == (2, 40, 4, 32)
    tol = 2e-5 if dtype == "float32" else 2e-2
    assert np.abs(got.float().numpy()
                  - np.asarray(want, np.float32)).max() < tol


# --------------------------------------------------------------------------
# forward, prefill, decode
# --------------------------------------------------------------------------

# measured port-vs-JAX relative error of forward in bf16 on these inputs:
# 1.12e-2 (blocked), 1.01e-2 (flash, reference); the bar is the JAX
# package's 0.08
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["blocked", "flash", "reference"])
def test_forward_and_prefill_match_jax(jax_tree, port_params, impl, compute):
    jcfg, cfg = configs(attn_impl=impl, compute_dtype=compute)
    toks = tokens(5, 2, 48)
    want = np.asarray(jax_forward(jax_tree, {"tokens": jnp.asarray(toks)},
                                  jcfg, JaxRuntime()))
    got = forward(port_params, {"tokens": toks}, cfg, Runtime("cpu"))
    assert got.shape == (2, 48, cfg.vocab_padded)
    assert got.dtype == torch.float32
    bar = F32_BAR if compute == "float32" else BF16_BAR
    v = cfg.vocab
    assert rel(got[..., :v], want[..., :v]) < bar
    last = prefill(port_params, {"tokens": toks}, cfg, Runtime("cpu"))
    want_last = np.asarray(jax_prefill(
        jax_tree, {"tokens": jnp.asarray(toks)}, jcfg, JaxRuntime()))
    assert rel(last[:, :v], want_last[:, :v]) < bar
    # the head on the last position only gives forward's last row, up to
    # the matmul's summation order (and one bf16 rounding of the logits)
    assert rel(last, got[:, -1]) < (1e-5 if compute == "float32" else 1e-2)


def test_decode_matches_jax_with_rolling_cache(jax_tree, port_params):
    """12 steps into an 8-slot cache: slots roll from step 8 on."""
    jcfg, cfg = configs(compute_dtype="float32")
    B, C = 2, 8
    first = tokens(6, B, 1)[:, 0]
    jc = jax_init_caches(jcfg, B, C)
    tc = init_caches(cfg, B, C, device="cpu")
    jt, tt = jnp.asarray(first), torch.from_numpy(first)
    rt = Runtime("cpu")
    for pos in range(12):
        jt, jl, jc = jax_decode_step(jax_tree, jt, jc, jnp.int32(pos), jcfg,
                                     JaxRuntime())
        tt, tl, tc = decode_step(port_params, tt, tc, pos, cfg, rt)
        assert tt.tolist() == np.asarray(jt).tolist(), pos
        assert rel(tl[:, :cfg.vocab], np.asarray(jl)[:, :cfg.vocab]) \
            < F32_BAR, pos
    for name in ("k", "v"):
        assert np.abs(tc["body"]["b0"][name].numpy()
                      - np.asarray(jc["body"]["b0"][name])).max() < 1e-4


@pytest.mark.parametrize("features", [
    dict(qk_norm=True, qkv_bias=True, post_norms=True, attn_softcap=30.0,
         logit_softcap=20.0, tie_embeddings=False, scale_embed=True),
    dict(norm="layer", pos_embed="learned"),
    dict(pos_embed="sinusoidal", attn_impl="flash"),
], ids=["gemma-qwen-features", "layer-norm-learned", "sinusoidal"])
def test_block_features_match_jax(features):
    """The dense attention block's other features, each as the JAX
    package's init lays it out: forward and 6 decode steps in f32."""
    jcfg, cfg = configs(compute_dtype="float32", **features)
    tree = jax.tree.map(np.asarray,
                        jax_init_params(jax.random.PRNGKey(1), jcfg))
    params = params_from_jax(tree, device="cpu")
    rt = Runtime("cpu")
    toks = tokens(11, 2, 20)
    want = np.asarray(jax_forward(tree, {"tokens": jnp.asarray(toks)}, jcfg,
                                  JaxRuntime()))
    got = forward(params, {"tokens": toks}, cfg, rt)
    assert rel(got[..., :cfg.vocab], want[..., :cfg.vocab]) < F32_BAR
    jc, tc = jax_init_caches(jcfg, 2, 8), init_caches(cfg, 2, 8,
                                                     device="cpu")
    jt, tt = jnp.asarray(toks[:, 0]), torch.from_numpy(toks[:, 0])
    for pos in range(6):
        jt, jl, jc = jax_decode_step(tree, jt, jc, jnp.int32(pos), jcfg,
                                     JaxRuntime())
        tt, tl, tc = decode_step(params, tt, tc, pos, cfg, rt)
        assert tt.tolist() == np.asarray(jt).tolist()
        assert rel(tl[:, :cfg.vocab], np.asarray(jl)[:, :cfg.vocab]) \
            < F32_BAR


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_teacher_forced_decode_matches_prefill(port_params, compute):
    _, cfg = configs(attn_impl="flash", compute_dtype=compute)
    rt = Runtime("cpu")
    toks = tokens(7, 1, 16)
    want = prefill(port_params, {"tokens": toks}, cfg, rt)
    caches = init_caches(cfg, 1, 16, device="cpu")
    for t in range(16):
        _, logits, caches = decode_step(port_params, toks[:, t], caches, t,
                                        cfg, rt)
    bar = 1e-4 if compute == "float32" else BF16_BAR
    assert rel(logits[:, :cfg.vocab], want[:, :cfg.vocab]) < bar


def test_rolling_decode_matches_windowed_prefill(port_params):
    """A prompt longer than the cache: decode sees the last cache_len
    positions and itself, which is prefill with window cache_len + 1."""
    C, S = 8, 20
    _, cfg = configs(attn_impl="flash", compute_dtype="float32")
    wcfg = dataclasses.replace(cfg, groups=(Group(
        "body", (BlockCfg("attn", "dense", window=C + 1),), 2),))
    rt = Runtime("cpu")
    toks = tokens(8, 1, S)
    want = prefill(port_params, {"tokens": toks}, wcfg, rt)
    caches = init_caches(wcfg, 1, C, device="cpu")
    for t in range(S):
        _, logits, caches = decode_step(port_params, toks[:, t], caches, t,
                                        wcfg, rt)
    assert rel(logits[:, :cfg.vocab], want[:, :cfg.vocab]) < 1e-4
    full = prefill(port_params, {"tokens": toks}, cfg, rt)
    assert rel(full[:, :cfg.vocab], want[:, :cfg.vocab]) > 1e-3


def test_cast_once_gives_the_same_logits(port_params):
    _, cfg = configs(attn_impl="flash")
    rt = Runtime("cpu")
    toks = tokens(9, 2, 24)
    cast = cast_params(port_params, cfg)
    assert cast.dec_body.b0.attn.wq.dtype == torch.bfloat16
    assert cast.dec_body.b0.ln1.w.dtype == torch.float32
    assert torch.equal(prefill(cast, {"tokens": toks}, cfg, rt),
                       prefill(port_params, {"tokens": toks}, cfg, rt))


def test_padded_vocab_never_wins(port_params):
    _, cfg = configs(vocab=500)
    logits = prefill(port_params, {"tokens": tokens(10, 2, 8, 500)}, cfg,
                     Runtime("cpu"))
    assert torch.all(logits[:, 500:] == -1e30)
    nxt, _, _ = decode_step(port_params, [3, 4],
                            init_caches(cfg, 2, 4, device="cpu"), 0, cfg,
                            Runtime("cpu"))
    assert int(nxt.max()) < 500


def test_params_on_another_device_are_refused(port_params):
    _, cfg = configs()

    class Elsewhere(Runtime):
        def __init__(self):
            self.device = torch.device("meta")
    with pytest.raises(LPFFatalError, match="parameters live on"):
        prefill(port_params, {"tokens": tokens(1, 1, 4)}, cfg, Elsewhere())
