"""The port's three other dense configs (gemma2-9b, qwen3-14b,
qwen1.5-110b) against the JAX package on the CPU.

Each config equals the JAX package's field by field, smoke and full, and
its full-width parameter count equals the JAX tree's (``eval_shape``).
At the smoke config (2 layers, d 128, 4 heads over 2 kv heads, head dim
32, vocab 512; gemma2-9b's local layer with window 32) the JAX package's
``init_params`` tree is carried across with ``params_from_jax`` and the
forward, the prefill and 12 teacher-forced decode steps into a rolling
8-slot cache are held to the JAX package's: relative error (max |port -
jax| / max |jax|) below 1e-4 with ``compute_dtype="float32"`` and below
0.08 in bf16, the JAX package's own bf16 bar.  ``attn_impl="flash"``
runs the Pallas kernel in interpret mode on the JAX side and the kernel's
plain version on the port's.
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
from repro.models import count_params as jax_count_params
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_caches as jax_init_caches
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro_torch.configs import ARCHS, get_config
from repro_torch.interop import params_from_jax
from repro_torch.launch import one_card_config
from repro_torch.models import (Runtime, cast_params, count_params,
                                decode_step, forward, init_caches,
                                init_params, load_params, prefill)

DENSE = ("gemma2-9b", "qwen3-14b", "qwen1.5-110b")
F32_BAR = 1e-4
BF16_BAR = 0.08


def rel(a, ref):
    a = np.asarray(a, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(a - ref).max() / (np.abs(ref).max() + 1e-9))


def configs(arch, **kw):
    return (dataclasses.replace(jax_get_config(arch, smoke=True), **kw),
            dataclasses.replace(get_config(arch, smoke=True), **kw))


@pytest.fixture(scope="module", params=DENSE)
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


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", DENSE)
def test_config_matches_jax(arch, smoke):
    assert arch in ARCHS
    assert dataclasses.asdict(get_config(arch, smoke=smoke)) == \
        dataclasses.asdict(jax_get_config(arch, smoke=smoke))


@pytest.mark.parametrize("arch", DENSE)
def test_count_params_matches_jax_at_full_width(arch):
    want = jax_count_params(jax_get_config(arch))
    assert count_params(get_config(arch)) == want
    # the published sizes (ROADMAP A8.1)
    assert round(want / 1e9, 2) == {"gemma2-9b": 9.24, "qwen3-14b": 14.77,
                                    "qwen1.5-110b": 111.21}[arch]


def test_registry_is_the_jax_registry():
    """The port registers the JAX package's ten architectures, in its
    order; a name outside them is refused with the known ones listed."""
    assert ARCHS == JAX_ARCHS and len(ARCHS) == 10
    with pytest.raises(KeyError, match="whisper-base"):
        get_config("gpt-2")


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_one_card_config_matches_jax(arch):
    """Each architecture's config as the launchers build it on one card
    (``ep_degree=1``) equals the JAX package's at that degree."""
    assert dataclasses.asdict(one_card_config(arch, smoke=False)) == \
        dataclasses.asdict(jax_get_config(arch, ep_degree=1))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["blocked", "flash"])
def test_forward_and_prefill_match_jax(model, impl, compute):
    arch, tree, params = model
    jcfg, cfg = configs(arch, attn_impl=impl, compute_dtype=compute)
    toks = tokens(5, 2, 48)
    want = np.asarray(jax_forward(tree, {"tokens": jnp.asarray(toks)}, jcfg,
                                  JaxRuntime()))
    got = forward(params, {"tokens": toks}, cfg, Runtime("cpu"))
    assert got.shape == (2, 48, cfg.vocab_padded)
    bar = F32_BAR if compute == "float32" else BF16_BAR
    v = cfg.vocab
    assert rel(got[..., :v], want[..., :v]) < bar
    last = prefill(params, {"tokens": toks}, cfg, Runtime("cpu"))
    want_last = np.asarray(jax_prefill(tree, {"tokens": jnp.asarray(toks)},
                                       jcfg, JaxRuntime()))
    assert rel(last[:, :v], want_last[:, :v]) < bar


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_teacher_forced_decode_matches_jax(model, compute):
    """12 steps of the same tokens into an 8-slot cache (slots roll from
    step 8 on): the logits of every step, and in f32 the greedy tokens
    and the caches."""
    arch, tree, params = model
    jcfg, cfg = configs(arch, compute_dtype=compute)
    B, C = 2, 8
    toks = tokens(6, B, 12)
    jc = jax_init_caches(jcfg, B, C)
    tc = init_caches(cfg, B, C, device="cpu")
    rt = Runtime("cpu")
    bar = F32_BAR if compute == "float32" else BF16_BAR
    for pos in range(12):
        jt, jl, jc = jax_decode_step(tree, jnp.asarray(toks[:, pos]), jc,
                                     jnp.int32(pos), jcfg, JaxRuntime())
        tt, tl, tc = decode_step(params, torch.from_numpy(toks[:, pos]), tc,
                                 pos, cfg, rt)
        assert rel(tl[:, :cfg.vocab], np.asarray(jl)[:, :cfg.vocab]) < bar, \
            pos
        if compute == "float32":
            assert tt.tolist() == np.asarray(jt).tolist(), pos
    if compute == "float32":
        for b, blk in tc["body"].items():
            for name in ("k", "v"):
                assert np.abs(blk[name].numpy() - np.asarray(
                    jc["body"][b][name])).max() < 1e-4, (b, name)


@pytest.mark.parametrize("arch", DENSE + ("llama3.2-1b", "mamba2-130m"))
def test_load_params_equals_cast_of_init(arch):
    """The serving load (each matrix cast as it is drawn) gives the
    values of ``cast_params(init_params(...))``, leaf for leaf."""
    cfg = get_config(arch, smoke=True)
    want = dict(cast_params(init_params(3, cfg, device="cpu"),
                            cfg).named_parameters())
    got = dict(load_params(3, cfg, device="cpu").named_parameters())
    assert want.keys() == got.keys()
    for name, t in want.items():
        assert got[name].dtype == t.dtype, name
        assert torch.equal(got[name], t), name
    meta = load_params(0, cfg, device="meta")
    assert {n: (t.shape, t.dtype) for n, t in meta.named_parameters()} == \
        {n: (t.shape, t.dtype) for n, t in want.items()}
