"""llava-next-mistral-7b in the port against the JAX package on the CPU:
the mistral backbone behind the vision stub's prefix (``embeds``
prepended to the token embeddings, logits over the text positions only).

The config equals the JAX package's field for field, smoke and full, and
its parameter count is the JAX tree's (7.24 B).  At the smoke config (2
layers, d 128, 4 heads over 2 kv heads of 32, a 16-position prefix,
vocab 512) the JAX package's ``init_params`` tree is carried across with
``params_from_jax``, and the forward, the prefill, the loss with its
gradients (labels over the text only) and 12 teacher-forced decode steps
(text only: the JAX package's decode takes no prefix) are held to the JAX
package's: relative error below 1e-4 in f32 and 0.08 in bf16, blocked and
through the flash kernel (Pallas in interpret mode on the JAX side, the
kernel's plain version on the port's).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticStream as JaxStream
from repro.models import Runtime as JaxRuntime
from repro.models import count_params as jax_count_params
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_caches as jax_init_caches
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro.models import prefill as jax_prefill
from repro_torch.configs import ARCHS, get_config
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import (Runtime, cast_params, count_params,
                                decode_step, forward, init_caches,
                                init_params, load_params, loss_fn, prefill)

ARCH = "llava-next-mistral-7b"
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


@pytest.fixture(scope="module")
def jax_tree():
    jcfg, _ = configs()
    return jax.tree.map(np.asarray, jax.jit(
        jax_init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg))


@pytest.fixture(scope="module")
def params(jax_tree):
    return params_from_jax(jax_tree, device="cpu")


def batch_of(seed, B, S, labels=False, prefix=16):
    """Text tokens [B, S] after a ``prefix``-position vision prefix."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, 512, (B, S), dtype=np.int32),
         "embeds": rng.standard_normal((B, prefix, 128)).astype(np.float32)}
    if labels:
        b["labels"] = rng.integers(0, 512, (B, S), dtype=np.int32)
        b["labels"][0, -3:] = -1
    return b


def jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@pytest.mark.parametrize("smoke", [True, False])
def test_config_matches_jax(smoke):
    assert ARCH in ARCHS
    assert dataclasses.asdict(get_config(ARCH, smoke=smoke)) == \
        dataclasses.asdict(jax_get_config(ARCH, smoke=smoke))


def test_count_params_matches_jax():
    want = jax_count_params(jax_get_config(ARCH))
    assert count_params(get_config(ARCH)) == want
    assert round(want / 1e9, 2) == 7.24


def test_params_round_trip_exactly(jax_tree, params):
    a, b = flat(jax_tree), flat(params_to_numpy(params))
    assert a.keys() == b.keys()
    for name in a:
        assert np.array_equal(a[name], b[name]), name
    mine = {n: (tuple(t.shape), t.dtype) for n, t in init_params(
        0, get_config(ARCH, smoke=True), device="meta").named_parameters()}
    assert mine == {n: (tuple(t.shape), t.dtype)
                    for n, t in params.named_parameters()}


def test_load_params_equals_cast_of_init():
    cfg = get_config(ARCH, smoke=True)
    want = dict(cast_params(init_params(3, cfg, device="cpu"),
                            cfg).named_parameters())
    got = dict(load_params(3, cfg, device="cpu").named_parameters())
    assert want.keys() == got.keys()
    for name, t in want.items():
        assert got[name].dtype == t.dtype and torch.equal(got[name], t), name


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["blocked", "flash"])
def test_forward_and_prefill_match_jax(jax_tree, params, impl, compute):
    jcfg, cfg = configs(attn_impl=impl, compute_dtype=compute)
    b = batch_of(5, 2, 48)
    want = np.asarray(jax_forward(jax_tree, jax_batch(b), jcfg,
                                  JaxRuntime()))
    got = forward(params, b, cfg, CPU)
    assert got.shape == (2, 48, cfg.vocab_padded)      # text positions only
    bar = F32_BAR if compute == "float32" else BF16_BAR
    v = cfg.vocab
    assert rel(got[..., :v], want[..., :v]) < bar
    last = prefill(params, b, cfg, CPU)
    want_last = np.asarray(jax_prefill(jax_tree, jax_batch(b), jcfg,
                                       JaxRuntime()))
    assert rel(last[:, :v], want_last[:, :v]) < bar


def test_prefix_is_read(params):
    """Other prefixes, other logits; without the prefix the logits are the
    text-only prefill's."""
    _, cfg = configs(compute_dtype="float32")
    b = batch_of(3, 2, 24)
    last = prefill(params, b, cfg, CPU)
    rolled = dict(b, embeds=np.roll(b["embeds"], 1, axis=0))
    assert rel(prefill(params, rolled, cfg, CPU), last) > 1e-2
    text = {"tokens": b["tokens"]}
    assert rel(prefill(params, text, cfg, CPU), last) > 1e-2
    assert forward(params, text, cfg, CPU).shape[1] == 24


def test_loss_and_gradients_match_jax(jax_tree):
    """f32: labels over the text positions after the prefix."""
    jcfg, cfg = configs(compute_dtype="float32")
    b = batch_of(2, 2, 32, labels=True)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jax_loss_fn(
        p, jax_batch(b), jcfg, JaxRuntime())))(
        jax.tree.map(jnp.asarray, jax_tree))
    tparams = params_from_jax(jax_tree, device="cpu", trainable=True)
    loss = loss_fn(tparams, b, cfg, CPU)
    names = [n for n, _ in tparams.named_parameters()]
    grads = torch.autograd.grad(loss, list(tparams.parameters()))
    assert abs(loss.item() - float(jloss)) < 1e-5 * abs(float(jloss))
    want = flat(jax.tree.map(np.asarray, jgrads))
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        assert rel(g, want[name]) < F32_BAR, name


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_teacher_forced_decode_matches_jax(jax_tree, params, compute):
    """12 text-only steps into an 8-slot cache (slots roll from step 8
    on): every step's logits, and in f32 the tokens and caches."""
    jcfg, cfg = configs(compute_dtype=compute)
    B, C = 2, 8
    toks = batch_of(6, B, 12)["tokens"]
    jc = jax_init_caches(jcfg, B, C)
    tc = init_caches(cfg, B, C, device="cpu")
    bar = F32_BAR if compute == "float32" else BF16_BAR
    jstep = jax.jit(lambda tree, t, c, p: jax_decode_step(
        tree, t, c, p, jcfg, JaxRuntime()))
    jtree = jax.tree.map(jnp.asarray, jax_tree)
    for pos in range(12):
        jt, jl, jc = jstep(jtree, jnp.asarray(toks[:, pos]), jc,
                           jnp.int32(pos))
        tt, tl, tc = decode_step(params, torch.from_numpy(toks[:, pos]), tc,
                                 pos, cfg, CPU)
        assert rel(tl[:, :cfg.vocab], np.asarray(jl)[:, :cfg.vocab]) < bar, \
            pos
        if compute == "float32":
            assert tt.tolist() == np.asarray(jt).tolist(), pos
    if compute == "float32":
        for blk, c in tc["body"].items():
            for name in ("k", "v"):
                assert rel(c[name], np.asarray(jc["body"][blk][name])) < \
                    F32_BAR, (blk, name)


def test_prefill_matches_decode_logits(params):
    """Text-only prefill against 8 teacher-forced decode steps (f32)."""
    _, cfg = configs(compute_dtype="float32")
    toks = batch_of(7, 1, 8)["tokens"]
    want = prefill(params, {"tokens": toks}, cfg, CPU)
    caches = init_caches(cfg, 1, 8, device="cpu")
    for t in range(8):
        _, got, caches = decode_step(params, torch.from_numpy(toks[:, t]),
                                     caches, t, cfg, CPU)
    assert rel(got[:, :cfg.vocab], want[:, :cfg.vocab]) < F32_BAR


def test_stream_embeds_are_bit_identical_to_jax():
    jcfg, cfg = configs()
    dc = dict(vocab=512, seq_len=24, global_batch=3, seed=4)
    jstream = JaxStream(JaxDataConfig(**dc), jcfg)
    stream = SyntheticStream(DataConfig(**dc), cfg)
    for step in range(3):
        a, b = stream.batch(step), jstream.batch(step)
        assert a.keys() == b.keys() == {"tokens", "labels", "embeds"}
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    assert stream.batch(0)["embeds"].shape == (3, 16, 128)
    # without the model config, tokens and labels alone, as before
    assert SyntheticStream(DataConfig(**dc)).batch(0).keys() == \
        {"tokens", "labels"}


def test_serve_launcher_checks_on_cpu(capsys):
    serve_mod.main(["--arch", ARCH, "--device", "cpu", "--check",
                    "--requests", "4", "--tokens", "8", "--cache-len", "16"])
    out = capsys.readouterr().out
    assert "deadline_misses: 0" in out
    assert "bit-identical to solo decode" in out


def test_train_launcher_takes_embeds_on_cpu(capsys):
    out = train_mod.main(["--arch", ARCH, "--device", "cpu", "--steps", "2",
                          "--batch", "2", "--seq", "16"])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
