"""whisper-base in the port against the JAX package on the CPU: the
encoder (sinusoidal positions on the frames, non-causal attention,
LayerNorm), the decoder's learned positions and cross-attention, tied
embeddings, the audio stub's ``frames`` and the serving engine's encoder
output.

The config equals the JAX package's field for field, smoke and full, and
its parameter count is the JAX tree's (0.100 B).  At the smoke config (2
encoder and 2 decoder layers, d 128, 4 heads of 32, vocab 512) the JAX
package's ``init_params`` tree is carried across with
``params_from_jax``, and the forward, the prefill, the loss with its
gradients and 12 teacher-forced decode steps with ``enc_out`` are held to
the JAX package's: relative error below 1e-4 in f32 and 0.08 in bf16.
``attn_impl="flash"`` runs the Pallas kernel in interpret mode on the JAX
side and the kernel's plain version on the port's, at a prefill whose
frames are as many as its tokens.

The two limits of the JAX package's attention that an encoder-decoder
meets, mirrored and refused by name: blocked attention builds its mask
from the query length (a prefill with fewer frames than tokens fails in
the JAX package), and the flash kernel sizes its key blocks from the
query length (at one query, a decode step's cross-attention, the JAX
kernel reads one encoder frame only).
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
from repro.models.attention import attention as jax_attention
from repro.models.lm import _cast_params as jax_cast_params
from repro.models.lm import _run_encoder as jax_run_encoder
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import LPFFatalError
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import (Runtime, cast_params, count_params,
                                decode_step, forward, init_caches,
                                init_params, load_params, loss_fn, prefill)
from repro_torch.models.attention import attention
from repro_torch.models.lm import _run_encoder

ARCH = "whisper-base"
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


def batch_of(seed, B, S, labels=False):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, 512, (B, S), dtype=np.int32),
         "frames": rng.standard_normal((B, S, 128)).astype(np.float32)}
    if labels:
        b["labels"] = rng.integers(0, 512, (B, S), dtype=np.int32)
        b["labels"][0, -3:] = -1
    return b


def jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def jax_encoder(jax_tree, jcfg, frames):
    """The JAX package's encoder output, as its own prefill-vs-decode test
    builds it (the top-level leaves cast to the compute dtype)."""
    cdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[
        jcfg.compute_dtype]
    cast = jax_cast_params(jax_tree, cdt)
    p = {k: (v if k.startswith(("dec_", "enc_")) else cast[k])
         for k, v in jax_tree.items()}
    return jax_run_encoder(p, jnp.asarray(frames), jcfg, JaxRuntime())


# --------------------------------------------------------------------------
# configuration and parameters
# --------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [True, False])
def test_config_matches_jax(smoke):
    assert ARCH in ARCHS
    assert dataclasses.asdict(get_config(ARCH, smoke=smoke)) == \
        dataclasses.asdict(jax_get_config(ARCH, smoke=smoke))


def test_count_params_matches_jax():
    want = jax_count_params(jax_get_config(ARCH))
    assert count_params(get_config(ARCH)) == want
    assert round(want / 1e9, 3) == 0.100


def test_params_round_trip_exactly(jax_tree, params):
    a, b = flat(jax_tree), flat(params_to_numpy(params))
    assert a.keys() == b.keys()
    for name in a:
        assert np.array_equal(a[name], b[name]), name
    raw = dict(params.named_parameters())
    assert {"pos_embed", "enc_final_norm.w", "enc_final_norm.b",
            "enc_enc.b0.attn.wq", "dec_dec.b0.xattn.wk",
            "dec_dec.b0.ln_x.b"} <= set(raw)
    assert "head" not in raw                       # tied embeddings
    assert raw["pos_embed"].shape == (256, 128)
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
    assert got["pos_embed"].dtype == torch.bfloat16


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["blocked", "flash"])
def test_forward_and_prefill_match_jax(jax_tree, params, impl, compute):
    jcfg, cfg = configs(attn_impl=impl, compute_dtype=compute)
    b = batch_of(5, 2, 32)
    want = np.asarray(jax_forward(jax_tree, jax_batch(b), jcfg,
                                  JaxRuntime()))
    got = forward(params, b, cfg, CPU)
    assert got.shape == (2, 32, cfg.vocab_padded)
    bar = F32_BAR if compute == "float32" else BF16_BAR
    v = cfg.vocab
    assert rel(got[..., :v], want[..., :v]) < bar
    last = prefill(params, b, cfg, CPU)
    want_last = np.asarray(jax_prefill(jax_tree, jax_batch(b), jcfg,
                                       JaxRuntime()))
    assert rel(last[:, :v], want_last[:, :v]) < bar
    # the decoder reads the frames: other frames, other logits
    b2 = dict(b, frames=np.roll(b["frames"], 1, axis=0))
    assert rel(prefill(params, b2, cfg, CPU)[:, :v], last[:, :v]) > 10 * bar


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_encoder_matches_jax(jax_tree, params, compute):
    jcfg, cfg = configs(compute_dtype=compute)
    frames = batch_of(3, 2, 24)["frames"]
    want = jax_encoder(jax_tree, jcfg, frames)
    got = _run_encoder(params, frames, cfg, CPU)
    assert got.dtype == getattr(torch, compute)
    assert rel(got.float(), np.asarray(want, np.float32)) < (
        F32_BAR if compute == "float32" else BF16_BAR)


def test_loss_and_gradients_match_jax(jax_tree):
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
    # the gradient reaches the encoder through the cross-attention
    assert np.abs(want["enc_enc.b0.attn.wq"]).max() > 0


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_teacher_forced_decode_matches_jax(jax_tree, params, compute):
    """12 steps into an 8-slot cache (slots roll from step 8 on), every
    step's cross-attention against the same 20-frame ``enc_out`` (the JAX
    encoder's output, blocked: one query over every frame): the logits of
    every step, and in f32 the greedy tokens and the caches."""
    jcfg, cfg = configs(compute_dtype=compute)
    B, C = 2, 8
    toks = batch_of(6, B, 12)["tokens"]
    enc = jax_encoder(jax_tree, jcfg, batch_of(9, B, 20)["frames"])
    t_enc = torch.from_numpy(np.array(enc, np.float32)).to(
        getattr(torch, compute))
    jc = jax_init_caches(jcfg, B, C)
    tc = init_caches(cfg, B, C, device="cpu")
    bar = F32_BAR if compute == "float32" else BF16_BAR
    jstep = jax.jit(lambda tree, t, c, p: jax_decode_step(
        tree, t, c, p, jcfg, JaxRuntime(), enc))
    jtree = jax.tree.map(jnp.asarray, jax_tree)
    for pos in range(12):
        jt, jl, jc = jstep(jtree, jnp.asarray(toks[:, pos]), jc,
                           jnp.int32(pos))
        tt, tl, tc = decode_step(params, torch.from_numpy(toks[:, pos]), tc,
                                 pos, cfg, CPU, t_enc)
        assert rel(tl[:, :cfg.vocab], np.asarray(jl)[:, :cfg.vocab]) < bar, \
            pos
        if compute == "float32":
            assert tt.tolist() == np.asarray(jt).tolist(), pos
    if compute == "float32":
        for blk, c in tc["dec"].items():
            for name in ("k", "v"):
                assert rel(c[name], np.asarray(jc["dec"][blk][name])) < \
                    F32_BAR, (blk, name)


def test_prefill_matches_decode_logits(params):
    """The JAX package's own check (``tests/test_models_smoke.py``): 8
    teacher-forced decode steps with the prefill's encoder output match
    the prefill's last logits; here in f32 to the f32 bar."""
    _, cfg = configs(compute_dtype="float32")
    b = batch_of(7, 1, 8)
    want = prefill(params, b, cfg, CPU)
    enc = _run_encoder(params, b["frames"], cfg, CPU)
    caches = init_caches(cfg, 1, 8, device="cpu")
    for t in range(8):
        _, got, caches = decode_step(params, torch.from_numpy(
            b["tokens"][:, t]), caches, t, cfg, CPU, enc)
    assert rel(got[:, :cfg.vocab], want[:, :cfg.vocab]) < F32_BAR


def test_decode_with_tensor_pos_equals_int_pos(params):
    """A 0-d device position (what a captured step replays) indexes the
    learned positions as the int does: logits and caches bit for bit."""
    _, cfg = configs(compute_dtype="float32")
    toks = batch_of(8, 2, 10)["tokens"]
    enc = torch.zeros(2, 64, 128, dtype=torch.bfloat16)
    a = init_caches(cfg, 2, 8, device="cpu")
    b = init_caches(cfg, 2, 8, device="cpu")
    for pos in range(10):
        _, la, a = decode_step(params, torch.from_numpy(toks[:, pos]), a,
                               pos, cfg, CPU, enc)
        _, lb, b = decode_step(params, torch.from_numpy(toks[:, pos]), b,
                               torch.tensor(pos), cfg, CPU, enc)
        assert torch.equal(la, lb), pos


# --------------------------------------------------------------------------
# the reference's attention limits
# --------------------------------------------------------------------------

def _qkv(S, Skv, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((1, S, 2, 32), (1, Skv, 2, 32), (1, Skv, 2, 32))]


def test_blocked_attention_mask_follows_the_query_length():
    """Four queries over eight keys fail in the JAX package (its mask is
    [S, S]) and raise by name here; one query takes every key in both."""
    q, k, v = _qkv(4, 8)
    with pytest.raises(Exception):
        jax_attention(*map(jnp.asarray, (q, k, v)), impl="blocked",
                      causal=False)
    with pytest.raises(LPFFatalError, match="query length"):
        attention(*map(torch.from_numpy, (q, k, v)), impl="blocked",
                  causal=False)
    q1 = q[:, :1]
    want = jax_attention(*map(jnp.asarray, (q1, k, v)), impl="blocked",
                         causal=False)
    got = attention(*map(torch.from_numpy, (q1, k, v)), impl="blocked",
                    causal=False)
    assert rel(got, want) < 1e-5


@pytest.mark.parametrize("S", [1, 4])
def test_flash_refuses_other_key_lengths(S):
    """The JAX kernel sizes its key blocks from the query length, so it
    reads only the first S of eight keys, silently (recorded here against
    the reference over those keys); the port refuses by name."""
    q, k, v = _qkv(S, 8)
    got_jax = jax_attention(*map(jnp.asarray, (q, k, v)), impl="flash",
                            causal=False)
    first = jax_attention(*map(jnp.asarray, (q, k[:, :S], v[:, :S])),
                          impl="reference", causal=False)
    assert float(jnp.abs(got_jax - first).max()) < 1e-5
    with pytest.raises(LPFFatalError, match="keys as long as the queries"):
        attention(*map(torch.from_numpy, (q, k, v)), impl="flash",
                  causal=False)


def test_flash_decode_cross_attention_is_refused(params):
    """Decode's cross-attention (one query over the frames) under
    ``attn_impl="flash"`` raises; whisper decodes blocked."""
    _, cfg = configs(attn_impl="flash", compute_dtype="float32")
    caches = init_caches(cfg, 1, 8, device="cpu")
    with pytest.raises(LPFFatalError, match="keys as long as the queries"):
        decode_step(params, torch.zeros(1, dtype=torch.long), caches, 0,
                    cfg, CPU, torch.zeros(1, 16, 128))


# --------------------------------------------------------------------------
# data, serving, training
# --------------------------------------------------------------------------

def test_stream_frames_are_bit_identical_to_jax():
    jcfg, cfg = configs()
    dc = dict(vocab=512, seq_len=24, global_batch=3, seed=4)
    jstream = JaxStream(JaxDataConfig(**dc), jcfg)
    stream = SyntheticStream(DataConfig(**dc), cfg)
    for step in range(3):
        a, b = stream.batch(step), jstream.batch(step)
        assert a.keys() == b.keys() == {"tokens", "labels", "frames"}
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    assert stream.batch(0)["frames"].shape == (3, 24, 128)


def test_engine_feeds_zero_frames_and_streams_match_decode(params):
    """The engine feeds the JAX engine's encoder output (zeros, [B, 64, D]
    in bf16); its batched streams equal the solo ones, the per-token
    path's and a plain ``decode_step`` loop's on the same input."""
    _, cfg = configs()
    eng = serve_mod.ModelDecodeEngine(cfg, [(2, 16)], params=params,
                                      device="cpu", calibrate_tokens=2)
    (enc,) = eng._enc[(2, 16)]
    assert enc.shape == (2, 64, 128) and enc.dtype == torch.bfloat16
    assert not enc.any()
    rows = eng._decode_rows((2, 16), [5, 77], 6)
    assert eng._decode_rows((2, 16), [77], 6)[0] == rows[1]
    eng.quarantine((2, 16))
    assert eng._decode_rows((2, 16), [5, 77], 6) == rows
    caches = init_caches(cfg, 2, 16, device="cpu")
    tok, seq = torch.tensor([5, 77]), []
    for pos in range(6):
        tok, _, caches = decode_step(params, tok, caches, pos, cfg, CPU, enc)
        seq.append(tok)
    assert [tuple(r) for r in torch.stack(seq).T.tolist()] == rows


def test_serve_launcher_checks_on_cpu(capsys):
    serve_mod.main(["--arch", ARCH, "--device", "cpu", "--check",
                    "--requests", "4", "--tokens", "8", "--cache-len", "16"])
    out = capsys.readouterr().out
    assert "deadline_misses: 0" in out
    assert "bit-identical to solo decode" in out


def test_train_launcher_takes_frames_on_cpu(capsys):
    out = train_mod.main(["--arch", ARCH, "--device", "cpu", "--steps", "2",
                          "--batch", "2", "--seq", "16"])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
