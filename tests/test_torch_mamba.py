"""Parity of the port's mamba2-130m serving stack with the JAX reference on
the CPU, at the smoke config (2 layers, d 128, d_state 16, head dim 32,
8 heads, chunk 32, vocab 512).

Weights are the JAX package's ``init_params`` / ``mamba_params`` trees,
carried across with ``params_from_jax``; inputs come from numpy.  Where
the JAX model reaches the Pallas kernel (``impl="kernel"``) it runs in
interpret mode, as its own tests run it; the port takes the kernel's plain
version for a CPU tensor.  The port's blocks call ``impl="kernel"`` where
the JAX blocks take the chunked path: the same function.  Bars as in
``tests/test_torch_models.py``: relative error below 1e-4 with
``compute_dtype="float32"``, below 0.08 (the JAX package's bf16 bar) in
bf16.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import compat
from repro.models import Runtime as JaxRuntime
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_caches as jax_init_caches
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro.models import prefill as jax_prefill
from repro.models.lm import _cast_params as jax_cast_params
from repro.models.lm import count_params as jax_count_params
from repro.models.mamba import mamba_apply as jax_mamba_apply
from repro.models.mamba import mamba_decode_step as jax_mamba_decode_step
from repro.models.mamba import mamba_init_cache as jax_mamba_init_cache
from repro.models.mamba import mamba_params as jax_mamba_params
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.runtime.train_step import build_train_step as jax_build_train_step
from repro_torch.configs import get_config
from repro_torch.core import LPFFatalError
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.interop import (opt_state_from_jax, params_from_jax,
                                 params_to_numpy)
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import serve as serve_mod
from repro_torch.models import (Runtime, cast_params, count_params,
                                decode_step, forward, init_caches,
                                init_params, prefill)
from repro_torch.models import lm, mamba
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.train_step import build_train_step

ARCH = "mamba2-130m"
F32_BAR = 1e-4
BF16_BAR = 0.08
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


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


def mixer(compute):
    """The smoke config's mixer parameters in both packages, weight
    matrices cast to ``compute`` as each package's layer body casts them
    (the vectors stay f32)."""
    mcfg = get_config(ARCH, smoke=True).mamba
    jdt, tdt = DTYPES[compute]
    tree = jax_cast_params(jax.tree.map(np.asarray, jax_mamba_params(
        jax.random.PRNGKey(2), mcfg)), jdt)
    tp = lm._cast_params({k: torch.from_numpy(np.array(v, np.float32))
                          for k, v in tree.items()}, tdt)
    return mcfg, tree, tp


# --------------------------------------------------------------------------
# configuration and parameters
# --------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [True, False])
def test_config_matches_jax(smoke):
    assert dataclasses.asdict(get_config(ARCH, smoke=smoke)) == \
        dataclasses.asdict(jax_get_config(ARCH, smoke=smoke))


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
    m = port_params.dec_body.b0.mamba
    for name in ("conv_b", "norm_w", "d_skip", "a_log", "dt_bias"):
        assert getattr(m, name).dtype == torch.float32, name
    assert m.conv_w.shape == (2, 4, 256 + 2 * 16)


def test_full_width_layout_matches_jax():
    """The published geometry's tree, by name and shape (the meta device
    and ``jax.eval_shape``: nothing is allocated): stacked [24, ...]
    leaves, ``a_log`` [24, 24], ``conv_w`` [24, 4, 1792]."""
    jshape = jax.eval_shape(lambda: jax_init_params(
        jax.random.PRNGKey(0), jax_get_config(ARCH)))
    want = {jax.tree_util.keystr(k): (v.shape, np.dtype(v.dtype).name)
            for k, v in jax.tree_util.tree_flatten_with_path(jshape)[0]}
    p = init_params(0, get_config(ARCH), device="meta")
    got = {"".join(f"['{s}']" for s in n.split(".")):
           (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for n, t in p.named_parameters()}
    assert got == want
    assert got["['dec_body']['b0']['mamba']['a_log']"][0] == (24, 24)
    assert got["['dec_body']['b0']['mamba']['conv_w']"][0] == (24, 4, 1792)


def test_count_params_matches_jax():
    cfg = get_config(ARCH)
    assert count_params(cfg) == jax_count_params(jax_get_config(ARCH)) \
        == 129_100_224
    assert lm.model_flops(cfg, 10) == 6.0 * 129_100_224 * 10


def test_cast_once_keeps_the_vectors_f32(port_params):
    _, cfg = configs()
    cast = cast_params(port_params, cfg)
    m = cast.dec_body.b0.mamba
    assert m.in_x.dtype == m.conv_w.dtype == torch.bfloat16
    assert m.a_log.dtype == m.conv_b.dtype == m.d_skip.dtype \
        == torch.float32
    toks = tokens(9, 2, 40)
    rt = Runtime("cpu")
    assert torch.equal(prefill(cast, {"tokens": toks}, cfg, rt),
                       prefill(port_params, {"tokens": toks}, cfg, rt))


# --------------------------------------------------------------------------
# the mixer
# --------------------------------------------------------------------------

# measured port-vs-JAX relative error of the mixer in bf16 on these
# inputs: 5.5e-3 with either impl; the bar is the JAX package's 0.08
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["chunked", "kernel"])
def test_mamba_apply_matches_jax(impl, compute):
    mcfg, tree, tp = mixer(compute)
    jdt, tdt = DTYPES[compute]
    x = np.random.default_rng(3).standard_normal(
        (2, 64, mcfg.d_model)).astype(np.float32)
    want = jax_mamba_apply(tree, jnp.asarray(x, jdt), mcfg, impl=impl)
    got = mamba.mamba_apply(tp, torch.from_numpy(x).to(tdt), mcfg,
                            impl=impl)
    assert got.dtype == tdt and got.shape == (2, 64, mcfg.d_model)
    assert rel(got.float(), want) < (F32_BAR if compute == "float32"
                                     else BF16_BAR)


def test_bf16_model_hands_the_scan_f32_views(monkeypatch):
    """silu(conv + conv_b) with the f32 bias promotes a bf16 model's xbc to
    f32, as in the JAX package: the scan receives f32 x, b and c, as
    strided views of the convolution output (no copy)."""
    mcfg, _, tp = mixer("bfloat16")
    seen = {}
    real = ssd_ops.ssd

    def spy(x, dt, a, b, c, *, chunk):
        seen.update(x=x, dt=dt, a=a, b=b, c=c, chunk=chunk)
        return real(x, dt, a, b, c, chunk=chunk)

    monkeypatch.setattr(ssd_ops, "ssd", spy)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 64, mcfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    out = mamba.mamba_apply(tp, x, mcfg, impl="kernel")
    assert out.dtype == torch.bfloat16
    for name in ("x", "dt", "a", "b", "c"):
        assert seen[name].dtype == torch.float32, name
    assert seen["chunk"] == mcfg.chunk
    assert not seen["x"].is_contiguous() and seen["x"].stride(-1) == 1
    assert seen["x"].stride(1) == mcfg.conv_dim


def test_chunked_path_refuses_a_ragged_length():
    mcfg, _, tp = mixer("float32")
    x = torch.zeros(1, 40, mcfg.d_model)
    with pytest.raises(LPFFatalError, match="not a multiple"):
        mamba.mamba_apply(tp, x, mcfg, impl="chunked")
    # the kernel path masks the tail instead
    assert mamba.mamba_apply(tp, x, mcfg, impl="kernel").shape == x.shape


def test_mamba_decode_step_matches_jax():
    """12 steps of the recurrence in f32: outputs, state and conv window
    (updated in place in the port) against the JAX package's."""
    mcfg, tree, tp = mixer("float32")
    B = 2
    jc = jax_mamba_init_cache(B, mcfg)
    tc = mamba.mamba_init_cache(B, mcfg)
    xs = np.random.default_rng(5).standard_normal(
        (12, B, mcfg.d_model)).astype(np.float32)
    for t in range(12):
        want, jc = jax_mamba_decode_step(tree, jnp.asarray(xs[t]), jc, mcfg)
        ssm = tc["ssm"]
        got, tc2 = mamba.mamba_decode_step(tp, torch.from_numpy(xs[t]), tc,
                                           mcfg)
        assert tc2 is tc and tc["ssm"] is ssm
        assert rel(got, want) < F32_BAR, t
    assert rel(tc["ssm"], jc["ssm"]) < F32_BAR
    assert rel(tc["conv"], jc["conv"]) < F32_BAR


# --------------------------------------------------------------------------
# the model: forward, prefill, decode, serving
# --------------------------------------------------------------------------

@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_forward_and_prefill_match_jax(jax_tree, port_params, compute):
    jcfg, cfg = configs(compute_dtype=compute)
    toks = tokens(6, 2, 64)
    want = np.asarray(jax_forward(jax_tree, {"tokens": jnp.asarray(toks)},
                                  jcfg, JaxRuntime()))
    before = ssd_kernel.ssd_scan.launches
    got = forward(port_params, {"tokens": toks}, cfg, Runtime("cpu"))
    assert ssd_kernel.ssd_scan.launches == before
    assert got.shape == (2, 64, cfg.vocab_padded)
    bar = F32_BAR if compute == "float32" else BF16_BAR
    v = cfg.vocab
    assert rel(got[..., :v], want[..., :v]) < bar
    last = prefill(port_params, {"tokens": toks}, cfg, Runtime("cpu"))
    want_last = np.asarray(jax_prefill(
        jax_tree, {"tokens": jnp.asarray(toks)}, jcfg, JaxRuntime()))
    assert rel(last[:, :v], want_last[:, :v]) < bar


def test_decode_matches_jax(jax_tree, port_params):
    jcfg, cfg = configs(compute_dtype="float32")
    B = 2
    first = tokens(7, B, 1)[:, 0]
    jc = jax_init_caches(jcfg, B, 8)
    tc = init_caches(cfg, B, 8, device="cpu")
    assert tc["body"]["b0"]["ssm"].shape == (2, B, 8, 16, 32)
    assert tc["body"]["b0"]["conv"].shape == (2, B, 3, 256 + 32)
    jt, tt = jnp.asarray(first), torch.from_numpy(first)
    rt = Runtime("cpu")
    for pos in range(12):
        jt, jl, jc = jax_decode_step(jax_tree, jt, jc, jnp.int32(pos), jcfg,
                                     JaxRuntime())
        tt, tl, tc = decode_step(port_params, tt, tc, pos, cfg, rt)
        assert tt.tolist() == np.asarray(jt).tolist(), pos
        assert rel(tl[:, :cfg.vocab], np.asarray(jl)[:, :cfg.vocab]) \
            < F32_BAR, pos
    for name in ("ssm", "conv"):
        assert rel(tc["body"]["b0"][name],
                   np.asarray(jc["body"]["b0"][name])) < F32_BAR


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_teacher_forced_decode_matches_prefill(port_params, compute):
    _, cfg = configs(compute_dtype=compute)
    rt = Runtime("cpu")
    toks = tokens(8, 1, 40)          # 40: a ragged last chunk of 8
    want = prefill(port_params, {"tokens": toks}, cfg, rt)
    caches = init_caches(cfg, 1, 40, device="cpu")
    for t in range(40):
        _, logits, caches = decode_step(port_params, toks[:, t], caches, t,
                                        cfg, rt)
    bar = F32_BAR if compute == "float32" else BF16_BAR
    assert rel(logits[:, :cfg.vocab], want[:, :cfg.vocab]) < bar


def test_serve_launcher_checks_on_cpu(capsys):
    serve_mod.main(["--arch", ARCH, "--device", "cpu", "--check"])
    out = capsys.readouterr().out
    assert "deadline_misses: 0" in out
    done = re.search(r"check: (\d+)/(\d+) completed requests bit-identical",
                     out)
    assert done and int(done[1]) == int(done[2]) >= 1


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def test_three_train_steps_match_jax():
    """Three ``build_train_step`` steps (AdamW, ``remat="full"``: the
    kernel path's forward, its recompute and the VJP of its plain
    version) against the JAX package's on a (1, 1) mesh (its blocks take
    the chunked path) from one state, in f32: losses within 1e-5, every
    parameter within 1e-4 (measured 7.5e-5 at most, in ``out_proj``,
    whose step-0 gradient there is 3.5e-9: AdamW normalises each
    element's gradient by its own magnitude), or within 2 lr a step
    where the step-0 gradient is below 1e-6 of its leaf's largest."""
    jcfg, cfg = configs(compute_dtype="float32", vocab=256)
    jparams = jax.tree.map(jnp.asarray, jax_init_params(
        jax.random.PRNGKey(1), jcfg))
    jopt = jax_adamw_init(jparams)
    jts = jax_build_train_step(jcfg, compat.make_mesh((1, 1), ("data",
                                                               "model")),
                               opt_cfg=JaxAdamWConfig(lr=1e-3),
                               donate=False)
    ts = build_train_step(cfg, opt_cfg=AdamWConfig(lr=1e-3), device="cpu")
    assert cfg.remat == "full"
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             device="cpu", trainable=True)
    opt = opt_state_from_jax(jax.tree.map(np.asarray, jopt), device="cpu")
    stream = SyntheticStream(DataConfig(vocab=256, seq_len=64,
                                        global_batch=4))
    grads0 = jax.tree.map(np.asarray, jax.grad(lambda p: jax_loss_fn(
        p, {k: jnp.asarray(v) for k, v in stream.batch(0).items()}, jcfg,
        JaxRuntime()))(jparams))
    before = ssd_kernel.ssd_scan.launches
    for step in range(3):
        b = stream.batch(step)
        jparams, jopt, jm = jts.step_fn(
            jparams, jopt, {k: jnp.asarray(v) for k, v in b.items()})
        params, opt, m = ts.step_fn(params, opt, b)
        assert abs(m["loss"].item() - float(jm["loss"])) < 1e-5 * abs(
            float(jm["loss"])), step
    assert ssd_kernel.ssd_scan.launches == before    # CPU: the plain version
    want = dict(params_to_numpy_named(jax.tree.map(np.asarray, jparams)))
    g0 = dict(params_to_numpy_named(grads0))
    got = {n: t.detach().numpy() for n, t in params.named_parameters()}
    assert got.keys() == want.keys()
    for name, x in got.items():
        g = np.abs(g0[name])
        d = np.abs(x - want[name])
        assert d[g >= 1e-6 * g.max()].max(initial=0.0) < 1e-4, name
        assert d.max() <= 2 * 1e-3 * 3, name


def params_to_numpy_named(tree, prefix=""):
    """(dotted name, leaf) of a nested dict of arrays."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from params_to_numpy_named(v, f"{prefix}{k}.")
        else:
            yield prefix + k, np.asarray(v, np.float32)
