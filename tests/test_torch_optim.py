"""The port's Adafactor and error-feedback int8 compression
(``repro_torch.optim``) against the JAX package's ``repro.optim``, step
for step on seeded numpy trees in f32: parameters, the factored and
unfactored second moments, the int8 codes, scales and residuals.  The
tolerance is 1e-6 (relative to each leaf's largest magnitude); the int8
codes are equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro_torch import optim as toptim

#: leaf shapes: factored matrices (both trailing dims >= 128, stacked and
#: not), a matrix too narrow to factor, vectors
SHAPES = {"w": (256, 192), "b": (64,), "narrow": (200, 96),
          "blk": {"k": (3, 130, 140), "n": (3, 16)}}
STEPS = 5
TOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    """Each comparison runs torch on one CPU thread.  On a loaded
    pytest-xdist worker (an 8-core host, torch's MKL build) the first
    ``torch.sqrt`` of a process has been seen off by up to 3.1e-4
    (relative) on one OpenMP worker thread's chunk, the later calls
    exact: an error of the library's threaded path, which would otherwise
    decide this test rather than the optimizer's arithmetic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(rng, shapes, scale=1.0):
    return {k: _tree(rng, v, scale) if isinstance(v, dict)
            else (scale * rng.standard_normal(v)).astype(np.float32)
            for k, v in shapes.items()}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else np.asarray(
        v.detach() if isinstance(v, torch.Tensor) else v)
        for k, v in tree.items()}


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(
        np.array(v)) for k, v in tree.items()}


def _close(a, b, what):
    a, b = dict(_leaves(_np(a))), dict(_leaves(_np(b)))
    assert sorted(a) == sorted(b), what
    for name in a:
        x = np.asarray(a[name], np.float64)
        y = np.asarray(b[name], np.float64)
        assert x.shape == y.shape, (what, name)
        scale = max(np.abs(y).max(), 1e-30)
        assert np.abs(x - y).max() <= TOL * scale, (what, name)


@pytest.mark.parametrize("schedule", [False, True])
@pytest.mark.parametrize("min_dim", [128, 16])
def test_adafactor_matches_jax_step_for_step(schedule, min_dim):
    rng = np.random.default_rng([7, min_dim])
    params = _tree(rng, SHAPES)
    if schedule:
        jcfg = joptim.AdafactorConfig(
            lr=joptim.warmup_cosine(1e-2, 2, STEPS),
            min_dim_factored=min_dim)
        tcfg = toptim.AdafactorConfig(
            lr=toptim.warmup_cosine(1e-2, 2, STEPS),
            min_dim_factored=min_dim)
    else:
        jcfg = joptim.AdafactorConfig(lr=1e-2, min_dim_factored=min_dim)
        tcfg = toptim.AdafactorConfig(lr=1e-2, min_dim_factored=min_dim)
    jp = jax.tree.map(jnp.asarray, params)
    tp = _torch(params)
    js, ts = joptim.adafactor_init(jp, jcfg), toptim.adafactor_init(tp, tcfg)
    assert ts["step"] == 0
    _close(ts["acc"], js["acc"], "init")
    for step in range(STEPS):
        grads = _tree(rng, SHAPES, scale=0.1 * (step + 1))
        jp, js, jm = joptim.adafactor_update(
            jax.tree.map(jnp.asarray, grads), js, jp, jcfg)
        tp, ts, tm = toptim.adafactor_update(_torch(grads), ts, tp, tcfg)
        assert ts["step"] == int(js["step"]) == step + 1
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
        _close(tp, jp, f"params step {step}")
        _close(ts["acc"], js["acc"], f"moments step {step}")
    factored = {n for n, v in _leaves(_np(ts["acc"])) if n.endswith(".vr")}
    assert factored == ({"w.vr", "blk.k.vr"} if min_dim == 128 else
                        {"w.vr", "narrow.vr", "blk.k.vr"})


def test_adafactor_is_functional_and_keeps_dtype():
    rng = np.random.default_rng(3)
    params = _torch(_tree(rng, SHAPES))
    params["b"] = params["b"].to(torch.bfloat16)
    before = {n: v.clone() for n, v in _leaves(params)}
    state = toptim.adafactor_init(params)
    new, state2, _ = toptim.adafactor_update(
        _torch(_tree(rng, SHAPES)), state, params)
    for n, v in _leaves(params):
        assert torch.equal(v, before[n])            # arguments unchanged
    assert new["b"].dtype == torch.bfloat16 and state["step"] == 0
    assert state2["acc"]["b"]["v"].dtype == torch.float32


def test_ef_compression_matches_jax_step_for_step():
    rng = np.random.default_rng(11)
    params = _tree(rng, SHAPES)
    jr = joptim.ef_init(jax.tree.map(jnp.asarray, params))
    tr = toptim.ef_init(_torch(params))
    _close(tr, jr, "init")
    for step in range(STEPS):
        grads = _tree(rng, SHAPES, scale=10.0 ** (step - 2))
        jq, js, jr = joptim.ef_compress(jax.tree.map(jnp.asarray, grads), jr)
        tq, ts, tr = toptim.ef_compress(_torch(grads), tr)
        jcodes = dict(_leaves(_np(jq)))
        for name, a in _leaves(_np(tq)):
            assert a.dtype == np.int8, name
            assert np.array_equal(a, jcodes[name]), (step, name)
        _close(ts, js, f"scales step {step}")
        _close(tr, jr, f"residual step {step}")
        _close(toptim.ef_decompress(tq, ts), joptim.ef_decompress(jq, js),
               f"decompressed step {step}")


def test_ef_feedback_delays_never_destroys():
    """Summed over steps, decompressed updates plus the last residual equal
    the summed gradients (to f32 rounding): quantisation error is carried,
    not lost."""
    rng = np.random.default_rng(5)
    shapes = {"g": (64, 32)}
    res = toptim.ef_init(_torch(_tree(rng, shapes)))
    total_g = torch.zeros(64, 32)
    total_u = torch.zeros(64, 32)
    for _ in range(6):
        g = _torch(_tree(rng, shapes))
        q, s, res = toptim.ef_compress(g, res)
        total_g += g["g"]
        total_u += toptim.ef_decompress(q, s)["g"]
    assert torch.allclose(total_u + res["g"], total_g, atol=1e-5)


@pytest.mark.parametrize("clip", [None, 1e-3])
def test_adamw_donated_update_matches_the_functional_one(clip, monkeypatch):
    """``donate=True`` writes the functional update's values into the
    arguments (1e-6), slice by slice along the leading axis (here slices
    of 4,096 elements, so the stacked leaves take several)."""
    from repro_torch.optim import adamw as tadamw
    monkeypatch.setattr(tadamw, "_DONATE_SLICE", 1 << 12)
    rng = np.random.default_rng(2)
    params = _torch(_tree(rng, SHAPES))
    cfg = toptim.AdamWConfig(lr=1e-2, clip_norm=clip)
    state = toptim.adamw_init(params, cfg)
    dparams = {k: ({kk: vv.clone() for kk, vv in v.items()}
                   if isinstance(v, dict) else v.clone())
               for k, v in params.items()}
    dstate = toptim.adamw_init(dparams, cfg)
    for step in range(3):
        grads = _tree(rng, SHAPES, scale=0.1)
        params, state, m = toptim.adamw_update(_torch(grads), state, params,
                                               cfg)
        held = dict(_leaves(dparams))
        dparams, dstate, dm = toptim.adamw_update(
            _torch(grads), dstate, dparams, cfg, donate=True)
        for name, v in _leaves(dparams):
            assert v.data_ptr() == held[name].data_ptr(), name  # in place
        assert float(dm["grad_norm"]) == float(m["grad_norm"])
        _close(dparams, params, f"params step {step}")
        _close(dstate["m"], state["m"], f"m step {step}")
        _close(dstate["v"], state["v"], f"v step {step}")


def test_donating_train_step_matches_the_functional_step():
    """``build_train_step(donate=True)``: the same losses and (to 1e-6)
    the same parameters as the functional step, the update written into
    the parameters the step was given."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.runtime.train_step import build_train_step
    cfg = get_config("llama3.2-1b", smoke=True)
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=32,
                                        global_batch=2))
    runs = {}
    for donate in (False, True):
        ts = build_train_step(cfg, opt_cfg=toptim.AdamWConfig(lr=1e-3),
                              donate=donate, device="cpu")
        params, opt = ts.init_fn(0)
        losses = []
        for step in range(2):
            batch = {k: torch.from_numpy(v)
                     for k, v in stream.batch(step).items()}
            ptrs = [p.data_ptr() for p in params.parameters()]
            params, opt, m = ts.step_fn(params, opt, batch)
            losses.append(m["loss"].item())
            assert ([p.data_ptr() for p in params.parameters()]
                    == ptrs) == donate
        runs[donate] = (losses, params.tree())
    assert runs[True][0][0] == runs[False][0][0]
    assert runs[True][0][1] == pytest.approx(runs[False][0][1], rel=1e-6)
    _close(runs[True][1], runs[False][1], "donated params")
