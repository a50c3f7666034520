"""The port's examples (``repro_torch.examples``) against the JAX
package's (``examples/*.py``) on the CPU.

* ``quickstart`` (the paper's Algorithm 2): the JAX example's own
  ``spmd``, imported from its file and run through ``exec_`` on the 8
  host devices, against the port's at ``1024 512``, ``5 512`` and ``0
  512``: error codes and rows bit-equal, ledger records equal field by
  field and priced alike on the same machine (TPU v5e's fields given to
  the port as data, its ``"ici"`` link as ``"vp"``), the reports equal;
  the port's own report is priced on ``H100_SXM``.
* ``fft_spectral``: the spectrum against the JAX package's ``bsp_fft``
  of the same signal within ``tests/test_torch_fft.py``'s bar (2e-4
  relative), the RMS figures and ``h_bytes`` equal.
* ``pagerank_interop``: the JAX example's ``shard_map`` host hooking
  PageRank against the port's host: the same iteration count and nnz a
  process, ranks within 1e-6.
* ``train_lm``: the first 6 losses on the virtual (4, 2) mesh against
  JAX's example step on the 8 host devices from the same initial weights
  (``params_from_jax``, written as the step-0 checkpoint the example
  resumes from), f32 compute, within 1e-5 relative
  (``tests/test_torch_mesh.py``'s step parity); a resume from a
  checkpoint bit-equal to the uninterrupted run.
* Each ``main(["--device", "cpu", ...])`` exits 0; the ``cuda`` default
  is refused by name without a card.
"""

import dataclasses
import importlib.util
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import core as jlpf
from repro.algorithms import bsp_fft as jax_bsp_fft
from repro.algorithms import partition_graph as jax_partition_graph
from repro.algorithms import rmat_graph as jax_rmat_graph
from repro.algorithms.pagerank import pagerank_spmd as jax_pagerank_spmd
from repro.configs import get_config as jax_get_config
from repro.core import compat
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticStream as JaxStream
from repro.launch.mesh import make_mesh as jax_make_mesh
from repro.models import init_params as jax_init_params
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro.runtime.train_step import build_train_step as jax_build_train_step
from repro_torch import core as tlpf
from repro_torch.checkpoint import save
from repro_torch.checkpoint.store import _flatten
from repro_torch.configs import get_config
from repro_torch.examples import (fft_spectral, pagerank_interop, quickstart,
                                  train_lm)
from repro_torch.interop import (hardware_from_fields, opt_state_from_jax,
                                 params_from_jax)

ROOT = Path(__file__).resolve().parents[1]
#: train_lm's parity run: steps, and the bar on each loss (relative)
LM_STEPS, LM_LOSS_BAR = 6, 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny shapes under the suite's workers: one torch thread for this
    module, the setting restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_example(name):
    """The JAX package's ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ledger_rows(ledger):
    return [dataclasses.asdict(r) for r in ledger.records]


# --------------------------------------------------------------------------
# quickstart: Algorithm 2
# --------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,error,rows", [
    (1024, 512, 0, [128] * 8),
    (5, 512, 1, [1, 1, 1, 1, 1, 0, 0, 0]),
    (0, 512, 1, [0] * 8)])
def test_quickstart_matches_jax(mesh8, m, n, error, rows):
    jq = jax_example("quickstart")
    (jerr, jrows), jled = jlpf.exec_(
        mesh8, jq.spmd, {"mdim": jnp.asarray([m, n], jnp.int32)},
        out_specs=(P(), P("x")), return_ledger=True)
    # TPU v5e's table as data, its "ici" link as the port's "vp"
    fields = dataclasses.asdict(jlpf.TPU_V5E)
    fields["links"] = dict(fields["links"], vp=fields["links"]["ici"])
    tpu = hardware_from_fields(fields)
    res = quickstart.run(m, n, device="cpu", hardware=tpu)
    assert res["error"] == int(jerr) == error
    assert res["errors"] == [error] * 8
    assert res["rows"] == np.asarray(jrows).tolist() == rows
    assert ledger_rows(res["ledger"]) == ledger_rows(jled)
    assert [(r.label, r.h_bytes, r.rounds, r.n_msgs)
            for r in res["ledger"].records] == [
        ("fetch-dims", 56, 7, 8), ("error-broadcast", 28, 13, 64)]
    jm = jlpf.probe({"x": 8}, jlpf.TPU_V5E)
    tm = res["machine"]
    assert (jm.p, jm.g, jm.l, jm.r) == (tm.p, tm.g, tm.l, tm.r)
    assert jled.predicted_seconds(jm) == res["ledger"].predicted_seconds(tm)
    assert res["report"] == jled.report(jm)


def test_quickstart_prices_on_the_h100_by_default():
    res = quickstart.run(1024, 512, device="cpu")
    assert res["hardware"] == tlpf.H100_SXM.name
    assert res["machine"] == tlpf.probe({"vp": 8}, tlpf.H100_SXM)
    assert res["report"] == res["ledger"].report(res["machine"])


# --------------------------------------------------------------------------
# fft_spectral
# --------------------------------------------------------------------------

def test_fft_spectral_matches_jax(mesh8):
    clean, noisy = fft_spectral.signal()
    jspec, jled = jax_bsp_fft(mesh8, jnp.asarray(noisy, jnp.complex64),
                              return_ledger=True)
    keep = np.zeros(fft_spectral.N)
    keep[:fft_spectral.CUTOFF] = 1.0
    keep[-fft_spectral.CUTOFF:] = 1.0
    jrec = np.real(np.asarray(jax_bsp_fft(mesh8, jspec * jnp.asarray(keep),
                                          inverse=True)))
    res = fft_spectral.run(device="cpu")
    want = np.asarray(jspec).astype(np.complex128)
    got = res["spectrum"].numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 2e-4
    assert res["rms_before"] == float(np.sqrt(np.mean((noisy - clean) ** 2)))
    j_after = float(np.sqrt(np.mean((jrec - clean) ** 2)))
    assert abs(res["rms_after"] - j_after) < 1e-5
    assert f"{res['rms_before']:.3f} {res['rms_after']:.3f}" == \
        "0.797 0.133" == f"{res['rms_before']:.3f} {j_after:.3f}"
    assert res["h_bytes"] == jled.h_bytes == res["predicted_h_bytes"] == \
        28672
    assert ledger_rows(res["ledger"]) == ledger_rows(jled)


# --------------------------------------------------------------------------
# pagerank_interop: Algorithm 3
# --------------------------------------------------------------------------

def jax_pagerank_interop(mesh8):
    """The JAX example's host function and ``shard_map``, returning its
    numbers."""
    N, procs = pagerank_interop.N, pagerank_interop.PROCS
    edges = jax_rmat_graph(N, pagerank_interop.EDGES, seed=42)
    g = jax_partition_graph(edges, N, procs)
    shard = {k: jnp.asarray(getattr(g, k)) for k in
             ("row_ids", "col_ext", "vals", "pack_idx", "dangling")}

    def host_analytics(args):
        local_nnz = jnp.sum((args["vals"] > 0).astype(jnp.int32))

        def spmd(ctx, s, p, a):
            local = {k: v.reshape(v.shape[1:]) for k, v in a.items()}
            return jax_pagerank_spmd(ctx, g, local, tol=1e-7, max_iter=150)

        r, iters, res = jlpf.hook(("x",), spmd, args)
        return r, iters[None], local_nnz[None]

    fn = jax.jit(compat.shard_map(
        host_analytics, mesh=mesh8, in_specs=({k: P("x") for k in shard},),
        out_specs=(P("x"), P(), P("x")), check_vma=False))
    r, iters, nnz = fn(shard)
    return (np.asarray(r).reshape(-1), int(iters[0]),
            np.asarray(nnz).tolist())


def test_pagerank_interop_matches_jax(mesh8):
    jr, jiters, jnnz = jax_pagerank_interop(mesh8)
    res = pagerank_interop.run(device="cpu")
    assert res["iterations"] == jiters == 13
    assert res["nnz_per_process"] == jnnz == [554, 221, 228, 78, 220, 79,
                                              89, 31]
    assert np.abs(res["ranks"] - jr).max() < 1e-6
    assert res["rel_err"] < 1e-3 and abs(res["mass"] - 1.0) < 1e-5
    assert res["top5"] == [int(v) for v in np.argsort(-jr)[:5]]


# --------------------------------------------------------------------------
# train_lm
# --------------------------------------------------------------------------

def lm_cfgs():
    kw = dict(compute_dtype="float32")
    return (dataclasses.replace(jax_get_config(train_lm.ARCH, smoke=True),
                                **kw),
            dataclasses.replace(get_config(train_lm.ARCH, smoke=True), **kw))


def test_train_lm_matches_jax_example_step(tmp_path, monkeypatch):
    jcfg, cfg = lm_cfgs()
    monkeypatch.setattr(train_lm, "get_config", lambda arch, smoke: cfg)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    jopt = jax_adamw_init(jparams)
    # the port's run resumes from JAX's initial weights as step 0: the
    # JAX tree's leaves copied by name into the port's own structure
    # (a checkpoint's leaves are in the order of the port's tree)
    jtree = dict(_flatten((
        params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu",
                        trainable=True),
        opt_state_from_jax(jax.tree.map(np.asarray, jopt), device="cpu"))))
    state = train_lm.build(LM_STEPS, "cpu")[0].init_fn(0)
    with torch.no_grad():
        for name, leaf in _flatten(state):
            if isinstance(leaf, torch.Tensor):
                leaf.copy_(jtree[name])
    save(str(tmp_path), 0, state)
    res = train_lm.run(LM_STEPS, str(tmp_path), device="cpu",
                       ckpt_every=100, log=None)
    assert res["start"] == 0 and len(res["losses"]) == LM_STEPS
    # JAX's example step, built as examples/train_lm.py builds it
    jts = jax_build_train_step(
        jcfg, jax_make_mesh(train_lm.MESH, ("data", "model")),
        opt_cfg=JaxAdamWConfig(lr=jax_warmup_cosine(
            train_lm.PEAK_LR, train_lm.WARMUP, LM_STEPS)))
    jstream = JaxStream(JaxDataConfig(vocab=jcfg.vocab,
                                      seq_len=train_lm.SEQ,
                                      global_batch=train_lm.BATCH, seed=0),
                        jcfg)
    for step, loss in enumerate(res["losses"]):
        jparams, jopt, jm = jts.step_fn(
            jparams, jopt, {k: jnp.asarray(v)
                            for k, v in jstream.batch(step).items()})
        want = float(jm["loss"])
        assert abs(loss - want) < LM_LOSS_BAR * abs(want), (step, loss,
                                                            want)


def test_train_lm_resume_is_bitexact(tmp_path):
    """A run stopped after step 3 leaves its checkpoints up to step 3; a
    restart to the same ``--steps`` (the schedule spans them) resumes
    there and trains as the uninterrupted run did, bit for bit."""
    full = train_lm.run(6, str(tmp_path), device="cpu", ckpt_every=3,
                        log=None)
    shutil.rmtree(tmp_path / "step_6")
    assert sorted(p.name for p in tmp_path.glob("step_*")) == ["step_3"]
    again = train_lm.run(6, str(tmp_path), device="cpu", ckpt_every=3,
                         log=None)
    assert (full["start"], again["start"]) == (0, 3)
    assert again["losses"] == full["losses"][3:]
    for a, b in zip(full["params"].parameters(),
                    again["params"].parameters()):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# the command lines
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mod,argv,expect", [
    (quickstart, ["1024", "512"], "global error code: 0 (OK)"),
    (quickstart, ["0", "512"], "global error code: 1 (ILLEGAL_INPUT)"),
    (fft_spectral, [], "ledger h-relation:             28672 bytes"),
    (pagerank_interop, [], "13 iterations"),
    (train_lm, ["--steps", "20"], "loss: ")])
def test_main_runs_on_cpu(mod, argv, expect, tmp_path, capsys):
    if mod is train_lm:
        argv = argv + ["--ckpt", str(tmp_path)]
    assert mod.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert expect in out
    if mod is quickstart:
        assert "predicted costs on h100_sxm" in out


@pytest.mark.parametrize("mod", [quickstart, fft_spectral, pagerank_interop,
                                 train_lm])
def test_main_refuses_cuda_without_a_card(mod, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the examples run on it")
    argv = ["--ckpt", str(tmp_path)] if mod is train_lm else []
    with pytest.raises(tlpf.LPFFatalError, match="cuda"):
        mod.main(argv)
