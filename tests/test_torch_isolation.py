"""The port stands alone and hides neither the device nor the kernel.

* ``src/repro_torch`` and ``chip_smoke.py`` import neither ``jax`` nor
  the JAX package ``repro`` (an AST scan, and a fresh interpreter that
  imports the whole port and finds no ``jax`` loaded);
* entry points asked for no device run on the card: without one they
  raise, they never carry on on the CPU (the LPF core, the FFT, the
  serving path: ``init_params``, ``prefill``, ``decode_step``,
  ``build_serve_buckets``, ``ModelDecodeEngine``, the serve launcher; and
  the training path: ``loss_fn``, ``build_train_step`` (also over a
  pod mesh), the train launcher (also with ``--mesh 2x1x1``), the interop loaders, a checkpoint restore; and PageRank:
  ``lpf_pagerank``, ``dataflow_pagerank``, the sparse oracle and
  ``shard_tensors``);
* a CPU tensor takes the plain version and launches nothing; the CUDA
  wrapper refuses a CPU tensor, and a missing ``nvcc`` raises instead of
  falling back; on a CPU context ``compile_program`` is the plain
  version of compiled replay and captures no CUDA graph.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import core as tlpf
from repro_torch.algorithms import bsp_fft
from repro_torch.kernels import build
from repro_torch.kernels.fft_stage import kernel as fft_kernel
from repro_torch.kernels.fft_stage import ops as fft_ops
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops

ROOT = Path(__file__).resolve().parents[1]
PORT_ROOT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT_ROOT.rglob("*.py")) + [ROOT / "chip_smoke.py"] \
    + sorted((ROOT / "scripts").glob("*.py"))
#: every module of the port, found by walking the tree
PORT_MODULES = sorted(
    ".".join(("repro_torch",) + p.relative_to(PORT_ROOT).with_suffix("")
             .parts).removesuffix(".__init__")
    for p in PORT_ROOT.rglob("*.py"))


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_fresh_interpreter_loads_no_jax():
    assert "repro_torch.launch.serve" in PORT_MODULES
    assert {"repro_torch.launch.train", "repro_torch.runtime.train_loop",
            "repro_torch.optim.adamw", "repro_torch.data.pipeline",
            "repro_torch.checkpoint.store"} <= set(PORT_MODULES)
    assert "repro_torch.kernels.flash_attention.kernel" in PORT_MODULES
    assert {"repro_torch.bsp", "repro_torch.bsp.collectives",
            "repro_torch.algorithms.graphs",
            "repro_torch.algorithms.pagerank"} <= set(PORT_MODULES)
    assert {"repro_torch.models.moe", "repro_torch.configs.granite_moe_3b",
            "repro_torch.configs.jamba_v01_52b"} <= set(PORT_MODULES)
    assert {"repro_torch.configs.deepseek_v3_671b",
            "repro_torch.configs.llava_next_mistral_7b",
            "repro_torch.configs.whisper_base"} <= set(PORT_MODULES)
    assert {"repro_torch.core.persist", "repro_torch.runtime.faults",
            "repro_torch.analysis.__main__", "repro_torch.optim.adafactor",
            "repro_torch.optim.compress"} <= set(PORT_MODULES)
    assert ROOT / "scripts" / "warm_start.py" in PORT_FILES
    assert {"repro_torch.bsp.pod_sync", "repro_torch.bsp.grad_sync",
            "repro_torch.launch.mesh"} <= set(PORT_MODULES)
    assert ROOT / "scripts" / "program_replay.py" in PORT_FILES
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad)\n"
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_points_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")
    x = torch.zeros(64, dtype=torch.complex64)
    with pytest.raises(tlpf.LPFFatalError, match="cuda"):
        tlpf.exec_(8, lambda ctx, s, p, a: None)
    with pytest.raises(tlpf.LPFFatalError, match="cuda"):
        bsp_fft(x, p=8)
    with pytest.raises(tlpf.LPFFatalError, match="cuda"):
        tlpf.LPFContext(4)
    assert bsp_fft(x, p=8, device="cpu").device.type == "cpu"


def test_pagerank_entry_points_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")
    from repro_torch.algorithms import (banded_graph, dataflow_pagerank,
                                        lpf_pagerank, partition_graph,
                                        shard_tensors,
                                        sparse_reference_pagerank)
    edges = banded_graph(16, 2)
    g = partition_graph(edges, 16, 4)
    calls = [
        lambda: lpf_pagerank(4, g),
        lambda: dataflow_pagerank(edges, 16, iters=1),
        lambda: sparse_reference_pagerank(edges, 16),
        lambda: shard_tensors(g),
    ]
    for call in calls:
        with pytest.raises(tlpf.LPFFatalError, match="cuda"):
            call()
    assert lpf_pagerank(4, g, device="cpu")[0].device.type == "cpu"


def test_serving_entry_points_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import (Runtime, decode_step, init_caches,
                                    init_params, prefill)
    from repro_torch.runtime.train_step import build_serve_buckets
    cfg = get_config("llama3.2-1b", smoke=True)
    params = init_params(0, cfg, device="cpu")
    caches = init_caches(cfg, 1, 4, device="cpu")
    calls = [
        lambda: init_params(0, cfg),
        lambda: init_caches(cfg, 1, 4),
        lambda: Runtime(),
        lambda: prefill(params, {"tokens": [[1, 2]]}, cfg),
        lambda: decode_step(params, [1], caches, 0, cfg),
        lambda: build_serve_buckets(cfg, [(1, 8)]),
        lambda: serve.ModelDecodeEngine(cfg, [(1, 8)]),
        lambda: serve.main(["--requests", "1"]),
    ]
    for call in calls:
        with pytest.raises(tlpf.LPFFatalError, match="cuda"):
            call()
    assert prefill(params, {"tokens": [[1, 2]]}, cfg,
                   Runtime("cpu")).device.type == "cpu"


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "jamba-v0.1-52b"])
def test_moe_models_refuse_without_a_card(arch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, train
    from repro_torch.models import load_params, prefill
    from repro_torch.runtime.train_step import build_train_step
    cfg = get_config(arch, smoke=True)
    params = load_params(0, cfg, device="cpu")
    for call in (lambda: load_params(0, cfg),
                 lambda: prefill(params, {"tokens": [[1, 2]]}, cfg),
                 lambda: build_train_step(cfg),
                 lambda: serve.main(["--arch", arch, "--requests", "1"]),
                 lambda: train.main(["--arch", arch, "--steps", "1"])):
        with pytest.raises(tlpf.LPFFatalError, match="cuda"):
            call()


def test_loading_and_program_engine_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")
    from repro_torch.configs import get_config
    from repro_torch.models import load_params
    from repro_torch.runtime.server import ProgramDecodeEngine
    cfg = get_config("gemma2-9b", smoke=True)
    for call in (lambda: load_params(0, cfg),
                 lambda: ProgramDecodeEngine(buckets=((2, 8),))):
        with pytest.raises(tlpf.LPFFatalError, match="cuda"):
            call()
    assert ProgramDecodeEngine(buckets=((2, 8),),
                               device="cpu").device.type == "cpu"


def test_training_entry_points_refuse_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")
    import numpy as np
    from repro_torch.checkpoint import restore, save
    from repro_torch.configs import get_config
    from repro_torch.interop import opt_state_from_jax, params_from_jax
    from repro_torch.launch import train
    from repro_torch.models import init_params, loss_fn
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.train_step import build_train_step
    cfg = get_config("llama3.2-1b", smoke=True)
    params = init_params(0, cfg, device="cpu", trainable=True)
    batch = {"tokens": [[1, 2]], "labels": [[2, -1]]}
    meta = init_params(0, cfg, device="meta")
    save(str(tmp_path), 1, params)
    calls = [
        lambda: init_params(0, cfg, trainable=True),
        lambda: loss_fn(params, batch, cfg),
        lambda: build_train_step(cfg),
        lambda: build_train_step(cfg, make_mesh((2, 1, 1)), grad_sync="lpf"),
        lambda: train.main(["--steps", "1"]),
        lambda: train.main(["--steps", "1", "--mesh", "2x1x1",
                            "--grad-sync", "lpf"]),
        lambda: params_from_jax({"w": np.zeros(2, np.float32)}),
        lambda: opt_state_from_jax({"m": {}, "v": {}, "step": 0}),
        lambda: restore(str(tmp_path), 1, meta, device="cuda"),
    ]
    for call in calls:
        with pytest.raises(tlpf.LPFFatalError, match="cuda"):
            call()
    assert build_train_step(cfg, device="cpu").rt.device.type == "cpu"


def test_cpu_tensor_takes_the_plain_version():
    fft_kernel.fft_planes.launches = 0
    fft_kernel.fft_planes.cuda_launches = 0
    fa_kernel.flash_attention_fwd.launches = 0
    q = torch.randn(1, 4, 16, 32)
    fa_ops.flash_attention(q, q[:, :2], q[:, :2])
    assert fa_kernel.flash_attention_fwd.launches == 0
    x = torch.randn(4, 256, dtype=torch.complex64)
    fft_ops.fft(x)
    fft_ops.ifft(x)
    bsp_fft(torch.zeros(1024, dtype=torch.complex64), p=8, use_kernel=True,
            device="cpu")
    assert fft_kernel.fft_planes.launches == 0
    assert fft_kernel.fft_planes.cuda_launches == 0


def test_cuda_wrapper_never_falls_back(monkeypatch):
    with pytest.raises(tlpf.LPFFatalError, match="CUDA tensor"):
        fft_kernel.fft_planes(torch.zeros(2, 8, dtype=torch.complex64))
    q = torch.zeros(1, 2, 8, 32)
    with pytest.raises(tlpf.LPFFatalError, match="CUDA tensors"):
        fa_kernel.flash_attention_fwd(q, q, q)
    # a gradient on CPU tensors comes from the plain backward, never a
    # kernel; the backward wrapper refuses CPU tensors
    fa_kernel.flash_attention_bwd_dkv.launches = 0
    fa_kernel.flash_attention_bwd_dq.launches = 0
    qg = q.clone().requires_grad_()
    fa_ops.flash_attention(qg, q, q).sum().backward()
    assert qg.grad is not None
    assert (fa_kernel.flash_attention_bwd_dkv.launches,
            fa_kernel.flash_attention_bwd_dq.launches) == (0, 0)
    lse = torch.zeros(1, 2, 8, 1)
    with pytest.raises(tlpf.LPFFatalError, match="CUDA tensors"):
        fa_kernel.flash_attention_bwd(q, q, q, q, q, lse)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "TOOLKIT_NVCC", Path("/nonexistent/nvcc"))
    with pytest.raises(tlpf.LPFFatalError, match="nvcc not found"):
        build.find_nvcc()


def test_cpu_context_compiles_programs_without_capture(monkeypatch):
    """On a CPU context a flushed program runs as ``compile_program``'s
    plain version — the schedule over a ``ValueStore`` — every call: no
    CUDA graph is built or replayed."""
    from repro_torch.analysis import traces

    def no_graph(*a, **k):
        raise AssertionError("a CUDA graph was built on a CPU context")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", no_graph)
    p, slots, steps, scratch = traces.canned_bucketed_trace(p=4, w=8)
    pc = tlpf.ProgramCache()
    ctx = tlpf.LPFContext(p, device="cpu", program_cache=pc)
    assert ctx.compile_programs
    run, reset, handles, _ = traces.bind_trace(
        ctx, slots, steps, scratch,
        {s.sid: torch.ones(p, s.size, dtype=torch.int32) for s in slots})
    for _ in range(3):
        reset()
        run()
    (cp,) = pc.artifacts()
    assert cp.device.type == "cpu" and not cp.captured
    assert (cp.n_calls, cp.n_replays) == (3, 0)
    assert ctx.loop_graph_replays == 0


@pytest.mark.parametrize("module", ["core/faultpoints.py",
                                    "runtime/faults.py"])
def test_fault_modules_import_only_the_stdlib_at_module_level(module):
    """Arming a plan (a root context reading ``LPF_FAULT_PLAN``) must not
    drag in the heavy stack: the fault modules' top-level imports are the
    standard library and ``faultpoints``; the harness imports torch and
    the port inside its functions."""
    tree = ast.parse((PORT_ROOT / module).read_text())
    for node in tree.body:
        if isinstance(node, ast.Import):
            for a in node.names:
                assert a.name.split(".")[0] in sys.stdlib_module_names, a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                assert node.module == "__future__" or \
                    node.module.split(".")[0] in sys.stdlib_module_names, \
                    node.module
            else:
                assert (node.module or "").endswith("faultpoints") or \
                    [a.name for a in node.names] == ["faultpoints"], \
                    node.module
