"""The port stands alone and hides neither the device nor the kernel.

* ``src/repro_torch`` and ``chip_smoke.py`` import neither ``jax`` nor
  the JAX package ``repro`` (an AST scan, and a fresh interpreter that
  imports the whole port and finds no ``jax`` loaded);
* entry points asked for no device run on the card: without one they
  raise, they never carry on on the CPU;
* a CPU tensor takes the plain version and launches nothing; the CUDA
  wrapper refuses a CPU tensor, and a missing ``nvcc`` raises instead of
  falling back.
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

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


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
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.interop, "
            "repro_torch.algorithms, repro_torch.kernels.build, "
            "repro_torch.kernels.fft_stage.ops; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); "
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


def test_cpu_tensor_takes_the_plain_version():
    fft_kernel.fft_planes.launches = 0
    fft_kernel.fft_planes.cuda_launches = 0
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
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "TOOLKIT_NVCC", Path("/nonexistent/nvcc"))
    with pytest.raises(tlpf.LPFFatalError, match="nvcc not found"):
        build.find_nvcc()
