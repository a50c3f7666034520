"""Build the port's CUDA sources (``repro_torch/csrc/*.cu``) at first use.

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with :mod:`ctypes`.  Libraries land in
``build/repro_torch/<name>-<hash>/`` at the repository root (a directory
``.gitignore`` lists), keyed by a hash of the source, the headers beside
it and the flags, so a changed source rebuilds and an unchanged one loads
the existing library.  Several sources build in parallel, one ``nvcc``
each, all started together.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

from ..core.errors import LPFFatalError

__all__ = ["NVCC_FLAGS", "BuildResult", "build", "load", "find_nvcc"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: where the CUDA toolkit puts nvcc when it is not on PATH
TOOLKIT_NVCC = Path("/usr/local/cuda/bin/nvcc")


@dataclasses.dataclass(frozen=True)
class BuildResult:
    name: str
    path: Path
    log: str            # nvcc/ptxas output (registers, spills, smem)


_LOADED: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and TOOLKIT_NVCC.exists():
        nvcc = str(TOOLKIT_NVCC)
    if nvcc is None:
        raise LPFFatalError(
            "nvcc not found: the port's CUDA kernels build from "
            "repro_torch/csrc at first use and need the CUDA toolkit")
    return nvcc


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}" / f"lib{name}.so"


def build(names: Sequence[str]) -> Dict[str, BuildResult]:
    """Build every named source that has no up-to-date library, one
    ``nvcc`` process per source, all started together."""
    targets = {n: _target(n) for n in names}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    results: Dict[str, BuildResult] = {
        n: BuildResult(n, t, (t.parent / "nvcc.log").read_text()
                       if (t.parent / "nvcc.log").exists() else "")
        for n, t in targets.items() if n not in todo}
    if not todo:
        return results
    nvcc = find_nvcc()
    procs = {}
    for n, t in todo.items():
        t.parent.mkdir(parents=True, exist_ok=True)
        tmp = t.with_name(f"{t.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, todo[n])
        (todo[n].parent / "nvcc.log").write_text(log)
        results[n] = BuildResult(n, todo[n], log)
    if failed:
        raise LPFFatalError("CUDA build failed: " + "\n".join(failed))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(build([name])[name].path))
    return lib
