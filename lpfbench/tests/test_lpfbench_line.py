"""A whole run on the CPU but for the look for a card: the last line has
exactly the contract's keys, and nothing forbidden is imported."""

import json
import subprocess
import sys

import pytest

from lpfbench import harness
from lpfbench_tiny import fft_cell, line, train_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_fft_line_has_the_contract_keys_and_is_correct():
    out = line(fft_cell())
    assert list(out) == KEYS          # ``checks`` comes last
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert set(out["metrics"]) == {"setup_s", "fft_ms", "fft_p95_ms",
                                   "peak_mem_gib"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_train_line_is_correct():
    out = line(train_cell(), seconds=0.5)
    assert list(out) == KEYS and out["correct"] is True
    assert set(out["metrics"]) == {"setup_s", "train_tokens_per_s",
                                   "peak_mem_gib"}
    assert set(out["checks"]) == {"loss_gap", "grad_err", "change_gap"}


def test_a_traced_run_with_no_device_time_gives_no_result():
    with pytest.raises(harness.BenchError, match="no device time"):
        line(fft_cell(), trace=1)


RUN = """
import sys, json
sys.path[:0] = [{root!r}, {src!r}]
from lpfbench_tiny import fft_cell, train_cell, line
from lpfbench import harness
line(fft_cell()); line(train_cell(), seconds=0.1)
print(json.dumps(sorted(harness.forbidden_modules())))
"""

REF = """
import sys, json
sys.path[:0] = [{root!r}]
import lpfbench.reference.fft, lpfbench.reference.granite
import lpfbench.counts.fft, lpfbench.counts.flash, lpfbench.counts.model
tops = {{m.split(".")[0] for m in sys.modules}}
print(json.dumps(sorted(t for t in tops if t in
      ("jax", "jaxlib", "flax", "repro", "repro_torch"))))
"""


def _child(code):
    here = str(harness.PKG / "tests")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=here, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_imports_neither_jax_nor_the_jax_package():
    assert _child(RUN.format(root=str(harness.ROOT),
                             src=str(harness.ROOT / "src"))) == []


def test_the_reference_imports_nothing_of_either_package():
    assert _child(REF.format(root=str(harness.ROOT))) == []


def test_without_the_program_a_run_exits_nonzero(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files
    gives no result."""
    import shutil
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.PKG, tmp_path / "lpfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "lpfbench", "--workload", "fft-n2e26-p8",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "src/repro_torch" in out.stderr
