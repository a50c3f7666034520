"""``BENCHMARK.json`` against the contract's shape, and the harness
finding every cell's files by the names it gives."""

import json
import re

import pytest

from lpfbench import harness

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["lpfbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_and_units():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])


@pytest.mark.parametrize("w", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(w):
    cell = harness.load_cell(w)
    assert cell.chips == 1
    assert harness.driver_of(cell).run
    e2e = {m["name"] for m in cell.end_to_end()}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = cell.per_layer()
    assert layers
    for m in layers:
        assert m["moves"] in e2e
        assert callable(harness.metric_reader(m["name"]))
    assert set(cell.limits) and all(v > 0 for v in cell.limits.values())


def test_every_metric_has_a_reader_and_every_config_a_cell():
    for m in SPEC["per_layer"]:
        assert (harness.PKG / "metrics" / f"{m['name']}.py").is_file()
        assert m["workloads"]
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        conf = json.loads((harness.ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]


def test_forbidden_modules_compares_whole_names():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.core",
                                      "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(["repro.core", "jax.numpy", "flax"]) \
        == ["flax", "jax", "repro"]
