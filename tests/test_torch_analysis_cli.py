"""``python -m repro_torch.analysis`` against ``python -m repro.analysis``.

* Exit codes: 0 on every canned trace (lint, optimize, re-lint, verify),
  on ``--record-cache`` and on the ``--cache-dir`` audit of what it
  recorded; 1 on a corrupted entry and on a cost diff that misses an
  entry; a usage error without a cache mode.
* Priced on the JAX package's TPU v5e table (given to the port as data,
  through ``interop.hardware_from_fields``), ``--record-cache`` and
  ``--cache-dir`` dump the same entry filenames and the same costs as
  the JAX package's CLI, and the JAX package's committed cost baseline
  diffs clean against the port's dump.
* By default the port prices on its own machine, the ``"vp"`` link of
  8 virtual processes on one H100 (not the TPU table).
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys

import pytest

from repro.analysis import __main__ as jcli
from repro.core import machine as jmachine
from repro_torch import core as tlpf
from repro_torch.analysis import __main__ as tcli
from repro_torch.analysis.traces import CANNED_TRACES
from repro_torch.interop import hardware_from_fields

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPU_DCN = tlpf.probe({"pod": 8}, hardware_from_fields(
    dataclasses.asdict(jmachine.TPU_V5E)))


def test_port_machine_is_the_h100_vp_link():
    assert tcli.MACHINE == tlpf.probe({"vp": 8}, tlpf.H100_SXM)
    assert (TPU_DCN.g, TPU_DCN.l, TPU_DCN.r) == \
        (jcli.DCN.g, jcli.DCN.l, jcli.DCN.r)


@pytest.mark.parametrize("name", [None, *sorted(CANNED_TRACES)])
def test_every_canned_trace_verifies(name, capsys):
    argv = [] if name is None else [name]
    assert tcli.main(argv) == 0
    out = capsys.readouterr().out
    for trace in ([name] if name else CANNED_TRACES):
        assert f"== {trace}:" in out
    assert "verified:" in out


@pytest.mark.parametrize("machine", ["port", "tpu"])
def test_record_and_audit_dump_jax_equal_costs(machine, tmp_path, capsys):
    """The same canned traces recorded by both CLIs on the TPU table:
    equal filenames and costs in both dumps.  On the port's own machine
    every entry still records and audits clean."""
    m = TPU_DCN if machine == "tpu" else None
    tdir, tcosts = str(tmp_path / "t"), str(tmp_path / "t.json")
    assert tcli.main(["--record-cache", tdir, "--dump-costs", tcosts],
                     machine=m) == 0
    assert tcli.main(["--cache-dir", tdir, "--diff-costs", tcosts],
                     machine=m) == 0
    assert "4 entries, 4 verified, 0 bad" in capsys.readouterr().out
    with open(tcosts) as fh:
        tdump = json.load(fh)
    assert len(tdump) == 4
    assert all(c["predicted_us"] > 0 for c in tdump.values())
    if machine == "port":
        return
    jdir, jcosts = str(tmp_path / "j"), str(tmp_path / "j.json")
    assert jcli.main(["--record-cache", jdir, "--dump-costs", jcosts]) == 0
    with open(jcosts) as fh:
        jdump = json.load(fh)
    assert tdump == jdump
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    # the audits' dumps (costs priced from what is on disk) agree too
    ta, ja = str(tmp_path / "ta.json"), str(tmp_path / "ja.json")
    assert tcli.main(["--cache-dir", tdir, "--dump-costs", ta],
                     machine=m) == 0
    assert jcli.main(["--cache-dir", jdir, "--dump-costs", ja]) == 0
    with open(ta) as f1, open(ja) as f2:
        assert json.load(f1) == json.load(f2)
    # the JAX package's committed TPU baseline diffs clean against it
    baseline = os.path.join(ROOT, "benchmarks", "CACHE_COSTS_baseline.json")
    assert tcli.main(["--cache-dir", tdir, "--diff-costs", baseline],
                     machine=m) == 0


def test_audit_fails_on_corruption_and_missing_entries(tmp_path, capsys):
    cache_dir = str(tmp_path / "cache")
    costs = str(tmp_path / "costs.json")
    assert tcli.main(["--record-cache", cache_dir, "--dump-costs", costs,
                      "pagerank", "fft_redistribute"]) == 0
    assert tcli.main(["--cache-dir", cache_dir, "--diff-costs", costs]) == 0
    assert "2 entries, 2 verified, 0 bad" in capsys.readouterr().out
    victim = sorted(os.listdir(cache_dir))[0]
    path = os.path.join(cache_dir, victim)
    blob = bytearray(open(path, "rb").read())
    blob[-3] ^= 0x40
    open(path, "wb").write(bytes(blob))
    assert tcli.main(["--cache-dir", cache_dir]) == 1
    assert "INVALID" in capsys.readouterr().out
    os.remove(path)
    assert tcli.main(["--cache-dir", cache_dir, "--diff-costs", costs]) == 1
    assert "MISSING" in capsys.readouterr().out


def test_jax_entries_audit_invalid_in_the_port(tmp_path, capsys):
    jdir = str(tmp_path / "j")
    assert jcli.main(["--record-cache", jdir, "pagerank"]) == 0
    assert tcli.main(["--cache-dir", jdir]) == 1
    assert "torch version skew" in capsys.readouterr().out


def test_pickled_trace_and_usage_errors(tmp_path, capsys):
    p, _slots, steps, scratch = CANNED_TRACES["pagerank"]()
    path = str(tmp_path / "trace.pkl")
    with open(path, "wb") as fh:
        pickle.dump((p, steps), fh)
    assert tcli.main(["--pickle", path]) == 0
    assert f"== {path}:" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        tcli.main(["--dump-costs", str(tmp_path / "x.json")])
    with pytest.raises(SystemExit):
        tcli.main(["no_such_trace"])


def test_module_entry_point_exits_zero():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           "pagerank"], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "verified:" in proc.stdout
