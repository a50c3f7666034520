"""Cells of ``BENCHMARK.json`` cut to sizes the CPU runs in seconds,
for the tests (the same files, a few sizes changed)."""

import argparse
import time

from lpfbench import harness, run

GRANITE_SMOKE = dict(hidden_size=128, num_hidden_layers=2,
                     num_attention_heads=4, num_key_value_heads=2,
                     head_dim=32, intermediate_size=64, num_local_experts=6,
                     num_experts_per_tok=2, vocab_size=512)


def fft_cell(n=4096):
    cell = harness.load_cell("fft-n2e26-p8")
    cell.config = dict(cell.config, n=n)
    return cell


def smoke_cell(**program_overrides):
    """granite's cell on the port's smoke config (d 128, 2 layers)."""
    cell = harness.load_cell("granite-train-b2s4096")
    prog = dict(cell.config["program"], smoke=True)
    prog["overrides"] = dict(prog["overrides"], **program_overrides)
    cell.config = dict(cell.config, program=prog,
                       model=dict(cell.config["model"], **GRANITE_SMOKE))
    cell.traffic = dict(cell.traffic, seq=64, pool=8)
    return cell


def train_cell():
    """granite's cell at its published widths cut to one layer holding 8
    experts, B 2 x S 256: the smallest size at which sound runs of the
    port meet the cell's own limits (the smoke config's bf16 rounding
    does not average out over its 128 tokens)."""
    cell = harness.load_cell("granite-train-b2s4096")
    cell.config = dict(
        cell.config, program=dict(cell.config["program"], layers=1,
                                  experts=8),
        model=dict(cell.config["model"], num_hidden_layers=1,
                   num_local_experts=8))
    cell.traffic = dict(cell.traffic, seq=256, pool=4)
    return cell


def line(cell, seed=2 ** 31 + 11, seconds=0.3, trace=0, device=None):
    """A whole run of ``cell`` on ``device`` (the CPU by default) but for
    the look for a card: its result line."""
    import torch
    args = argparse.Namespace(workload=cell.name, seed=seed,
                              seconds=seconds, trace=trace)
    return run.run(args, time.perf_counter(),
                   device=device or torch.device("cpu"), cell=cell)
