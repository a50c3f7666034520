"""A traced window's ops of a profiler range, forward and backward: the
autograd nodes of the range's ops belong to it, a remat recompute of code
outside the range does not."""

import time

import torch
from torch.utils import checkpoint as ckpt

from lpfbench import harness
from lpfbench_tiny import smoke_cell


def _block(x, w):
    with torch.profiler.record_function("block"):
        y = (x @ w).relu()
        out = torch.zeros_like(y)
        for e in range(3):
            out.index_add_(0, torch.arange(2), y[e:e + 2])
        return out


def _layer(x, w, w2):
    h = (x @ w2).tanh()
    return h + _block(h, w)


def _traced(fn):
    with harness.Window(time.perf_counter(), 60.0, torch.device("cpu"),
                        trace=True) as w:
        fn()
    return w.profile


def test_range_ops_hold_the_backward_and_leave_out_the_recompute():
    g = torch.Generator().manual_seed(0)
    x, w, w2 = (torch.randn(*s, generator=g, requires_grad=True)
                for s in ((8, 16), (16, 16), (16, 16)))

    def step():
        ckpt.checkpoint(_layer, x, w, w2, use_reentrant=False).sum() \
            .backward()
    prof = _traced(step)
    names = [e.name for e in prof.range_ops("block")]
    nodes = [n.rsplit(" ", 1)[1] for n in names
             if n.startswith("autograd::engine::evaluate_function")]
    assert sorted(set(nodes)) == ["IndexAddBackward0", "MmBackward0",
                                  "ReluBackward0", "SliceBackward0"]
    assert nodes.count("IndexAddBackward0") == 3
    # the block's forward and its recompute
    assert names.count("block") == 2 and names.count("aten::index_add_") == 6
    # the layer's own op, forward, backward or recomputed, is not the block's
    assert "aten::tanh" not in names and "aten::tanh_backward" not in names
    assert not any("AddBackward0" == n for n in nodes)


def test_moe_range_ties_the_ports_backward_nodes():
    """The port's MoE block under a training step: its autograd nodes are
    found through the range of ``moe_single``."""
    from lpfbench.drivers import train as train_driver
    cell = smoke_cell(compute_dtype="float32")
    dev = torch.device("cpu")
    pool = train_driver.token_pool(3, cell.traffic, 512, dev)
    ts, params, opt = train_driver.build(cell, 3, dev)
    prof = _traced(lambda: ts.step_fn(params, opt,
                                      train_driver.batch_of(pool, 0)))
    names = [e.name for e in prof.range_ops("moe_single")]
    assert any(n.endswith("IndexAddBackward0") for n in names)
    assert not any(n.endswith("EmbeddingBackward0") for n in names)
