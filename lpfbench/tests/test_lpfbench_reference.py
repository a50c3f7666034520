"""Each plain reference agrees with the port at a tiny size on the CPU."""

import numpy as np
import pytest
import torch

from lpfbench.drivers import train as train_driver
from lpfbench.reference import fft as fft_ref
from lpfbench.reference import granite as granite_ref
from lpfbench.reference import training

from lpfbench_tiny import smoke_cell


@pytest.mark.parametrize("n", [1 << 10, 1 << 14])
def test_fft_reference_agrees_with_bsp_fft(n):
    from repro_torch.algorithms import bsp_fft
    g = torch.Generator().manual_seed(n)
    x = torch.complex(torch.randn(n, generator=g), torch.randn(n, generator=g))
    got = fft_ref.compare(bsp_fft(x, p=8, use_kernel=True, device="cpu"),
                          fft_ref.fft_reference(x))
    assert got["rel_l2"] < 1e-6 and got["max_err"] < 1e-5
    want = np.fft.fft(x.numpy().astype(np.complex128))
    assert np.abs(fft_ref.fft_reference(x).numpy() - want).max() < 1e-9


@pytest.mark.parametrize("n", [1 << 6, 1 << 12, 1 << 19])
def test_fft_by_products_in_f32_is_the_transform(n):
    x = torch.view_as_complex(torch.randn(n, 2, generator=torch.Generator()
                                          .manual_seed(1)))
    got = fft_ref.compare(fft_ref.fft_matmul(x, tf32=False),
                          fft_ref.fft_reference(x))
    assert got["rel_l2"] < 1e-6 and got["max_err"] < 1e-5


def test_granite_reference_follows_the_port_in_f32():
    """The port in float32 compute (reference attention) and the plain
    reference take the same three steps: losses, first gradients and
    changes agree to float32 rounding."""
    torch.manual_seed(0)
    cell = smoke_cell(compute_dtype="float32", attn_impl="reference")
    dev = torch.device("cpu")
    m = cell.config["model"]
    pool = train_driver.token_pool(5, cell.traffic, m["vocab_size"], dev)
    ts, params, opt = train_driver.build(cell, 5, dev)
    _, _, got = train_driver.step_readings(cell, 5, ts, params, opt, pool, 3)
    want = train_driver.reference_readings(cell, 5, pool, 3, dev)
    gaps = train_driver.gaps(got, want)
    assert gaps["loss_gap"] < 1e-5
    assert gaps["grad_gap"] < 1e-4
    assert gaps["change_gap"] < 1e-3


def test_granite_weights_are_made_from_the_seed_alone():
    m = smoke_cell().config["model"]
    specs = granite_ref.param_specs(m)
    a = training.make_params(7, specs, "cpu")
    i = [s[0] for s in specs].index("dec_body.b0.moe.w_gate")
    assert torch.equal(a["dec_body.b0.moe.w_gate"],
                       training.make_leaf(7, i, specs[i], "cpu"))
    assert not torch.equal(a["embed"], training.make_params(8, specs, "cpu")
                           ["embed"])
    assert float(a["dec_body.b0.ln1.w"].abs().max()) == 0.0


def test_the_configuration_names_its_reference():
    """The train driver takes the reference module the configuration
    names, and that module reads the port's config back under the file's
    keys, ``run_as`` included."""
    cell = smoke_cell()
    ref = train_driver.reference_of(cell.config)
    assert ref is granite_ref
    cfg = train_driver.program_config(cell.config)
    assert ref.port_sizes(cfg).items() <= train_driver.sizes(
        cell.config).items()


def test_expert_load_reads_each_block():
    """The expert load of the cell's batches, through the program's own
    ``expert_load``: one reading a layer and batch, every routed token
    counted."""
    from lpfbench import expert_load
    cell = smoke_cell()
    got = expert_load.read(cell, 3, 2, torch.device("cpu"))
    assert got["blocks"] == 2 * 2
    T = cell.traffic["batch"] * cell.traffic["seq"]
    assert got["mean_load"] == pytest.approx(T * 2 / 6)
    assert 0.0 <= got["dropped_share_least_layer"] <= got["dropped_share"] \
        <= got["dropped_share_largest_layer"] < 1.0
    assert got["fullest_over_mean"] >= 1.0
