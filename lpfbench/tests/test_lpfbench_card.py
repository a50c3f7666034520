"""The controls on the card, at sizes a test run holds: the program's
run is correct and the control, the reference one precision below the
configuration's, is not.  ``gpu``: they skip without a card."""

import pytest

from lpfbench import harness
from lpfbench.drivers import bsp_fft as fft_driver
from lpfbench_tiny import fft_cell, line

pytestmark = pytest.mark.gpu


def test_fft_program_passes_and_tf32_control_fails(card):
    cell = fft_cell(n=1 << 22)
    assert line(cell, seconds=1.0, device=card)["correct"] is True
    for seed in (1, 2, 3):
        got = fft_driver.control(cell, seed, card)
        ok, _ = harness.judge(got, cell.limits)
        assert not ok, got
        # the same products in float32 pass: the precision fails it
        ok32, _ = harness.judge(fft_driver.control(cell, seed, card, "f32"),
                                cell.limits)
        assert ok32


def test_granite_fp8_control_fails_on_the_card(card):
    """The reference in fp8 in the program's place, at the cell's own
    size, on the seeds its limits were read from: each fails a limit."""
    from lpfbench.drivers import train as train_driver
    cell = harness.load_cell("granite-train-b2s4096")
    for seed in (201, 202, 203):
        got = train_driver.control(cell, seed, card, "control")
        got.pop("detail")
        for k in train_driver.NOT_COMPARED:
            got.pop(k)
        ok, _ = harness.judge(got, cell.limits)
        assert not ok, got
