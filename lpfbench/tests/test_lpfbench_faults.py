"""Each fault a cell can have, planted in the program under a whole run
(on the CPU but for the look for a card), makes ``correct`` false; the
same run without it is correct."""

import pytest
import torch

from lpfbench_tiny import fft_cell, line, train_cell


def test_fft_sound_run_is_correct():
    assert line(fft_cell())["correct"] is True


def test_fft_exchange_left_out(monkeypatch):
    """The total exchanges between the virtual processes stage no
    message: each process keeps what it had."""
    from repro_torch.core.context import LPFContext
    monkeypatch.setattr(LPFContext, "put_msgs", lambda self, msgs: None)
    assert line(fft_cell())["correct"] is False


def test_fft_answer_altered_where_it_is_produced(monkeypatch):
    """One output value of each transform is off by its own size."""
    from repro_torch.algorithms import fft
    real = fft.bsp_fft_spmd

    def altered(*a, **k):
        y = real(*a, **k)
        y = y.clone()
        y[0, 0] = 2 * y[0, 0]
        return y
    monkeypatch.setattr(fft, "bsp_fft_spmd", altered)
    out = line(fft_cell())
    assert out["correct"] is False
    assert out["checks"]["max_err"]["value"] > \
        out["checks"]["max_err"]["limit"]


def test_fft_half_the_rows_left_out(monkeypatch):
    """The local FFT of half the processes' rows is left out."""
    from repro_torch.algorithms import fft
    real = fft._local_fft

    def half(x, use_kernel):
        y = real(x, use_kernel)
        y[y.shape[0] // 2:] = 0
        return y
    monkeypatch.setattr(fft, "_local_fft", half)
    assert line(fft_cell())["correct"] is False


def test_train_sound_run_is_correct():
    assert line(train_cell(), seconds=0.3)["correct"] is True


def test_train_step_returns_its_state_unchanged(monkeypatch):
    from repro_torch.runtime import train_step

    def frozen(grads, state, params, cfg, *, donate=False):
        return params, state, {"grad_norm": torch.zeros(()), "lr": 0.0}
    monkeypatch.setattr(train_step, "adamw_update", frozen)
    out = line(train_cell(), seconds=0.3)
    assert out["correct"] is False
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_train_half_the_batch_left_out(monkeypatch):
    """The loss is the mean over the first half of the batch's rows."""
    from repro_torch.runtime import train_step
    real = train_step.loss_fn

    def half(params, batch, cfg, rt=None):
        return real(params, {k: v[:v.shape[0] // 2] for k, v in
                             batch.items()}, cfg, rt)
    monkeypatch.setattr(train_step, "loss_fn", half)
    assert line(train_cell(), seconds=0.3)["correct"] is False
