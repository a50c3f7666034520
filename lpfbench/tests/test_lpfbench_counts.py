"""The copied counts give the hand-worked values."""

import json

import pytest

from lpfbench import harness
from lpfbench.counts import fft, flash, model


def test_fft_bound_of_one_2e26_transform():
    # 2 * 2^26 * 8 bytes at 3.35 TB/s: 0.3205 ms, over the 0.1202 ms of
    # 5 N log2 N flops at 67 TFLOP/s
    assert fft.transform_bound_ms(1 << 26) == pytest.approx(0.32051, 1e-4)
    assert fft.fft_bound_ms(1, 1 << 26)[1] == "bytes"
    assert fft.fft_bound_ms(8, 1 << 23)[0] == pytest.approx(0.32051, 1e-4)


def granite():
    return json.loads((harness.PKG / "configs" /
                       "granite-moe-3b-a800m.json").read_text())["model"]


def test_granite_active_parameters_match_the_port():
    from repro_torch.launch import one_card_config
    from repro_torch.models import count_params
    cfg = one_card_config("granite-moe-3b-a800m", smoke=False)
    got = model.param_counts(granite())
    assert got["total"] == count_params(cfg)
    assert got["active"] == count_params(cfg, active_only=True)
    assert 3.2e9 < got["total"] < 3.4e9 and 0.85e9 < got["active"] < 0.9e9


def test_granite_train_flops_are_6_n_active_tokens():
    n_active = model.param_counts(granite())["active"]
    assert model.train_flops(granite(), 2 * 4096) == 6 * n_active * 8192


def test_flash_bounds_at_the_cell_shape():
    pairs = 4096 * 4097 / 2
    assert flash.kept_pairs(4096, True) == pairs
    ms, kind = flash.flash_fwd_bound_ms(2, 24, 8, 4096, 64, True, None, 2)
    assert kind == "operations"
    assert ms == pytest.approx(4 * 2 * 24 * 64 * pairs / 989e12 * 1e3)
    bwd = flash.flash_bwd_bound_ms(2, 24, 8, 4096, 64, True, None, 2)
    assert bwd["dkv"][0] == pytest.approx(2 * ms)
    assert bwd["dq"][0] == pytest.approx(1.5 * ms)


def test_dense_parameters_match_the_port():
    """A configuration with no experts counts a dense SwiGLU block
    (llama3.2-1b's published sizes)."""
    from repro_torch.launch import one_card_config
    from repro_torch.models import count_params
    m = dict(hidden_size=2048, num_hidden_layers=16, num_attention_heads=32,
             num_key_value_heads=8, head_dim=64, intermediate_size=8192,
             vocab_size=128256, tie_word_embeddings=True)
    got = model.param_counts(m)
    cfg = one_card_config("llama3.2-1b", smoke=False)
    assert got["total"] == got["active"] == count_params(cfg)
