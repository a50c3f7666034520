"""Deterministic synthetic data pipeline — the port's own copy of the JAX
package's ``repro.data.pipeline`` (numpy only, so its batches are
bit-identical to the JAX package's for the same seed and step).

Every batch is a pure function of ``(seed, step)`` — no state to lose on
restart beyond the step counter, which rides in the checkpoint.  The
token stream has learnable structure (a noisy affine next-token rule over
a zipf-ish marginal) so training loss demonstrably decreases.  Given the
model config, the modality stubs synthesise patch embeddings (``embeds``
[B, stub_prefix, d_model], vision) or encoder frames (``frames`` [B, S,
d_model], audio with an encoder) with the same determinism; a model with
a vision tower (the port's ``VLMConfig``) gets image tiles instead
(``pixels`` [B, n_tiles, 3, s, s], N(0, 1), the scale of an image
processor's normalised output).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from ..models.config import ModelConfig

__all__ = ["DataConfig", "SyntheticStream"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    structure: float = 0.75      # P(next token follows the affine rule)


class SyntheticStream:
    """Checkpointable iterator: state == step (int)."""

    def __init__(self, cfg: DataConfig,
                 model_cfg: Optional[ModelConfig] = None):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.a = 6364136223846793005 % cfg.vocab or 1
        self.c = 1442695040888963407 % cfg.vocab

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed << 32) ^ step)
        B, S = cfg.global_batch, cfg.seq_len
        # zipf-ish marginal for the random branches
        ranks = np.arange(1, cfg.vocab + 1)
        probs = 1.0 / ranks
        probs /= probs.sum()
        toks = np.empty((B, S), np.int64)
        toks[:, 0] = rng.integers(0, cfg.vocab, B)
        rand_draws = rng.choice(cfg.vocab, size=(B, S), p=probs)
        follow = rng.random((B, S)) < cfg.structure
        for t in range(1, S):
            nxt = (toks[:, t - 1] * self.a + self.c) % cfg.vocab
            toks[:, t] = np.where(follow[:, t], nxt, rand_draws[:, t])
        labels = np.concatenate(
            [toks[:, 1:], np.full((B, 1), -1, np.int64)], axis=1)
        out = {"tokens": toks.astype(np.int32),
               "labels": labels.astype(np.int32)}
        mc = self.model_cfg
        if mc is not None and mc.vision is not None:
            v = mc.vision
            out["pixels"] = rng.standard_normal(
                (B, v.n_tiles, 3, v.image_size, v.image_size)
            ).astype(np.float32)
        elif mc is not None and mc.modality == "vision":
            out["embeds"] = rng.standard_normal(
                (B, mc.stub_prefix, mc.d_model)).astype(np.float32)
        if mc is not None and mc.modality == "audio" and mc.encoder_groups:
            out["frames"] = rng.standard_normal(
                (B, S, mc.d_model)).astype(np.float32)
        return out

    # -- checkpointable iterator protocol --------------------------------
    def state(self, step: int) -> dict:
        return {"step": int(step), "seed": self.cfg.seed}

    @staticmethod
    def resume(state: dict) -> int:
        return int(state["step"])
