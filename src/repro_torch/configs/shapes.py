"""The assigned input-shape set and per-(arch x shape) input specs — the
JAX package's ``repro.configs.shapes``.

Four cells per architecture:
  train_4k     seq 4,096   global_batch 256   (train_step)
  prefill_32k  seq 32,768  global_batch 32    (serve prefill forward)
  decode_32k   seq 32,768  global_batch 128   (serve_step, 1 new token)
  long_500k    seq 524,288 global_batch 1     (decode; sub-quadratic only)

``decode_*``/``long_*`` run ``serve_step`` — one token against a KV/SSM
cache of ``seq_len`` — not ``train_step``.  ``long_500k`` is skipped for
pure full-attention architectures and runs for the SSM/hybrid ones.  The
specs are meta-device tensors (the shapes and dtypes of the JAX
package's ``ShapeDtypeStruct`` stand-ins, nothing allocated).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..models.config import ModelConfig

__all__ = ["ShapeCell", "SHAPES", "SUBQUADRATIC", "input_specs",
           "applicable"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

#: archs allowed to run long_500k (sub-quadratic sequence mixing)
SUBQUADRATIC = {"mamba2-130m", "jamba-v0.1-52b"}


def applicable(arch: str, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return False, "full-attention arch: 500k decode skipped (DESIGN.md §4)"
    return True, ""


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape_name: str) -> Dict[str, torch.Tensor]:
    """Meta-device stand-ins for every model input of this cell.

    train/prefill: the batch for ``train_step``/``prefill``.
    decode: {token, pos} (+ enc_out for enc-dec); caches are built
    separately by ``repro_torch.models.lm.init_caches``."""
    cell = SHAPES[shape_name]
    B, S = cell.global_batch, cell.seq_len
    i32 = torch.int32
    cdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[
        cfg.compute_dtype]

    if cell.kind in ("train", "prefill"):
        batch = {}
        if cfg.modality == "vision":
            P = cfg.stub_prefix
            batch["embeds"] = _spec((B, P, cfg.d_model), cdt)
            batch["tokens"] = _spec((B, S - P), i32)
            batch["labels"] = _spec((B, S - P), i32)
        elif cfg.modality == "audio":
            batch["frames"] = _spec((B, S, cfg.d_model), cdt)
            batch["tokens"] = _spec((B, S), i32)
            batch["labels"] = _spec((B, S), i32)
        else:
            batch["tokens"] = _spec((B, S), i32)
            batch["labels"] = _spec((B, S), i32)
        return batch

    specs = {"token": _spec((B,), i32), "pos": _spec((), i32)}
    if cfg.encoder_groups:
        # encoder ran at prefill; decode consumes its output states
        specs["enc_out"] = _spec((B, 1500, cfg.d_model), cdt)
    return specs
