"""Architecture registry: ``--arch <id>`` resolves here.

Each module exposes ``config(ep_degree)`` (the published geometry, as in
the JAX package's ``repro.configs``) and ``smoke_config()`` (a reduced
same-family config for CPU tests).  All ten of the JAX package's
architectures are registered: the dense attention models (llama3.2-1b,
qwen3-14b, gemma2-9b, qwen1.5-110b), mamba2-130m, the MoE models
granite-moe-3b-a800m and deepseek-v3-671b (MLA blocks and multi-token
prediction), the hybrid jamba-v0.1-52b, the vision-prefix model
llava-next-mistral-7b and the encoder-decoder whisper-base.  The JAX
package's assigned shape set (:mod:`.shapes`) is exported beside them.

``VARIANTS`` holds the port's own configurations, which ``get_config``
resolves too but which are no architecture of the JAX package (so not in
``ARCHS``): llava-next-mistral-7b with its real vision tower.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

from . import (deepseek_v3_671b, gemma2_9b, granite_moe_3b, jamba_v01_52b,
               llama3_2_1b, llava_next_mistral_7b, mamba2_130m, qwen1_5_110b,
               qwen3_14b, whisper_base)
from .shapes import SHAPES, ShapeCell, applicable, input_specs

_MODULES = (qwen1_5_110b, llama3_2_1b, qwen3_14b, gemma2_9b, granite_moe_3b,
            deepseek_v3_671b, mamba2_130m, llava_next_mistral_7b,
            jamba_v01_52b, whisper_base)

REGISTRY: Dict[str, Tuple[Callable, Callable]] = {
    m.ARCH: (m.config, m.smoke_config) for m in _MODULES
}

ARCHS = tuple(REGISTRY)

VARIANTS: Dict[str, Tuple[Callable, Callable]] = {
    llava_next_mistral_7b.TOWER_ARCH: (
        llava_next_mistral_7b.tower_config,
        llava_next_mistral_7b.tower_smoke_config),
}


def get_config(arch: str, *, smoke: bool = False, ep_degree: int = 16):
    known = {**REGISTRY, **VARIANTS}
    if arch not in known:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(known)}")
    full, small = known[arch]
    return small() if smoke else full(ep_degree=ep_degree)


__all__ = ["REGISTRY", "ARCHS", "VARIANTS", "get_config", "SHAPES",
           "ShapeCell", "applicable", "input_specs"]
