"""Architecture registry: ``--arch <id>`` resolves here.

Each module exposes ``config(ep_degree)`` (the published geometry, as in
the JAX package's ``repro.configs``) and ``smoke_config()`` (a reduced
same-family config for CPU tests).  Only the architectures whose blocks
the port runs are registered: the dense attention models (llama3.2-1b,
qwen3-14b, gemma2-9b, qwen1.5-110b), mamba2-130m, the MoE model
granite-moe-3b-a800m and the hybrid jamba-v0.1-52b.  The JAX package's
other three come with their blocks (ROADMAP A8, A8.3).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

from . import (gemma2_9b, granite_moe_3b, jamba_v01_52b, llama3_2_1b,
               mamba2_130m, qwen1_5_110b, qwen3_14b)

_MODULES = (qwen1_5_110b, llama3_2_1b, qwen3_14b, gemma2_9b, granite_moe_3b,
            mamba2_130m, jamba_v01_52b)

REGISTRY: Dict[str, Tuple[Callable, Callable]] = {
    m.ARCH: (m.config, m.smoke_config) for m in _MODULES
}

ARCHS = tuple(REGISTRY)

#: the JAX package's architectures whose blocks are not ported yet
NOT_PORTED = ("deepseek-v3-671b", "llava-next-mistral-7b", "whisper-base")


def get_config(arch: str, *, smoke: bool = False, ep_degree: int = 16):
    if arch in NOT_PORTED:
        raise KeyError(f"arch {arch!r} is not ported yet (ROADMAP A8, "
                       f"A8.3); "
                       f"ported: {sorted(REGISTRY)}")
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(REGISTRY)}")
    full, small = REGISTRY[arch]
    return small() if smoke else full(ep_degree=ep_degree)


__all__ = ["REGISTRY", "ARCHS", "NOT_PORTED", "get_config"]
