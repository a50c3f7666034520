"""The model stack on one device: dense attention blocks assembled into a
decoder-only LM (llama3.2-1b first), prefill through the flash-attention
kernel and greedy decode against a rolling KV cache."""

from .blocks import Runtime
from .config import BlockCfg, Group, MLACfg, ModelConfig
from .lm import (ParamTree, cast_params, decode_step, forward, init_caches,
                 init_params, prefill)
from .mamba import MambaConfig
from .moe import MoEConfig

__all__ = [
    "Runtime", "BlockCfg", "Group", "MLACfg", "ModelConfig",
    "MambaConfig", "MoEConfig", "ParamTree",
    "init_params", "cast_params", "forward", "prefill", "decode_step",
    "init_caches",
]
