"""The model stack on one device: dense attention blocks and Mamba-2
blocks assembled into a decoder-only LM (llama3.2-1b, qwen3-14b,
gemma2-9b, qwen1.5-110b, mamba2-130m), the training loss with autograd
through the flash-attention kernels, prefill (through the flash-attention
or ``ssd_scan`` kernel) and greedy decode against a rolling KV cache or a
recurrent state."""

from .blocks import Runtime
from .config import BlockCfg, Group, MLACfg, ModelConfig
from .lm import (ParamTree, cast_params, count_params, decode_step, forward,
                 init_caches, init_params, load_params, loss_fn, model_flops,
                 prefill)
from .mamba import MambaConfig
from .moe import MoEConfig

__all__ = [
    "Runtime", "BlockCfg", "Group", "MLACfg", "ModelConfig",
    "MambaConfig", "MoEConfig", "ParamTree",
    "init_params", "load_params", "cast_params", "forward", "prefill",
    "decode_step", "init_caches", "loss_fn", "count_params", "model_flops",
]
