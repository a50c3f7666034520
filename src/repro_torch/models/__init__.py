"""The model stack on one device: attention, MLA and Mamba-2 mixers,
cross-attention, dense or MoE feed-forward blocks, assembled into an LM
with an optional encoder, vision prefix (a stub's embeddings, or a
``VLMConfig``'s vision tower, :mod:`.vision`) or multi-token-prediction
head (all ten architectures of ``repro_torch.configs``), the training loss with
autograd through the kernels, prefill (through the flash-attention or
``ssd_scan`` kernel) and greedy decode against a rolling KV cache, MLA's
compressed cache or a recurrent state."""

from .blocks import Runtime
from .config import BlockCfg, Group, MLACfg, ModelConfig, VisionCfg, VLMConfig
from .lm import (ParamTree, cast_params, count_params, decode_step, forward,
                 init_caches, init_params, load_params, loss_fn, model_flops,
                 prefill)
from .mamba import MambaConfig
from .moe import MoEConfig

__all__ = [
    "Runtime", "BlockCfg", "Group", "MLACfg", "ModelConfig", "VisionCfg",
    "VLMConfig",
    "MambaConfig", "MoEConfig", "ParamTree",
    "init_params", "load_params", "cast_params", "forward", "prefill",
    "decode_step", "init_caches", "loss_fn", "count_params", "model_flops",
]
