"""Model configuration: a model is a sequence of *groups*, each a
repeating unit of block configs whose parameters are stacked
``[repeats, ...]`` (the JAX package scans a group; the port loops over
it).  Field for field the JAX package's ``repro.models.config``, so a
configuration carries across as is.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from .mamba import MambaConfig
from .moe import MoEConfig

__all__ = ["BlockCfg", "Group", "MLACfg", "ModelConfig"]


@dataclasses.dataclass(frozen=True)
class MLACfg:
    q_lora: int = 1536
    kv_lora: int = 512
    dh_nope: int = 128
    dh_rope: int = 64
    dh_v: int = 128


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    mixer: str = "attn"            # attn | mla | mamba | none
    ffn: str = "dense"             # dense | moe | none
    causal: bool = True
    window: Optional[int] = None   # sliding-window (local) attention
    cross_attn: bool = False       # decoder block attending to encoder


@dataclasses.dataclass(frozen=True)
class Group:
    name: str
    blocks: Tuple[BlockCfg, ...]
    repeats: int

    @property
    def n_layers(self) -> int:
        return len(self.blocks) * self.repeats


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    vocab: int
    groups: Tuple[Group, ...]
    # attention geometry
    n_heads: int = 8
    n_kv: int = 8
    head_dim: Optional[int] = None
    d_ff: int = 0
    rope_theta: float = 10000.0
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    norm: str = "rms"              # rms | layer
    post_norms: bool = False       # gemma-2 sandwich norms
    pos_embed: str = "rope"        # rope | sinusoidal | learned | none
    tie_embeddings: bool = False
    # sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLACfg] = None
    mamba: Optional[MambaConfig] = None
    shared_expert: bool = False    # deepseek shared expert alongside MoE
    # enc-dec
    encoder_groups: Tuple[Group, ...] = ()
    # modality stub: input embeddings are provided directly for the first
    # `stub_prefix` positions (vision patches / audio frames)
    modality: str = "none"         # none | vision | audio
    stub_prefix: int = 0
    # multi-token prediction (deepseek): extra next-next-token head
    mtp: bool = False
    scale_embed: bool = False      # gemma: embeddings scaled by sqrt(d)
    # execution policy
    unroll_layers: bool = False    # the JAX package's FLOP calibration
    attn_impl: str = "blocked"     # blocked | flash | reference
    q_chunk: int = 512
    remat: str = "full"            # full | dots | none (training)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    max_seq: int = 8192            # RoPE/learned-position capacity

    @property
    def vocab_padded(self) -> int:
        """Embedding/head tables padded to a 256 multiple; padded logits
        are masked."""
        return -(-self.vocab // 256) * 256

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def n_layers(self) -> int:
        return sum(g.n_layers for g in self.groups) \
            + sum(g.n_layers for g in self.encoder_groups)
