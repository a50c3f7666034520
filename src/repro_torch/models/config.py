"""Model configuration: a model is a sequence of *groups*, each a
repeating unit of block configs whose parameters are stacked
``[repeats, ...]`` (the JAX package scans a group; the port loops over
it).  Field for field the JAX package's ``repro.models.config``, so a
configuration carries across as is.

One addition is the port's own and opt-in: :class:`VLMConfig`, a
:class:`ModelConfig` with a vision tower (:class:`VisionCfg`: a CLIP ViT,
LLaVA's projector and anyres packing) whose image positions take the
place of the vision stub's precomputed ``embeds``.  A plain
:class:`ModelConfig` has no tower (its ``vision`` is None, a property
and no field), so every registered config still equals the JAX
package's field for field.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from .mamba import MambaConfig
from .moe import MoEConfig

__all__ = ["BlockCfg", "Group", "MLACfg", "ModelConfig", "VisionCfg",
           "VLMConfig"]


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
    # dense (SwiGLU) | moe | gelu | quick_gelu (two biased matrices and
    # that activation, a vision tower's MLP) | none
    ffn: str = "dense"
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
    def vision(self) -> Optional["VisionCfg"]:
        """The vision tower; None: the model has none (see
        :class:`VLMConfig`)."""
        return None

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def n_layers(self) -> int:
        return sum(g.n_layers for g in self.groups) \
            + sum(g.n_layers for g in self.encoder_groups)


@dataclasses.dataclass(frozen=True)
class VisionCfg:
    """A CLIP ViT tower over square tiles, LLaVA's two-layer projector and
    anyres packing (LLaVA-NeXT), as ``llava-hf/llava-v1.6-mistral-7b-hf``
    publishes them: ``vision_config``, ``vision_feature_layer``,
    ``projector_hidden_act`` and one of ``image_grid_pinpoints``.

    An image at the pinpoint ``grid`` x ``image_size`` px is ``n_tiles``
    tiles: the whole image resized to one tile (the base), then the grid's
    tiles row by row.  Each tile is ``n_patches`` patches of
    ``patch_size`` px, embedded with a class token and learned positions;
    the tower's hidden states after layer ``run_layers`` (its
    ``feature_layer``-th from the end, counting the embeddings as layer
    0) less the class position are the features, so the layers after it
    are neither held nor run.  The projector maps them to the language
    model's width.  The packed image is the base tile's features, then
    the grid's as one map ``grid[0] * side`` rows by ``grid[1] * side``
    columns with ``image_newline`` after each row (an image at its
    pinpoint's own size unpads nothing)."""
    image_size: int = 336          # a tile's side, px
    patch_size: int = 14
    d_model: int = 1024
    n_heads: int = 16
    d_ff: int = 4096
    n_layers: int = 24             # the tower as published
    feature_layer: int = -2        # hidden state read (-1: the last)
    grid: Tuple[int, int] = (2, 2)     # tiles of the pinpoint, rows x cols
    act: str = "quick_gelu"
    projector_act: str = "gelu"

    @property
    def side(self) -> int:
        """Patches along a tile's side."""
        return self.image_size // self.patch_size

    @property
    def n_patches(self) -> int:
        return self.side * self.side

    @property
    def run_layers(self) -> int:
        """The layers whose output is read: the rest are not held."""
        return self.n_layers + 1 + self.feature_layer

    @property
    def n_tiles(self) -> int:
        return 1 + self.grid[0] * self.grid[1]

    @property
    def n_positions(self) -> int:
        """Positions of one packed image."""
        rows, cols = self.grid[0] * self.side, self.grid[1] * self.side
        return self.n_patches + rows * (cols + 1)


@dataclasses.dataclass(frozen=True)
class VLMConfig(ModelConfig):
    """A language model behind a vision tower: a batch's ``pixels`` [B,
    n_tiles, 3, image_size, image_size] become each sample's image
    positions, before its tokens."""
    vision: VisionCfg = VisionCfg()
