"""llava-next-mistral-7b [vlm]: mistral-7B backbone (32L d=4096 32H GQA
kv=8 ff=14336 vocab=32000).  Two configurations:

* ``config()`` / ``smoke_config()`` (registered as ``ARCH``): the vision
  frontend is a STUB — ``input_specs`` provides 576 precomputed patch
  embeddings (anyres tiling happens before the backbone).  The JAX
  package's ``repro.configs.llava_next_mistral_7b``, field for field.
* ``tower_config()`` / ``tower_smoke_config()`` (``TOWER_ARCH``, the
  port's own): the same backbone behind its real vision tower
  (:class:`~repro_torch.models.config.VisionCfg`: CLIP ViT-L/14-336 to its
  23rd of 24 layers, the two-layer GELU projector, anyres packing of one
  672x672 image into 5 tiles and 2,928 positions with ``image_newline``),
  built by :mod:`repro_torch.models.vision`.

[hf:llava-hf/llava-v1.6-mistral-7b-hf, openai/clip-vit-large-patch14-336;
unverified]"""

import dataclasses

from ..models.config import BlockCfg, Group, ModelConfig, VisionCfg, VLMConfig

ARCH = "llava-next-mistral-7b"
TOWER_ARCH = "llava-next-mistral-7b-tower"


def config(ep_degree: int = 16) -> ModelConfig:
    return ModelConfig(
        name=ARCH, d_model=4096, vocab=32000,
        groups=(Group("body", (BlockCfg("attn", "dense"),), 32),),
        n_heads=32, n_kv=8, head_dim=128, d_ff=14336,
        rope_theta=1_000_000.0,
        modality="vision", stub_prefix=576,
        max_seq=32768,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", d_model=128, vocab=512,
        groups=(Group("body", (BlockCfg("attn", "dense"),), 2),),
        n_heads=4, n_kv=2, head_dim=32, d_ff=256,
        modality="vision", stub_prefix=16, q_chunk=32,
        max_seq=256,
    )


def _with_tower(cfg: ModelConfig, name: str, vision: VisionCfg) -> VLMConfig:
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(ModelConfig)}
    return VLMConfig(**dict(fields, name=name, stub_prefix=0),
                     vision=vision)


def tower_config(ep_degree: int = 16) -> VLMConfig:
    """The published model, tower and all (7.57 B parameters)."""
    return _with_tower(config(ep_degree), TOWER_ARCH, VisionCfg())


def tower_smoke_config() -> VLMConfig:
    """The smoke backbone behind a tower of 2 run layers (of 3), d 64, 4
    heads of 16, 28-px tiles of 14-px patches: 5 tiles and 24 positions
    an image."""
    return _with_tower(smoke_config(), TOWER_ARCH + "-smoke", VisionCfg(
        image_size=28, patch_size=14, d_model=64, n_heads=4, d_ff=256,
        n_layers=3))
