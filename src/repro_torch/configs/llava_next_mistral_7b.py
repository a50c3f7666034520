"""llava-next-mistral-7b [vlm]: mistral-7B backbone (32L d=4096 32H GQA
kv=8 ff=14336 vocab=32000); vision frontend is a STUB — ``input_specs``
provides 576 precomputed patch embeddings (anyres tiling happens before
the backbone).  [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

The JAX package's ``repro.configs.llava_next_mistral_7b``, field for field."""

from ..models.config import BlockCfg, Group, ModelConfig

ARCH = "llava-next-mistral-7b"


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
