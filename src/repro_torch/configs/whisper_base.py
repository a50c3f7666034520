"""whisper-base [audio]: enc-dec, 6+6L d=512 8H ff=2048 vocab=51865,
conv frontend STUB (``input_specs`` provides precomputed frame
embeddings), LayerNorm, sinusoidal encoder / learned decoder positions.
[arXiv:2212.04356; unverified]

The JAX package's ``repro.configs.whisper_base``, field for field."""

from ..models.config import BlockCfg, Group, ModelConfig

ARCH = "whisper-base"


def config(ep_degree: int = 16) -> ModelConfig:
    return ModelConfig(
        name=ARCH, d_model=512, vocab=51865,
        encoder_groups=(Group("enc", (BlockCfg("attn", "dense",
                                               causal=False),), 6),),
        groups=(Group("dec", (BlockCfg("attn", "dense",
                                       cross_attn=True),), 6),),
        n_heads=8, n_kv=8, head_dim=64, d_ff=2048,
        norm="layer", pos_embed="learned", modality="audio",
        tie_embeddings=True,
        max_seq=32768,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", d_model=128, vocab=512,
        encoder_groups=(Group("enc", (BlockCfg("attn", "dense",
                                               causal=False),), 2),),
        groups=(Group("dec", (BlockCfg("attn", "dense",
                                       cross_attn=True),), 2),),
        n_heads=4, n_kv=4, head_dim=32, d_ff=256,
        norm="layer", pos_embed="learned", modality="audio",
        tie_embeddings=True, q_chunk=32,
        max_seq=256,
    )
