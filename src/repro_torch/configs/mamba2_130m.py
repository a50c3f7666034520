"""mamba2-130m [ssm]: 24L d=768 attn-free, ssm_state=128, vocab=50280,
SSD (state-space duality).  [arXiv:2405.21060; unverified]

The JAX package's ``repro.configs.mamba2_130m``, field for field."""

from ..models.config import BlockCfg, Group, ModelConfig
from ..models.mamba import MambaConfig

ARCH = "mamba2-130m"


def config(ep_degree: int = 16) -> ModelConfig:
    return ModelConfig(
        name=ARCH, d_model=768, vocab=50280,
        groups=(Group("body", (BlockCfg("mamba", "none"),), 24),),
        n_heads=12, n_kv=12,  # unused (attn-free)
        mamba=MambaConfig(d_model=768, d_state=128, expand=2, head_dim=64,
                          n_groups=1, chunk=128),
        tie_embeddings=True, pos_embed="none",
        max_seq=1 << 20,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", d_model=128, vocab=512,
        groups=(Group("body", (BlockCfg("mamba", "none"),), 2),),
        n_heads=4, n_kv=4,
        mamba=MambaConfig(d_model=128, d_state=16, expand=2, head_dim=32,
                          n_groups=1, chunk=32),
        tie_embeddings=True, pos_embed="none",
        max_seq=256,
    )
