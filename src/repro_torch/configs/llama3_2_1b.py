"""llama3.2-1b [dense]: 16L d=2048 32H (GQA kv=8) ff=8192 vocab=128256,
small llama3.  [hf:meta-llama/Llama-3.2-1B; unverified]"""

from ..models.config import BlockCfg, Group, ModelConfig

ARCH = "llama3.2-1b"


def config(ep_degree: int = 16) -> ModelConfig:
    return ModelConfig(
        name=ARCH, d_model=2048, vocab=128256,
        groups=(Group("body", (BlockCfg("attn", "dense"),), 16),),
        n_heads=32, n_kv=8, head_dim=64, d_ff=8192,
        rope_theta=500_000.0, tie_embeddings=True,
        max_seq=32768,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", d_model=128, vocab=512,
        groups=(Group("body", (BlockCfg("attn", "dense"),), 2),),
        n_heads=4, n_kv=2, head_dim=32, d_ff=256,
        rope_theta=500_000.0, tie_embeddings=True, q_chunk=32,
        max_seq=256,
    )
