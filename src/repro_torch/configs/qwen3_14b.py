"""qwen3-14b [dense]: 40L d=5120 40H (GQA kv=8) ff=17408 vocab=151936,
qk_norm + GQA.  [hf:Qwen/Qwen3-8B; hf]

The JAX package's ``repro.configs.qwen3_14b``, field for field."""

from ..models.config import BlockCfg, Group, ModelConfig

ARCH = "qwen3-14b"


def config(ep_degree: int = 16) -> ModelConfig:
    return ModelConfig(
        name=ARCH, d_model=5120, vocab=151936,
        groups=(Group("body", (BlockCfg("attn", "dense"),), 40),),
        n_heads=40, n_kv=8, head_dim=128, d_ff=17408,
        rope_theta=1_000_000.0, qk_norm=True,
        max_seq=32768,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", d_model=128, vocab=512,
        groups=(Group("body", (BlockCfg("attn", "dense"),), 2),),
        n_heads=4, n_kv=2, head_dim=32, d_ff=256,
        rope_theta=1_000_000.0, qk_norm=True, q_chunk=32,
        max_seq=256,
    )
