"""qwen1.5-110b [dense]: 80L d=8192 64H (GQA kv=8) ff=49152 vocab=152064,
QKV bias.  [hf:Qwen/Qwen1.5-0.5B; hf]

The JAX package's ``repro.configs.qwen1_5_110b``, field for field."""

from ..models.config import BlockCfg, Group, ModelConfig

ARCH = "qwen1.5-110b"


def config(ep_degree: int = 16) -> ModelConfig:
    return ModelConfig(
        name=ARCH, d_model=8192, vocab=152064,
        groups=(Group("body", (BlockCfg("attn", "dense"),), 80),),
        n_heads=64, n_kv=8, head_dim=128, d_ff=49152,
        rope_theta=1_000_000.0, qkv_bias=True,
        max_seq=32768,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", d_model=128, vocab=512,
        groups=(Group("body", (BlockCfg("attn", "dense"),), 2),),
        n_heads=4, n_kv=2, head_dim=32, d_ff=256,
        rope_theta=1_000_000.0, qkv_bias=True, q_chunk=32,
        max_seq=256,
    )
