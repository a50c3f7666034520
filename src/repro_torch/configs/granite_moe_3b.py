"""granite-moe-3b-a800m [moe]: 32L d=1536 24H (GQA kv=8) expert-ff=512
vocab=49155, MoE 40 experts top-8 (the spec header's 40e; the HF card's
sibling model uses 32e — we follow the header and note the discrepancy in
DESIGN.md).  [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

The JAX package's ``repro.configs.granite_moe_3b``, field for field.
``ep_degree`` pads the expert count to a multiple of the model-axis size:
the launchers build one card's config with ``ep_degree=1`` (40 experts);
the default 16 (48) is the registry's, for the published parameter
count's parity."""

from ..models.config import BlockCfg, Group, ModelConfig
from ..models.moe import MoEConfig

ARCH = "granite-moe-3b-a800m"


def config(ep_degree: int = 16) -> ModelConfig:
    return ModelConfig(
        name=ARCH, d_model=1536, vocab=49155,
        groups=(Group("body", (BlockCfg("attn", "moe"),), 32),),
        n_heads=24, n_kv=8, head_dim=64, d_ff=512,
        rope_theta=10000.0, tie_embeddings=True,
        moe=MoEConfig(d_model=1536, d_ff=512, n_experts=40, top_k=8,
                      ep_degree=ep_degree),
        max_seq=32768,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", d_model=128, vocab=512,
        groups=(Group("body", (BlockCfg("attn", "moe"),), 2),),
        n_heads=4, n_kv=2, head_dim=32, d_ff=64,
        tie_embeddings=True, q_chunk=32,
        moe=MoEConfig(d_model=128, d_ff=64, n_experts=6, top_k=2,
                      ep_degree=1),
        max_seq=256,
    )
