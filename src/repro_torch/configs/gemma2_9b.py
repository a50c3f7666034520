"""gemma2-9b [dense]: 42L d=3584 16H (GQA kv=8) ff=14336 vocab=256000,
local(4096)+global alternating, attn softcap 50, logit softcap 30,
sandwich norms, scaled embeddings.  [arXiv:2408.00118; hf]

The JAX package's ``repro.configs.gemma2_9b``, field for field."""

from ..models.config import BlockCfg, Group, ModelConfig

ARCH = "gemma2-9b"
WINDOW = 4096


def config(ep_degree: int = 16) -> ModelConfig:
    return ModelConfig(
        name=ARCH, d_model=3584, vocab=256000,
        groups=(Group("body", (BlockCfg("attn", "dense", window=WINDOW),
                               BlockCfg("attn", "dense")), 21),),
        n_heads=16, n_kv=8, head_dim=256, d_ff=14336,
        rope_theta=10000.0, attn_softcap=50.0, logit_softcap=30.0,
        post_norms=True, scale_embed=True, tie_embeddings=True,
        max_seq=32768,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", d_model=128, vocab=512,
        groups=(Group("body", (BlockCfg("attn", "dense", window=32),
                               BlockCfg("attn", "dense")), 1),),
        n_heads=4, n_kv=2, head_dim=32, d_ff=256,
        attn_softcap=50.0, logit_softcap=30.0, post_norms=True,
        scale_embed=True, tie_embeddings=True, q_chunk=32,
        max_seq=256,
    )
