"""jamba-v0.1-52b [hybrid]: 32L d=4096 32H (GQA kv=8) ff=14336
vocab=65536, Mamba:attention 7:1 interleave (attention at position 4 of
each 8-layer period), MoE 16 experts top-2 on every other layer, no
positional embeddings.  [arXiv:2403.19887; hf]

Adaptation note (DESIGN.md §4): Jamba v0.1 uses Mamba-1 (S6); this repo's
SSM mixer is the SSD (Mamba-2) formulation with Jamba's d_state=16 — the
layer pattern, widths and parallelism are what this cell reproduces.

The JAX package's ``repro.configs.jamba_v01_52b``, field for field.
"""

from ..models.config import BlockCfg, Group, ModelConfig
from ..models.mamba import MambaConfig
from ..models.moe import MoEConfig


ARCH = "jamba-v0.1-52b"


def _unit(window=None):
    blocks = []
    for i in range(8):
        mixer = "attn" if i == 4 else "mamba"
        ffn = "moe" if i % 2 == 1 else "dense"
        blocks.append(BlockCfg(mixer, ffn, window=window))
    return tuple(blocks)


def config(ep_degree: int = 16) -> ModelConfig:
    return ModelConfig(
        name=ARCH, d_model=4096, vocab=65536,
        groups=(Group("body", _unit(), 4),),
        n_heads=32, n_kv=8, head_dim=128, d_ff=14336,
        pos_embed="none",
        mamba=MambaConfig(d_model=4096, d_state=16, expand=2, head_dim=64,
                          n_groups=1, chunk=128),
        moe=MoEConfig(d_model=4096, d_ff=14336, n_experts=16, top_k=2,
                      ep_degree=ep_degree),
        max_seq=1 << 20,
    )


def smoke_config() -> ModelConfig:
    blocks = (BlockCfg("mamba", "dense"), BlockCfg("mamba", "moe"),
              BlockCfg("attn", "dense"), BlockCfg("mamba", "moe"))
    return ModelConfig(
        name=ARCH + "-smoke", d_model=128, vocab=512,
        groups=(Group("body", blocks, 1),),
        n_heads=4, n_kv=2, head_dim=32, d_ff=256,
        pos_embed="none", q_chunk=32,
        mamba=MambaConfig(d_model=128, d_state=16, expand=2, head_dim=32,
                          n_groups=1, chunk=32),
        moe=MoEConfig(d_model=128, d_ff=64, n_experts=4, top_k=2,
                      ep_degree=1),
        max_seq=256,
    )
