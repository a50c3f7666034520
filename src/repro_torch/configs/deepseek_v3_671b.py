"""deepseek-v3-671b [moe]: 61L d=7168 128H MLA, 1 shared + 256 routed
experts top-8 (expert ff=2048, dense-prefix ff=18432), vocab=129280,
MTP head.  bf16 params (§DESIGN memory policy).  [arXiv:2412.19437; hf]

The JAX package's ``repro.configs.deepseek_v3_671b``, field for field."""

from ..models.config import BlockCfg, Group, MLACfg, ModelConfig
from ..models.moe import MoEConfig

ARCH = "deepseek-v3-671b"


def config(ep_degree: int = 16) -> ModelConfig:
    return ModelConfig(
        name=ARCH, d_model=7168, vocab=129280,
        groups=(
            Group("dense", (BlockCfg("mla", "dense"),), 3),
            Group("moe", (BlockCfg("mla", "moe"),), 58),
        ),
        n_heads=128, n_kv=128, head_dim=128, d_ff=18432,
        rope_theta=10000.0,
        mla=MLACfg(q_lora=1536, kv_lora=512, dh_nope=128, dh_rope=64,
                   dh_v=128),
        moe=MoEConfig(d_model=7168, d_ff=2048, n_experts=256, top_k=8,
                      ep_degree=ep_degree),
        shared_expert=True, mtp=True,
        param_dtype="bfloat16",
        max_seq=32768,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", d_model=128, vocab=512,
        groups=(
            Group("dense", (BlockCfg("mla", "dense"),), 1),
            Group("moe", (BlockCfg("mla", "moe"),), 2),
        ),
        n_heads=4, n_kv=4, head_dim=32, d_ff=256,
        mla=MLACfg(q_lora=64, kv_lora=32, dh_nope=32, dh_rope=16, dh_v=32),
        moe=MoEConfig(d_model=128, d_ff=64, n_experts=6, top_k=2,
                      ep_degree=1),
        shared_expert=True, mtp=True, q_chunk=32,
        max_seq=256,
    )
