"""deepseek-v3-671b [arXiv:2412.19437]: 61L d7168, MLA (128 heads), MoE
256 routed experts top-8 + 1 shared, first 3 layers dense (d_ff 18432),
MTP depth 1, vocab 129280.
The torch twin of ``repro.configs.deepseek_v3_671b`` (its training-only
constants left out)."""

import torch

from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import MLAConfig, TransformerConfig

ARCH_ID = "deepseek-v3-671b"
FAMILY = "lm"


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
        d_ff=18432,                       # the 3 dense layers
        vocab_size=129280,
        attention="mla",
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
        moe=MoEConfig(n_experts=256, top_k=8, d_ff=2048, n_shared=1,
                      d_ff_shared=2048, capacity_factor=1.25),
        n_dense_layers=3,
        mtp=True,
        tie_embeddings=False,
        rope_theta=1e4,
        dtype=torch.bfloat16,
        q_chunk=1024, kv_chunk=2048,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=4, d_model=64, n_heads=8,
        n_kv_heads=8, d_ff=128, vocab_size=512,
        attention="mla",
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=8,
                      qk_rope_dim=4, v_head_dim=8),
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=32, n_shared=1,
                      d_ff_shared=32),
        n_dense_layers=1, mtp=True, tie_embeddings=False,
        dtype=torch.float32, q_chunk=16, kv_chunk=16,
    )
