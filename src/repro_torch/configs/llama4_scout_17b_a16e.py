"""llama4-scout-17b-16e [hf:meta-llama/Llama-4-Scout-17B-16E]: 48L d5120,
40H GQA kv=8, MoE 16 experts top-1 + shared expert (d_ff 8192), vocab
202048.  Text backbone only.
The torch twin of ``repro.configs.llama4_scout_17b_a16e``."""

import torch

from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "llama4-scout-17b-16e"
FAMILY = "lm"
OPTIMIZER = "adafactor"
TRAIN_ACCUM_STEPS = 4
ACCUM_DTYPE = torch.float32


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_head=128, d_ff=8192, vocab_size=202048,
        moe=MoEConfig(n_experts=16, top_k=1, d_ff=8192, n_shared=1,
                      d_ff_shared=8192, capacity_factor=1.5,
                      norm_topk=False),
        n_dense_layers=0,
        rope_theta=5e5,
        tie_embeddings=False,
        dtype=torch.bfloat16,
        q_chunk=1024, kv_chunk=2048,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=4, d_model=64, n_heads=8,
        n_kv_heads=2, d_head=8, d_ff=96, vocab_size=512,
        moe=MoEConfig(n_experts=4, top_k=1, d_ff=96, n_shared=1,
                      d_ff_shared=96, norm_topk=False),
        tie_embeddings=False, dtype=torch.float32, q_chunk=16, kv_chunk=16,
    )
