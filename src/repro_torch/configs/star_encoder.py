"""The paper's own encoder: STAR [arXiv:2108.xxxxx / SIGIR'21] is a
BERT-base bi-encoder (12L, d768, 12H) producing 768-d embeddings, +1 dim
from the Eq. 1 transform. Weights are unavailable offline; this config
gives the CACHE pipeline a faithfully-shaped encoder backbone.
The torch twin of ``repro.configs.star_encoder``."""

import torch

from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "star-encoder"
FAMILY = "lm"
OPTIMIZER = "adamw"
TRAIN_ACCUM_STEPS = 4
ACCUM_DTYPE = torch.float32


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_head=64, d_ff=3072, vocab_size=30522,
        tie_embeddings=True, dtype=torch.float32,
        q_chunk=128, kv_chunk=128,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=32, n_heads=4,
        n_kv_heads=4, d_head=8, d_ff=64, vocab_size=256,
        dtype=torch.float32, q_chunk=16, kv_chunk=16,
    )
