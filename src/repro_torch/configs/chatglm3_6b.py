"""chatglm3-6b [arXiv:2406.12793]: 28L d4096 32H GQA kv=2, SwiGLU d_ff
13696, vocab 65024, partial ("2d") interleaved RoPE over half the head dim.
The torch twin of ``repro.configs.chatglm3_6b``."""

import torch

from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "chatglm3-6b"
FAMILY = "lm"


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
        d_head=128, d_ff=13696, vocab_size=65024,
        rotary_frac=0.5, rope_interleaved=True,
        tie_embeddings=False,
        dtype=torch.bfloat16,
        q_chunk=1024, kv_chunk=2048,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=3, d_model=64, n_heads=8,
        n_kv_heads=2, d_head=8, d_ff=160, vocab_size=512,
        rotary_frac=0.5, rope_interleaved=True, tie_embeddings=False,
        dtype=torch.float32, q_chunk=16, kv_chunk=16,
    )
