"""mistral-large-123b [hf:mistralai/Mistral-Large-Instruct-2407]: dense 88L
d12288 96H GQA kv=8 d_head 128, SwiGLU d_ff 28672, vocab 32768.
The torch twin of ``repro.configs.mistral_large_123b``."""

import torch

from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "mistral-large-123b"
FAMILY = "lm"
OPTIMIZER = "adamw"
TRAIN_ACCUM_STEPS = 8
ACCUM_DTYPE = torch.float32


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8,
        d_head=128, d_ff=28672, vocab_size=32768,
        rope_theta=1e6,
        tie_embeddings=False,
        dtype=torch.bfloat16,
        q_chunk=1024, kv_chunk=2048,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=3, d_model=64, n_heads=8,
        n_kv_heads=2, d_head=8, d_ff=192, vocab_size=512,
        tie_embeddings=False, dtype=torch.float32, q_chunk=16, kv_chunk=16,
    )
