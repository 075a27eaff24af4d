"""gemma2-9b [arXiv:2408.00118]: 42L d3584 16H GQA kv=8 d_head 256,
GeGLU d_ff 14336, vocab 256000; alternating local(4096)/global attention,
attn logit softcap 50, final softcap 30, pre+post RMSNorm (zero-centered),
embeddings scaled by sqrt(d), tied head.
The torch twin of ``repro.configs.gemma2_9b``."""

import torch

from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "gemma2-9b"
FAMILY = "lm"


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8,
        d_head=256, d_ff=14336, vocab_size=256000,
        window=4096, layer_pattern="lg",
        attn_softcap=50.0, final_softcap=30.0,
        use_post_norm=True, zero_centered_norm=True, embed_scale=True,
        tie_embeddings=True,
        dtype=torch.bfloat16,
        q_chunk=1024, kv_chunk=2048,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab_size=512,
        window=8, layer_pattern="lg", attn_softcap=50.0, final_softcap=30.0,
        use_post_norm=True, zero_centered_norm=True, embed_scale=True,
        dtype=torch.float32, q_chunk=16, kv_chunk=16,
    )
