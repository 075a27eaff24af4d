"""Moonlight-16B-A3B (moonshotai, ``model_type`` deepseek_v3; its
published ``config.json``): 27 layers at d 2,048, the first dense (SwiGLU
11,264), then 26 MoE layers of 64 routed experts (width 1,408, 6 a token)
and 2 shared ones (one SwiGLU of 2,816).  DeepSeek-V3's router: sigmoid
scores, the choice by score + correction bias (``noaux_tc``, one group),
the gates renormalised over the 6 and scaled by 2.446.  MLA with 16
heads and no query latent (``q_lora_rank`` null), kv latent 512, q/k 128
+ 64 rotary, v 128; rope theta 50,000 unscaled, RMSNorm eps 1e-5, vocab
163,840, untied, no MTP layer; bf16.

Served as a query encoder (``serve.engine.make_lm_query_encoder``): the
MoE layers are dropless (``capacity_factor`` None), so that a row's
hidden states do not depend on the rows it shares a batch with.  Not in
``registry.PORTED``, which mirrors the JAX package's registry: the JAX
package has no twin of it.
"""

import torch

from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import MLAConfig, TransformerConfig

ARCH_ID = "moonlight-16b-a3b"
FAMILY = "lm"
SOURCE = "https://huggingface.co/moonshotai/Moonlight-16B-A3B/blob/main/config.json"


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=11264,                       # the one dense layer
        vocab_size=163840,
        attention="mla",
        mla=MLAConfig(q_lora_rank=None, kv_lora_rank=512, qk_nope_dim=128,
                      qk_rope_dim=64, v_head_dim=128),
        moe=MoEConfig(n_experts=64, top_k=6, d_ff=1408, n_shared=2,
                      d_ff_shared=2816, capacity_factor=None,
                      norm_topk=True, scoring="sigmoid", routed_scale=2.446),
        n_dense_layers=1,
        mtp=False,
        tie_embeddings=False,
        rope_theta=50000.0,
        norm_eps=1e-5,
        dtype=torch.bfloat16,
        q_chunk=128, kv_chunk=128,
    )


def smoke_config() -> TransformerConfig:
    """A few layers, 8 experts, f32: the CPU tests' size."""
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=96, vocab_size=512,
        attention="mla",
        mla=MLAConfig(q_lora_rank=None, kv_lora_rank=16, qk_nope_dim=8,
                      qk_rope_dim=4, v_head_dim=8),
        moe=MoEConfig(n_experts=8, top_k=3, d_ff=24, n_shared=2,
                      d_ff_shared=48, capacity_factor=None, norm_topk=True,
                      scoring="sigmoid", routed_scale=2.446),
        n_dense_layers=1, mtp=False, tie_embeddings=False,
        rope_theta=50000.0, norm_eps=1e-5,
        dtype=torch.float32, q_chunk=16, kv_chunk=16,
    )
