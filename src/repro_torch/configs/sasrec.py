"""sasrec [arXiv:1808.09781]: causal self-attention sequence recommender,
embed 50, 2 blocks, 1 head, seq 50.  Item vocab 1,048,576 (= retrieval
candidates; the item table is 210 MB of f32).  The torch twin of
``repro.configs.sasrec``."""

import torch

from repro_torch.models.recsys import SeqRecConfig

ARCH_ID = "sasrec"
FAMILY = "recsys"
OPTIMIZER = "adamw"
TRAIN_ACCUM_STEPS = 1
ACCUM_DTYPE = torch.float32


def full_config() -> SeqRecConfig:
    return SeqRecConfig(name=ARCH_ID, vocab=1_048_576, max_len=50,
                        embed_dim=50, n_blocks=2, n_heads=1, causal=True,
                        dtype=torch.float32)


def smoke_config() -> SeqRecConfig:
    return SeqRecConfig(name=ARCH_ID + "-smoke", vocab=200, max_len=12,
                        embed_dim=16, n_blocks=2, n_heads=1, causal=True,
                        dtype=torch.float32)
