"""bert4rec [arXiv:1904.06690]: bidirectional sequence recommender,
embed 64, 2 blocks, 2 heads, seq 200.  Encoder-only: no decode shapes.
Item vocab 1,048,576 (the item table is 268 MB of f32).  The torch twin
of ``repro.configs.bert4rec``."""

import torch

from repro_torch.models.recsys import SeqRecConfig

ARCH_ID = "bert4rec"
FAMILY = "recsys"
OPTIMIZER = "adamw"
TRAIN_ACCUM_STEPS = 1
ACCUM_DTYPE = torch.float32


def full_config() -> SeqRecConfig:
    return SeqRecConfig(name=ARCH_ID, vocab=1_048_576, max_len=200,
                        embed_dim=64, n_blocks=2, n_heads=2, causal=False,
                        dtype=torch.float32)


def smoke_config() -> SeqRecConfig:
    return SeqRecConfig(name=ARCH_ID + "-smoke", vocab=200, max_len=16,
                        embed_dim=16, n_blocks=2, n_heads=2, causal=False,
                        dtype=torch.float32)
