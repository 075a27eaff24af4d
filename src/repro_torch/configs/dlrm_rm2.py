"""dlrm-rm2 [arXiv:1906.00091]: 13 dense + 26 sparse features, embed 64,
bottom MLP 13-512-256-64, top MLP 512-512-256-1, dot interaction.
Tables: 26 x 1,048,576 rows x 64 (6.98 GB of f32).  The torch twin of
``repro.configs.dlrm_rm2``."""

import torch

from repro_torch.models.recsys import DLRMConfig

ARCH_ID = "dlrm-rm2"
FAMILY = "recsys"
OPTIMIZER = "adamw"
TRAIN_ACCUM_STEPS = 1
ACCUM_DTYPE = torch.float32


def full_config() -> DLRMConfig:
    return DLRMConfig(name=ARCH_ID, n_dense=13, n_sparse=26, embed_dim=64,
                      vocab=1_048_576, multi_hot=1,
                      bot_mlp=(13, 512, 256, 64),
                      top_mlp_hidden=(512, 512, 256, 1),
                      dtype=torch.float32)


def smoke_config() -> DLRMConfig:
    return DLRMConfig(name=ARCH_ID + "-smoke", n_dense=13, n_sparse=4,
                      embed_dim=8, vocab=1000, multi_hot=2,
                      bot_mlp=(13, 16, 8), top_mlp_hidden=(16, 1),
                      dtype=torch.float32)
