"""xdeepfm [arXiv:1803.05170]: 39 sparse fields, embed 10, CIN 200-200-200,
DNN 400-400, order-1 linear term.  Tables: 39 x 1,048,576 x 10 plus the
39 x 1,048,576 x 1 linear term (1.80 GB of f32).  The torch twin of
``repro.configs.xdeepfm``."""

import torch

from repro_torch.models.recsys import XDeepFMConfig

ARCH_ID = "xdeepfm"
FAMILY = "recsys"
OPTIMIZER = "adamw"
TRAIN_ACCUM_STEPS = 1
ACCUM_DTYPE = torch.float32


def full_config() -> XDeepFMConfig:
    return XDeepFMConfig(name=ARCH_ID, n_sparse=39, embed_dim=10,
                         vocab=1_048_576, cin_layers=(200, 200, 200),
                         mlp=(400, 400), dtype=torch.float32)


def smoke_config() -> XDeepFMConfig:
    return XDeepFMConfig(name=ARCH_ID + "-smoke", n_sparse=6, embed_dim=4,
                         vocab=500, cin_layers=(8, 8), mlp=(16,),
                         dtype=torch.float32)
