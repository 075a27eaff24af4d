"""egnn [arXiv:2102.09844]: 4 layers, d_hidden 64, E(n)-equivariant.  The
torch twin of ``repro.configs.egnn``.

The paper's CACHE technique is INAPPLICABLE to this architecture (no
nearest-neighbor retrieval step in its forward path) -- implemented without
it, as in the JAX package."""

import torch

from repro_torch.models.egnn import EGNNConfig

ARCH_ID = "egnn"
FAMILY = "gnn"
OPTIMIZER = "adamw"
TRAIN_ACCUM_STEPS = 1
ACCUM_DTYPE = torch.float32

# per-shape input geometry (the JAX package's)
SHAPES = {
    "full_graph_sm": dict(n_nodes=2708, n_edges=10556, d_feat=1433,
                          kind="full"),
    "minibatch_lg": dict(n_nodes=232965, n_edges=114615892, batch_nodes=1024,
                         fanout=(15, 10), d_feat=602, kind="mini"),
    "ogb_products": dict(n_nodes=2449029, n_edges=61859140, d_feat=100,
                         kind="full"),
    "molecule": dict(n_nodes=30, n_edges=64, batch=128, d_feat=16,
                     kind="batched"),
}


def full_config(d_feat: int = 1433, readout: str = "node") -> EGNNConfig:
    return EGNNConfig(name=ARCH_ID, n_layers=4, d_hidden=64, d_feat_in=d_feat,
                      n_classes=8, readout=readout, dtype=torch.float32)


def smoke_config() -> EGNNConfig:
    return EGNNConfig(name=ARCH_ID + "-smoke", n_layers=2, d_hidden=16,
                      d_feat_in=8, n_classes=4, dtype=torch.float32)
