"""Architecture registry of the port: ``get(arch)`` for every arch of the
JAX package's ``repro.configs.registry``, and its 40 assigned cells
(``all_cells``).

``RECSYS_SHAPES`` holds the recsys input shapes, copied from the JAX
package's ``launch/cells.py`` (``RECSYS_SHAPE_DEFS``).  Each config module
also carries the JAX package's training constants: ``OPTIMIZER`` (a key
of ``train.optimizer.OPTIMIZERS``), ``TRAIN_ACCUM_STEPS`` and
``ACCUM_DTYPE`` (the gradient accumulator's dtype; the JAX package's
default where its module has none).
"""

from __future__ import annotations

import importlib

__all__ = ["PORTED", "ASSIGNED", "LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES",
           "get", "shapes_for", "all_cells"]

PORTED = {
    "dlrm-rm2": "repro_torch.configs.dlrm_rm2",
    "xdeepfm": "repro_torch.configs.xdeepfm",
    # the dense transformer (the paper's own encoder backbone first)
    "star-encoder": "repro_torch.configs.star_encoder",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
    # MLA / MoE / MTP (and every LM's decode path)
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "llama4-scout-17b-16e": "repro_torch.configs.llama4_scout_17b_a16e",
    # the sequential recommenders and the equivariant GNN
    "sasrec": "repro_torch.configs.sasrec",
    "bert4rec": "repro_torch.configs.bert4rec",
    "egnn": "repro_torch.configs.egnn",
}

# the 40 assigned cells: every arch but the paper's encoder backbone, each
# at its family's shapes (the JAX package's registry, in its order)
ASSIGNED = ("deepseek-v3-671b", "llama4-scout-17b-16e", "chatglm3-6b",
            "mistral-large-123b", "gemma2-9b", "egnn", "bert4rec", "xdeepfm",
            "dlrm-rm2", "sasrec")
LM_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    # one query against the first n_candidates rows of the item table
    "retrieval_cand": dict(kind="retrieval", batch=1,
                           n_candidates=1_000_000),
}


def get(arch_id: str):
    """The config module of a ported arch (``full_config``,
    ``smoke_config``, ``ARCH_ID``, ``FAMILY``)."""
    if arch_id not in PORTED:
        raise KeyError(f"unknown arch {arch_id!r}")
    return importlib.import_module(PORTED[arch_id])


def shapes_for(arch_id: str) -> tuple:
    fam = get(arch_id).FAMILY
    return {"lm": LM_SHAPES, "gnn": GNN_SHAPES,
            "recsys": tuple(RECSYS_SHAPES)}[fam]


def all_cells() -> list:
    """The 40 assigned (arch, shape) cells."""
    return [(a, s) for a in ASSIGNED for s in shapes_for(a)]
