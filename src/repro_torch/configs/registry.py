"""Architecture registry of the port: ``get(arch)`` for every arch of the
JAX package's ``repro.configs.registry``.

``RECSYS_SHAPES`` holds the recsys input shapes, copied from the JAX
package's ``launch/cells.py`` (``RECSYS_SHAPE_DEFS``).  Each config module
also carries the JAX package's training constants: ``OPTIMIZER`` (a key
of ``train.optimizer.OPTIMIZERS``), ``TRAIN_ACCUM_STEPS`` and
``ACCUM_DTYPE`` (the gradient accumulator's dtype; the JAX package's
default where its module has none).
"""

from __future__ import annotations

import importlib

__all__ = ["PORTED", "RECSYS_SHAPES", "get"]

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
