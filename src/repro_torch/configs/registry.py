"""Architecture registry of the port: ``get(arch)`` for the ported archs.

An arch the JAX package knows (``repro.configs.registry``) but the port
does not serve yet raises ``NotImplementedError`` naming the ROADMAP item
that ports it.  ``RECSYS_SHAPES`` holds the ported recsys input shapes,
copied from the JAX package's ``launch/cells.py`` (``RECSYS_SHAPE_DEFS``);
``train_batch`` and ``retrieval_cand`` wait for training and retrieval.
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
}
_SEQREC = "ROADMAP.md queue 1, item 13c (seqrec: SASRec, BERT4Rec)"
_WAITING = {
    "sasrec": _SEQREC,
    "bert4rec": _SEQREC,
    "egnn": "ROADMAP.md queue 1, item 13d (egnn)",
}

RECSYS_SHAPES = {
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
}


def get(arch_id: str):
    """The config module of a ported arch (``full_config``,
    ``smoke_config``, ``ARCH_ID``, ``FAMILY``)."""
    if arch_id in PORTED:
        return importlib.import_module(PORTED[arch_id])
    if arch_id in _WAITING:
        raise NotImplementedError(f"{arch_id} is not ported yet: "
                                  f"{_WAITING[arch_id]}")
    raise KeyError(f"unknown arch {arch_id!r}")
