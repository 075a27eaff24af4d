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
}
_SEQREC = "ROADMAP.md queue 1, item 13 (seqrec: SASRec, BERT4Rec)"
_LM = "ROADMAP.md queue 1, item 13 (the transformer, moe)"
_WAITING = {
    "sasrec": _SEQREC,
    "bert4rec": _SEQREC,
    "egnn": "ROADMAP.md queue 1, item 13 (egnn)",
    "star-encoder": "ROADMAP.md queue 1, item 13 (the transformer)",
    **dict.fromkeys(("deepseek-v3-671b", "llama4-scout-17b-16e",
                     "chatglm3-6b", "mistral-large-123b", "gemma2-9b"), _LM),
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
