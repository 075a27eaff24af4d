"""Per-turn result record and the back-end answer -> insert helper.

The port of ``repro.serve.engine``'s ``EngineTurn`` and ``radius_and_docs``
(the single-session ``ConversationalEngine`` is not part of this port yet).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["EngineTurn", "radius_and_docs", "radius_from_scores"]


@dataclasses.dataclass
class EngineTurn:
    ids: np.ndarray
    scores: np.ndarray
    hit: bool
    degraded: bool
    latency_s: float
    # serving tier: "l1" (session cache) or "backend" (full retrieval);
    # ``hit`` is the paper's notion — True iff no back-end query ran
    tier: str = "l1"
    # admission -> wave start, and the wave-level span breakdown
    # (``repro_torch.serve.telemetry.TurnSpans``) for batched turns
    queue_wait_s: float = 0.0
    spans: Optional[object] = None


def radius_from_scores(scores: np.ndarray) -> np.ndarray:
    """Eq. 1 distance of unit vectors from their inner products, in f32."""
    s = np.asarray(scores, np.float32)
    return np.sqrt(np.clip(np.float32(2.0) - np.float32(2.0) * s,
                           np.float32(0.0), None))


def radius_and_docs(scores: np.ndarray, ids: np.ndarray,
                    doc_embeddings: torch.Tensor):
    """r_a and the insertable docs of one merged back-end row.

    r_a comes from the LAST VALID column (short merges are padded with
    (-inf, -1) sentinels), never from a sentinel.  The embeddings are
    gathered on ``doc_embeddings``' device; sentinel ids are clipped for
    the lookup and never inserted.
    """
    n_valid = int((ids >= 0).sum())
    if n_valid == 0:
        raise TimeoutError("back-end answer holds no valid documents")
    radius = float(radius_from_scores(scores[n_valid - 1]))
    idx = torch.as_tensor(np.maximum(ids, 0), device=doc_embeddings.device)
    return radius, doc_embeddings[idx], torch.as_tensor(ids)
