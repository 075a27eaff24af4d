"""MIPS -> Euclidean-NN embedding transform (paper Eq. 1).

The port of ``repro.core.embedding``::

    psi_bar = [ psi / ||psi||          , 0 ]                  (queries)
    phi_bar = [ phi / M , sqrt(1 - ||phi||^2 / M^2) ]         (documents)

with M = max_i ||phi_i||, so argmax <psi, phi> == argmin ||psi_bar - phi_bar||
and every transformed vector is a unit vector in R^{l+1}, where the squared
Euclidean distance is 2 - 2<a, b>.
"""

from __future__ import annotations

import torch

__all__ = ["transform_documents", "transform_queries", "distance_from_scores",
           "pairwise_scores", "pairwise_distances"]


def transform_documents(phi: torch.Tensor, max_norm=None):
    """Document side of Eq. 1; returns (phi_bar, M).  ``max_norm`` is M
    (computed from this batch when None; pass the corpus M for increments)."""
    norms = torch.linalg.vector_norm(phi, dim=-1)
    m = norms.max() if max_norm is None else torch.as_tensor(
        max_norm, dtype=phi.dtype, device=phi.device)
    scaled = phi / m
    extra = torch.sqrt(torch.clamp(1.0 - (scaled * scaled).sum(-1), min=0.0))
    return torch.cat([scaled, extra[..., None]], dim=-1), m


def transform_queries(psi: torch.Tensor) -> torch.Tensor:
    """Query side of Eq. 1: L2-normalize and append a zero."""
    normed = psi / torch.linalg.vector_norm(psi, dim=-1, keepdim=True)
    return torch.cat([normed, normed.new_zeros(normed.shape[:-1] + (1,))],
                     dim=-1)


def distance_from_scores(scores: torch.Tensor) -> torch.Tensor:
    """||a - b|| = sqrt(2 - 2<a, b>) for unit vectors a, b."""
    return torch.sqrt(torch.clamp(2.0 - 2.0 * scores, min=0.0))


def pairwise_scores(queries: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
    """(q, l+1) x (n, l+1) -> (q, n) inner products."""
    return queries @ docs.T


def pairwise_distances(queries: torch.Tensor,
                       docs: torch.Tensor) -> torch.Tensor:
    """(q, l+1) x (n, l+1) -> (q, n) Euclidean distances (unit-norm inputs)."""
    return distance_from_scores(pairwise_scores(queries, docs))
