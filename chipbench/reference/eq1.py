"""Eq. 1 of the paper (MIPS to Euclidean nearest neighbours), plain:
documents phi -> [phi / M, sqrt(1 - ||phi||^2 / M^2)], queries are unit
vectors with a zero appended; for unit vectors ||a - b|| = sqrt(2 - 2 a.b).
"""

from __future__ import annotations

import torch


def documents(phi: torch.Tensor, max_norm: float) -> torch.Tensor:
    scaled = phi / max_norm
    extra = torch.sqrt(torch.clamp(1.0 - (scaled * scaled).sum(-1), min=0.0))
    return torch.cat([scaled, extra[:, None]], dim=-1)


def distance(scores: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(2.0 - 2.0 * scores, min=0.0))
