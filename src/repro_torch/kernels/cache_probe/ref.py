"""Plain PyTorch versions of the probe kernel (``csrc/cache_probe.cu``).

The CPU path and the tests use them; ``chip_smoke.py`` holds the kernel
against them on the card.  Same arithmetic: f32 dot of every record with the
session's psi, times the record scale, r_hat = radius - sqrt(clip(2 - 2s)).
``lowquality`` is the plain version of the kernel's decision mode: ring
validity, the first maximal r_hat, the hit test and nearest_q = -1 for a
cache that holds no record.
"""

from __future__ import annotations

import torch


def probe_rhat_batched(q_emb: torch.Tensor, psi: torch.Tensor,
                       radius: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q_emb (S, Qp, Dp) any storage dtype; psi (S, Dp) f32; radius and
    scale (S, Qp) f32 -> r_hat (S, Qp) f32."""
    scores = torch.bmm(q_emb.to(torch.float32), psi[:, :, None])[..., 0]
    scores = scores * scale
    return radius - torch.sqrt(torch.clamp(2.0 - 2.0 * scores, min=0.0))


def probe_rhat(q_emb: torch.Tensor, psi: torch.Tensor, radius: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
    """One session: q_emb (Qp, Dp); psi (Dp,) f32; radius and scale (Qp,)
    f32 -> r_hat (Qp,) f32."""
    return probe_rhat_batched(q_emb[None], psi[None], radius[None],
                              scale[None])[0]


def lowquality(q_emb: torch.Tensor, psi: torch.Tensor, radius: torch.Tensor,
               n_queries: torch.Tensor, epsilon, q_scale=None,
               max_queries: int | None = None):
    """The LowQuality test of S sessions.  q_emb (S, Qp, Dp); psi (S, dim
    <= Dp) f32; radius (S, Qp); n_queries (S,) total record counters;
    q_scale (S, Qp) or None (ones); ``max_queries`` the logical ring length
    (None = every slot).  A record is live iff its slot < min(n_queries,
    max_queries); a dead one has r_hat -inf.  Returns (hit (S,) bool,
    best_r (S,) f32, nearest (S,) int32, -1 for an empty cache)."""
    s, qp, dp = q_emb.shape
    dev = q_emb.device
    mq = qp if max_queries is None else max_queries
    psi = torch.nn.functional.pad(psi.to(torch.float32), (0, dp - psi.shape[1]))
    scale = torch.ones((s, qp), device=dev) if q_scale is None \
        else q_scale.to(torch.float32)
    n_queries = n_queries.to(dev)
    idx = torch.arange(qp, device=dev)[None, :]
    valid = (idx < n_queries[:, None]) & (idx < mq)
    neg = torch.tensor(float("-inf"), device=dev)
    r_hat = torch.where(valid, probe_rhat_batched(
        q_emb, psi, torch.where(valid, radius.to(torch.float32), neg), scale),
        neg)
    best = torch.argmax(r_hat, dim=1)
    best_r = torch.gather(r_hat, 1, best[:, None])[:, 0]
    has_q = n_queries > 0
    hit = has_q & (best_r >= epsilon)
    nearest = torch.where(has_q, best.to(torch.int32),
                          torch.tensor(-1, dtype=torch.int32, device=dev))
    return hit, best_r, nearest
