"""Plain PyTorch versions of the probe kernel (``csrc/cache_probe.cu``).

The CPU path and the tests use it; ``chip_smoke.py`` holds the kernel
against it on the card.  Same arithmetic: f32 dot of every record with the
session's psi, times the record scale, r_hat = radius - sqrt(clip(2 - 2s)).
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
