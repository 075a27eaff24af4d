"""Batched LowQuality probe: the first launch of every serving wave.

The port of ``repro.kernels.cache_probe.ops.cache_probe_batched``: the
wrapper folds ring validity into the radius as -inf (a slot is live iff its
index < min(n_queries, the LOGICAL ``max_queries``)), runs one kernel over
the stacked record payload for r_hat, then takes the argmax (the first
maximal index, as ``jnp.argmax``), the hit test r_hat >= epsilon, and
nearest_q = -1 for caches that hold no record.

``probe_rhat_batched`` dispatches on the tensor's device: CUDA launches
``csrc/cache_probe.cu``, CPU runs ``ref.probe_rhat_batched``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, dispatch
from repro_torch.kernels.cache_probe import ref

__all__ = ["probe_rhat_batched", "cache_probe_batched", "COUNTER"]

COUNTER = dispatch.counter("cache_probe")
_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def probe_rhat_batched(q_emb: torch.Tensor, psi: torch.Tensor,
                       radius: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """r_hat (S, Qp) f32 for q_emb (S, Qp, Dp), psi (S, Dp) f32, radius and
    scale (S, Qp) f32."""
    if not dispatch.is_kernel(q_emb):
        return ref.probe_rhat_batched(q_emb, psi, radius, scale)
    s, qp, dp = q_emb.shape
    if q_emb.dtype not in _build.STORE:
        raise TypeError(f"unsupported record payload dtype {q_emb.dtype}")
    for name, t, shape in (("psi", psi, (s, dp)), ("radius", radius, (s, qp)),
                           ("scale", scale, (s, qp))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape \
                or t.device != q_emb.device:
            raise ValueError(f"{name}: expected f32 {shape} on {q_emb.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    q_emb, psi, radius, scale = (t.contiguous()
                                 for t in (q_emb, psi, radius, scale))
    out = torch.empty((s, qp), dtype=torch.float32, device=q_emb.device)
    fn = _build.function("cache_probe", "probe_rhat_batched", _ARGS)
    COUNTER.launch()
    code = fn(q_emb.data_ptr(), psi.data_ptr(), radius.data_ptr(),
              scale.data_ptr(), out.data_ptr(), s, qp, dp,
              _build.STORE[q_emb.dtype], _build.stream_of(q_emb))
    _build.check(code, "probe_rhat_batched")
    return out


def cache_probe_batched(q_emb: torch.Tensor, psi: torch.Tensor,
                        radius: torch.Tensor, n_queries: torch.Tensor,
                        epsilon, q_scale: torch.Tensor | None = None,
                        max_queries: int | None = None):
    """One LowQuality test per session.  q_emb (S, Qp, Dp) stacked record
    payload; psi (S, dim <= Dp) f32; radius (S, Qp); n_queries (S,) total
    record counters; q_scale (S, Qp) f32 (None = ones); ``max_queries`` the
    logical ring length (None = every slot).  Returns (hit (S,) bool,
    best_r_hat (S,) f32, best_idx (S,) int32, -1 for empty caches)."""
    COUNTER.call()
    s, qp, dp = q_emb.shape
    dev = q_emb.device
    psi_p = torch.nn.functional.pad(psi.to(torch.float32),
                                    (0, dp - psi.shape[1]))
    if q_scale is None:
        q_scale = torch.ones((s, qp), dtype=torch.float32, device=dev)
    mq = qp if max_queries is None else max_queries
    idx = torch.arange(qp, device=dev)[None, :]
    valid = (idx < n_queries[:, None]) & (idx < mq)
    neg = torch.tensor(float("-inf"), device=dev)
    radius_m = torch.where(valid, radius.to(torch.float32), neg)
    r_hat = probe_rhat_batched(q_emb, psi_p, radius_m,
                               q_scale.to(torch.float32))
    r_hat = torch.where(valid, r_hat, neg)
    best = torch.argmax(r_hat, dim=1)
    best_r = torch.gather(r_hat, 1, best[:, None])[:, 0]
    has_q = n_queries > 0
    hit = has_q & (best_r >= epsilon)
    nearest = torch.where(has_q, best.to(torch.int32),
                          torch.tensor(-1, dtype=torch.int32, device=dev))
    return hit, best_r, nearest
