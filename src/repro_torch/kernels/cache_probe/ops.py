"""LowQuality probe: the first launch of every serving wave
(``cache_probe_batched``) and of every turn of Algorithm 1 for one session
(``cache_probe``).

The port of ``repro.kernels.cache_probe.ops``: the wrappers fold ring
validity into the radius as -inf (a slot is live iff its index <
min(n_queries, the LOGICAL ``max_queries``)), run one kernel over the
record payload for r_hat, then take the argmax (the first maximal index, as
``jnp.argmax``), the hit test r_hat >= epsilon, and nearest_q = -1 for
caches that hold no record.  ``cache_probe`` also pads a ring that is not a
multiple of ``layout.RING`` and a width that is not a multiple of
``layout.FEAT`` (never taken for a state from ``init_cache``).

``probe_rhat`` and ``probe_rhat_batched`` dispatch on the tensor's device:
CUDA launches ``csrc/cache_probe.cu`` (entries ``probe_rhat`` and
``probe_rhat_batched``, one counter each), CPU runs the ``ref`` version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import layout
from repro_torch.kernels import _build, dispatch
from repro_torch.kernels.cache_probe import ref

__all__ = ["probe_rhat", "cache_probe", "probe_rhat_batched",
           "cache_probe_batched", "COUNTER", "SINGLE"]

COUNTER = dispatch.counter("cache_probe")
SINGLE = dispatch.counter("probe_rhat")
_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_SINGLE_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _check_f32(name, t, shape, device):
    if t.dtype != torch.float32 or tuple(t.shape) != shape \
            or t.device != device:
        raise ValueError(f"{name}: expected f32 {shape} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def probe_rhat(q_emb: torch.Tensor, psi: torch.Tensor, radius: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
    """r_hat (Qp,) f32 for one session: q_emb (Qp, Dp), psi (Dp,) f32,
    radius and scale (Qp,) f32."""
    if not dispatch.is_kernel(q_emb):
        return ref.probe_rhat(q_emb, psi, radius, scale)
    qp, dp = q_emb.shape
    if q_emb.dtype not in _build.STORE:
        raise TypeError(f"unsupported record payload dtype {q_emb.dtype}")
    for name, t, shape in (("psi", psi, (dp,)), ("radius", radius, (qp,)),
                           ("scale", scale, (qp,))):
        _check_f32(name, t, shape, q_emb.device)
    q_emb, psi, radius, scale = (t.contiguous()
                                 for t in (q_emb, psi, radius, scale))
    out = torch.empty((qp,), dtype=torch.float32, device=q_emb.device)
    fn = _build.function("cache_probe", "probe_rhat", _SINGLE_ARGS)
    SINGLE.launch()
    code = fn(q_emb.data_ptr(), psi.data_ptr(), radius.data_ptr(),
              scale.data_ptr(), out.data_ptr(), qp, dp,
              _build.STORE[q_emb.dtype], _build.stream_of(q_emb))
    _build.check(code, "probe_rhat")
    return out


def cache_probe(q_emb: torch.Tensor, psi: torch.Tensor, radius: torch.Tensor,
                n_queries, epsilon, q_scale: torch.Tensor | None = None,
                max_queries: int | None = None):
    """One LowQuality test.  q_emb (Qmax, D) record payload; psi (dim <= D,)
    f32; radius (Qmax,); n_queries the total record counter (int or 0-dim
    tensor); q_scale (Qmax,) f32 (None = ones); ``max_queries`` the logical
    ring length (None = every slot).  Returns (hit, best_r_hat, best_idx)
    as 0-dim tensors, best_idx -1 for an empty cache."""
    SINGLE.call()
    qmax, d = q_emb.shape
    dev = q_emb.device
    qpad, dpad = (-qmax) % layout.RING, (-d) % layout.FEAT
    if q_scale is None:
        q_scale = torch.ones((qmax,), dtype=torch.float32, device=dev)
    q_scale = q_scale.to(torch.float32)
    radius = radius.to(torch.float32)
    if qpad or dpad:   # unpadded callers only: O(ring), never O(capacity)
        q_emb = torch.nn.functional.pad(q_emb, (0, dpad, 0, qpad))
        radius = torch.nn.functional.pad(radius, (0, qpad),
                                         value=float("-inf"))
        q_scale = torch.nn.functional.pad(q_scale, (0, qpad), value=1.0)
    psi_p = torch.nn.functional.pad(psi.to(torch.float32),
                                    (0, d + dpad - psi.shape[0]))
    hit, best_r, nearest = _lowquality(
        lambda r: probe_rhat(q_emb, psi_p, r[0], q_scale)[None], radius[None],
        torch.as_tensor(n_queries, device=dev).reshape(1), epsilon,
        qmax if max_queries is None else max_queries)
    return hit[0], best_r[0], nearest[0]


def _lowquality(rhat, radius, n_queries, epsilon, max_queries: int):
    """The LowQuality decision over (S, Qp) records: ring validity folded
    into the radius as -inf, r_hat = ``rhat(radius)``, the first maximal
    record, the hit test and nearest_q = -1 for an empty cache."""
    qp = radius.shape[1]
    dev = radius.device
    idx = torch.arange(qp, device=dev)[None, :]
    valid = (idx < n_queries[:, None]) & (idx < max_queries)
    neg = torch.tensor(float("-inf"), device=dev)
    r_hat = torch.where(valid, rhat(torch.where(valid, radius, neg)), neg)
    best = torch.argmax(r_hat, dim=1)
    best_r = torch.gather(r_hat, 1, best[:, None])[:, 0]
    has_q = n_queries > 0
    hit = has_q & (best_r >= epsilon)
    nearest = torch.where(has_q, best.to(torch.int32),
                          torch.tensor(-1, dtype=torch.int32, device=dev))
    return hit, best_r, nearest


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
    if s > 65535:
        raise ValueError(f"{s} sessions exceed the probe grid's 65535 rows")
    for name, t, shape in (("psi", psi, (s, dp)), ("radius", radius, (s, qp)),
                           ("scale", scale, (s, qp))):
        _check_f32(name, t, shape, q_emb.device)
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
    q_scale = q_scale.to(torch.float32)
    return _lowquality(
        lambda r: probe_rhat_batched(q_emb, psi_p, r, q_scale),
        radius.to(torch.float32), n_queries, epsilon,
        qp if max_queries is None else max_queries)
