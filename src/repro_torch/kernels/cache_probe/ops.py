"""LowQuality probe: the first launch of every serving wave
(``cache_probe_batched``) and of every turn of Algorithm 1 for one session
(``cache_probe``).

The port of ``repro.kernels.cache_probe.ops``.  ``cache_probe`` and
``cache_probe_batched`` are one launch of ``csrc/cache_probe.cu`` in its
decision mode and no PyTorch op after it: the kernel folds ring validity
in (a slot is live iff its index < min(n_queries, the LOGICAL
``max_queries``)), dots only the live records, and takes the first maximal
r_hat (``jnp.argmax``'s pick), the hit test r_hat >= epsilon and
nearest_q = -1 for a cache that holds no record.  Nothing runs before the
launch either when the inputs are the state's own: a missing ``q_scale``
reads as ones, psi is read at its own width (zero past it), any ring
length and width are taken as they are, and an int record count goes to
the kernel as a scalar.

``probe_rhat`` and ``probe_rhat_batched`` return r_hat alone (the kernel's
r_hat mode, the functions held against the JAX kernels).  Every entry
dispatches on the tensor's device: CUDA launches the kernel (counter
``probe_rhat`` for one session, ``cache_probe`` for a wave), CPU runs the
``ref`` version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, dispatch
from repro_torch.kernels.cache_probe import ref

__all__ = ["probe_rhat", "cache_probe", "probe_rhat_batched",
           "cache_probe_batched", "COUNTER", "SINGLE"]

COUNTER = dispatch.counter("cache_probe")
SINGLE = dispatch.counter("probe_rhat")
_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
         + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.float32 and t.is_contiguous() \
        else t.to(torch.float32).contiguous()


def _check(name, t, shape, device, dtype=torch.float32):
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device:
        raise ValueError(f"{name}: expected {dtype} {shape} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _launch(counter: dispatch.KernelCounter, q_emb, psi, radius, scale, *,
            r_hat=None, decision=None, n_queries=None, epsilon=0.0,
            max_queries=None):
    """One launch over q_emb (S, Qp, Dp) (or (Qp, Dp): one session): r_hat
    mode into ``r_hat``, or decision mode into ``decision`` = (hit,
    best_r, nearest) with the record counts ``n_queries`` (an int or an
    (S,) / 0-dim tensor)."""
    if q_emb.dtype not in _build.STORE:
        raise TypeError(f"unsupported record payload dtype {q_emb.dtype}")
    dev = q_emb.device
    qp, dp = q_emb.shape[-2:]
    s = q_emb.shape[0] if q_emb.dim() == 3 else 1
    if qp < 1 or dp < 1:
        raise ValueError(f"empty record ring {tuple(q_emb.shape)}")
    lead = q_emb.shape[:-2]
    if psi.shape[:-1] != lead or psi.shape[-1] > dp:
        raise ValueError(f"psi {tuple(psi.shape)} does not fit records "
                         f"{tuple(q_emb.shape)}")
    psi, radius = _f32(psi), _f32(radius)
    _check("psi", psi, tuple(psi.shape), dev)
    _check("radius", radius, (*lead, qp), dev)
    if scale is not None:
        scale = _f32(scale)
        _check("q_scale", scale, (*lead, qp), dev)
    nq_ptr, nq = None, 0
    if decision is not None:
        if isinstance(n_queries, torch.Tensor):
            if n_queries.dtype != torch.int32 or n_queries.device != dev:
                n_queries = n_queries.to(dev, torch.int32)
            _check("n_queries", n_queries, tuple(lead), dev, torch.int32)
            nq_ptr = n_queries.contiguous().data_ptr()
        else:
            if lead:
                raise ValueError("a batched probe takes n_queries as an "
                                 "(S,) tensor")
            nq = int(n_queries)
    hit, best_r, nearest = decision or (None, None, None)
    q_emb = q_emb.contiguous()
    fn = _build.function("cache_probe", "cache_probe", _ARGS)
    counter.launch()
    code = fn(q_emb.data_ptr(), psi.data_ptr(), radius.data_ptr(),
              None if scale is None else scale.data_ptr(), nq_ptr,
              None if r_hat is None else r_hat.data_ptr(),
              None if hit is None else hit.data_ptr(),
              None if best_r is None else best_r.data_ptr(),
              None if nearest is None else nearest.data_ptr(),
              s, qp, dp, psi.shape[-1], nq,
              qp if max_queries is None else max_queries, float(epsilon),
              _build.STORE[q_emb.dtype], _build.stream_of(q_emb))
    _build.check(code, "cache_probe")


def probe_rhat(q_emb: torch.Tensor, psi: torch.Tensor, radius: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
    """r_hat (Qp,) f32 for one session: q_emb (Qp, Dp), psi (Dp,) f32,
    radius and scale (Qp,) f32."""
    if not dispatch.is_kernel(q_emb):
        return ref.probe_rhat(q_emb, psi, radius, scale)
    if tuple(psi.shape) != (q_emb.shape[1],):
        raise ValueError(f"psi {tuple(psi.shape)} is not ({q_emb.shape[1]},)")
    out = torch.empty((q_emb.shape[0],), dtype=torch.float32,
                      device=q_emb.device)
    _launch(SINGLE, q_emb, psi, radius, scale, r_hat=out)
    return out


def probe_rhat_batched(q_emb: torch.Tensor, psi: torch.Tensor,
                       radius: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """r_hat (S, Qp) f32 for q_emb (S, Qp, Dp), psi (S, Dp) f32, radius and
    scale (S, Qp) f32."""
    if not dispatch.is_kernel(q_emb):
        return ref.probe_rhat_batched(q_emb, psi, radius, scale)
    s, qp, dp = q_emb.shape
    if tuple(psi.shape) != (s, dp):
        raise ValueError(f"psi {tuple(psi.shape)} is not ({s}, {dp})")
    out = torch.empty((s, qp), dtype=torch.float32, device=q_emb.device)
    _launch(COUNTER, q_emb, psi, radius, scale, r_hat=out)
    return out


def _decision(shape, device):
    """Empty (hit, best_r, nearest) of ``shape``: best_r and nearest share
    one allocation."""
    stats = torch.empty((2, *shape), dtype=torch.int32, device=device)
    return (torch.empty(shape, dtype=torch.bool, device=device),
            stats[0].view(torch.float32), stats[1])


@dispatch.kernel_extent
def cache_probe(q_emb: torch.Tensor, psi: torch.Tensor, radius: torch.Tensor,
                n_queries, epsilon, q_scale: torch.Tensor | None = None,
                max_queries: int | None = None):
    """One LowQuality test.  q_emb (Qmax, D) record payload; psi (dim <= D,)
    f32; radius (Qmax,); n_queries the total record counter (int or 0-dim
    tensor); q_scale (Qmax,) f32 (None = ones); ``max_queries`` the logical
    ring length (None = every slot).  Returns (hit, best_r_hat, best_idx)
    as 0-dim tensors, best_idx -1 for an empty cache."""
    SINGLE.call()
    if not dispatch.is_kernel(q_emb):
        out = ref.lowquality(
            q_emb[None], psi[None], radius[None],
            torch.as_tensor(n_queries).reshape(1), epsilon,
            None if q_scale is None else q_scale[None],
            q_emb.shape[0] if max_queries is None else max_queries)
        return tuple(x[0] for x in out)
    out = _decision((), q_emb.device)
    _launch(SINGLE, q_emb, psi, radius, q_scale, decision=out,
            n_queries=n_queries, epsilon=epsilon, max_queries=max_queries)
    return out


@dispatch.kernel_extent
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
    if not dispatch.is_kernel(q_emb):
        return ref.lowquality(q_emb, psi, radius, n_queries, epsilon, q_scale,
                              max_queries)
    out = _decision((q_emb.shape[0],), q_emb.device)
    _launch(COUNTER, q_emb, psi, radius, q_scale, decision=out,
            n_queries=n_queries, epsilon=epsilon, max_queries=max_queries)
    return out
