"""Metric-cache ops over a stacked ``CacheState``: the port of
``repro.core.cache_ops`` for the L1 session tier.

State layout (leaves at the PHYSICAL extents of ``repro_torch.core.layout``;
``Cp`` = ``cfg.phys_capacity``, ``Dp`` = ``cfg.phys_dim``, ``Qp`` =
``cfg.phys_max_queries``; batched states carry a leading sessions axis):

  doc_emb   (Cp, Dp)   cached transformed documents in ``cfg.store_dtype``
  doc_ids   (Cp,)      int32 global ids, -1 = empty
  doc_stamp (Cp,)      int32 last-use step (LRU policy)
  q_emb     (Qp, Dp)   records of back-end-answered queries (same format)
  q_radius  (Qp,)      f32 r_a, -inf = no record
  n_docs, n_queries, step   int32 counters (n_queries is the monotone total;
                            the records form a ring over ``max_queries``)
  doc_scale (Cp,), q_scale (Qp,)   f32 score multipliers (ones unless int8)

Padded slots hold the empty-slot sentinels forever; every op masks on the
logical extents, and a dropped insert position is ``phys_capacity``.

**In place.**  Unlike the JAX package, the ops UPDATE THE STATE TENSORS IN
PLACE and return the same state object: the cache payload is the largest
allocation of the serving path, and the wave kernel writes it directly.
Callers that need the old state keep a copy.

**A wave's rows.**  The batched ops take ``rows`` (W,) int32: the state's
``doc_emb`` is then the whole stacked payload and wave row w's payload is
row ``rows[w]``, while every other leaf holds the wave's own W rows (what
``BatchedMetricCache.gather(..., payload=False)`` hands a wave).  The wave
kernel reads and writes the payload through that index, so no wave copies
it.

Every op is batched: psi (S, dim), and ``do`` / ``record`` masks gate which
rows insert and which record a claim.  The scalar ops run the batched ones
on a one-row view of an unbatched state.  The heavy steps go through the
kernel wrappers (``kernels.cache_probe``, ``kernels.cache_wave``), which
launch on a CUDA state and run their plain versions on a CPU one; the
position logic (dedup, append, LRU / ball eviction) is plain PyTorch here,
shared by every path.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import embedding as emb
from repro_torch.core import layout, quant
from repro_torch.kernels.cache_probe.ops import cache_probe_batched
from repro_torch.kernels.cache_wave import ops as wave_ops
from repro_torch.kernels.dispatch import resolve_device

__all__ = ["CacheState", "CacheConfig", "ProbeResult", "init_cache",
           "init_batched_cache", "reset_sessions", "probe", "query",
           "insert", "probe_batched", "query_batched", "insert_batched",
           "insert_query_batched", "pad_features", "store_rows",
           "dedup_mask", "evicting_positions", "insert_positions",
           "validate_state", "to_numpy"]


class CacheState(NamedTuple):
    doc_emb: torch.Tensor
    doc_ids: torch.Tensor
    doc_stamp: torch.Tensor
    q_emb: torch.Tensor
    q_radius: torch.Tensor
    n_docs: torch.Tensor
    n_queries: torch.Tensor
    step: torch.Tensor
    doc_scale: torch.Tensor
    q_scale: torch.Tensor


class CacheConfig(NamedTuple):
    capacity: int              # logical doc-slot count
    dim: int                   # logical feature width
    max_queries: int = 64      # logical query-record ring length
    epsilon: float = 0.04      # the paper's tuned default (Fig. 4)
    dedup: bool = True
    eviction: str = "none"     # "none" (paper) | "lru" | "ball"
    store_dtype: str = "fp32"  # quant.DTYPES

    @property
    def phys_capacity(self) -> int:
        return layout.phys_capacity(self.capacity)

    @property
    def phys_dim(self) -> int:
        return layout.phys_dim(self.dim)

    @property
    def phys_max_queries(self) -> int:
        return layout.phys_queries(self.max_queries)


class ProbeResult(NamedTuple):
    hit: torch.Tensor        # bool — r_hat >= epsilon for some record
    r_hat: torch.Tensor      # max over records of (r_a - delta(psi_a, psi))
    nearest_q: torch.Tensor  # argmax (int32), -1 when there is no record


def init_batched_cache(cfg: CacheConfig, n_sessions: int,
                       device=None) -> CacheState:
    """``n_sessions`` empty cache rows at the physical extents."""
    dev = resolve_device(device)
    store = quant.storage_dtype(cfg.store_dtype)
    s, cp, dp, qp = n_sessions, cfg.phys_capacity, cfg.phys_dim, \
        cfg.phys_max_queries
    i32, f32 = torch.int32, torch.float32
    return CacheState(
        doc_emb=torch.zeros((s, cp, dp), dtype=store, device=dev),
        doc_ids=torch.full((s, cp), -1, dtype=i32, device=dev),
        doc_stamp=torch.zeros((s, cp), dtype=i32, device=dev),
        q_emb=torch.zeros((s, qp, dp), dtype=store, device=dev),
        q_radius=torch.full((s, qp), float("-inf"), dtype=f32, device=dev),
        n_docs=torch.zeros((s,), dtype=i32, device=dev),
        n_queries=torch.zeros((s,), dtype=i32, device=dev),
        step=torch.zeros((s,), dtype=i32, device=dev),
        doc_scale=torch.ones((s, cp), dtype=f32, device=dev),
        q_scale=torch.ones((s, qp), dtype=f32, device=dev))


def reset_sessions(state: CacheState, cfg: CacheConfig,
                   mask) -> CacheState:
    """Re-initialize, in place, the rows of a batched state where ``mask``
    (S,) is True; the others are untouched.  Returns the same state."""
    mask = torch.as_tensor(mask, dtype=torch.bool,
                           device=state.doc_ids.device)
    for full, one in zip(state, init_batched_cache(cfg, 1,
                                                   state.doc_ids.device)):
        full[mask] = one
    return state


def init_cache(cfg: CacheConfig, device=None) -> CacheState:
    """One unbatched cache row at the physical extents."""
    return CacheState(*(x[0] for x in init_batched_cache(cfg, 1, device)))


def pad_features(x: torch.Tensor, width: int) -> torch.Tensor:
    """Zero-pad the trailing feature axis to ``width`` (no-op if aligned)."""
    short = width - x.shape[-1]
    if short < 0:
        raise ValueError(f"rows of width {x.shape[-1]} exceed {width}")
    return x if short == 0 else torch.nn.functional.pad(x, (0, short))


def store_rows(x: torch.Tensor, store_dtype: str):
    """Rows in the storage format and their scales (ones when the format
    carries none)."""
    qc = quant.quantize(x, store_dtype)
    if qc.scale is None:
        return qc.data, torch.ones(x.shape[:-1], dtype=torch.float32,
                                   device=x.device)
    return qc.data, qc.scale


def _rows(state: CacheState) -> CacheState:
    """One-row batched view of an unbatched state (shares its storage)."""
    return CacheState(*(x.unsqueeze(0) for x in state))


def _isin_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per row r: a[r, j] in b[r, :].  Sort-based, O((|a| + |b|) log |b|)
    memory-light, never the |a| x |b| comparison matrix."""
    srt = torch.sort(b, dim=1).values.contiguous()
    idx = torch.searchsorted(srt, a.contiguous()).clamp(max=b.shape[1] - 1)
    return torch.gather(srt, 1, idx) == a


def dedup_mask(new_ids: torch.Tensor, existing_ids: torch.Tensor) -> torch.Tensor:
    """(S, kc): True for the first occurrence of each id not already cached."""
    in_cache = _isin_rows(new_ids, existing_ids)
    srt, order = torch.sort(new_ids, dim=1, stable=True)
    dup_sorted = torch.zeros_like(new_ids, dtype=torch.bool)
    dup_sorted[:, 1:] = srt[:, 1:] == srt[:, :-1]
    dup_later = torch.zeros_like(dup_sorted).scatter_(1, order, dup_sorted)
    return ~in_cache & ~dup_later


def evicting_positions(state: CacheState, capacity: int, keep: torch.Tensor,
                       evict_key: torch.Tensor, evictable: torch.Tensor,
                       drop: int):
    """Write positions under an eviction policy (see the JAX docstring):
    appends fill [n_docs, capacity), then kept docs overwrite evictable
    slots in ascending ``evict_key`` order (stable); the rest drop."""
    n_docs = state.n_docs.long()[:, None]
    rank = torch.cumsum(keep.long(), dim=1) - 1
    append_pos = n_docs + rank
    inf = torch.tensor(float("inf"), device=evict_key.device)
    evict_order = torch.argsort(torch.where(evictable, evict_key, inf),
                                dim=1, stable=True)
    evict_rank = rank - (capacity - n_docs)
    evict_pos = torch.gather(evict_order, 1,
                             torch.clamp(evict_rank, 0, capacity - 1))
    pos = torch.where(append_pos < capacity, append_pos, evict_pos)
    placeable = evict_rank < evictable.sum(dim=1, keepdim=True)
    pos = torch.where(keep & placeable, pos, torch.full_like(pos, drop))
    dropped = (keep & ~placeable).sum(dim=1).to(torch.int32)
    return pos, dropped


def insert_positions(state: CacheState, cfg: CacheConfig, psi: torch.Tensor,
                     new_ids: torch.Tensor, rows=None):
    """(keep, pos, dropped, new_n) of one batched insert; ``pos`` equals
    ``cfg.phys_capacity`` for a dropped or unkept document."""
    drop = cfg.phys_capacity
    keep = dedup_mask(new_ids, state.doc_ids) if cfg.dedup \
        else torch.ones_like(new_ids, dtype=torch.bool)
    keep = keep & (new_ids >= 0)
    if cfg.eviction in ("lru", "ball"):
        occupied = state.doc_ids >= 0
        in_batch = _isin_rows(state.doc_ids, new_ids)
        evictable = occupied & ~in_batch
        if cfg.eviction == "lru":
            key = state.doc_stamp.to(torch.float32)
        else:
            psi_p = pad_features(psi.to(torch.float32), state.doc_emb.shape[-1])
            payload = state.doc_emb if rows is None \
                else state.doc_emb.index_select(0, rows)
            scores = torch.bmm(payload.to(torch.float32),
                               psi_p[:, :, None])[..., 0]
            key = -emb.distance_from_scores(
                quant.scale_scores(scores, state.doc_scale))
        pos, dropped = evicting_positions(state, cfg.capacity, keep, key,
                                          evictable, drop)
    elif cfg.eviction == "none":
        append_pos = state.n_docs.long()[:, None] \
            + torch.cumsum(keep.long(), dim=1) - 1
        fits = append_pos < cfg.capacity
        pos = torch.where(keep & fits, append_pos,
                          torch.full_like(append_pos, drop))
        dropped = (keep & ~fits).sum(dim=1).to(torch.int32)
    else:
        raise ValueError(f"eviction {cfg.eviction!r}: expected none/lru/ball")
    new_n = torch.clamp(state.n_docs + keep.sum(dim=1).to(torch.int32),
                        max=cfg.capacity)
    return keep, pos.to(torch.int32), dropped, new_n.to(torch.int32)


def probe_batched(state: CacheState, psi: torch.Tensor, epsilon,
                  max_queries: int | None = None) -> ProbeResult:
    """One LowQuality test (Eq. 3/4) per row: one probe-kernel launch."""
    return ProbeResult(*cache_probe_batched(
        state.q_emb, psi, state.q_radius, state.n_queries, epsilon,
        q_scale=state.q_scale, max_queries=max_queries))


def _apply_query_touch(state: CacheState, ids: torch.Tensor,
                       slots: torch.Tensor) -> None:
    """The query's state update: stamp the returned REAL docs with the
    row's step (empty-slot answers are not touched), then bump step.  The
    touched slots are marked by a scatter of counts rather than found with
    a mask, which would wait for the device."""
    touched = torch.zeros(state.doc_stamp.shape, dtype=torch.int32,
                          device=ids.device)
    touched.scatter_add_(1, slots.long().clamp(0, touched.shape[1] - 1),
                         (ids >= 0).to(torch.int32))
    state.doc_stamp.copy_(torch.where(touched > 0, state.step[:, None],
                                      state.doc_stamp))
    state.step.add_(1)


def query_batched(state: CacheState, psi: torch.Tensor, k: int, rows=None):
    """Per-row top-k (one wave-kernel launch in query mode), then the LRU
    touch and step bump in place.  Returns ((scores, dists, ids, slots),
    state)."""
    psi_p = pad_features(psi.to(torch.float32), state.doc_emb.shape[-1])
    vals, ids, slots = wave_ops.wave_query_topk(
        state.doc_emb, state.doc_ids, state.doc_scale, psi_p, k, rows)
    _apply_query_touch(state, ids, slots)
    return (vals, emb.distance_from_scores(vals), ids, slots), state


def _gated(n: int, do, record, device):
    do = torch.ones((n,), dtype=torch.bool, device=device) if do is None \
        else torch.as_tensor(do, dtype=torch.bool, device=device)
    record = do if record is None \
        else torch.as_tensor(record, dtype=torch.bool, device=device)
    return do, record


def _insert(state, cfg, psi, radius, new_emb, new_ids, do, record, k=None,
            rows=None):
    dev = state.doc_ids.device
    new_ids = torch.as_tensor(new_ids, device=dev).to(torch.int32)
    psi = torch.as_tensor(psi, device=dev).to(torch.float32)
    do, record = _gated(new_ids.shape[0], do, record, dev)
    _keep, pos, dropped, new_n = insert_positions(state, cfg, psi, new_ids,
                                                  rows)
    cp, dp = cfg.phys_capacity, state.doc_emb.shape[-1]
    pos = torch.where(do[:, None], pos, torch.full_like(pos, cp))
    dropped = torch.where(do, dropped, torch.zeros_like(dropped))
    rec_g = do & record
    emb_q, emb_scale = store_rows(torch.as_tensor(new_emb, device=dev),
                                  cfg.store_dtype)
    psi_q, psi_scale = store_rows(psi, cfg.store_dtype)
    qslot = torch.remainder(state.n_queries, cfg.max_queries)
    radius = torch.as_tensor(radius, device=dev).to(torch.float32) \
        .expand(new_ids.shape[0])
    args = (state.doc_emb, state.doc_ids, state.doc_stamp, state.doc_scale,
            state.q_emb, state.q_radius, state.q_scale,
            pad_features(emb_q, dp), emb_scale, new_ids, pos,
            pad_features(psi_q, dp), psi_scale, radius, rec_g, qslot,
            state.step)
    out = None
    if k is None:
        wave_ops.wave_insert_scatter(*args, rows=rows)
    else:
        out = wave_ops.wave_insert_query(*args, psi=pad_features(psi, dp), k=k,
                                         rows=rows)
    state.n_docs.copy_(torch.where(do, new_n, state.n_docs))
    state.n_queries.add_(rec_g.to(torch.int32))
    state.step.add_(do.to(torch.int32))
    return out, dropped


def insert_batched(state: CacheState, cfg: CacheConfig, psi, radius,
                   new_emb, new_ids, do=None, record=None, rows=None):
    """Row-gated batched insert (one wave-kernel launch in insert mode).
    psi (S, dim), radius (S,), new_emb (S, kc, dim <= Dp), new_ids (S, kc).
    ``do`` masks the rows that insert at all, ``record`` the rows that
    record their (psi, r_a) claim.  Updates ``state`` in place; returns
    (state, dropped (S,))."""
    _, dropped = _insert(state, cfg, psi, radius, new_emb, new_ids, do, record,
                         rows=rows)
    return state, dropped


def insert_query_batched(state: CacheState, cfg: CacheConfig, psi, radius,
                         new_emb, new_ids, k: int, do=None, record=None,
                         rows=None):
    """The wave's tail: ``insert_batched`` then ``query_batched`` on the
    post-insert state, ONE wave-kernel launch.  Updates ``state`` in place;
    returns ((scores, dists, ids, slots), state, dropped)."""
    (vals, ids, slots), dropped = _insert(state, cfg, psi, radius, new_emb,
                                          new_ids, do, record, k=k, rows=rows)
    _apply_query_touch(state, ids, slots)
    return (vals, emb.distance_from_scores(vals), ids, slots), state, dropped


def probe(state: CacheState, psi: torch.Tensor, epsilon,
          max_queries: int | None = None) -> ProbeResult:
    """The LowQuality test of one unbatched state."""
    res = probe_batched(_rows(state), psi[None], epsilon, max_queries)
    return ProbeResult(*(x[0] for x in res))


def query(state: CacheState, psi: torch.Tensor, k: int):
    """NN(C, psi, k) of one unbatched state, in place (LRU touch, step)."""
    out, _ = query_batched(_rows(state), psi[None], k)
    return tuple(x[0] for x in out), state


def insert(state: CacheState, cfg: CacheConfig, psi, radius, new_emb,
           new_ids, record=True):
    """Insert the k_c back-end results of one miss into an unbatched state,
    in place.  Returns (state, n_dropped)."""
    dev = state.doc_ids.device
    _, dropped = _insert(_rows(state), cfg, torch.as_tensor(psi)[None],
                         torch.as_tensor(radius, dtype=torch.float32)
                         .reshape(1), torch.as_tensor(new_emb)[None],
                         torch.as_tensor(new_ids)[None], None,
                         torch.tensor([bool(record)], device=dev))
    return state, dropped[0]


def to_numpy(x) -> np.ndarray:
    """numpy copy of a tensor or view of any array (a JAX one included);
    bf16 is widened to f32, which holds every bf16 value exactly."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def validate_state(state: CacheState, cfg: CacheConfig, *,
                   n_corpus: int | None = None):
    """Integrity check of a (batched) state against its layout invariants:
    counters in range, an occupied id prefix, untouched pad sentinels,
    finite payloads and scales, radii never NaN or +inf.  Host-side and
    read-only.  Returns (ok per row, list of problems)."""
    batched = state.n_docs.ndim > 0
    leaves = {f: to_numpy(getattr(state, f)) for f in state._fields}
    if not batched:
        leaves = {f: v[None] for f, v in leaves.items()}
    rows = leaves["n_docs"].shape[0]
    cap, qmax = cfg.capacity, cfg.max_queries
    ok = np.ones((rows,), bool)
    problems: list[str] = []

    def flag(mask, what):
        bad = np.asarray(mask, bool)
        if bad.any():
            ok[bad] = False
            problems.extend(f"row {int(r)}: {what}" for r in np.nonzero(bad)[0])

    n_docs = leaves["n_docs"]
    flag((n_docs < 0) | (n_docs > cap), "n_docs outside [0, capacity]")
    flag(leaves["n_queries"] < 0, "negative n_queries")
    flag(leaves["step"] < 0, "negative step")
    nd = np.clip(n_docs, 0, cap)[:, None]
    ids = leaves["doc_ids"]
    col = np.arange(ids.shape[1])[None, :]
    occupied, vacant = col < nd, (col >= nd) & (col < cap)
    flag((occupied & (ids < 0)).any(axis=1),
         "sentinel id inside the occupied prefix")
    if n_corpus is not None:
        flag((occupied & (ids >= n_corpus)).any(axis=1),
             "doc id beyond the corpus")
    flag((vacant & (ids != -1)).any(axis=1), "non-sentinel id in a vacant slot")
    flag((ids[:, cap:] != -1).any(axis=1), "pad doc slot lost its -1 id")
    flag((leaves["doc_stamp"][:, cap:] != 0).any(axis=1),
         "pad doc slot carries an LRU stamp")
    flag((leaves["doc_scale"][:, cap:] != 1.0).any(axis=1),
         "pad doc slot scale != 1")
    scale = leaves["doc_scale"][:, :cap]
    flag((~np.isfinite(scale) | (scale <= 0)).any(axis=1),
         "non-finite or non-positive doc scale")
    qscale = leaves["q_scale"]
    flag((~np.isfinite(qscale) | (qscale <= 0)).any(axis=1),
         "non-finite or non-positive query scale")
    rad = leaves["q_radius"]
    flag((np.isnan(rad) | (rad == np.inf)).any(axis=1),
         "NaN or +inf claim radius")
    flag((rad[:, qmax:] != -np.inf).any(axis=1),
         "pad ring slot lost its -inf radius sentinel")
    if not np.issubdtype(leaves["doc_emb"].dtype, np.integer):
        flag(~np.isfinite(leaves["doc_emb"][:, :cap]).all(axis=(1, 2)),
             "non-finite cached document embedding")
        flag(~np.isfinite(leaves["q_emb"]).all(axis=(1, 2)),
             "non-finite claim query embedding")
    return (ok if batched else ok[0]), problems
