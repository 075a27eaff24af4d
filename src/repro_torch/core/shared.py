"""Cross-session shared cache tier (L2) with semantic result reuse.

The port of ``repro.core.shared``.  ``SharedTier`` sits between the
per-session L1 caches and the back end (probe order: L1 -> L2 memo -> L2
shards -> back end).  An L2 shard is one row of the same stacked
``CacheState`` the L1 tier uses (``core.cache.BatchedMetricCache``, LRU
eviction), driven by the same ops and kernels: the L2 probe is
``probe_batched`` over the wave's gathered shard rows, L2 answers come
from ``query_batched`` and admissions from ``insert_batched``.  The shard
payload stays in the stacked state: a wave reads and writes it through
``rows=``, never through a copy.

* **Shard routing** — ``argmax(psi @ R)`` for a fixed seeded Gaussian
  ``R`` (dim, n_shards): near-duplicate queries agree on the shard.
* **Admission** — a back-end answer is *offered*; it is promoted whole
  (claim and documents) once ``admission_frac`` of its documents were
  retrieved by ``admission_sessions`` distinct session tokens (per
  topical cluster with a ``ClusterIndex`` attached).  Offered answers
  keep their embedding rows as tensors on the tier's device until the
  end-of-wave ``flush_admissions``.
* **Semantic result memo** — recent (psi, top-k_c) pairs of fresh
  retrievals; a near-duplicate query (cosine >= ``memo_sim``) from
  another session reuses the set, with the Eq. 3 claim
  ``r_a - delta(psi_a, psi)``.
* **TTL** — ``tick()`` retires claims older than ``ttl_waves`` by
  writing -inf into their ``q_radius`` slots, in place.

Host bookkeeping (the router matrix, admission counts, claim stamps, the
memo) is numpy, exactly as in the JAX package.

**Repeated shard rows.**  A wave routes many rows to a few shards, so
its gathered sub-state repeats rows.  The JAX package scatters them back
with ``.at[idx].set``, where the last occurrence wins on the CPU.
``query_rows`` writes each shard back once, from its last row, on either
device, so its LRU stamps and ``step`` are those of the wave's last row
for each shard.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import quant
from repro_torch.core.cache import BatchedMetricCache
from repro_torch.core.cache_ops import (CacheConfig, CacheState, ProbeResult,
                                        insert_batched, probe_batched,
                                        query_batched)

__all__ = ["SharedTier"]

_NEVER = -(2 ** 62)  # claim/memo stamp for "never written"


class SharedTier:
    """Sharded, TTL'd, cross-session L2 embedding cache + result memo on
    one device (None means ``cuda``)."""

    def __init__(self, *, dim: int, n_shards: int = 4, capacity: int = 4096,
                 max_queries: int = 256, epsilon: float = 0.04,
                 ttl_waves: Optional[int] = 512,
                 admission_sessions: int = 2, admission_frac: float = 0.5,
                 admission_table_max: int = 1_000_000,
                 memo_size: int = 256, memo_sim: float = 0.995,
                 cluster=None, dtype: Optional[str] = None, seed: int = 0,
                 device=None):
        self.cfg = CacheConfig(capacity=capacity, dim=dim,
                               max_queries=max_queries, epsilon=epsilon,
                               eviction="lru",
                               store_dtype=quant.resolve_dtype(dtype))
        self.n_shards = n_shards
        self.shards = BatchedMetricCache(self.cfg, n_shards, device)
        self.device = self.shards.device
        self._router = np.random.default_rng(seed).standard_normal(
            (dim, n_shards)).astype(np.float32)
        self.ttl_waves = ttl_waves
        self.wave = 0
        qp = self.cfg.phys_max_queries
        self._claim_wave = np.full((n_shards, qp), _NEVER, np.int64)
        self._claim_alive = np.zeros((n_shards, qp), bool)
        self.admission_sessions = admission_sessions
        self.admission_frac = admission_frac
        self.admission_table_max = admission_table_max
        self.cluster = cluster
        self._seen: dict[int, set] = {}
        self._pending: list[tuple] = []
        self.memo_size = memo_size
        self.memo_sim = memo_sim
        self._memo_psi: Optional[np.ndarray] = None   # (M, dim) f32
        self._memo_ids: Optional[np.ndarray] = None   # (M, k_c)
        self._memo_scores: Optional[np.ndarray] = None
        self._memo_radius = np.zeros((memo_size,), np.float32)
        self._memo_token: list = [None] * memo_size
        self._memo_wave = np.full((memo_size,), _NEVER, np.int64)
        self._memo_n = 0
        self.n_promoted = 0
        self.n_offered = 0
        self.n_memo_served = 0
        self.n_stale_served = 0
        self.total_dropped = 0

    @property
    def state(self) -> CacheState:
        """The stacked shard state (n_shards rows)."""
        return self.shards.state

    @state.setter
    def state(self, value: CacheState) -> None:
        self.shards.state = value

    # ---------------------------------------------------------------- waves
    def tick(self) -> None:
        """Advance the wave clock; retire claims past their TTL by writing
        -inf into their ring slots' radius, in place (the documents stay:
        embeddings don't go stale, claims do)."""
        self.wave += 1
        if self.ttl_waves is None:
            return
        stale = np.logical_and(self._claim_alive,
                               self.wave - self._claim_wave > self.ttl_waves)
        if stale.any():
            self.state.q_radius.masked_fill_(
                torch.as_tensor(stale, device=self.device), float("-inf"))
            self._claim_alive[stale] = False

    # -------------------------------------------------------------- routing
    def route(self, psi) -> np.ndarray:
        """Shard index per query row: argmax over the fixed projections."""
        return np.argmax(np.asarray(psi, np.float32) @ self._router, axis=1)

    def _psi(self, psi) -> torch.Tensor:
        return torch.as_tensor(psi, device=self.device).to(torch.float32)

    # ------------------------------------------------------------ probe path
    def probe_rows(self, psi, shards) -> ProbeResult:
        """The L2 LowQuality test of a wave: one probe launch over the
        gathered shard rows (a repeated shard is gathered again; the probe
        only reads)."""
        sub = self.shards.gather(shards, payload=False)
        return probe_batched(sub, self._psi(psi), self.cfg.epsilon,
                             max_queries=self.cfg.max_queries)

    def query_rows(self, psi, shards, k: int):
        """Top-k cached docs per wave row from its shard: one wave-kernel
        launch on the stacked payload.  The LRU touches go back with the
        last row of each shard winning."""
        if k > self.cfg.capacity:
            raise ValueError("L2 answer k exceeds shard capacity")
        sub = self.shards.gather(shards, payload=False)
        out, sub = query_batched(sub, self._psi(psi), k,
                                 rows=self.shards.wave_rows(shards))
        # each shard once, from its last row: what JAX's ``.at[].set``
        # keeps on the CPU (a repeated index would keep any on the card)
        shards = np.asarray(shards).reshape(-1)
        _, first_rev = np.unique(shards[::-1], return_index=True)
        last = np.sort(shards.size - 1 - first_rev)
        self.shards.scatter(shards[last], sub,
                            rows=torch.as_tensor(last, device=self.device))
        return out

    # ------------------------------------------------------------- admission
    def offer(self, token, psi, radius: float, emb, ids) -> bool:
        """Offer one back-end (or reused) answer for promotion; returns
        whether it was queued (see the module docstring).  ``emb`` (width,
        >= dim) rows are kept as a tensor on the tier's device."""
        ids = np.asarray(ids)
        real = ids >= 0
        if not real.any():
            return False
        self.n_offered += 1
        if len(self._seen) > self.admission_table_max:
            self._seen.clear()
        if self.cluster is not None:
            # one vote per distinct cluster; out-of-corpus ids key per doc,
            # negated so they never collide with cluster ids
            cids = self.cluster.cluster_of(ids[real])
            keys = [int(c) if c >= 0 else -(int(d) + 1)
                    for c, d in zip(cids, ids[real])]
            for ck in set(keys):
                s = self._seen.setdefault(ck, set())
                if len(s) < self.admission_sessions:
                    s.add(token)
            promotable = sum(1 for ck in keys
                             if len(self._seen[ck]) >= self.admission_sessions)
        else:
            promotable = 0
            for d in ids[real].tolist():
                s = self._seen.setdefault(d, set())
                if len(s) < self.admission_sessions:
                    s.add(token)
                if len(s) >= self.admission_sessions:
                    promotable += 1
        if promotable < self.admission_frac * int(real.sum()):
            return False
        shard = int(self.route(np.asarray(psi, np.float32)[None])[0])
        self._pending.append((shard, np.asarray(psi, np.float32),
                              float(radius),
                              torch.as_tensor(emb, device=self.device),
                              ids.astype(np.int32)))
        return True

    def flush_admissions(self) -> int:
        """Insert the admitted answers into their shards: answers bound for
        distinct shards share one insert launch, same-shard answers go in
        ordered sub-waves (the in-place insert through ``rows`` never sees
        one row twice).  Claim ring slots are wave-stamped for the TTL."""
        pending, self._pending = self._pending, []
        promoted = 0
        while pending:
            seen: set = set()
            now, later = [], []
            for p in pending:
                (now if p[0] not in seen else later).append(p)
                seen.add(p[0])
            shards = np.array([p[0] for p in now], np.int32)
            sub = self.shards.gather(shards, payload=False)
            slots = sub.n_queries.cpu().numpy() % self.cfg.max_queries
            sub, dropped = insert_batched(
                sub, self.cfg, self._psi(np.stack([p[1] for p in now])),
                torch.tensor([p[2] for p in now], dtype=torch.float32,
                             device=self.device),
                torch.stack([p[3] for p in now]),
                torch.as_tensor(np.stack([p[4] for p in now]),
                                device=self.device),
                rows=self.shards.wave_rows(shards))
            self.shards.scatter(shards, sub)
            self._claim_wave[shards, slots] = self.wave
            self._claim_alive[shards, slots] = True
            self.total_dropped += int(dropped.sum())
            promoted += len(now)
            pending = later
        self.n_promoted += promoted
        return promoted

    # ------------------------------------------------------------ result memo
    def memo_record(self, token, psi, ids, scores, radius: float) -> None:
        """Memoize one fresh retrieval's full (psi, top-k_c) result set."""
        psi = np.asarray(psi, np.float32)
        ids = np.asarray(ids)
        scores = np.asarray(scores, np.float32)
        if self._memo_psi is None:
            self._memo_psi = np.zeros((self.memo_size, psi.shape[-1]),
                                      np.float32)
            self._memo_ids = np.full((self.memo_size, ids.shape[-1]), -1,
                                     np.int64)
            self._memo_scores = np.full((self.memo_size, ids.shape[-1]),
                                        -np.inf, np.float32)
        slot = self._memo_n % self.memo_size
        self._memo_psi[slot] = psi
        self._memo_ids[slot] = ids
        self._memo_scores[slot] = scores
        self._memo_radius[slot] = radius
        self._memo_token[slot] = token
        self._memo_wave[slot] = self.wave
        self._memo_n += 1

    def memo_lookup(self, token, psi, *, allow_stale: bool = False):
        """``(ids, scores, claim_radius)`` of another session's memoized
        near-duplicate (cosine >= ``memo_sim``, fresher than ``ttl_waves``),
        or None.  ``allow_stale`` (stale-while-error) waives the TTL and the
        other-session gates, never the similarity floor; its claim must not
        be recorded."""
        if self._memo_psi is None:
            return None
        psi = np.asarray(psi, np.float32)
        fresh = (self._memo_wave != _NEVER
                 if (allow_stale or self.ttl_waves is None)
                 else self.wave - self._memo_wave <= self.ttl_waves)
        other = np.array([t is not None and (allow_stale or t != token)
                          for t in self._memo_token])
        valid = np.logical_and(fresh, other)
        if not valid.any():
            return None
        sims = self._memo_psi @ psi  # unit-norm embeddings: dot == cosine
        sims = np.where(valid, sims, -np.inf)
        best = int(np.argmax(sims))
        if sims[best] < self.memo_sim:
            return None
        self.n_memo_served += 1
        if allow_stale:
            self.n_stale_served += 1
        delta = float(np.sqrt(max(2.0 - 2.0 * float(sims[best]), 0.0)))
        claim = float(self._memo_radius[best]) - delta
        return (self._memo_ids[best].copy(),
                self._memo_scores[best].copy(), claim)

    # ------------------------------------------------------------- inspection
    def contains(self, doc_ids) -> np.ndarray:
        """Membership of each id in ANY shard's cached documents."""
        cached = self.state.doc_ids.cpu().numpy().ravel()
        return np.isin(np.asarray(doc_ids), cached[cached >= 0])

    @property
    def n_docs(self) -> np.ndarray:
        return self.state.n_docs.cpu().numpy()

    def memory_bytes(self) -> int:
        return self.shards.memory_bytes()
