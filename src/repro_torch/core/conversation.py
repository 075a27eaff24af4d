"""Algorithm 1 — the conversational client gluing cache and back end.

The port of ``repro.core.conversation``.  The hit/miss branch is host
control flow (a miss performs the back-end round trip), so Algorithm 1
runs as a small host loop over device ops: ``probe`` -> (hit: cache ``query``) |
(miss: back-end ``search`` + ``insert`` + cache ``query``).  On a CUDA
index a turn is one launch of the single-session probe kernel, one of the
wave kernel's query mode and, on a miss, the two launches of the kNN
search plus one of the wave kernel's insert mode; the ``none`` policy is
one kNN search per turn.

``ConversationalSearcher`` also keeps the telemetry the paper reports:
per-utterance hit/miss, coverage against the exact index answer, timing.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.cache import MetricCache
from repro_torch.core.cache_ops import CacheConfig
from repro_torch.core.metric_index import MetricIndex, SearchResult

__all__ = ["TurnRecord", "ConversationalSearcher"]


@dataclass
class TurnRecord:
    hit: bool
    r_hat: float
    ids: np.ndarray
    distances: np.ndarray
    coverage: Optional[float]
    cache_docs: int
    latency_s: float


@dataclass
class ConversationalSearcher:
    """The client of Fig. 2: encoder -> CACHE -> (maybe) back-end index.

    policy: "dynamic" (Algorithm 1), "static" (fill once, never update), or
    "none" (no cache; every query hits the back end — the paper's
    baseline).  The cache lives on the index's device and stores
    embeddings in the index's dtype.
    """
    index: MetricIndex
    k: int = 10
    k_c: int = 1000
    epsilon: float = 0.04
    policy: str = "dynamic"
    cache_capacity: Optional[int] = None     # default: 16 updates worth of k_c
    max_queries: int = 64
    eviction: str = "none"
    dedup: bool = True
    measure_coverage: bool = False           # compare vs. exact index answers
    encoder: Optional[Callable] = None       # raw query -> psi (else pass psi)
    history: list = field(default_factory=list)

    def __post_init__(self):
        cap = self.cache_capacity or 16 * self.k_c
        cfg = CacheConfig(capacity=cap, dim=self.index.dim,
                          max_queries=self.max_queries, epsilon=self.epsilon,
                          dedup=self.dedup, eviction=self.eviction,
                          store_dtype=self.index.dtype)
        self.cache = MetricCache(cfg, device=self.index.device)

    # -- conversation lifecycle -------------------------------------------
    def start_conversation(self):
        self.cache.reset()
        self.history = []

    # -- Algorithm 1 -------------------------------------------------------
    def answer(self, query) -> TurnRecord:
        psi = self.encoder(query) if self.encoder is not None else query
        psi = torch.as_tensor(psi, device=self.index.device) \
            .to(torch.float32)
        t0 = time.perf_counter()

        if self.policy == "none":
            res = self.index.search(psi[None], self.k)
            rec = self._record(hit=False, r_hat=float("-inf"), res=res,
                               psi=psi, t0=t0)
            self.history.append(rec)
            return rec

        pr = self.cache.probe(psi)
        empty = self.cache.n_queries == 0
        # static policy never updates after the first fill
        low_quality = empty or (self.policy == "dynamic" and not bool(pr.hit))

        if low_quality:
            backend = self.index.search(psi[None], self.k_c)
            radius = backend.distances[0, -1]          # r_a: k_c-th NN distance
            # f32 view, not the raw payload: a bf16 / int8 index stores a
            # quantized doc_emb whose magnitude lives in doc_scale.  The
            # index stores docs in id order (ids == row index).
            doc_emb = self.index.dequantized()[backend.ids[0].long()]
            self.cache.insert(psi, radius, doc_emb, backend.ids[0])

        scores, dists, ids, _ = self.cache.query(psi, self.k)
        res = SearchResult(scores[None], dists[None], ids[None])
        rec = self._record(hit=not low_quality, r_hat=float(pr.r_hat),
                           res=res, psi=psi, t0=t0)
        self.history.append(rec)
        return rec

    def _record(self, *, hit, r_hat, res: SearchResult, psi, t0) -> TurnRecord:
        ids = res.ids[0].cpu().numpy()
        cov = None
        if self.measure_coverage:
            exact = self.index.search(psi[None], self.k)
            cov = float(np.isin(ids, exact.ids[0].cpu().numpy()).mean())
        return TurnRecord(
            hit=bool(hit), r_hat=r_hat, ids=ids,
            distances=res.distances[0].cpu().numpy(), coverage=cov,
            cache_docs=self.cache.n_docs,
            latency_s=time.perf_counter() - t0)

    # -- telemetry ----------------------------------------------------------
    def hit_rate(self, skip_first: bool = True) -> float:
        """Paper convention: the compulsory first miss is excluded."""
        turns = self.history[1:] if skip_first else self.history
        if not turns:
            return float("nan")
        return float(np.mean([t.hit for t in turns]))

    def mean_coverage(self) -> float:
        covs = [t.coverage for t in self.history if t.coverage is not None]
        return float(np.mean(covs)) if covs else float("nan")
