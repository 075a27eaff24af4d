"""Exact nearest-neighbour metric index: the back end of the paper's Fig. 2.

The port of ``repro.core.metric_index``.  ``scan_topk`` is the one
corpus-scan contract — id -1 rows never win, -inf result positions carry
id -1, equal scores keep the lower corpus position — and runs the fused
kNN wrapper
(``kernels.knn.ops.knn_search``): the hand-written kernels on a CUDA
corpus, the plain version on a CPU one.  ``streaming_topk`` is the plain
chunked scan with a running top-k carry (peak memory O(B * chunk)) behind
``chunked_nn`` and ``masked_chunked_nn``, and ``exact_nn`` the one-shot
full-matrix oracle.  ``MetricIndex.cluster`` builds (and memoizes) the
topical ``ClusterIndex`` of ``core.cluster``.  ``MetricIndex(sharded=True)``
lays its corpus out over a device mesh once and searches it through
``dist.retrieval.sharded_nn``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import embedding as emb
from repro_torch.core import layout, quant
from repro_torch.core.cache_ops import pad_features
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.kernels.knn import ops as knn_ops

__all__ = ["SearchResult", "exact_nn", "chunked_nn", "masked_chunked_nn",
           "streaming_topk", "scan_topk", "MetricIndex"]


class SearchResult(NamedTuple):
    scores: torch.Tensor     # (q, k) inner products, descending
    distances: torch.Tensor  # (q, k) Euclidean distances, ascending
    ids: torch.Tensor        # (q, k) int32 document ids


def _as_result(scores: torch.Tensor, ids: torch.Tensor) -> SearchResult:
    return SearchResult(scores, emb.distance_from_scores(scores), ids)


def _stable_topk(scores: torch.Tensor, k: int):
    vals, pos = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], pos[:, :k]


def exact_nn(docs: torch.Tensor, doc_ids: torch.Tensor, queries: torch.Tensor,
             k: int) -> SearchResult:
    """Reference exact k-NN over the full (q, n) score matrix."""
    vals, pos = _stable_topk(emb.pairwise_scores(queries, docs), k)
    return _as_result(vals, doc_ids[pos])


def streaming_topk(docs: torch.Tensor, doc_ids: torch.Tensor,
                   queries: torch.Tensor, k: int, chunk: int,
                   masked: bool = False, scale: torch.Tensor | None = None):
    """Plain chunked scan with a running (scores, ids) carry; the carry
    precedes each chunk, so ties keep the lower corpus position.  Rows with
    id < 0 score -inf when ``masked``.  Dequantize-first scoring."""
    q = queries.to(torch.float32)
    best_s = torch.full((q.shape[0], k), float("-inf"), device=q.device)
    best_i = torch.full((q.shape[0], k), -1, dtype=torch.int32,
                        device=q.device)
    neg = torch.tensor(float("-inf"), device=q.device)
    for lo in range(0, docs.shape[0], chunk):
        cd, ci = docs[lo:lo + chunk], doc_ids[lo:lo + chunk]
        s = q @ cd.to(torch.float32).T
        if scale is not None:
            s = s * scale[lo:lo + chunk]
        if masked:
            s = torch.where(ci[None, :] < 0, neg, s)
        cand_s = torch.cat([best_s, s], dim=1)
        cand_i = torch.cat([best_i, ci[None, :].expand(q.shape[0], -1)], dim=1)
        best_s, pos = _stable_topk(cand_s, k)
        best_i = torch.gather(cand_i, 1, pos)
    return best_s, best_i


def chunked_nn(docs: torch.Tensor, doc_ids: torch.Tensor,
               queries: torch.Tensor, k: int, chunk: int = 4096) -> SearchResult:
    """Streaming exact k-NN over an unpadded corpus (``streaming_topk``)."""
    return _as_result(*streaming_topk(docs, doc_ids, queries, k, chunk))


def masked_chunked_nn(docs: torch.Tensor, doc_ids: torch.Tensor,
                      queries: torch.Tensor, k: int,
                      chunk: int = 4096) -> SearchResult:
    """``chunked_nn`` over a sentinel-padded corpus (id < 0 rows masked)."""
    return _as_result(*streaming_topk(docs, doc_ids, queries, k, chunk,
                                      masked=True))


def scan_topk(docs: torch.Tensor, doc_ids: torch.Tensor,
              queries: torch.Tensor, k: int, *,
              scale: torch.Tensor | None = None,
              int8_dot: bool | None = None):
    """The corpus-scan contract: raw (scores (B, k), ids (B, k))."""
    return knn_ops.knn_search(docs, doc_ids, queries, k, scale=scale,
                              int8_dot=int8_dot)


class MetricIndex:
    """A corpus of transformed embeddings on one device.

    Raw (l-dim) input is transformed with Eq. 1 and M kept; transformed
    (l+1-dim, unit-norm) input is taken as is.  The corpus is stored at the
    padded width ``layout.phys_dim(dim)`` in ``dtype`` (None follows
    ``REPRO_CORPUS_DTYPE``); ``int8_dot`` pins the int8 scoring rule.
    ``dim`` names the logical width of transformed rows that arrive
    already zero-padded (None: their width): an fp32 corpus at
    ``layout.phys_dim(dim)`` on the device is then used as is, not copied.

    ``sharded`` lays the corpus out once over ``mesh`` (None: the active
    ``sharding_rules`` mesh, else a flat mesh over the default process
    group) with ``dist.retrieval.shard_corpus``: ``doc_emb``, ``doc_ids``
    and ``doc_scale`` become ``DTensor``s, each rank holding its slice, and
    every ``search`` is ``sharded_nn``, called by every rank.  At a world
    of one the corpus is not copied.
    """

    def __init__(self, doc_emb, doc_ids=None, *, transformed: bool = False,
                 dtype: str | None = None, int8_dot: bool | None = None,
                 dim: int | None = None, device=None, sharded: bool = False,
                 mesh=None):
        self.device = resolve_device(device)
        doc_emb = torch.as_tensor(doc_emb, dtype=torch.float32,
                                  device=self.device)
        if doc_ids is None:
            doc_ids = torch.arange(doc_emb.shape[0], dtype=torch.int32)
        self.doc_ids = torch.as_tensor(doc_ids, device=self.device) \
            .to(torch.int32)
        if transformed:
            self.max_norm = torch.tensor(1.0, device=self.device)
            emb_t = doc_emb
        else:
            emb_t, self.max_norm = emb.transform_documents(doc_emb)
        self.dim = int(emb_t.shape[1] if dim is None else dim)
        if dim is not None and not transformed:
            raise ValueError("dim= names the width of transformed rows")
        self.n_docs = int(emb_t.shape[0])
        emb_t = pad_features(emb_t, layout.phys_dim(self.dim))
        self.dtype = quant.resolve_dtype(dtype)
        qc = quant.quantize(emb_t, self.dtype)
        self.doc_emb, self.doc_scale = qc.data, qc.scale
        self.int8_dot = quant.resolve_int8_dot(int8_dot, self.doc_emb.dtype)
        self._dequant = None
        self._clusters: dict = {}
        self.sharded, self.mesh = sharded, mesh
        if sharded:
            from repro_torch.dist import retrieval
            (self.doc_emb, self.doc_ids, self.doc_scale, self.mesh,
             _chunk) = retrieval.shard_corpus(self.doc_emb, self.doc_ids,
                                              scale=self.doc_scale,
                                              mesh=mesh)

    def transform_queries(self, psi: torch.Tensor) -> torch.Tensor:
        return emb.transform_queries(psi)

    def search(self, queries: torch.Tensor, k: int) -> SearchResult:
        """queries: (q, l+1) transformed embeddings."""
        queries = torch.as_tensor(queries, dtype=torch.float32,
                                  device=self.device)
        if queries.ndim == 1:
            queries = queries[None]
        k = min(k, self.n_docs)
        if self.sharded:
            from repro_torch.dist import retrieval
            return retrieval.sharded_nn(self.doc_emb, self.doc_ids, queries,
                                        k, scale=self.doc_scale,
                                        int8_dot=self.int8_dot)
        return _as_result(*scan_topk(self.doc_emb, self.doc_ids, queries, k,
                                     scale=self.doc_scale,
                                     int8_dot=self.int8_dot))

    def cluster(self, n_clusters: int = 64, *, iters: int = 10,
                seed: int = 0, max_width: int = 256, path=None):
        """Build (and memoize) a topical ``ClusterIndex`` over this corpus
        (``core.cluster.build_cluster_index``'s arguments).  An existing
        ``.npz`` at ``path`` is loaded instead of building; a fresh build is
        saved there.  Memoized per argument tuple: the corpus is immutable,
        so a rebuild can never differ."""
        import os

        from repro_torch.core.cluster import ClusterIndex, build_cluster_index
        key = (int(n_clusters), int(iters), int(seed), int(max_width))
        if key not in self._clusters:
            if path is not None and os.path.exists(path):
                self._clusters[key] = ClusterIndex.load(path)
            else:
                self._clusters[key] = build_cluster_index(
                    self, n_clusters, iters=iters, seed=seed,
                    max_width=max_width)
                if path is not None:
                    self._clusters[key].save(path)
        return self._clusters[key]

    def dequantized(self) -> torch.Tensor:
        """f32 view (n, dim) of the transformed corpus — the values every
        scorer scores against (memoized)."""
        if self._dequant is None:
            self._dequant = quant.dequantize(quant.QuantizedCorpus(
                self.doc_emb, self.doc_scale, self.dtype))[:, :self.dim]
        return self._dequant
