"""Offline spherical k-means over the corpus: topical locality.

The port of ``repro.core.cluster``.  Conversational queries cluster
topically, so a back-end miss may warm the cache with the *cluster
neighbourhood* of its answer, and the shared tier may count admission per
topic.  The build rides the ``scan_topk`` contract (the fused kNN kernels
on a CUDA corpus, their plain version on a CPU one); no kernel of its own:

* **assignment** — the K centroids are the scan's corpus (ids 0..K-1,
  zero-padded to the corpus width, so the kernel's aligned operand rule
  holds), the documents its queries in chunks of ``query_chunk`` rows,
  k = 1; equal scores keep the lower centroid id.  The queries are the
  stored payload rows themselves (dequantized per chunk when quantized),
  never a second (N, width) copy of the corpus.
* **k-means++ seeding** — D² on the corpus's device, one matrix-vector
  product a draw; only the (N,) distances go to the host, where numpy's
  ``default_rng(seed)`` draws (``integers``, then ``choice(n, p=...)``)
  exactly as the JAX package does, so both pick the same centroids.
* **update** — the renormalized per-cluster mean (empty clusters keep
  their centroid).  JAX sums with ``segment_sum``; here the documents are
  sorted by cluster (a stable sort) and each cluster's rows summed in
  fixed blocks in a fixed order.  That form is deterministic on the card,
  where ``index_add_`` sums with float atomics: a centroid that differs
  in its last bit flips near-tie assignments and moves the Lloyd loop's
  stop, so two builds must agree bit for bit.
* **neighbourhood tables** — one more ``scan_topk`` over the stored
  payload (centroids as queries, k = ``max_width``).

The product, ``ClusterIndex``, holds host numpy arrays in the JAX
package's ``.npz`` format, so an index saved by either package loads in
the other.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import embedding as emb
from repro_torch.core import layout, quant
from repro_torch.core.cache_ops import pad_features
from repro_torch.kernels.dispatch import resolve_device

__all__ = ["ClusterIndex", "assign_clusters", "build_cluster_index"]

BLOCK = 1 << 16   # corpus rows a step of the D² and centroid sums


def _rows(docs, scale, lo: int, hi: int) -> torch.Tensor:
    """f32 rows [lo, hi) of a (possibly quantized) payload: a view of an
    f32 payload, the dequantized rows otherwise."""
    part = docs[lo:hi]
    if part.dtype == torch.float32 and scale is None:
        return part
    return quant.dequantize(quant.QuantizedCorpus(
        part, None if scale is None else scale[lo:hi], "int8"))


def _assign(docs, scale, centroids: torch.Tensor, query_chunk: int):
    """(assign (n,) int32, score (n,) f32) on the corpus's device."""
    from repro_torch.core.metric_index import scan_topk

    n, width = docs.shape
    dev = docs.device
    cents = pad_features(centroids.to(dev, torch.float32),
                         layout.phys_dim(width))
    cids = torch.arange(cents.shape[0], dtype=torch.int32, device=dev)
    assign = torch.empty((n,), dtype=torch.int32, device=dev)
    score = torch.empty((n,), dtype=torch.float32, device=dev)
    for lo in range(0, n, query_chunk):
        hi = min(lo + query_chunk, n)
        s, i = scan_topk(cents, cids, _rows(docs, scale, lo, hi), 1)
        assign[lo:hi] = i[:, 0]
        score[lo:hi] = s[:, 0]
    return assign, score


def assign_clusters(docs, centroids, *, query_chunk: int = 2048,
                    device=None):
    """Nearest-centroid assignment through the ``scan_topk`` contract, on
    ``device`` (None means ``cuda``).

    ``docs`` (n, width >= dim) f32 rows; ``centroids`` (K, dim).  Returns
    numpy ``(assign (n,) int32, score (n,) f32)``: the winning centroid id
    per document and its score."""
    dev = resolve_device(device)
    docs = torch.as_tensor(docs, dtype=torch.float32, device=dev)
    a, s = _assign(docs, None, torch.as_tensor(
        np.asarray(centroids, np.float32), device=dev), query_chunk)
    return a.cpu().numpy(), s.cpu().numpy()


def _refresh_centroids(docs, scale, assign: torch.Tensor,
                       old: torch.Tensor, k: int) -> torch.Tensor:
    """The spherical update: each cluster's renormalized mean, summed in a
    fixed order (stable sort by cluster, then ``BLOCK``-row partial sums
    added in turn); empty clusters carry their previous centroid."""
    dim = old.shape[1]
    order = torch.argsort(assign, stable=True)
    counts = torch.bincount(assign.long(), minlength=k).cpu().numpy()
    offsets = np.concatenate([[0], np.cumsum(counts)])
    sums = torch.zeros((k, docs.shape[1]), dtype=torch.float32,
                       device=docs.device)
    for c in range(k):
        for lo in range(int(offsets[c]), int(offsets[c + 1]), BLOCK):
            idx = order[lo:min(lo + BLOCK, int(offsets[c + 1]))]
            part = docs.index_select(0, idx)
            if scale is not None or part.dtype != torch.float32:
                part = quant.dequantize(quant.QuantizedCorpus(
                    part, None if scale is None else scale[idx], "int8"))
            sums[c] += part.sum(dim=0)
    sums = sums[:, :dim]
    norms = torch.linalg.vector_norm(sums, dim=1, keepdim=True)
    fresh = sums / torch.clamp(norms, min=1e-12)
    keep = (torch.as_tensor(counts, device=docs.device)[:, None] > 0) \
        & (norms > 1e-12)
    return torch.where(keep, fresh, old)


def _kmeanspp_init(docs, scale, dim: int, k: int, seed: int) -> torch.Tensor:
    """Deterministic k-means++ seeding on the unit sphere (D² sampling):
    the distances on the corpus's device, the draws in host numpy."""
    rng = np.random.default_rng(seed)
    n = docs.shape[0]

    def row(i: int) -> torch.Tensor:
        return _rows(docs, scale, i, i + 1)[0]

    def d2_to(c: torch.Tensor) -> torch.Tensor:
        # squared distance of unit vectors: 2 - 2 s
        out = torch.empty((n,), dtype=torch.float32, device=docs.device)
        for lo in range(0, n, BLOCK * 4):
            hi = min(lo + BLOCK * 4, n)
            out[lo:hi] = torch.clamp(
                2.0 - 2.0 * torch.mv(_rows(docs, scale, lo, hi), c), min=0.0)
        return out

    cents = [row(int(rng.integers(n)))]
    d2 = d2_to(cents[0])
    for _ in range(1, k):
        host = d2.cpu().numpy()
        total = float(host.sum())
        if total <= 0.0:            # corpus exhausted (duplicates)
            cents.append(row(int(rng.integers(n))))
            continue
        nxt = int(rng.choice(n, p=host / total))
        cents.append(row(nxt))
        d2 = torch.minimum(d2, d2_to(cents[-1]))
    return torch.stack(cents)[:, :dim].clone()


class ClusterIndex:
    """Topical-locality artifact of :func:`build_cluster_index` (host numpy).

    centroids (K, dim) f32 unit-norm centres; assign (n_docs,) int32 per
    corpus position; member_offsets / member_ids the CSR member lists,
    most central first; near_ids / near_d (K, max_width) the corpus-wide
    nearest documents of each centroid and their Euclidean distances,
    ascending.  ``near_d[c, m-1]`` is the radius of the ball around
    centroid ``c`` that a width-``m`` prefetch caches whole, which makes
    :meth:`prefetch`'s claim bound sound.
    """

    def __init__(self, centroids, assign, member_offsets, member_ids,
                 near_ids, near_d, *, n_iters: int = 0):
        self.centroids = np.asarray(centroids, np.float32)
        self.assign = np.asarray(assign, np.int32)
        self.member_offsets = np.asarray(member_offsets, np.int64)
        self.member_ids = np.asarray(member_ids, np.int64)
        self.near_ids = np.asarray(near_ids, np.int64)
        self.near_d = np.asarray(near_d, np.float32)
        self.n_iters = int(n_iters)

    @property
    def n_clusters(self) -> int:
        return int(self.centroids.shape[0])

    @property
    def n_docs(self) -> int:
        return int(self.assign.shape[0])

    @property
    def max_width(self) -> int:
        """Widest prefetch the neighbour tables support."""
        return int(self.near_ids.shape[1])

    @property
    def sizes(self) -> np.ndarray:
        return np.diff(self.member_offsets).astype(np.int64)

    def members(self, c: int) -> np.ndarray:
        """Doc ids of cluster ``c``, most central first."""
        return self.member_ids[self.member_offsets[c]:
                               self.member_offsets[c + 1]]

    def cluster_of(self, ids) -> np.ndarray:
        """Per-document cluster ids; -1 for out-of-corpus / sentinel ids."""
        ids = np.asarray(ids, np.int64)
        out = np.full(ids.shape, -1, np.int32)
        ok = (ids >= 0) & (ids < self.n_docs)
        out[ok] = self.assign[ids[ok]]
        return out

    def nearest_centroid(self, psi: np.ndarray):
        """(cluster id, Euclidean distance to its centroid) of a unit
        query; ties go to the lower id."""
        scores = self.centroids @ np.asarray(psi, np.float32)
        c = int(np.argmax(scores))
        delta = float(np.sqrt(max(2.0 - 2.0 * float(scores[c]), 0.0)))
        return c, delta

    def prefetch(self, psi: np.ndarray, answer_ids: np.ndarray, width: int):
        """``(extra_ids, claim_bound)`` for a back-end miss at ``psi``: up
        to ``width`` documents nearest the centroid of ``psi``'s cluster
        that are not in ``answer_ids``, and the sound claim radius
        ``d_w - ||psi - c||`` (triangle inequality; 0.0 when negative)."""
        width = min(int(width), self.max_width)
        if width <= 0:
            return np.empty(0, np.int64), 0.0
        c, delta = self.nearest_centroid(psi)
        ids = self.near_ids[c, :width]
        d_w = float(self.near_d[c, width - 1])
        extra = ids[(ids >= 0) & ~np.isin(ids, answer_ids)]
        return extra.astype(np.int64), max(d_w - delta, 0.0)

    def memory_bytes(self) -> int:
        """Host bytes held by the index arrays."""
        return sum(a.nbytes for a in (self.centroids, self.assign,
                                      self.member_offsets, self.member_ids,
                                      self.near_ids, self.near_d))

    def save(self, path) -> None:
        """Persist to ``path`` as an ``.npz`` archive (the JAX format)."""
        np.savez(path, centroids=self.centroids, assign=self.assign,
                 member_offsets=self.member_offsets,
                 member_ids=self.member_ids, near_ids=self.near_ids,
                 near_d=self.near_d, n_iters=np.int64(self.n_iters))

    @classmethod
    def load(cls, path) -> "ClusterIndex":
        with np.load(path) as z:
            return cls(z["centroids"], z["assign"], z["member_offsets"],
                       z["member_ids"], z["near_ids"], z["near_d"],
                       n_iters=int(z["n_iters"]))


def build_cluster_index(index, n_clusters: int = 64, *, iters: int = 10,
                        seed: int = 0, max_width: int = 256,
                        query_chunk: int = 2048) -> ClusterIndex:
    """Spherical k-means over a ``MetricIndex`` corpus, on its device.

    ``iters`` bounds the Lloyd iterations (they stop early once the
    assignment repeats); ``max_width`` sizes the neighbour tables and so
    the widest serving-time ``prefetch_width``."""
    from repro_torch.core.metric_index import scan_topk

    docs, scale = index.doc_emb, index.doc_scale
    n, dim = index.n_docs, index.dim
    k = max(1, min(int(n_clusters), n))
    max_width = max(1, min(int(max_width), n))

    centroids = _kmeanspp_init(docs, scale, dim, k, seed)
    assign = None
    n_iters = 0
    for _ in range(max(1, int(iters))):
        n_iters += 1
        new_assign, _ = _assign(docs, scale, centroids, query_chunk)
        if assign is not None and torch.equal(new_assign, assign):
            break
        assign = new_assign
        centroids = _refresh_centroids(docs, scale, assign, centroids, k)

    # member lists by centrality (score to the own centroid, descending);
    # numpy's lexsort as two stable sorts
    assign, own = _assign(docs, scale, centroids, query_chunk)
    by_score = torch.argsort(-own, stable=True)
    order = by_score[torch.argsort(assign[by_score], stable=True)]
    member_ids = index.doc_ids[order].cpu().numpy().astype(np.int64)
    assign_np = assign.cpu().numpy()
    member_offsets = np.zeros(k + 1, np.int64)
    np.cumsum(np.bincount(assign_np, minlength=k), out=member_offsets[1:])

    # neighbour tables: centroids as queries over the stored payload
    s, i = scan_topk(docs, index.doc_ids, centroids, max_width, scale=scale,
                     int8_dot=index.int8_dot)
    return ClusterIndex(centroids.cpu().numpy(), assign_np, member_offsets,
                        member_ids, i.cpu().numpy().astype(np.int64),
                        emb.distance_from_scores(s).cpu().numpy(),
                        n_iters=n_iters)
