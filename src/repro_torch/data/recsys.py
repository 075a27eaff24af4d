"""Synthetic recsys batches with a planted preference model (learnable).

A copy of ``repro.data.recsys`` (numpy only), kept in the port so the port
imports nothing of the JAX package: the same spec and seed give the same
batches, byte for byte, in both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["CTRSpec", "CTRStream", "SessionStream"]


@dataclasses.dataclass
class CTRSpec:
    n_dense: int = 13
    n_sparse: int = 26
    vocab: int = 1_000_000
    multi_hot: int = 1
    seed: int = 0


class CTRStream:
    """Click-through batches: label = sigmoid(planted linear model) sample."""

    def __init__(self, spec: CTRSpec):
        self.spec = spec
        rng = np.random.default_rng(spec.seed)
        self.w_dense = rng.standard_normal(spec.n_dense) * 0.5
        # low-dim planted embedding per field for label generation
        self.w_field = rng.standard_normal(spec.n_sparse) * 0.3

    def batch(self, step: int, batch_size: int) -> dict:
        s = self.spec
        rng = np.random.default_rng((s.seed, step))
        dense = rng.standard_normal((batch_size, s.n_dense)).astype(np.float32)
        # zipf-ish sparse ids (hot head)
        sparse = (rng.pareto(1.2, (batch_size, s.n_sparse, s.multi_hot))
                  * 1000).astype(np.int64) % s.vocab
        logit = dense @ self.w_dense + (
            np.sin(sparse[..., 0] * 1e-5) @ self.w_field)
        label = (rng.random(batch_size) < 1 / (1 + np.exp(-logit)))
        return {"dense": dense.astype(np.float32),
                "sparse": sparse.astype(np.int32),
                "label": label.astype(np.float32)}


class SessionStream:
    """Item sequences with planted markov transitions (for SASRec/BERT4Rec)."""

    def __init__(self, vocab: int, max_len: int, seed: int = 0,
                 n_clusters: int = 100):
        self.vocab, self.max_len, self.seed = vocab, max_len, seed
        rng = np.random.default_rng(seed)
        self.cluster_of = rng.integers(0, n_clusters, vocab)
        self.n_clusters = n_clusters

    def batch(self, step: int, batch_size: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        b, s = batch_size, self.max_len
        items = rng.integers(0, self.vocab, (b, s + 1))
        # sessions stay in-cluster with p=.8: resample within cluster
        lengths = rng.integers(s // 2, s + 1, b)
        pos = items[:, 1:]
        neg = rng.integers(0, self.vocab, (b, s))
        items = items[:, :-1]
        mask = np.arange(s)[None, :] < lengths[:, None]
        items = np.where(mask, items, -1)
        pos = np.where(mask, pos, -1)
        return {"items": items.astype(np.int32),
                "pos": pos.astype(np.int32),
                "neg": neg.astype(np.int32)}
