"""Synthetic CAsT-like workload with planted topical locality.

TREC CAsT qrels/collections are not redistributable offline, so we generate a
corpus + conversations that reproduce the *geometry* the paper exploits
(Fig. 1): queries of one conversation cluster tightly; their relevant
documents cluster around the same topic centroid; conversations drift within
a topic and occasionally shift sub-topic.

Everything is deterministic in the seed.  Embeddings are generated directly
in raw R^l space (pre-Eq.-1), with non-unit norms, so the MIPS->L2 transform
is exercised end to end.

Relevance (qrels): for each utterance, the graded relevant set is the docs
nearest the utterance's *ideal point* (its noise-free topical position):
grade 2 for the closest ``n_rel2``, grade 1 for the next ``n_rel1``.  The
no-caching system does not see ideal points — only the noisy utterance — so
effectiveness < 1 and cache-induced degradation is measurable, mirroring the
paper's evaluation design.

A copy of ``repro.data.conversations`` (numpy only), kept in the port so
the port imports nothing of the JAX package: the same ``WorldConfig`` and
seed give the same world in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

__all__ = ["WorldConfig", "Conversation", "TopicWorld", "make_world"]


@dataclass(frozen=True)
class WorldConfig:
    n_topics: int = 20
    docs_per_topic: int = 2000
    n_background: int = 20000       # off-topic distractor docs
    dim: int = 768                  # raw dim (pre-transform), STAR-like
    subspace_dim: int = 16          # local manifold dim per topic (see note)
    doc_sigma: float = 0.35         # doc spread around topic center
    query_sigma: float = 0.12       # utterance noise around ideal point
    drift_sigma: float = 0.08       # per-turn topical drift
    subtopic_prob: float = 0.25     # prob. a turn jumps to a new sub-topic
    subtopic_sigma: float = 0.45    # sub-topic offset scale
    turns: int = 10
    n_conversations: int = 30
    n_rel2: int = 5
    n_rel1: int = 15
    norm_jitter: float = 0.15       # doc norms in [1-j, 1+j] (exercises Eq. 1)
    seed: int = 0


@dataclass
class Conversation:
    topic: int
    queries: np.ndarray          # (turns, dim) raw query embeddings
    ideal_points: np.ndarray     # (turns, dim) noise-free positions
    qrels: List[dict]            # per turn: {doc_id: grade}


@dataclass
class TopicWorld:
    cfg: WorldConfig
    doc_emb: np.ndarray          # (n_docs, dim) raw
    doc_topic: np.ndarray        # (n_docs,) topic id, -1 = background
    centers: np.ndarray          # (n_topics, dim) unit
    conversations: List[Conversation]

    @property
    def n_docs(self) -> int:
        return self.doc_emb.shape[0]


def _unit(x: np.ndarray, axis=-1) -> np.ndarray:
    return x / np.linalg.norm(x, axis=axis, keepdims=True)


def _noise(rng, shape, sigma: float) -> np.ndarray:
    """Gaussian with TOTAL norm ~= sigma (not per-coordinate): in d dims a
    per-coordinate sigma yields norm sigma*sqrt(d), which at d=768 drowns
    the unit-norm signal — all sigmas in WorldConfig are norm-scale."""
    return (sigma / np.sqrt(shape[-1])) * rng.standard_normal(shape)


def make_world(cfg: WorldConfig = WorldConfig()) -> TopicWorld:
    """Topical-locality world.

    Within-topic structure lives in a per-topic low-dim subspace
    (``subspace_dim``): isotropic 768-d Gaussians have vanishing angular
    discrimination between near neighbors (O(sigma^2/sqrt(d))), so ranking
    would be dominated by norm jitter — real encoder embeddings are locally
    low-rank, which this reproduces.  All sigmas are total-norm scales.
    """
    rng = np.random.default_rng(cfg.seed)
    centers = _unit(rng.standard_normal((cfg.n_topics, cfg.dim)))
    # per-topic orthonormal local frames (dim x subspace_dim)
    frames = []
    for t in range(cfg.n_topics):
        m = rng.standard_normal((cfg.dim, cfg.subspace_dim))
        q, _ = np.linalg.qr(m)
        frames.append(q)
    frames = np.stack(frames)

    def in_subspace(topic, shape, sigma):
        z = rng.standard_normal(shape + (cfg.subspace_dim,))
        z *= sigma / np.sqrt(cfg.subspace_dim)
        return z @ frames[topic].T

    # --- corpus ----------------------------------------------------------
    topic_docs = np.concatenate([
        _unit(centers[t] + in_subspace(t, (cfg.docs_per_topic,),
                                       cfg.doc_sigma))
        for t in range(cfg.n_topics)])
    bg_docs = _unit(rng.standard_normal((cfg.n_background, cfg.dim)))
    doc_emb = np.concatenate([topic_docs, bg_docs], axis=0)
    # non-unit norms so Eq. 1's document branch is non-trivial
    norms = 1.0 + cfg.norm_jitter * (rng.random(doc_emb.shape[0]) * 2 - 1)
    doc_emb = doc_emb * norms[:, None]
    doc_topic = np.concatenate([
        np.repeat(np.arange(cfg.n_topics), cfg.docs_per_topic),
        np.full(cfg.n_background, -1),
    ])

    # normalized docs for qrel geometry (relevance ~ angular proximity)
    doc_unit = _unit(doc_emb)

    # --- conversations ----------------------------------------------------
    convs: List[Conversation] = []
    for _ in range(cfg.n_conversations):
        topic = int(rng.integers(cfg.n_topics))
        point = _unit(centers[topic] +
                      in_subspace(topic, (), cfg.doc_sigma * 0.5))
        queries, ideals, qrels = [], [], []
        for _t in range(cfg.turns):
            if _t > 0 and rng.random() < cfg.subtopic_prob:
                point = _unit(centers[topic] +
                              in_subspace(topic, (), cfg.subtopic_sigma))
            point = _unit(point + in_subspace(topic, (), cfg.drift_sigma))
            q = point + in_subspace(topic, (), cfg.query_sigma)
            sims = doc_unit @ point
            order = np.argsort(-sims)
            qr = {int(d): 2 for d in order[:cfg.n_rel2]}
            qr.update({int(d): 1 for d in order[cfg.n_rel2:cfg.n_rel2 + cfg.n_rel1]})
            queries.append(q)
            ideals.append(point.copy())
            qrels.append(qr)
        convs.append(Conversation(topic=topic,
                                  queries=np.stack(queries),
                                  ideal_points=np.stack(ideals),
                                  qrels=qrels))
    return TopicWorld(cfg=cfg, doc_emb=doc_emb, doc_topic=doc_topic,
                      centers=centers, conversations=convs)
