"""Offline IR effectiveness metrics (paper Sec. 3.2): MAP/MRR/nDCG/P@k, coverage.

Evaluation is offline and tiny — plain numpy, matching trec_eval semantics:
graded qrels (grade > 0 == relevant for the binary metrics).  A copy of
``repro.metrics.ir`` (numpy only), kept in the port so the port imports
nothing of the JAX package.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

__all__ = ["precision_at_k", "average_precision", "mrr", "ndcg_at_k",
           "coverage", "mean_metric"]

Qrels = Mapping[int, int]  # doc_id -> grade


def _rel(ranked: Sequence[int], qrels: Qrels) -> np.ndarray:
    return np.array([qrels.get(int(d), 0) for d in ranked], dtype=np.float64)


def precision_at_k(ranked: Sequence[int], qrels: Qrels, k: int) -> float:
    rel = _rel(ranked[:k], qrels) > 0
    return float(rel.sum() / k)


def average_precision(ranked: Sequence[int], qrels: Qrels, k: int = 200) -> float:
    """MAP@k with the standard trec_eval denominator: total #relevant docs."""
    n_rel = sum(1 for g in qrels.values() if g > 0)
    if n_rel == 0:
        return 0.0
    rel = _rel(ranked[:k], qrels) > 0
    cum = np.cumsum(rel)
    prec = cum / np.arange(1, len(rel) + 1)
    return float((prec * rel).sum() / n_rel)


def mrr(ranked: Sequence[int], qrels: Qrels, k: int = 200) -> float:
    rel = _rel(ranked[:k], qrels) > 0
    hits = np.nonzero(rel)[0]
    return float(1.0 / (hits[0] + 1)) if hits.size else 0.0


def ndcg_at_k(ranked: Sequence[int], qrels: Qrels, k: int = 3) -> float:
    gains = _rel(ranked[:k], qrels)
    discounts = 1.0 / np.log2(np.arange(2, len(gains) + 2))
    dcg = float((gains * discounts).sum())
    ideal = np.sort([g for g in qrels.values() if g > 0])[::-1][:k].astype(np.float64)
    if ideal.size == 0:
        return 0.0
    idcg = float((ideal * (1.0 / np.log2(np.arange(2, ideal.size + 2)))).sum())
    return dcg / idcg if idcg > 0 else 0.0


def coverage(cache_ids: Sequence[int], exact_ids: Sequence[int], k: int) -> float:
    """Eq. 5: |NN(C,psi,k) ∩ NN(M,psi,k)| / k."""
    return float(len(set(map(int, cache_ids[:k])) & set(map(int, exact_ids[:k]))) / k)


def mean_metric(fn, runs, qrels_by_q, **kw) -> float:
    """Average fn(ranked, qrels) over queries present in both runs and qrels."""
    vals = [fn(ranked, qrels_by_q[q], **kw) for q, ranked in runs.items()
            if q in qrels_by_q]
    return float(np.mean(vals)) if vals else float("nan")
