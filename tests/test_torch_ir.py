"""The port's copy of the IR metrics equals ``repro.metrics.ir``.

Random rankings (with repeats and ids absent from the qrels) against
random graded qrels, including empty and all-zero-grade qrels; every
metric is float-equal between the two packages.
"""

import numpy as np
import pytest

from repro.metrics import ir as jir
from repro_torch.metrics import ir as tir


def _cases(seed, n=40):
    rng = np.random.default_rng(seed)
    for i in range(n):
        ranked = rng.integers(0, 300, size=rng.integers(1, 250)).tolist()
        n_rel = int(rng.integers(0, 30))
        docs = rng.choice(300, size=n_rel, replace=False)
        grades = rng.integers(0, 4, size=n_rel) if i % 7 else np.zeros(n_rel)
        yield ranked, {int(d): int(g) for d, g in zip(docs, grades)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_jax(seed):
    for ranked, qrels in _cases(seed):
        for k in (1, 3, 10):
            assert tir.precision_at_k(ranked, qrels, k) == \
                jir.precision_at_k(ranked, qrels, k)
        assert tir.average_precision(ranked, qrels, 200) == \
            jir.average_precision(ranked, qrels, 200)
        assert tir.mrr(ranked, qrels, 200) == jir.mrr(ranked, qrels, 200)
        assert tir.ndcg_at_k(ranked, qrels, 3) == \
            jir.ndcg_at_k(ranked, qrels, 3)
        exact = sorted(qrels)[:10] or [0]
        assert tir.coverage(ranked, exact, 10) == \
            jir.coverage(ranked, exact, 10)


def test_mean_metric_equal_jax():
    runs = {q: r for q, (r, _) in enumerate(_cases(9, 12))}
    qrels = {q: g for q, (_, g) in enumerate(_cases(9, 12)) if q % 3}
    for fn in ("average_precision", "mrr", "ndcg_at_k"):
        assert tir.mean_metric(getattr(tir, fn), runs, qrels) == \
            jir.mean_metric(getattr(jir, fn), runs, qrels)
