"""The port's Algorithm 1 for one session against the JAX package, on the CPU.

One small topical world (the same transformed corpus and queries in both
packages) is searched by the JAX ``ConversationalSearcher`` and by the
port's on CPU tensors, turn for turn: the ``dynamic``, ``static`` and
``none`` policies; fp32, bf16 and int8 indices (the cache stores the
index's dtype); eviction ``none``, ``lru`` and ``ball`` with a capacity
small enough to evict; and a JAX cache state carried into the port
mid-conversation (``convert.cache_state_from_numpy``).  Per turn the hit,
ids and cache size are equal and r_hat and distances agree within 1e-5;
``hit_rate`` and ``mean_coverage`` are equal.  The kernel counters show the
per-turn op contract: probe + query on a hit, plus kNN + insert on a miss,
and one kNN per turn without a cache.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.conversation import ConversationalSearcher as JSearcher
from repro.core.embedding import transform_documents, transform_queries
from repro.core.metric_index import MetricIndex as JIndex
from repro.data.conversations import WorldConfig, make_world
from repro_torch import convert
from repro_torch.core.conversation import ConversationalSearcher
from repro_torch.core.metric_index import MetricIndex
from repro_torch.kernels import dispatch

jax.config.update("jax_platform_name", "cpu")

WORLD = WorldConfig(n_topics=4, docs_per_topic=150, n_background=300,
                    dim=32, subspace_dim=6, turns=5, n_conversations=3,
                    doc_sigma=0.6, query_sigma=0.12, drift_sigma=0.16,
                    subtopic_prob=0.35, subtopic_sigma=0.75, seed=5)
K, KC = 8, 60
TOL = 1e-5
OPS = ("probe_rhat", "wave_query_topk", "knn_score", "knn_select",
       "wave_insert_scatter")


@pytest.fixture(scope="module")
def world():
    w = make_world(WORLD)
    docs, _ = transform_documents(jnp.asarray(w.doc_emb, jnp.float32))
    streams = [np.asarray(transform_queries(jnp.asarray(c.queries,
                                                        jnp.float32)))
               for c in w.conversations]
    return np.array(docs), streams


def _pair(docs, dtype, **kw):
    j = JSearcher(JIndex(jnp.asarray(docs), transformed=True, dtype=dtype,
                         use_kernel=False), **kw)
    t = ConversationalSearcher(MetricIndex(docs, transformed=True,
                                           dtype=dtype, device="cpu"), **kw)
    return j, t


def _same_turn(a, b, what):
    assert b.hit == a.hit, what
    np.testing.assert_array_equal(b.ids, np.asarray(a.ids), err_msg=what)
    assert b.cache_docs == a.cache_docs, what
    if np.isfinite(a.r_hat):
        assert abs(b.r_hat - a.r_hat) <= TOL, what
    else:
        assert b.r_hat == a.r_hat, what
    fin = np.isfinite(np.asarray(a.distances))
    np.testing.assert_allclose(b.distances[fin],
                               np.asarray(a.distances)[fin], atol=TOL,
                               rtol=0, err_msg=what)
    if a.coverage is not None:
        assert b.coverage == a.coverage, what


def _converse(j, t, streams):
    """Every conversation through both searchers; returns the port's op
    calls per turn and its hit flags."""
    calls, hits = [], []
    for c, stream in enumerate(streams):
        j.start_conversation()
        t.start_conversation()
        for turn, q in enumerate(stream):
            dispatch.reset_counters()
            a = j.answer(jnp.asarray(q))
            b = t.answer(torch.tensor(q))
            c_ = dispatch.counters()
            calls.append({n: c_[n].calls for n in OPS})
            hits.append(b.hit)
            _same_turn(a, b, f"conversation {c} turn {turn}")
    return calls, hits


@pytest.mark.parametrize("policy", ["dynamic", "static", "none"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_searcher_matches_jax(world, policy, dtype):
    docs, streams = world
    j, t = _pair(docs, dtype, k=K, k_c=KC, epsilon=0.04, policy=policy,
                 cache_capacity=6 * KC, measure_coverage=True)
    calls, hits = _converse(j, t, streams)
    assert t.hit_rate() == j.hit_rate()
    assert t.hit_rate(skip_first=False) == j.hit_rate(skip_first=False)
    assert t.mean_coverage() == pytest.approx(j.mean_coverage(), abs=0)
    for c, hit in zip(calls, hits):
        if policy == "none":
            # one kNN op per turn (plus the coverage search), nothing else
            assert c == {"probe_rhat": 0, "wave_query_topk": 0,
                         "knn_score": 2, "knn_select": 2,
                         "wave_insert_scatter": 0}
        else:
            miss = 0 if hit else 1
            assert c == {"probe_rhat": 1, "wave_query_topk": 1,
                         "knn_score": miss + 1, "knn_select": miss + 1,
                         "wave_insert_scatter": miss}
    if policy == "dynamic":
        assert any(hits[1:]) and not all(hits[1:])
    if policy == "static":
        assert t.cache.n_docs <= KC


@pytest.mark.parametrize("eviction", ["none", "lru", "ball"])
@pytest.mark.parametrize("dtype", ["fp32", "int8"])
def test_searcher_eviction_matches_jax(world, eviction, dtype):
    """A cache of 70 slots under k_c = 60 and a strict epsilon: the second
    miss of a conversation evicts (or, without eviction, drops)."""
    docs, streams = world
    j, t = _pair(docs, dtype, k=K, k_c=KC, epsilon=0.2, policy="dynamic",
                 cache_capacity=70, eviction=eviction)
    _converse(j, t, streams)
    assert t.cache.total_dropped == j.cache.total_dropped
    if eviction == "none":
        assert t.cache.total_dropped > 0
    assert t.hit_rate() == j.hit_rate()


def test_jax_state_carried_mid_conversation(world):
    """Two turns in the JAX searcher, its cache state carried into the port,
    the rest of the conversation in both: identical turns."""
    docs, streams = world
    j, t = _pair(docs, "fp32", k=K, k_c=KC, epsilon=0.04, policy="dynamic",
                 cache_capacity=6 * KC)
    stream = streams[1]
    j.start_conversation()
    t.start_conversation()
    for q in stream[:2]:
        j.answer(jnp.asarray(q))
    t.cache.state = convert.cache_state_from_numpy(j.cache.state, t.cache.cfg,
                                                   device="cpu")
    assert t.cache.n_docs == j.cache.n_docs
    assert t.cache.total_queries == j.cache.total_queries
    for turn, q in enumerate(stream[2:]):
        _same_turn(j.answer(jnp.asarray(q)), t.answer(torch.tensor(q)),
                   f"carried turn {turn + 2}")
    got = convert.cache_state_to_numpy(t.cache.state, t.cache.cfg)
    want = convert.cache_state_to_numpy(j.cache.state, t.cache.cfg)
    for f, a, b in zip(got._fields, got, want):
        if f == "q_radius":     # r_a from each package's own f32 scan
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


def test_searcher_without_a_card_raises(monkeypatch, world):
    """``MetricIndex()`` with no device means the card: without one it
    raises, and the searcher over it never starts."""
    docs, _ = world
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ConversationalSearcher(MetricIndex(docs, transformed=True))
