"""The port's topical clustering (``repro_torch.core.cluster``) against the
JAX package (``repro.core.cluster``, its ``ref`` tier), on the CPU.

The cases of ``tests/test_cluster.py``, each fed the same seeded inputs in
both packages: the assignment at every storage dtype, the k-means++
centroids, the whole ``ClusterIndex`` (assignments, members, neighbour
tables; centroids within 1e-5), ``.npz`` files read both ways and
``MetricIndex.cluster``'s memo, the prefetch ids and claim bound,
cluster-aware admission in the shared tier, and the prefetch wave's
calls.  Both packages cluster the same transformed corpus (the JAX
index's dequantized rows): the Eq. 1 coordinate of two independent
transforms differs by up to 5e-4 at ``norm_jitter=0``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cluster import ClusterIndex as JCluster
from repro.core.cluster import _kmeanspp_init as j_kmeanspp
from repro.core.cluster import assign_clusters as j_assign
from repro.core.cluster import build_cluster_index as j_build
from repro.core.metric_index import MetricIndex as JIndex
from repro.core.shared import SharedTier as JTier
from repro.data.conversations import WorldConfig, make_world
from repro.serve.router import ShardAnswer as JAnswer
from repro.serve.router import ShardedRouter as JRouter
from repro.serve.session import BatchedEngine as JEngine
from repro_torch.core.cache_ops import CacheConfig, init_batched_cache
from repro_torch.core.cluster import (ClusterIndex, _kmeanspp_init,
                                      assign_clusters, build_cluster_index)
from repro_torch.core.cache_ops import insert_query_batched
from repro_torch.core.metric_index import MetricIndex
from repro_torch.core.shared import SharedTier
from repro_torch.dist.retrieval import DeviceShard
from repro_torch.kernels import dispatch
from repro_torch.serve.router import ShardAnswer, ShardedRouter
from repro_torch.serve.session import BatchedEngine

jax.config.update("jax_platform_name", "cpu")

CENT_TOL = 1e-5


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _topical_world(**overrides):
    cfg = dict(n_topics=4, docs_per_topic=300, n_background=600, dim=48,
               subspace_dim=4, turns=6, n_conversations=6, doc_sigma=0.8,
               query_sigma=0.05, drift_sigma=0.08, subtopic_prob=0.4,
               subtopic_sigma=0.45, norm_jitter=0.0, seed=11)
    cfg.update(overrides)
    return make_world(WorldConfig(**cfg))


def _both(raw, *, transformed=False):
    """(JAX index, its dequantized corpus, the port's index over it)."""
    jindex = JIndex(jnp.asarray(raw, jnp.float32), transformed=transformed)
    docs = np.asarray(jindex.dequantized())[:jindex.n_docs]
    return jindex, docs, MetricIndex(docs, transformed=True, device="cpu")


def _assert_index_equal(t, j):
    np.testing.assert_allclose(t.centroids, j.centroids, atol=CENT_TOL)
    np.testing.assert_array_equal(t.assign, j.assign)
    np.testing.assert_array_equal(t.member_offsets, j.member_offsets)
    np.testing.assert_array_equal(t.member_ids, j.member_ids)
    np.testing.assert_array_equal(t.near_ids, j.near_ids)
    np.testing.assert_allclose(t.near_d, j.near_d, atol=CENT_TOL)
    assert t.n_iters == j.n_iters


@pytest.fixture(scope="module")
def topical():
    world = _topical_world()
    jindex, docs, tindex = _both(world.doc_emb)
    jci = j_build(jindex, 8, iters=10, seed=0, max_width=400, backend="ref")
    tci = build_cluster_index(tindex, 8, iters=10, seed=0, max_width=400)
    return world, jindex, docs, tindex, jci, tci


# -------------------------------------------------- assignment equivalence
@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_assignment_matches_jax(dtype):
    """The k = 1 scan picks JAX's centroid for every document of the
    dequantized corpus, with its score (1e-5), at every storage dtype."""
    rng = np.random.default_rng(3)
    jindex = JIndex(jnp.asarray(_unit(rng, (257, 32))), dtype=dtype)
    corpus = np.asarray(jindex.dequantized())[:jindex.n_docs]
    cents = corpus[rng.choice(jindex.n_docs, size=7, replace=False)]
    a_j, s_j = j_assign(corpus, cents, backend="ref", query_chunk=64)
    a_t, s_t = assign_clusters(corpus, cents, query_chunk=64,
                               device="cpu")
    np.testing.assert_array_equal(a_t, a_j)
    np.testing.assert_allclose(s_t, s_j, atol=1e-5)
    assert a_t.dtype == np.int32 and a_t.shape == (257,)
    # the port's own index at this dtype dequantizes to the same rows
    tindex = MetricIndex(_unit(np.random.default_rng(3), (257, 32)),
                         dtype=dtype, device="cpu")
    assert tindex.dequantized().shape == corpus.shape


def test_assignment_ties_take_the_lower_centroid():
    docs = _unit(np.random.default_rng(4), (5, 16))
    cents = np.stack([docs[2], docs[2], docs[0]])       # 0 and 1 tie
    a_t, _ = assign_clusters(docs, cents, query_chunk=2, device="cpu")
    a_j, _ = j_assign(docs, cents, backend="ref", query_chunk=2)
    np.testing.assert_array_equal(a_t, a_j)
    assert a_t[2] == 0


def test_kmeanspp_draws_the_jax_centroids(topical):
    _w, jindex, docs, tindex, _jci, _tci = topical
    want = j_kmeanspp(docs, 8, 5)
    got = _kmeanspp_init(tindex.doc_emb, tindex.doc_scale, tindex.dim, 8, 5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_build_recovers_planted_topics_as_jax():
    """Topic-pure clusters and the ClusterIndex invariants, with the whole
    index equal to JAX's."""
    world = _topical_world(n_background=0, docs_per_topic=200)
    jindex, docs, tindex = _both(world.doc_emb)
    jci = j_build(jindex, 8, iters=10, seed=0, max_width=64, backend="ref")
    ci = build_cluster_index(tindex, 8, iters=10, seed=0, max_width=64)
    _assert_index_equal(ci, jci)
    topic = np.arange(ci.n_docs) // 200
    for c in range(8):
        mem = ci.members(c)
        if len(mem):
            assert np.unique(topic[mem]).size == 1
    assert ci.sizes.sum() == ci.n_docs
    np.testing.assert_array_equal(np.sort(ci.member_ids),
                                  np.arange(ci.n_docs))
    for c in range(8):
        assert (np.diff(docs[ci.members(c)] @ ci.centroids[c]) <= 1e-5).all()
    assert (np.diff(ci.near_d, axis=1) >= -1e-5).all()
    np.testing.assert_array_equal(ci.cluster_of(np.arange(ci.n_docs)),
                                  ci.assign)
    np.testing.assert_array_equal(
        ci.cluster_of(np.array([-1, ci.n_docs, ci.n_docs + 7])), [-1] * 3)


def test_topical_index_equals_jax(topical):
    *_rest, jci, tci = topical
    _assert_index_equal(tci, jci)
    assert tci.memory_bytes() == jci.memory_bytes()


def test_prefetch_ids_and_bound_match_jax_and_are_sound(topical):
    world, jindex, docs, _tindex, jci, tci = topical
    rng = np.random.default_rng(5)
    checked = 0
    for conv in world.conversations:
        psi = np.asarray(jindex.transform_queries(
            jnp.asarray(conv.queries[:1], jnp.float32)))[0]
        answer = rng.choice(len(docs), size=20, replace=False)
        extra, bound = tci.prefetch(psi, answer, 300)
        j_extra, j_bound = jci.prefetch(psi, answer, 300)
        np.testing.assert_array_equal(extra, j_extra)
        assert bound == pytest.approx(j_bound, abs=1e-5)
        assert not np.isin(extra, answer).any()
        if bound <= 0.0:
            continue
        cached = set(answer.tolist()) | set(extra.tolist())
        dist = np.sqrt(np.maximum(2.0 - 2.0 * (docs @ psi), 0.0))
        assert all(int(d) in cached for d in np.nonzero(dist <= bound)[0])
        checked += 1
    assert checked > 0
    empty, b0 = tci.prefetch(psi, answer, 0)
    assert empty.size == 0 and b0 == 0.0
    assert tci.prefetch(psi, answer, 10 ** 6)[0].size <= tci.max_width


def test_npz_loads_in_both_packages_and_cluster_memoizes(tmp_path):
    rng = np.random.default_rng(9)
    jindex, _docs, tindex = _both(_unit(rng, (120, 16)))
    ci = tindex.cluster(5, iters=4, seed=1, max_width=12)
    assert tindex.cluster(5, iters=4, seed=1, max_width=12) is ci
    jci = jindex.cluster(5, iters=4, seed=1, max_width=12, backend="ref")
    _assert_index_equal(ci, jci)
    ours, theirs = tmp_path / "port.npz", tmp_path / "jax.npz"
    ci.save(ours)
    jci.save(theirs)
    _assert_index_equal(JCluster.load(ours), ci)
    _assert_index_equal(ClusterIndex.load(theirs), jci)
    # a fresh index loads the artifact instead of clustering
    other = MetricIndex(_unit(rng, (120, 16)), device="cpu")
    loaded = other.cluster(5, iters=4, seed=1, max_width=12, path=theirs)
    np.testing.assert_array_equal(loaded.assign, jci.assign)


# ------------------------------------------------ cluster-aware admission
def _toy_cluster(cls, assign):
    assign = np.asarray(assign, np.int32)
    k = int(assign.max()) + 1
    order = np.argsort(assign, kind="stable")
    offsets = np.zeros(k + 1, np.int64)
    np.cumsum(np.bincount(assign, minlength=k), out=offsets[1:])
    return cls(np.eye(k, 8, dtype=np.float32), assign, offsets,
               order.astype(np.int64), np.full((k, 2), -1, np.int64),
               np.zeros((k, 2), np.float32))


def _tiers(assign, **kw):
    base = dict(dim=16, n_shards=2, capacity=64, max_queries=5, **kw)
    return (JTier(backend="ref", cluster=_toy_cluster(JCluster, assign),
                  **base),
            SharedTier(cluster=_toy_cluster(ClusterIndex, assign),
                       device="cpu", **base))


def test_cluster_admission_promotes_topical_siblings_as_jax():
    for tier in _tiers([0, 0, 0, 0, 1, 1, 1, 1]):
        rng = np.random.default_rng(21)
        emb = _unit(rng, (8, 16))
        tier.tick()
        a = tier.offer(("a", 1), _unit(rng, (16,)), 0.5, emb[[0, 1]],
                       np.array([0, 1]))
        b = tier.offer(("b", 1), _unit(rng, (16,)), 0.5, emb[[2, 3]],
                       np.array([2, 3]))
        assert not a and b
        assert tier.flush_admissions() == 1
        assert tier.contains(np.array([2, 3])).all()
    jt, tt = _tiers([0, 0, 0, 0, 1, 1, 1, 1])
    np.testing.assert_array_equal(tt.n_docs, np.asarray(jt.n_docs))


def test_cluster_admission_same_session_never_promotes_as_jax():
    for tier in _tiers([0, 0, 0, 0]):
        rng = np.random.default_rng(22)
        emb = _unit(rng, (2, 16))
        tier.tick()
        for ids in ([0, 1], [2, 3], [0, 3]):
            assert not tier.offer(("a", 1), _unit(rng, (16,)), 0.5, emb,
                                  np.array(ids))
        assert tier.flush_admissions() == 0
        assert not tier.offer(("a", 1), _unit(rng, (16,)), 0.5, emb,
                              np.array([100, 101]))
        assert tier.offer(("b", 1), _unit(rng, (16,)), 0.5, emb,
                          np.array([100, 101]))


# ------------------------------------------- serving integration + calls
def _mini(rng, *, width, shared=False):
    n, d = 300, 48
    jindex, docs, tindex = _both(_unit(rng, (n, d)))
    ci = build_cluster_index(tindex, 6, iters=4, seed=0, max_width=64)
    shard = DeviceShard(docs, np.arange(n, dtype=np.int32), device="cpu")
    tier = SharedTier(dim=docs.shape[1], n_shards=2, capacity=128,
                      max_queries=8, admission_sessions=4, cluster=ci,
                      device="cpu") if shared else None
    eng = BatchedEngine(ShardedRouter([shard], deadline_s=120.0), docs,
                        dim=docs.shape[1], n_sessions=4, k=5, k_c=17,
                        capacity=256, shared=tier, cluster=ci,
                        prefetch_width=width, device="cpu")
    qs = np.asarray(jindex.transform_queries(jnp.asarray(_unit(rng,
                                                               (3, d)))))
    return eng, [torch.as_tensor(q) for q in qs]


def test_prefetch_width_validated_against_tables():
    with pytest.raises(ValueError, match="max_width"):
        _mini(np.random.default_rng(30), width=65)


@pytest.mark.parametrize("shared", [False, True])
def test_prefetch_miss_wave_calls(shared):
    """The widened insert rides the fused launch: 3 calls (probe -> kNN ->
    insert+query), 4 with the shared tier (its probe after L1's)."""
    eng, qs = _mini(np.random.default_rng(31 + shared), width=32,
                    shared=shared)
    with eng.router:
        dispatch.reset_counters()
        turns = eng.answer_batch([0, 1, 2], qs)
        assert all(t.tier == "backend" for t in turns)
        assert eng.prefetch_issued > 0
        c = {n: v.calls for n, v in dispatch.counters().items() if v.calls}
        assert c == {"cache_probe": 1 + shared, "knn_score": 1,
                     "knn_select": 1, "wave_insert_query": 1}


def test_widened_insert_writes_the_stacked_payload_in_place():
    """The (k_c + width)-column insert leaves the payload where it is: one
    wave call, the same storage, every kept row written."""
    k_c, width, dim, s = 17, 32, 48, 3
    cfg = CacheConfig(capacity=256, dim=dim)
    state = init_batched_cache(cfg, s, "cpu")
    ptr = state.doc_emb.data_ptr()
    rng = np.random.default_rng(33)
    emb = torch.as_tensor(_unit(rng, (s, k_c + width, dim)))
    ids = torch.arange(s * (k_c + width)).reshape(s, -1)
    dispatch.reset_counters()
    insert_query_batched(state, cfg, torch.as_tensor(_unit(rng, (s, dim))),
                         torch.zeros(s), emb, ids, 5)
    assert dispatch.counters()["wave_insert_query"].calls == 1
    assert state.doc_emb.data_ptr() == ptr
    assert (state.n_docs == k_c + width).all()
    np.testing.assert_array_equal(state.doc_emb[:, :k_c + width, :dim],
                                  emb.numpy())


def test_prefetch_lifts_hit_rate_as_jax(topical):
    """The topical replay with prefetch beats the one without, with the
    JAX engine's hit rates and prefetch accounting at both widths."""
    world, jindex, docs, _tindex, jci, tci = topical
    n_s = len(world.conversations)
    streams = [np.asarray(jindex.transform_queries(
        jnp.asarray(c.queries, jnp.float32))) for c in world.conversations]
    ids = np.arange(len(docs))

    def shard(queries, k):
        scores = queries @ docs.T
        top = np.argsort(-scores, axis=1, kind="stable")[:, :k]
        return np.take_along_axis(scores, top, axis=1), ids[top]

    def run(width, jax_side):
        if jax_side:
            router = JRouter([lambda q, k: JAnswer(*shard(q, k))],
                             deadline_s=30.0)
            eng = JEngine(router, docs, dim=docs.shape[1], n_sessions=n_s,
                          k=5, k_c=20, capacity=4096, backend="ref",
                          cluster=jci if width else None,
                          prefetch_width=width)
            conv = jnp.asarray
        else:
            router = ShardedRouter([lambda q, k: ShardAnswer(*shard(q, k))],
                                   deadline_s=30.0)
            eng = BatchedEngine(router, docs, dim=docs.shape[1],
                                n_sessions=n_s, k=5, k_c=20, capacity=4096,
                                cluster=tci if width else None,
                                prefetch_width=width, device="cpu")
            conv = torch.as_tensor
        with router:
            hits = 0
            for t in range(streams[0].shape[0]):
                for turn in eng.answer_batch(
                        list(range(n_s)), [conv(streams[s][t])
                                           for s in range(n_s)]):
                    hits += turn.prefetch_hits > 0
        return eng, hits

    base, _ = run(0, False)
    pref, pref_turns = run(400, False)
    jpref, jturns = run(400, True)
    assert pref.hit_rate() > base.hit_rate()
    assert pref.prefetch_warm_hits > 0 and pref_turns == jturns > 0
    assert pref.hit_rate() == jpref.hit_rate()
    assert pref.prefetch_stats() == jpref.prefetch_stats()
