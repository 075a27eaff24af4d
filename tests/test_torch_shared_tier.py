"""The port's shared L2 tier (``repro_torch.core.shared``) against the JAX
package (``repro.core.shared``, its ``ref`` tier), on the CPU.

The cases of ``tests/test_shared_tier.py``, each run through both
packages on the same seeded inputs: admission, claim TTL, the result
memo (claims within 2e-3, as the JAX test allows: the square root turns
a 1e-7 cosine error into 5e-4 of distance), the tiered engine's memo
reuse, L2 shard hits and tier counts, and the wave's calls.  Then what
the port adds: the LRU stamps and ``step`` after a wave that queries one
shard twice (the last occurrence wins, as JAX's ``.at[].set`` keeps it
on the CPU), and the tier's state carried across packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.shared import SharedTier as JTier
from repro.serve.router import ShardAnswer as JAnswer
from repro.serve.router import ShardedRouter as JRouter
from repro.serve.session import BatchedEngine as JEngine
from repro_torch import convert
from repro_torch.core.shared import SharedTier
from repro_torch.kernels import dispatch
from repro_torch.serve.router import ShardAnswer, ShardedRouter
from repro_torch.serve.session import BatchedEngine

jax.config.update("jax_platform_name", "cpu")

CLAIM_TOL = 2e-3


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _pair(**kw):
    return (JTier(backend="ref", **kw), SharedTier(device="cpu", **kw))


def _counting_routers(docs, counter):
    ids = np.arange(len(docs))

    def shard(queries, k):
        counter["calls"] += 1
        scores = queries @ docs.T
        top = np.argsort(-scores, axis=1, kind="stable")[:, :k]
        return np.take_along_axis(scores, top, axis=1), ids[top]

    return (JRouter([lambda q, k: JAnswer(*shard(q, k))], deadline_s=30.0),
            ShardedRouter([lambda q, k: ShardAnswer(*shard(q, k))],
                          deadline_s=30.0))


def _engines(docs, counter, *, n_sessions, tier_kw, **kw):
    jr, tr = _counting_routers(docs, counter)
    jt, tt = _pair(dim=docs.shape[1], **tier_kw)
    return (JEngine(jr, docs, dim=docs.shape[1], n_sessions=n_sessions,
                    backend="ref", shared=jt, **kw),
            BatchedEngine(tr, docs, dim=docs.shape[1], n_sessions=n_sessions,
                          shared=tt, device="cpu", **kw))


def _same_turns(jt, tt):
    for a, b in zip(jt, tt):
        assert (b.tier, b.hit, b.degraded) == (a.tier, a.hit, a.degraded)
        np.testing.assert_array_equal(b.ids, a.ids)
        np.testing.assert_allclose(b.scores, a.scores, atol=1e-5)


# ------------------------------------------------------- admission policy
def test_admission_requires_distinct_sessions():
    for tier in _pair(dim=64, n_shards=2, capacity=100, max_queries=5):
        rng = np.random.default_rng(7)
        psi, emb, ids = _unit(rng, (64,)), _unit(rng, (6, 64)), \
            np.arange(10, 16)
        tier.tick()
        assert not tier.offer(("a", 1), psi, 0.5, emb, ids)
        assert tier.flush_admissions() == 0
        assert not tier.contains(ids).any()
        assert not tier.offer(("a", 1), psi, 0.5, emb, ids)
        assert tier.offer(("b", 1), psi, 0.5, emb, ids)
        assert tier.flush_admissions() == 1
        assert tier.contains(ids).all()
        assert tier.n_promoted == 1 and tier.n_offered == 3


def test_admission_frac_gates_partial_overlap():
    for tier in _pair(dim=32, capacity=100, max_queries=5,
                      admission_frac=0.5):
        rng = np.random.default_rng(8)
        emb = _unit(rng, (10, 32))
        hot, cold = np.arange(3), np.arange(100, 107)
        tier.tick()
        tier.offer(("a", 1), _unit(rng, (32,)), 0.5, emb[:3], hot)
        tier.offer(("b", 1), _unit(rng, (32,)), 0.5, emb[:3], hot)
        assert not tier.offer(("c", 1), _unit(rng, (32,)), 0.5, emb,
                              np.concatenate([hot, cold]))


def test_promoted_state_equals_jax():
    """Two promotions into one shard (two sub-waves) and one into the
    other: the shard states equal JAX's at the logical extents."""
    jt, tt = _pair(dim=24, n_shards=2, capacity=40, max_queries=6,
                   admission_sessions=1)
    rng = np.random.default_rng(10)
    offers = [(_unit(rng, (24,)), _unit(rng, (5, 24)),
               np.arange(5) + 7 * i) for i in range(5)]
    for tier in (jt, tt):
        tier.tick()
        for i, (psi, emb, ids) in enumerate(offers):
            assert tier.offer(("s", i), psi, 0.3 + 0.1 * i, emb, ids)
        assert tier.flush_admissions() == 5
    got = convert.cache_state_to_numpy(tt.state, tt.cfg)
    want = convert.cache_state_to_numpy(jt.state, jt.cfg)
    for f in got._fields:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(tt._claim_wave, jt._claim_wave)


# ------------------------------------------------------------- claim TTL
def test_ttl_expires_claims_but_not_documents():
    for tier in _pair(dim=64, n_shards=2, capacity=100, max_queries=5,
                      ttl_waves=3, admission_sessions=1):
        rng = np.random.default_rng(9)
        psi, ids = _unit(rng, (64,)), np.arange(20, 27)
        tier.tick()
        assert tier.offer(("a", 1), psi, 0.5, _unit(rng, (7, 64)), ids)
        tier.flush_admissions()
        shards = tier.route(psi[None])
        conv = torch.as_tensor if isinstance(tier, SharedTier) \
            else jnp.asarray
        assert bool(np.asarray(tier.probe_rows(conv(psi[None]),
                                               shards).hit)[0])
        for _ in range(4):
            tier.tick()
        assert not bool(np.asarray(tier.probe_rows(conv(psi[None]),
                                                   shards).hit)[0])
        assert tier.contains(ids).all()


# ------------------------------------------------------ semantic result memo
def test_memo_serves_other_sessions_only():
    for tier in _pair(dim=32):
        rng = np.random.default_rng(3)
        psi, ids = _unit(rng, (32,)), np.arange(9)
        scores = np.linspace(0.9, 0.5, 9).astype(np.float32)
        tier.tick()
        tier.memo_record(("a", 1), psi, ids, scores, radius=0.4)
        assert tier.memo_lookup(("a", 1), psi) is None
        g_ids, g_scores, claim = tier.memo_lookup(("b", 1), psi)
        np.testing.assert_array_equal(g_ids, ids)
        np.testing.assert_array_equal(g_scores, scores)
        assert abs(claim - 0.4) < CLAIM_TOL
        assert tier.memo_lookup(("b", 1), _unit(rng, (32,))) is None


def test_memo_claim_is_triangle_corrected():
    claims = []
    for tier in _pair(dim=48, memo_sim=0.9):
        rng = np.random.default_rng(4)
        psi = _unit(rng, (48,))
        tier.tick()
        tier.memo_record(("a", 1), psi, np.arange(5),
                         np.ones(5, np.float32), radius=0.7)
        near = psi + 0.05 * _unit(rng, (48,))
        near = near / np.linalg.norm(near)
        _, _, claim = tier.memo_lookup(("b", 1), near)
        assert abs(claim - (0.7 - np.sqrt(2.0 - 2.0 * float(near @ psi)))) \
            < CLAIM_TOL
        claims.append(claim)
    assert claims[0] == claims[1] < 0.7


def test_memo_entries_expire_after_ttl():
    for tier in _pair(dim=32, ttl_waves=2):
        rng = np.random.default_rng(5)
        psi = _unit(rng, (32,))
        tier.tick()
        tier.memo_record(("a", 1), psi, np.arange(4),
                         np.ones(4, np.float32), radius=0.3)
        tier.tick()
        assert tier.memo_lookup(("b", 1), psi) is not None
        tier.tick()
        tier.tick()
        assert tier.memo_lookup(("b", 1), psi) is None


# --------------------------------------------- tiered BatchedEngine waves
def test_engine_memo_reuse_cross_session_saves_backend():
    rng = np.random.default_rng(11)
    d, k = 48, 10
    docs = _unit(rng, (400, d))
    q0 = _unit(rng, (d,))
    q1 = q0 + 0.01 * _unit(rng, (d,))
    q1 = q1 / np.linalg.norm(q1)
    counter = {"calls": 0}
    jeng, teng = _engines(docs, counter, n_sessions=2, k=k, k_c=50,
                          tier_kw=dict(n_shards=2, capacity=1024))
    for eng, conv in ((jeng, jnp.asarray), (teng, torch.as_tensor)):
        with eng.router:
            t0 = eng.answer_batch([0], [conv(q0)])[0]
            assert t0.tier == "backend"
            before = counter["calls"]
            t1 = eng.answer_batch([1], [conv(q1)])[0]
            assert t1.tier == "l2_reuse" and t1.hit
            assert counter["calls"] == before
            assert eng.shared.n_memo_served == 1
    _same_turns(jeng.turns[1], teng.turns[1])


def test_engine_l2_shard_hit_and_l1_reset_survival():
    rng = np.random.default_rng(12)
    d = 48
    docs = _unit(rng, (400, d))
    base = _unit(rng, (d,))
    qs = []
    for _ in range(3):
        q = base + 0.01 * _unit(rng, (d,))
        qs.append(q / np.linalg.norm(q))
    counter = {"calls": 0}
    jeng, teng = _engines(docs, counter, n_sessions=3, k=10, k_c=50,
                          tier_kw=dict(n_shards=2, capacity=1024,
                                       memo_sim=1.5))
    for eng, conv in ((jeng, jnp.asarray), (teng, torch.as_tensor)):
        with eng.router:
            t0, t1 = eng.answer_batch([0, 1], [conv(qs[0]), conv(qs[1])])
            assert t0.tier == t1.tier == "backend"
            assert eng.shared.n_promoted >= 1
            assert eng.shared.contains(t0.ids[:10]).all()
            before = counter["calls"]
            t2 = eng.answer_batch([2], [conv(qs[2])])[0]
            assert t2.tier == "l2" and t2.hit and t2.ids.size > 0
            assert counter["calls"] == before
            eng.start_session(0)
            eng.start_session(1)
            assert eng.shared.contains(t0.ids[:10]).all()
    _same_turns(jeng.turns[2], teng.turns[2])
    assert (teng.cache.n_docs[:2] == 0).all()


def test_engine_tier_counts_and_aggregate_hit_rate():
    rng = np.random.default_rng(13)
    docs = _unit(rng, (300, 32))
    q = _unit(rng, (32,))
    jeng, teng = _engines(docs, {"calls": 0}, n_sessions=2, k=5, k_c=40,
                          tier_kw=dict(n_shards=2, capacity=1024))
    for eng, conv in ((jeng, jnp.asarray), (teng, torch.as_tensor)):
        with eng.router:
            assert np.isnan(eng.hit_rate())
            eng.answer_batch([0, 1], [conv(q), conv(q)])
            eng.answer_batch([0, 1], [conv(q), conv(q)])
    counts = teng.tier_counts()
    assert counts == jeng.tier_counts()
    assert counts["l1"] == 2 and sum(counts.values()) == 2
    assert teng.hit_rate() == teng.hit_rate(0) == 1.0
    assert sum(teng.tier_counts(skip_first=False).values()) == 4


# -------------------------------------------------------- calls per wave
def test_l2_probe_is_one_call_over_gathered_shard_rows():
    tier = SharedTier(dim=200, n_shards=3, capacity=100, max_queries=5,
                      device="cpu")
    ptr = tier.state.doc_emb.data_ptr()
    psi = torch.as_tensor(_unit(np.random.default_rng(14), (3, 200)))
    dispatch.reset_counters()
    tier.probe_rows(psi, np.arange(3))
    c = {n: v.calls for n, v in dispatch.counters().items() if v.calls}
    assert c == {"cache_probe": 1}
    assert tier.state.doc_emb.data_ptr() == ptr


def test_tiered_full_miss_wave_is_four_calls_then_reuse_three():
    rng = np.random.default_rng(15)
    d, s = 48, 4
    docs = _unit(rng, (300, d))
    counter = {"calls": 0}
    _jeng, teng = _engines(docs, counter, n_sessions=s + 1, k=5, k_c=17,
                           capacity=64,
                           tier_kw=dict(n_shards=2, capacity=128,
                                        max_queries=8))
    from repro_torch.dist.retrieval import DeviceShard
    teng.router = ShardedRouter([DeviceShard(docs, np.arange(300),
                                             device="cpu")], deadline_s=60)
    qs = _unit(rng, (s, d))
    with teng.router:
        dispatch.reset_counters()
        turns = teng.answer_batch(list(range(s)),
                                  [torch.as_tensor(q) for q in qs])
        assert all(t.tier == "backend" for t in turns)
        c = {n: v.calls for n, v in dispatch.counters().items() if v.calls}
        assert c == {"cache_probe": 2, "knn_score": 1, "knn_select": 1,
                     "wave_insert_query": 1}
        q = qs[0] + 0.01 * _unit(rng, (d,))
        dispatch.reset_counters()
        turn = teng.answer_batch([s], [torch.as_tensor(q / np.linalg.norm(q))])
        assert turn[0].tier == "l2_reuse"
        c = {n: v.calls for n, v in dispatch.counters().items() if v.calls}
        # L1 probe -> fused insert+query -> the flush of the promotion its
        # second-session vote triggers
        assert c == {"cache_probe": 1, "wave_insert_query": 1,
                     "wave_insert_scatter": 1}


# ----------------------------------------------------- what the port adds
def test_repeated_shard_query_keeps_the_last_rows_stamps_as_jax():
    """One wave queries shard 0 twice (rows 0 and 2): the stamps and
    ``step`` written back are the last row's, as in JAX on the CPU."""
    jt, tt = _pair(dim=16, n_shards=2, capacity=32, max_queries=4,
                   admission_sessions=1)
    rng = np.random.default_rng(16)
    emb = _unit(rng, (12, 16))
    psi = _unit(rng, (16,))
    shard = int(jt.route(psi[None])[0])
    q = np.stack([emb[0], emb[11], emb[5]])
    shards = np.array([shard, 1 - shard, shard])
    for tier, conv in ((jt, jnp.asarray), (tt, torch.as_tensor)):
        tier.tick()
        assert tier.offer(("a", 1), psi, 0.5, emb, np.arange(12))
        tier.flush_admissions()
        tier.query_rows(conv(q), shards, 3)
    for f in ("doc_stamp", "step", "doc_ids", "n_docs"):
        np.testing.assert_array_equal(getattr(tt.state, f).numpy(),
                                      np.asarray(getattr(jt.state, f))
                                      [..., :tt.state.doc_ids.shape[-1]]
                                      if f in ("doc_stamp", "doc_ids")
                                      else np.asarray(getattr(jt.state, f)),
                                      err_msg=f)
    # the last row (emb[5]'s neighbours) stamped at step 1, not row 0's
    stamps = tt.state.doc_stamp[shard].numpy()
    assert int(tt.state.step[shard]) == 2
    assert stamps[5] == 1 and stamps[0] == 0


def test_tier_state_carries_across_packages():
    """``convert.shared_tier_to_numpy`` / ``shared_tier_from_numpy``: a JAX
    tier's state loaded into the port's continues as the JAX tier does."""
    jt, tt = _pair(dim=24, n_shards=2, capacity=40, max_queries=6,
                   ttl_waves=2)
    rng = np.random.default_rng(17)
    psi = _unit(rng, (24,))
    jt.tick()
    jt.memo_record(("a", 1), psi, np.arange(5), np.ones(5, np.float32), 0.5)
    for tok in (("a", 1), ("b", 1)):
        jt.offer(tok, psi, 0.5, _unit(rng, (5, 24)), np.arange(5))
    jt.flush_admissions()
    convert.shared_tier_from_numpy(tt, convert.shared_tier_to_numpy(jt))
    for tier in (jt, tt):
        for _ in range(3):
            tier.tick()
    back = convert.shared_tier_to_numpy(tt)
    want = convert.shared_tier_to_numpy(jt)
    for f in back["state"]._fields:
        np.testing.assert_array_equal(getattr(back["state"], f),
                                      getattr(want["state"], f), err_msg=f)
    for f in ("claim_wave", "claim_alive", "_memo_psi", "_memo_ids"):
        np.testing.assert_array_equal(back[f], want[f])
    assert back["_seen"] == want["_seen"] and back["wave"] == 4
    assert tt.memo_lookup(("b", 1), psi, allow_stale=True) is not None
