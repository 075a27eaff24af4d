"""The port's tiered serving wave against the JAX package, on the CPU.

A topical world (few dense topics, ``norm_jitter=0``) clustered once in
each package over the same transformed corpus; Zipf traffic in fixed
rounds (``serve_bench.bench_zipf``'s shape: sessions draw popular
conversations, with a small jitter on the raw queries) through
``BatchedEngine(shared=SharedTier(cluster=...), cluster=...,
prefetch_width=...)``.  The port must give the JAX engine's turns wave by
wave: the same tiers, ids (scores within 1e-5), ``degraded`` flags and
counters (promotions, memo serves, prefetch accounting), with the wave's
kernel calls as the tiered contract says.  Then the degradation ladder:
a stale memo serve under a fenced back end, and the quarantine of a
corrupt slot.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cluster import build_cluster_index as j_build
from repro.core.metric_index import MetricIndex as JIndex
from repro.core.shared import SharedTier as JTier
from repro.data.conversations import WorldConfig, make_world
from repro.dist.retrieval import DeviceShard as JShard
from repro.serve.router import ShardedRouter as JRouter
from repro.serve.session import BatchedEngine as JEngine
from repro_torch.core.cluster import build_cluster_index
from repro_torch.core.metric_index import MetricIndex
from repro_torch.core.shared import SharedTier
from repro_torch.dist.retrieval import DeviceShard
from repro_torch.kernels import dispatch
from repro_torch.serve.router import ShardedRouter
from repro_torch.serve.session import BatchedEngine

jax.config.update("jax_platform_name", "cpu")

WORLD = WorldConfig(n_topics=4, docs_per_topic=300, n_background=600,
                    dim=48, subspace_dim=4, turns=6, n_conversations=6,
                    doc_sigma=0.8, query_sigma=0.05, drift_sigma=0.08,
                    subtopic_prob=0.4, subtopic_sigma=0.45, norm_jitter=0.0,
                    seed=11)
S, K, KC, WIDTH, CAP = 6, 5, 20, 100, 4096
SCORE_TOL = 1e-5


@pytest.fixture(scope="module")
def world():
    w = make_world(WORLD)
    jindex = JIndex(jnp.asarray(w.doc_emb, jnp.float32))
    docs = np.asarray(jindex.dequantized())[:jindex.n_docs]
    jci = j_build(jindex, 8, iters=10, seed=0, max_width=WIDTH,
                  backend="ref")
    tci = build_cluster_index(MetricIndex(docs, transformed=True,
                                          device="cpu"),
                              8, iters=10, seed=0, max_width=WIDTH)
    np.testing.assert_array_equal(tci.assign, jci.assign)
    np.testing.assert_array_equal(tci.near_ids, jci.near_ids)
    return w, jindex, docs, jci, tci


def _zipf_rounds(w, jindex, *, generations=2, alpha=1.1, jitter=0.005,
                 seed=11):
    """Per generation, each session's transformed query stream: a Zipf
    draw over the conversations plus a jitter on the raw queries (numpy,
    from ``seed``)."""
    rng = np.random.default_rng(seed)
    convs = w.conversations
    pop = np.arange(1, len(convs) + 1, dtype=np.float64) ** -alpha
    pop /= pop.sum()
    out = []
    for _ in range(generations):
        pick = rng.choice(len(convs), size=S, p=pop)
        out.append([np.asarray(jindex.transform_queries(jnp.asarray(
            convs[c].queries + jitter * rng.standard_normal(
                convs[c].queries.shape), jnp.float32))) for c in pick])
    return out


def _engines(docs, jci, tci, *, width=WIDTH, memo_sim=0.995, **tier_kw):
    ids = np.arange(docs.shape[0], dtype=np.int32)
    # breakers that stay open once tripped (the outage tests fence the
    # back end by recording failures)
    rkw = dict(deadline_s=30, n_docs=docs.shape[0], breaker_window=4,
               breaker_min_calls=2, breaker_cooldown_s=3600.0)
    jr = JRouter([JShard(docs, ids, backend="ref", dtype="fp32")], **rkw)
    tr = ShardedRouter([DeviceShard(docs, ids, device="cpu", dtype="fp32")],
                       **rkw)
    kw = dict(dim=docs.shape[1], n_shards=2, capacity=1024,
              memo_sim=memo_sim, **tier_kw)
    jtier = JTier(backend="ref", cluster=jci, **kw)
    ttier = SharedTier(cluster=tci, device="cpu", **kw)
    ekw = dict(dim=docs.shape[1], n_sessions=S, k=K, k_c=KC, capacity=CAP,
               dtype="fp32", prefetch_width=width)
    jeng = JEngine(jr, docs, backend="ref", shared=jtier, cluster=jci, **ekw)
    teng = BatchedEngine(tr, docs, shared=ttier, cluster=tci, device="cpu",
                         **ekw)
    return jeng, teng


def _calls():
    return {n: c.calls for n, c in dispatch.counters().items()}


def _assert_turns_equal(jt, tt):
    for a, b in zip(jt, tt):
        assert (b.tier, b.hit, b.degraded) == (a.tier, a.hit, a.degraded)
        np.testing.assert_array_equal(b.ids, a.ids)
        np.testing.assert_allclose(b.scores, a.scores, atol=SCORE_TOL)
        assert b.prefetch_hits == a.prefetch_hits


def _counters(eng):
    t = eng.shared
    return (t.n_promoted, t.n_offered, t.n_memo_served, t.n_stale_served,
            eng.prefetch_stats(), eng.tier_counts())


def test_tiered_zipf_turns_counters_and_launches_match_jax(world):
    w, jindex, docs, jci, tci = world
    jeng, teng = _engines(docs, jci, tci)
    with jeng.router, teng.router:
        seen = set()
        for gen in _zipf_rounds(w, jindex):
            for s in range(S):
                jeng.start_session(s)
                teng.start_session(s)
            for t in range(gen[0].shape[0]):
                wave = [gen[s][t] for s in range(S)]
                promoted = teng.shared.n_promoted
                dispatch.reset_counters()
                jt = jeng.answer_batch(range(S), [jnp.asarray(q)
                                                  for q in wave])
                tt = teng.answer_batch(range(S), [torch.as_tensor(q)
                                                  for q in wave])
                _assert_turns_equal(jt, tt)
                assert _counters(teng) == _counters(jeng)
                tiers = {x.tier for x in tt}
                seen |= tiers
                c = _calls()
                residual = bool(tiers & {"l2", "backend"})
                assert c["cache_probe"] == 1 + residual
                assert c["knn_score"] == c["knn_select"] \
                    == int("backend" in tiers)
                assert c["wave_insert_query"] == int(tiers != {"l1"})
                assert c["wave_query_topk"] == int(tiers == {"l1"}) \
                    + int("l2" in tiers)
                flushed = teng.shared.n_promoted - promoted
                assert (c["wave_insert_scatter"] > 0) == (flushed > 0)
                assert c["wave_insert_scatter"] <= flushed
        # the run exercises every tier and the prefetch
        assert seen == {"l1", "l2", "l2_reuse", "backend"}
        assert teng.prefetch_stats()["issued"] > 0
        assert teng.shared.n_promoted > 0 and teng.shared.n_memo_served > 0


def test_full_miss_tiered_wave_is_four_calls(world):
    """L1 probe -> L2 probe -> kNN -> fused insert+query, nothing else."""
    w, jindex, docs, jci, tci = world
    _jeng, teng = _engines(docs, jci, tci, admission_sessions=S + 1)
    with _jeng.router, teng.router:
        q = [torch.as_tensor(c.queries[0]) for c in w.conversations[:3]]
        q = [torch.as_tensor(np.asarray(jindex.transform_queries(
            jnp.asarray(x.numpy())))) for x in q]
        dispatch.reset_counters()
        turns = teng.answer_batch([0, 1, 2], q)
        assert all(t.tier == "backend" for t in turns)
        c = {n: v for n, v in _calls().items() if v}
        assert c == {"cache_probe": 2, "knn_score": 1, "knn_select": 1,
                     "wave_insert_query": 1}
        assert teng.prefetch_issued > 0


def test_prefetch_widens_inserts_and_claims_as_jax(world):
    """A miss inserts k_c + width documents and records max(r_a, bound)."""
    w, jindex, docs, jci, tci = world
    jeng, teng = _engines(docs, jci, tci, admission_sessions=S + 1)
    with jeng.router, teng.router:
        q = np.asarray(jindex.transform_queries(jnp.asarray(
            w.conversations[0].queries[:1], jnp.float32)))[0]
        jeng.answer_batch([0], [jnp.asarray(q)])
        teng.answer_batch([0], [torch.as_tensor(q)])
        jn = int(np.asarray(jeng.cache.state.n_docs)[0])
        tn = int(teng.cache.n_docs[0])
        assert tn == jn > KC
        jr = np.asarray(jeng.cache.state.q_radius)[0, 0]
        tr = float(teng.cache.state.q_radius[0, 0])
        assert tr == pytest.approx(float(jr), abs=1e-5)
        assert teng.prefetch_stats() == jeng.prefetch_stats()


def test_stale_memo_serve_under_outage_matches_jax(world):
    """The ladder's second step: a cold session under a fenced back end is
    served the stale memo (degraded, tier l2_reuse, no claim recorded)."""
    w, jindex, docs, jci, tci = world
    jeng, teng = _engines(docs, jci, tci, width=0, memo_sim=0.9,
                          ttl_waves=1)
    q = np.asarray(jindex.transform_queries(jnp.asarray(
        w.conversations[1].queries[:2], jnp.float32)))
    with jeng.router, teng.router:
        for eng, conv in ((jeng, jnp.asarray), (teng, torch.as_tensor)):
            eng.answer_batch([0, 1], [conv(x) for x in q])
            for _ in range(3):
                eng.shared.tick()
            eng.start_session(0)
            for b in eng.router.breakers:
                b.record(False)
                b.record(False)
            assert eng.router.backend_open
        jt = jeng.answer_batch([0], [jnp.asarray(q[1])])
        tt = teng.answer_batch([0], [torch.as_tensor(q[1])])
        _assert_turns_equal(jt, tt)
        assert tt[0].tier == "l2_reuse" and tt[0].degraded
        assert int(teng.cache.state.n_queries[0]) == 0      # no claim
        assert teng.shared.n_stale_served == jeng.shared.n_stale_served == 1
        assert teng.telemetry.faults["stale_served"] == 1


def test_quarantine_resets_a_corrupt_slot_as_jax(world):
    """``validate_every=1``: the next wave resets the poisoned slot, whose
    turn is then a compulsory back-end miss in both packages."""
    w, jindex, docs, jci, tci = world
    ids = np.arange(docs.shape[0], dtype=np.int32)
    q = [np.asarray(jindex.transform_queries(jnp.asarray(
        c.queries[:2], jnp.float32))) for c in w.conversations[:3]]
    out = []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            router = JRouter([JShard(docs, ids, backend="ref")],
                             deadline_s=30)
            eng = JEngine(router, docs, dim=docs.shape[1], n_sessions=3,
                          k=K, k_c=KC, capacity=CAP, backend="ref",
                          validate_every=1)
            conv = jnp.asarray
        else:
            router = ShardedRouter([DeviceShard(docs, ids, device="cpu")],
                                   deadline_s=30)
            eng = BatchedEngine(router, docs, dim=docs.shape[1],
                                n_sessions=3, k=K, k_c=KC, capacity=CAP,
                                validate_every=1, device="cpu")
            conv = torch.as_tensor
        with router:
            eng.answer_batch([0, 1, 2], [conv(x[0]) for x in q])
            if pkg == "jax":
                qr = np.asarray(eng.cache.state.q_radius).copy()
                qr[1, 0] = np.nan
                eng.cache.state = eng.cache.state._replace(
                    q_radius=jnp.asarray(qr))
            else:
                eng.cache.state.q_radius[1, 0] = float("nan")
            turns = eng.answer_batch([0, 1, 2], [conv(x[1]) for x in q])
        out.append((turns, eng.quarantined,
                    eng.telemetry.faults.get("quarantined_slots", 0)))
    (jt, jq, jf), (tt, tq, tf) = out
    _assert_turns_equal(jt, tt)
    assert tq == jq == 1 and tf == jf == 1
    assert tt[1].tier == "backend" and not tt[1].hit


def test_prefetch_width_beyond_tables_raises(world):
    _w, _j, docs, _jci, tci = world
    ids = np.arange(docs.shape[0], dtype=np.int32)
    with ShardedRouter([DeviceShard(docs, ids, device="cpu")]) as tr:
        with pytest.raises(ValueError, match="max_width"):
            BatchedEngine(tr, docs, dim=docs.shape[1], n_sessions=2,
                          cluster=tci, prefetch_width=WIDTH + 1,
                          device="cpu")


def test_shared_tier_on_another_device_or_dim_refused(world):
    _w, _j, docs, _jci, _tci = world
    ids = np.arange(docs.shape[0], dtype=np.int32)
    with ShardedRouter([DeviceShard(docs, ids, device="cpu")]) as tr:
        with pytest.raises(ValueError, match="dim"):
            BatchedEngine(tr, docs, dim=docs.shape[1], n_sessions=2,
                          shared=SharedTier(dim=docs.shape[1] + 1,
                                            device="cpu"), device="cpu")
