"""The wave on the stacked state in place, against the JAX package, on the CPU.

The port's wave ops take ``rows``, a (W,) int32 index into the stacked
payload: a wave copies every small leaf of its sessions but never the
cache payload, which the wave kernel (here its plain version) reads and
writes through the index.  The JAX package copies the wave's rows out and
back.  The same numpy inputs go through the JAX wave wrappers (the Pallas
kernel in interpret mode) and the JAX cache ops on the gathered rows, and
through the port on the stacked state with the index.  Real rows must give
equal ids, slots and state at the logical extents (scales within 2e-7
relative, as in ``test_torch_cache_ops.py``), f32 scores and the claim
radii the engines derive from them within 1e-6; rows
outside the wave stay untouched.  A padded row (a wave smaller than its
bucket repeats its first session) writes nothing, and neither does a row
the back end failed.  Last, ``BatchedEngine`` turn for turn against the
JAX engine, with the payload never copied.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache_ops as jc
from repro.core.embedding import transform_documents, transform_queries
from repro.data.conversations import WorldConfig, make_world
from repro.dist.retrieval import DeviceShard as JShard
from repro.kernels.cache_wave import ops as jwave
from repro.serve.router import ShardedRouter as JRouter
from repro.serve.session import BatchedEngine as JEngine
from repro_torch import convert
from repro_torch.core import cache_ops as tc
from repro_torch.core.cache import BatchedMetricCache
from repro_torch.dist.retrieval import DeviceShard
from repro_torch.kernels.cache_wave import ops as wave_ops
from repro_torch.serve.router import ShardedRouter
from repro_torch.serve.session import BatchedEngine

jax.config.update("jax_platform_name", "cpu")

S_ALL, CAP, DIM, MAXQ, KC, K = 5, 40, 33, 4, 12, 5
# wave rows -> stacked sessions; row 2 pads the wave with its first session
WAVE = np.array([3, 0, 3], np.int32)
REAL = 2


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _np(x):
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _t(x, like=None):
    """numpy (bf16 widened) -> torch, in ``like``'s dtype when given."""
    t = torch.as_tensor(_np(x))
    return t if like is None else t.to(like.dtype)


def _cfgs(dtype, eviction="none"):
    kw = dict(capacity=CAP, dim=DIM, max_queries=MAXQ, store_dtype=dtype,
              eviction=eviction)
    return jc.CacheConfig(**kw), tc.CacheConfig(**kw)


def _filled(rng, dtype, eviction="none", n_fill=20):
    """A JAX stacked state of S_ALL sessions after one insert of
    ``n_fill`` docs each (records and stamps included) and its port copy,
    plus the doc table."""
    jcfg, tcfg = _cfgs(dtype, eviction)
    table = _unit(rng.standard_normal((90, DIM)))
    ids = np.stack([rng.permutation(90)[:n_fill] for _ in range(S_ALL)])
    js = jc.init_batched_cache(jcfg, S_ALL)
    js, _ = jc.insert_batched(
        js, jcfg, jnp.asarray(_unit(rng.standard_normal((S_ALL, DIM)))),
        jnp.full((S_ALL,), 0.5), jnp.asarray(table[ids]),
        jnp.asarray(ids.astype(np.int32)), backend="ref")
    return jcfg, tcfg, js, convert.cache_state_from_numpy(js, tcfg, "cpu"), \
        table


def _gather_j(js):
    idx = jnp.asarray(WAVE)
    return jc.CacheState(*(x[idx] for x in js))


def _wave_view(full, sub, rows):
    """The port's wave rows as one state (payload read through ``rows``)."""
    return tc.CacheState(*(full.doc_emb.index_select(0, rows)
                           if f == "doc_emb" else getattr(sub, f)
                           for f in tc.CacheState._fields))


def _assert_rows_equal(port, ref, cfg, rows, radius_atol=0.0):
    """Leaves equal at the logical extents; scales within 2e-7 relative,
    and claim radii within ``radius_atol`` where the two packages derived
    them from their own f32 scores."""
    a = convert.cache_state_to_numpy(port, cfg)
    b = convert.cache_state_to_numpy(ref, cfg)
    for f in tc.CacheState._fields:
        x, y = getattr(a, f)[rows], getattr(b, f)[rows]
        if f in ("doc_scale", "q_scale"):
            np.testing.assert_allclose(x, y, rtol=2e-7, atol=0, err_msg=f)
        elif f == "q_radius":
            np.testing.assert_allclose(x, y, rtol=0, atol=radius_atol,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(x, y, err_msg=f)


def _assert_answers_equal(port, ref):
    (pv, pi, ps), (rv, ri, rs) = port, ref
    np.testing.assert_array_equal(pi[:REAL].numpy(), np.asarray(ri)[:REAL])
    np.testing.assert_array_equal(ps[:REAL].numpy(), np.asarray(rs)[:REAL])
    rv = np.asarray(rv)[:REAL]
    fin = np.isfinite(rv)
    np.testing.assert_array_equal(np.isfinite(pv[:REAL].numpy()), fin)
    np.testing.assert_allclose(pv[:REAL].numpy()[fin], rv[fin], atol=1e-6,
                               rtol=0)


def _assert_outside_untouched(full, before, cfg):
    out = sorted(set(range(S_ALL)) - set(WAVE.tolist()))
    a = convert.cache_state_to_numpy(full, cfg)
    b = convert.cache_state_to_numpy(before, cfg)
    np.testing.assert_array_equal(a.doc_emb[out], b.doc_emb[out])


@pytest.mark.parametrize("mode", ["insert_query", "query_topk",
                                  "insert_scatter"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_wave_ops_with_rows_match_jax_on_gathered_rows(dtype, mode):
    """The wave wrappers on the stacked payload through ``rows`` against the
    JAX wrappers (interpret mode) on the gathered rows."""
    rng = np.random.default_rng(["fp32", "bf16", "int8"].index(dtype))
    jcfg, tcfg, js, full, table = _filled(rng, dtype)
    before = tc.CacheState(*(x.clone() for x in full))
    jsub = _gather_j(js)
    tcache = BatchedMetricCache(tcfg, S_ALL, device="cpu")
    tcache.state = full
    sub = tcache.gather(WAVE, payload=False)
    assert sub.doc_emb is full.doc_emb
    rows = tcache.wave_rows(WAVE)
    w, jcp, tcp = len(WAVE), jcfg.phys_capacity, tcfg.phys_capacity
    dp = full.doc_emb.shape[-1]

    psi = _unit(rng.standard_normal((w, DIM)))
    new_ids = (100 + np.arange(w * KC).reshape(w, KC)).astype(np.int32)
    emb_q, emb_scale = jc.store_rows(
        jnp.asarray(_unit(rng.standard_normal((w, KC, DIM)))), dtype)
    psi_q, psi_scale = jc.store_rows(jnp.asarray(psi), dtype)
    n_docs = np.asarray(jsub.n_docs)
    pos = n_docs[:, None] + np.arange(KC)[None, :]
    drop = (np.arange(KC) % 3 == 0)[None, :] | (pos >= CAP)
    drop[1] = True                       # a row whose back end failed
    drop[2] = True                       # the padded row
    rec = np.array([True, False, False])
    radius = rng.uniform(0.1, 1.0, w).astype(np.float32)
    qslot = np.asarray(jsub.n_queries) % MAXQ
    step = np.asarray(jsub.step)

    jleaves = (jsub.doc_emb, jsub.doc_ids, jsub.doc_stamp, jsub.doc_scale,
               jsub.q_emb, jsub.q_radius, jsub.q_scale)
    jins = (emb_q, emb_scale, jnp.asarray(new_ids),
            jnp.asarray(np.where(drop, jcp, pos).astype(np.int32)), psi_q,
            psi_scale, jnp.asarray(radius), jnp.asarray(rec),
            jnp.asarray(qslot), jnp.asarray(step))
    tleaves = (full.doc_emb, sub.doc_ids, sub.doc_stamp, sub.doc_scale,
               sub.q_emb, sub.q_radius, sub.q_scale)
    tins = (tc.pad_features(_t(emb_q, full.doc_emb), dp), _t(emb_scale),
            torch.as_tensor(new_ids),
            torch.as_tensor(np.where(drop, tcp, pos).astype(np.int32)),
            tc.pad_features(_t(psi_q, full.doc_emb), dp), _t(psi_scale),
            torch.as_tensor(radius), torch.as_tensor(rec),
            torch.as_tensor(qslot), torch.as_tensor(step))
    psi_p = tc.pad_features(torch.as_tensor(psi), dp)

    if mode == "insert_query":
        jout, jans = jwave.wave_insert_query(*jleaves, *jins,
                                             jnp.asarray(psi), K,
                                             interpret=True)
        tans = wave_ops.wave_insert_query(*tleaves, *tins, psi_p, K,
                                          rows=rows)
    elif mode == "query_topk":
        jout = jleaves
        jans = jwave.wave_query_topk(jsub.doc_emb, jsub.doc_ids,
                                     jsub.doc_scale, jnp.asarray(psi), K,
                                     interpret=True)
        tans = wave_ops.wave_query_topk(full.doc_emb, sub.doc_ids,
                                        sub.doc_scale, psi_p, K, rows=rows)
    else:
        jout = jwave.wave_insert_scatter(*jleaves, *jins, interpret=True)
        tans = wave_ops.wave_insert_scatter(*tleaves, *tins, rows=rows)
        assert tans is None
    jpost = jsub._replace(**dict(zip(
        ("doc_emb", "doc_ids", "doc_stamp", "doc_scale", "q_emb",
         "q_radius", "q_scale"), jout)))
    _assert_rows_equal(_wave_view(full, sub, rows), jpost, tcfg,
                       slice(0, REAL))
    if tans is not None:
        _assert_answers_equal(tans, jans)
    # the failed and the padded row wrote nothing: session 0's payload and
    # the padded row's leaves are as before
    assert torch.equal(full.doc_emb[0], before.doc_emb[0])
    for f in ("doc_ids", "doc_stamp", "doc_scale", "q_emb", "q_radius"):
        assert torch.equal(getattr(sub, f)[1], getattr(before, f)[0]), f
        assert torch.equal(getattr(sub, f)[2], getattr(before, f)[3]), f
    _assert_outside_untouched(full, before, tcfg)


@pytest.mark.parametrize("eviction", ["none", "lru", "ball"])
def test_insert_query_batched_with_rows_matches_jax(eviction):
    """The cache ops' gated insert + query on the stacked state through
    ``rows`` against the JAX ops on the gathered rows, under every eviction
    policy (ball eviction scores the payload through the index too); the
    caches start near capacity so that inserts evict."""
    rng = np.random.default_rng(10 + ["none", "lru", "ball"].index(eviction))
    jcfg, tcfg, js, full, table = _filled(rng, "fp32", eviction, n_fill=34)
    before = tc.CacheState(*(x.clone() for x in full))
    jsub = _gather_j(js)
    tcache = BatchedMetricCache(tcfg, S_ALL, device="cpu")
    tcache.state = full
    sub = tcache.gather(WAVE, payload=False)
    rows = tcache.wave_rows(WAVE)
    w = len(WAVE)
    psi = _unit(rng.standard_normal((w, DIM)))
    ids = np.stack([rng.permutation(90)[:KC] for _ in range(w)]) \
        .astype(np.int32)
    do = np.array([True, False, False])
    record = np.array([True, True, False])
    radius = rng.uniform(0.1, 1.0, w).astype(np.float32)
    rout, jpost, rdrop = jc.insert_query_batched(
        jsub, jcfg, jnp.asarray(psi), jnp.asarray(radius),
        jnp.asarray(table[ids]), jnp.asarray(ids), K, do=jnp.asarray(do),
        record=jnp.asarray(record), backend="ref")
    (pv, _pd, pi, ps), _, pdrop = tc.insert_query_batched(
        sub, tcfg, torch.as_tensor(psi), torch.as_tensor(radius),
        torch.as_tensor(table[ids]), torch.as_tensor(ids), K,
        do=torch.as_tensor(do), record=torch.as_tensor(record), rows=rows)
    np.testing.assert_array_equal(pdrop.numpy()[:REAL],
                                  np.asarray(rdrop)[:REAL])
    _assert_answers_equal((pv, pi, ps), (rout[0], rout[2], rout[3]))
    _assert_rows_equal(_wave_view(full, sub, rows), jpost, tcfg,
                       slice(0, REAL))
    if eviction != "none":
        assert (np.asarray(jpost.doc_ids)[0] != np.asarray(jsub.doc_ids)[0]
                ).sum() > int(KC - (CAP - 34))   # some inserts evicted
    # scatter back the real rows only; the stacked state then equals the
    # JAX rows for sessions 3 and 0 and is untouched elsewhere
    tcache.scatter(WAVE[:REAL], sub, rows=torch.arange(REAL))
    js_after = jc.CacheState(*(x.at[jnp.asarray(WAVE[:REAL])].set(y[:REAL])
                               for x, y in zip(js, jpost)))
    _assert_rows_equal(tcache.state, js_after, tcfg, slice(None))
    _assert_outside_untouched(tcache.state, before, tcfg)


def test_gather_payload_and_scatter_rows():
    """``gather(payload=False)`` shares the stacked payload and copies the
    rest; ``scatter(rows=)`` writes back only those rows and skips the
    shared payload; out-of-range sessions raise before any copy."""
    cfg = tc.CacheConfig(capacity=CAP, dim=DIM, max_queries=MAXQ)
    cache = BatchedMetricCache(cfg, 4, device="cpu")
    ptr = cache.state.doc_emb.data_ptr()
    sub = cache.gather([2, 1, 2], payload=False)
    assert sub.doc_emb is cache.state.doc_emb
    assert sub.doc_ids.shape == (3, cfg.phys_capacity)
    assert sub.doc_ids.data_ptr() != cache.state.doc_ids.data_ptr()
    assert cache.wave_rows([2, 1, 2]).dtype == torch.int32
    sub.n_docs.copy_(torch.tensor([5, 6, 7], dtype=torch.int32))
    sub.doc_ids[:, 0] = torch.tensor([10, 11, 12], dtype=torch.int32)
    cache.scatter([2, 1], sub, rows=torch.arange(2))
    assert cache.state.doc_emb.data_ptr() == ptr
    np.testing.assert_array_equal(cache.n_docs, [0, 6, 5, 0])
    np.testing.assert_array_equal(cache.state.doc_ids[:, 0].numpy(),
                                  [-1, 11, 10, -1])
    copied = cache.gather([1, 3])
    assert copied.doc_emb.shape[0] == 2          # the default still copies
    with pytest.raises(IndexError):
        cache.gather([0, 4], payload=False)
    with pytest.raises(IndexError):
        cache.wave_rows([-1])


@pytest.mark.parametrize("s,cp", [(1, 12288), (64, 16384), (1, 16), (3, 768),
                                  (5, 1536), (132, 16384), (264, 1024),
                                  (300, 12288), (65535, 64)])
def test_wave_grid_fills_the_card(s, cp):
    """The (chunks, S) grid: every slot in exactly one chunk, chunks a
    multiple of the block's warps, never more blocks than the card holds
    at once, and S = 1 on every SM of an H100 (132)."""
    sms = 132
    chunk, chunks = wave_ops.wave_grid(s, cp, sms)
    assert chunk % wave_ops.CHUNK_ALIGN == 0
    assert (chunks - 1) * chunk < cp <= chunks * chunk
    assert s * chunks <= max(s, wave_ops.BLOCKS_PER_SM * sms)
    if s == 1 and cp >= sms * wave_ops.CHUNK_ALIGN:
        assert chunks >= sms
    if (s, cp) == (64, 16384):
        assert s * chunks > 64


# ------------------------------------------------------------ the engine
WORLD = WorldConfig(n_topics=4, docs_per_topic=150, n_background=300,
                    dim=32, subspace_dim=6, turns=4, n_conversations=4,
                    doc_sigma=0.6, query_sigma=0.12, drift_sigma=0.16,
                    subtopic_prob=0.35, subtopic_sigma=0.75, seed=5)
E_KC, E_K, E_CAP = 60, 8, 400


@pytest.fixture(scope="module")
def world():
    w = make_world(WORLD)
    docs, _ = transform_documents(jnp.asarray(w.doc_emb, jnp.float32))
    streams = [np.asarray(transform_queries(jnp.asarray(c.queries,
                                                        jnp.float32)))
               for c in w.conversations]
    return np.array(docs), streams


def test_batched_engine_in_place_matches_jax(world):
    """Waves of 3 of the 4 sessions (bucket 4: one padded row each) and of
    all 4: the port's engine, which never copies the payload, against the
    JAX engine turn for turn — ids, hits, tiers, scores — and cache state
    after every wave."""
    docs, streams = world
    ids = np.arange(docs.shape[0], dtype=np.int32)
    dim = docs.shape[1]
    with JRouter([JShard(docs, ids, backend="ref", dtype="fp32")],
                 deadline_s=30) as jr, \
            ShardedRouter([DeviceShard(docs, ids, device="cpu",
                                       dtype="fp32")], deadline_s=30) as tr:
        jeng = JEngine(jr, docs, dim=dim, n_sessions=4, k=E_K, k_c=E_KC,
                       capacity=E_CAP, backend="ref", dtype="fp32")
        teng = BatchedEngine(tr, docs, dim=dim, n_sessions=4, k=E_K,
                             k_c=E_KC, capacity=E_CAP, dtype="fp32",
                             device="cpu")
        payload = teng.cache.state.doc_emb
        gathered = []
        gather = teng.cache.gather

        def spy(sessions, payload=True):
            sub = gather(sessions, payload)
            gathered.append(sub.doc_emb)
            return sub
        teng.cache.gather = spy
        turn = [0] * 4
        waves = [[0, 1, 2], [3, 1, 0], [2, 3, 1], [0, 1, 2, 3], [3, 0, 2],
                 [1, 2, 3], [0, 1, 2, 3]]
        hits = 0
        for sids in waves:
            qs = [streams[s][min(turn[s], 3)] for s in sids]
            jt = jeng.answer_batch(sids, [jnp.asarray(q) for q in qs])
            tt = teng.answer_batch(sids, [torch.as_tensor(q) for q in qs])
            for s in sids:
                turn[s] += 1
            for a, b in zip(jt, tt):
                np.testing.assert_array_equal(b.ids, a.ids)
                np.testing.assert_allclose(b.scores, a.scores, atol=1e-6)
                assert (b.hit, b.tier) == (a.hit, a.tier)
                hits += b.hit
            _assert_rows_equal(teng.cache.state, jeng.cache.state,
                               teng.cache.cfg, slice(None), radius_atol=1e-6)
        assert 0 < hits < sum(len(w) for w in waves)
        assert teng.cache.state.doc_emb is payload
        assert len(gathered) == len(waves)
        assert all(x is payload for x in gathered)


def test_outage_wave_writes_no_payload(world):
    """With the back end down, warm sessions answer from their caches and
    the empty one fails; the stacked payload is left as it was and the
    failed session's leaves are not written back."""
    docs, streams = world
    ids = np.arange(docs.shape[0], dtype=np.int32)
    down = {"on": False}
    shard = DeviceShard(docs, ids, device="cpu")

    def call(q, k):
        if down["on"]:
            raise RuntimeError("shard down")
        return shard(q, k)

    with ShardedRouter([call], deadline_s=30, max_retries=0) as r:
        eng = BatchedEngine(r, docs, dim=docs.shape[1], n_sessions=4, k=E_K,
                            k_c=E_KC, capacity=E_CAP, device="cpu")
        eng.answer_batch([0, 1, 2], [s[0] for s in streams[:3]])
        down["on"] = True
        before = tc.CacheState(*(x.clone() for x in eng.cache.state))
        out = eng.answer_batch([0, 1, 3], [streams[0][0], -streams[1][0],
                                           streams[3][0]])
        assert isinstance(out[2], TimeoutError)
        assert (out[1].tier, out[1].degraded) == ("backend", True)
        after = eng.cache.state
        assert torch.equal(after.doc_emb, before.doc_emb)
        for f in tc.CacheState._fields:
            assert torch.equal(getattr(after, f)[3], getattr(before, f)[3]), f
            assert torch.equal(getattr(after, f)[2], getattr(before, f)[2]), f
        # the warm rows' query touched their stamps and steps only
        assert torch.equal(after.doc_ids, before.doc_ids)
        assert (after.step[:2] == before.step[:2] + 1).all()
