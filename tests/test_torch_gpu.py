"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: without a CUDA device every test skips (decided inside the
test, so every worker collects the same tests).  Run on a machine with a
card::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The kernels and the plain versions sum f32 dot products in different
orders, so scores agree within 1e-5 and ranks by
``repro_torch.kernels.parity.assert_topk_agree``; states written by the
wave kernel must equal the plain scatter bit for bit.  Embedding bags agree
within 1e-5 for f32 tables and 1e-3 for f16 / bf16 ones (both widen the
same rows to f32; only the order of the sums differs).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import cache_ops as tc
from repro_torch.configs import dlrm_rm2, xdeepfm
from repro_torch.core import quant
from repro_torch.kernels import dispatch
from repro_torch.kernels.cache_probe import ops as probe_ops
from repro_torch.kernels.cache_probe import ref as probe_ref
from repro_torch.kernels.cache_wave import ops as wave_ops
from repro_torch.kernels.cache_wave import ref as wave_ref
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.kernels.embedding_bag import ref as bag_ref
from repro_torch.kernels.knn import ops as knn_ops
from repro_torch.kernels.knn import ref as knn_ref
from repro_torch.kernels.parity import assert_close, assert_topk_agree
from repro_torch.models import recsys as rs

pytestmark = pytest.mark.gpu

TOL = 1e-5
DIM = 769


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    # bf16 products accumulate in f32, as XLA's do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return gen


def _unit(*shape, gen):
    return torch.nn.functional.normalize(
        torch.randn(*shape, generator=gen, device="cuda"), dim=-1)


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_probe_kernel_matches_plain(card, dtype):
    cfg = tc.CacheConfig(capacity=64, dim=DIM, max_queries=13)
    s, qp, dp = 9, cfg.phys_max_queries, cfg.phys_dim
    psi = tc.pad_features(_unit(s, DIM, gen=card), dp)
    recs = tc.pad_features(_unit(s, qp, DIM, gen=card), dp)
    q_emb, q_scale = tc.store_rows(recs, dtype)
    radius = torch.rand(s, qp, generator=card, device="cuda") + 0.5
    dispatch.reset_counters()
    rk = probe_ops.probe_rhat_batched(q_emb, psi, radius, q_scale)
    assert dispatch.counters()["cache_probe"].launches == 1
    rp = probe_ref.probe_rhat_batched(q_emb, psi, radius, q_scale)
    assert_close(rk, rp, 1e-4, "r_hat")
    n_q = torch.tensor([0, 1, 5, 13, 14, 30, 2, 7, 9], dtype=torch.int32,
                       device="cuda")
    got = probe_ops.cache_probe_batched(q_emb, psi[:, :DIM], radius, n_q,
                                        0.2, q_scale=q_scale, max_queries=13)
    want = probe_ops.cache_probe_batched(
        q_emb.cpu(), psi[:, :DIM].cpu(), radius.cpu(), n_q.cpu(), 0.2,
        q_scale=q_scale.cpu(), max_queries=13)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[2].cpu(), want[2])


@pytest.mark.parametrize("dtype,i8", [("fp32", False), ("bf16", False),
                                      ("int8", False), ("int8", True)])
@pytest.mark.parametrize("b,k", [(7, 100), (70, 1024), (3, 1)])
def test_knn_kernels_match_plain(card, dtype, i8, b, k):
    n = 20011
    docs = tc.pad_features(_unit(n, DIM, gen=card), 800)
    docs[500] = docs[17]                     # exact ties
    docs[9000] = docs[17]
    qc = quant.quantize(docs, dtype)
    ids = torch.arange(n, dtype=torch.int32, device="cuda") + 5
    ids[[3, 17 + 1, 12000]] = -1             # sentinel rows
    q = _unit(b, DIM, gen=card)
    q[0] = docs[17, :DIM]
    dispatch.reset_counters()
    v, i = knn_ops.knn_search(qc.data, ids, q, k, scale=qc.scale, int8_dot=i8)
    c = dispatch.counters()
    assert c["knn_score"].launches == c["knn_select"].launches == 1
    qq, qs = tc.pad_features(q, 800), None
    if i8:
        qqc = quant.quantize(qq, "int8")
        qq, qs = qqc.data, qqc.scale
    rv, ri = knn_ref.search(qc.data, ids, qq, k, qc.scale, qs)
    assert_topk_agree(v, i, rv, ri, TOL, f"knn {dtype} i8={i8}")
    if k >= 3:
        assert {22, 505, 9005} <= set(i[0, :3].tolist())
    # k above the valid rows: (-inf, -1) past them
    few = torch.full((40,), -1, dtype=torch.int32, device="cuda")
    few[:10] = torch.arange(10, dtype=torch.int32, device="cuda")
    v, i = knn_ops.knn_search(qc.data[:40], few, q, 64,
                              scale=None if qc.scale is None
                              else qc.scale[:40], int8_dot=i8)
    assert (i[:, 10:] == -1).all() and torch.isneginf(v[:, 10:]).all()
    assert (i[:, :10] >= 0).all()


def _wave_check(gen, dtype, mode, *, capacity, n_live, k, s=5, kc=150,
                pos=None):
    """One wave launch in ``mode`` on a state holding ``n_live`` docs per
    session against the plain version: states equal bit for bit, answers
    by ``assert_topk_agree``, empty slots in ascending order.  ``pos``
    (s, kc) replaces the default insert positions (appends, every third a
    drop, row 1 all drops)."""
    cfg = tc.CacheConfig(capacity=capacity, dim=DIM, max_queries=8,
                         store_dtype=dtype)
    state = tc.init_batched_cache(cfg, s, "cuda")
    rows = _unit(s, n_live, DIM, gen=gen)
    data, scale = tc.store_rows(rows, dtype)
    state.doc_emb[:, :n_live, :DIM] = data
    state.doc_scale[:, :n_live] = scale
    state.doc_ids[:, :n_live] = torch.arange(
        s * n_live, dtype=torch.int32, device="cuda").view(s, n_live)
    state.n_docs.fill_(n_live)
    state.n_queries.copy_(torch.tensor([0, 3, 8, 9, 20], dtype=torch.int32)
                          .repeat(s // 5 + 1)[:s])
    new_q, new_scale = tc.store_rows(_unit(s, kc, DIM, gen=gen), dtype)
    if pos is None:
        pos = (n_live + torch.arange(kc, device="cuda")).repeat(s, 1)
        pos[:, ::3] = cfg.phys_capacity                  # drops
        pos[1:2] = cfg.phys_capacity                     # a do=False row
    psi = _unit(s, DIM, gen=gen)
    psi_q, psi_scale = tc.store_rows(psi, dtype)
    ins = (tc.pad_features(new_q, 800), new_scale,
           torch.arange(kc, dtype=torch.int32, device="cuda").repeat(s, 1)
           + 10 ** 6, pos.to(torch.int32), tc.pad_features(psi_q, 800),
           psi_scale, torch.rand(s, device="cuda"),
           torch.tensor([True, False, True, True, False], device="cuda")
           .repeat(s // 5 + 1)[:s],
           torch.remainder(state.n_queries, 8),
           torch.full((s,), 4, dtype=torch.int32, device="cuda"))
    psi_p = tc.pad_features(psi, 800)
    sk = tc.CacheState(*(x.clone() for x in state))
    sp = tc.CacheState(*(x.clone() for x in state))
    lk = (sk.doc_emb, sk.doc_ids, sk.doc_stamp, sk.doc_scale, sk.q_emb,
          sk.q_radius, sk.q_scale)
    lp = (sp.doc_emb, sp.doc_ids, sp.doc_stamp, sp.doc_scale, sp.q_emb,
          sp.q_radius, sp.q_scale)
    dispatch.reset_counters()
    if mode == "insert_query":
        v, i, sl = wave_ops.wave_insert_query(*lk, *ins, psi_p, k)
        wave_ref.insert_scatter(*lp, *ins)
        rv, ri, rsl = wave_ref.query_topk(sp.doc_emb, sp.doc_ids,
                                          sp.doc_scale, psi_p, k)
    elif mode == "query_topk":
        v, i, sl = wave_ops.wave_query_topk(sk.doc_emb, sk.doc_ids,
                                            sk.doc_scale, psi_p, k)
        rv, ri, rsl = wave_ref.query_topk(sp.doc_emb, sp.doc_ids,
                                          sp.doc_scale, psi_p, k)
    else:
        wave_ops.wave_insert_scatter(*lk, *ins)
        wave_ref.insert_scatter(*lp, *ins)
    assert dispatch.counters()[f"wave_{mode}"].launches == 1
    for f, a, b in zip(tc.CacheState._fields, sk, sp):
        assert torch.equal(a, b), f
    if mode != "insert_scatter":
        assert v.shape == (s, k)
        assert_topk_agree(v, i, rv, ri, TOL, f"wave {mode} {dtype} k={k}")
        assert torch.equal(torch.gather(sk.doc_ids, 1, sl.long()), i)
        # empty slots follow in ascending slot order, as the plain sort
        empty = ri < 0
        assert torch.equal(sl[empty], rsl[empty])
        return int(empty.sum())
    return 0


@pytest.mark.parametrize("mode", ["insert_query", "query_topk",
                                  "insert_scatter"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_wave_kernel_matches_plain(card, dtype, mode):
    _wave_check(card, dtype, mode, capacity=700, n_live=300, k=128)


@pytest.mark.parametrize("k", [129, 200, 1024, 1500])
@pytest.mark.parametrize("mode", ["insert_query", "query_topk"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_wave_query_any_k(card, dtype, mode, k):
    """The repaired limit: the cache query at any k <= capacity (1500
    logical, 1536 physical slots), once past the live documents."""
    empty = _wave_check(card, dtype, mode, capacity=1500, n_live=1300, k=k)
    assert (empty > 0) == (k == 1500)


def test_wave_query_pairs_in_global_scratch(card, monkeypatch):
    """Survivors too many for shared memory go to global scratch: forced
    here at k = 200 by lowering the shared-memory pair budget."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "SMEM_PAIRS", 64)
    _wave_check(card, "fp32", "insert_query", capacity=1500, n_live=1300,
                k=200)


@pytest.mark.parametrize("k", [1, 200, 12288])
@pytest.mark.parametrize("mode", ["insert_query", "query_topk"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_wave_single_session_full_cache(card, dtype, mode, k):
    """Algorithm 1's cache at Table 1's setting: one session, capacity
    12000 (12288 physical slots, every block of the split grid on its own
    chunk), 11000 live docs plus a k_c = 1000 insert; k = 1, 200 and every
    physical slot (past the live docs: empties in ascending order)."""
    empty = _wave_check(card, dtype, mode, capacity=12000, n_live=11000,
                        k=k, s=1, kc=1000)
    assert (empty > 0) == (k == 12288)


def _chunk_edges(s, cp):
    """Insert positions on both sides of every chunk edge of the wave grid
    (the first and last physical slot included) plus two drop sentinels,
    in a different order per row."""
    chunk, chunks = wave_ops.wave_grid(s, cp, torch.cuda.get_device_properties(
        0).multi_processor_count)
    assert chunks > 2
    edges = sorted({0, cp - 1} | {e for c in range(1, chunks)
                                  for e in (c * chunk - 1, c * chunk)
                                  if e < cp})
    base = torch.tensor(edges + [cp, cp + 7], dtype=torch.int32)
    rows = [base[torch.randperm(len(base), generator=torch.Generator()
                                .manual_seed(r))] for r in range(s)]
    return torch.stack(rows).cuda()


@pytest.mark.parametrize("mode", ["insert_query", "query_topk",
                                  "insert_scatter"])
@pytest.mark.parametrize("dtype", ["fp32", "int8"])
def test_wave_insert_on_chunk_edges(card, dtype, mode):
    """Rows landing on each side of every chunk boundary, and the drop
    sentinels, write exactly what the plain scatter writes."""
    s, capacity = 3, 1500
    cp = tc.CacheConfig(capacity=capacity, dim=DIM).phys_capacity
    pos = _chunk_edges(s, cp)
    _wave_check(card, dtype, mode, capacity=capacity, n_live=400, k=300,
                s=s, kc=pos.shape[1], pos=pos)


def _bits(t):
    return t.contiguous().view(torch.uint8)


@pytest.mark.parametrize("mode", ["insert_query", "query_topk",
                                  "insert_scatter"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_wave_rows_on_stacked_payload(card, dtype, mode):
    """The wave through a row index on the stacked payload: rows [4, 1, 4,
    4] of six sessions, the last two padding the wave with its first
    session (no insert positions, rec false).  The stacked payload and the
    wave's leaves equal the plain version bit for bit, the real rows'
    answers agree, and no payload row outside the wave changes."""
    cfg = tc.CacheConfig(capacity=1500, dim=DIM, max_queries=8,
                         store_dtype=dtype)
    total, n_live, kc, k = 6, 900, 400, 64
    cp, dp = cfg.phys_capacity, cfg.phys_dim
    state = tc.init_batched_cache(cfg, total, "cuda")
    data, scale = tc.store_rows(_unit(total, n_live, DIM, gen=card), dtype)
    state.doc_emb[:, :n_live, :DIM] = data
    state.doc_scale[:, :n_live] = scale
    state.doc_ids[:, :n_live] = torch.arange(
        total * n_live, dtype=torch.int32, device="cuda").view(total, n_live)
    state.n_queries.copy_(torch.arange(total, dtype=torch.int32) * 5)
    wave = [4, 1, 4, 4]
    w = len(wave)
    rows = torch.tensor(wave, dtype=torch.int32, device="cuda")
    new_q, new_scale = tc.store_rows(_unit(w, kc, DIM, gen=card), dtype)
    # distinct slots per row, live ones included (an overwrite), then drops
    pos = torch.stack([torch.randperm(cp, generator=card, device="cuda")[:kc]
                       for _ in range(w)])
    pos[:, ::5] = cp
    pos[2:] = cp                                         # the padded rows
    pos = pos.to(torch.int32)
    psi = _unit(w, DIM, gen=card)
    psi_q, psi_scale = tc.store_rows(psi, dtype)
    rec = torch.tensor([True, True, False, False], device="cuda")
    full_k = tc.CacheState(*(x.clone() for x in state))
    full_p = tc.CacheState(*(x.clone() for x in state))
    idx = rows.long()

    def leaves(full):
        return (full.doc_emb, *(getattr(full, f)[idx].clone() for f in
                                ("doc_ids", "doc_stamp", "doc_scale",
                                 "q_emb", "q_radius", "q_scale")))
    lk, lp = leaves(full_k), leaves(full_p)
    ins = (tc.pad_features(new_q, dp), new_scale,
           torch.arange(w * kc, dtype=torch.int32, device="cuda").view(w, kc)
           + 10 ** 6, pos, tc.pad_features(psi_q, dp), psi_scale,
           torch.rand(w, device="cuda"), rec,
           torch.remainder(state.n_queries[idx], 8).to(torch.int32),
           torch.full((w,), 4, dtype=torch.int32, device="cuda"))
    psi_p = tc.pad_features(psi, dp)
    dispatch.reset_counters()
    if mode == "insert_query":
        v, i, sl = wave_ops.wave_insert_query(*lk, *ins, psi_p, k, rows=rows)
        wave_ref.insert_scatter(*lp, *ins, rows=rows)
        rv, ri, _ = wave_ref.query_topk(lp[0], lp[1], lp[3], psi_p, k, rows)
    elif mode == "query_topk":
        v, i, sl = wave_ops.wave_query_topk(lk[0], lk[1], lk[3], psi_p, k,
                                            rows=rows)
        rv, ri, _ = wave_ref.query_topk(lp[0], lp[1], lp[3], psi_p, k, rows)
    else:
        wave_ops.wave_insert_scatter(*lk, *ins, rows=rows)
        wave_ref.insert_scatter(*lp, *ins, rows=rows)
    assert dispatch.counters()[f"wave_{mode}"].launches == 1
    assert torch.equal(_bits(full_k.doc_emb), _bits(full_p.doc_emb))
    for a, b in zip(lk[1:], lp[1:]):
        assert torch.equal(_bits(a), _bits(b))
    outside = [r for r in range(total) if r not in wave]
    assert torch.equal(_bits(full_k.doc_emb[outside]),
                       _bits(state.doc_emb[outside]))
    if mode != "insert_scatter":
        assert_topk_agree(v[:2], i[:2], rv[:2], ri[:2], TOL,
                          f"wave rows {mode} {dtype}")
        assert torch.equal(torch.gather(lk[1], 1, sl.long())[:2], i[:2])


@pytest.mark.parametrize("mode", ["insert_query", "query_topk"])
def test_wave_keys_past_the_shared_stage(card, mode):
    """A capacity whose keys do not fit the merge's shared-memory stage
    (20480 physical slots): the merge reads them from L2."""
    _wave_check(card, "fp32", mode, capacity=20000, n_live=19000, k=300,
                s=2, kc=1000)


def test_wave_refuses_bad_rows(card):
    """A stacked payload needs its row index: int32, one entry a wave row,
    on the payload's device."""
    emb = torch.zeros(4, 64, 800, device="cuda")
    ids = torch.full((2, 64), -1, dtype=torch.int32, device="cuda")
    scale = torch.ones(2, 64, device="cuda")
    psi = torch.zeros(2, 800, device="cuda")
    for rows in (None, torch.tensor([0, 1], device="cuda"),
                 torch.tensor([0, 1, 2], dtype=torch.int32, device="cuda"),
                 torch.tensor([0, 1], dtype=torch.int32)):
        with pytest.raises(ValueError):
            wave_ops.wave_query_topk(emb, ids, scale, psi, 5, rows=rows)
    v, i, _ = wave_ops.wave_query_topk(
        emb, ids, scale, psi, 5,
        rows=torch.tensor([3, 0], dtype=torch.int32, device="cuda"))
    assert (i == -1).all() and torch.isneginf(v).all()


def test_wave_single_session_pairs_in_global_scratch(card, monkeypatch):
    """The one-session query at k = 200 with its survivors forced into
    global scratch."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "SMEM_PAIRS", 64)
    _wave_check(card, "fp32", "insert_query", capacity=12000, n_live=11000,
                k=200, s=1, kc=1000)


def test_engine_on_card_matches_cpu(card):
    """A small world served on the card answers turn for turn as the
    plain CPU path does."""
    from repro_torch.core.embedding import transform_documents
    from repro_torch.core.embedding import transform_queries
    from repro_torch.data.conversations import WorldConfig, make_world
    from repro_torch.dist.retrieval import DeviceShard
    from repro_torch.serve.router import ShardedRouter
    from repro_torch.serve.session import BatchedEngine

    w = make_world(WorldConfig(n_topics=4, docs_per_topic=500,
                               n_background=1000, dim=64, turns=5,
                               n_conversations=6, seed=3))
    docs = transform_documents(torch.as_tensor(w.doc_emb,
                                               dtype=torch.float32))[0]
    qs = [transform_queries(torch.as_tensor(c.queries, dtype=torch.float32))
          for c in w.conversations]
    turns = {}
    for dev in ("cuda", "cpu"):
        ids = np.arange(docs.shape[0], dtype=np.int32)
        with ShardedRouter([DeviceShard(docs, ids, device=dev)],
                           deadline_s=60) as router:
            eng = BatchedEngine(router, docs, dim=docs.shape[1], n_sessions=6,
                                k=10, k_c=200, capacity=1200, device=dev)
            dispatch.reset_counters()
            turns[dev] = [eng.answer_batch(range(6), [q[t] for q in qs])
                          for t in range(5)]
            if dev == "cuda":
                c = dispatch.counters()
                assert c["cache_probe"].launches == 5
                assert c["knn_score"].launches >= 1
    for wa, wb in zip(turns["cuda"], turns["cpu"]):
        for a, b in zip(wa, wb):
            assert a.tier == b.tier
            assert_topk_agree(a.scores[None], a.ids[None], b.scores[None],
                              b.ids[None], TOL, "engine turn")


def _knn_corpus(gen, n, n_sentinels=0):
    docs = tc.pad_features(_unit(n, DIM, gen=gen), 800)
    docs[n // 3] = docs[17]                 # exact ties
    ids = torch.arange(n, dtype=torch.int32, device="cuda") + 5
    if n_sentinels:
        ids[torch.randperm(n, generator=gen, device="cuda")[:n_sentinels]] = -1
    return docs, ids


@pytest.mark.parametrize("k", [1025, 2048, 5000, 20000])
def test_knn_search_past_the_old_limit(card, k):
    """The repaired limit: the fused search at any k <= N (k = 20000 keeps
    its survivors in global scratch)."""
    docs, ids = _knn_corpus(card, 100_003, n_sentinels=50)
    q = _unit(5, DIM, gen=card)
    q[0] = docs[17, :DIM]
    dispatch.reset_counters()
    v, i = knn_ops.knn_search(docs, ids, q, k)
    c = dispatch.counters()
    assert c["knn_score"].launches == c["knn_select"].launches == 1
    rv, ri = knn_ref.search(docs, ids, tc.pad_features(q, 800), k)
    assert_topk_agree(v, i, rv, ri, TOL, f"knn k={k}")
    assert v.shape == (5, k) and (i >= 0).all()


@pytest.mark.parametrize("global_pairs", [False, True])
def test_knn_search_at_k_equal_n(card, monkeypatch, global_pairs):
    """k = N on a few thousand rows with sentinels: every row ranked, the
    sentinels last as (-inf, -1)."""
    from repro_torch.kernels import _build
    if global_pairs:
        monkeypatch.setattr(_build, "SMEM_PAIRS", 256)
    n = 3001
    docs, ids = _knn_corpus(card, n, n_sentinels=40)
    q = _unit(3, DIM, gen=card)
    v, i = knn_ops.knn_search(docs, ids, q, n)
    rv, ri = knn_ref.search(docs, ids, tc.pad_features(q, 800), n)
    assert_topk_agree(v, i, rv, ri, TOL, "knn k=N")
    assert (i[:, :n - 40] >= 0).all() and (i[:, n - 40:] == -1).all()


THR = knn_ops.SCORE_GEMV_MAX_B


@pytest.mark.parametrize("dtype,i8", [("fp32", False), ("bf16", False),
                                      ("int8", False), ("int8", True)])
@pytest.mark.parametrize("dp", [32, 800])
@pytest.mark.parametrize("b", [1, 2, THR, THR + 1, 64, 65, 130])
def test_knn_score_paths_match_plain(card, dtype, i8, dp, b):
    """Both score paths (the single-query GEMV up to the threshold, the
    batched GEMM at any B) against the plain product on a corpus whose N is
    no tile multiple, with sentinel rows."""
    n = 5003
    docs = _unit(n, dp - 3, gen=card)
    docs = tc.pad_features(docs, dp)
    qc = quant.quantize(docs, dtype)
    ids = torch.arange(n, dtype=torch.int32, device="cuda")
    ids[[0, 777, n - 1]] = -1
    q = tc.pad_features(_unit(b, dp - 3, gen=card), dp)
    qs = None
    if i8:
        qqc = quant.quantize(q, "int8")
        q, qs = qqc.data, qqc.scale
    want = knn_ref.score(qc.data, ids, q, qc.scale, qs)
    for gemv in ([True, False] if b <= THR else [False]):
        got = knn_ops._score(qc.data, ids, q, qc.scale, qs, gemv=gemv)
        assert_close(got, want, TOL, f"score {dtype} i8={i8} gemv={gemv}")
        assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    dispatch.reset_counters()
    knn_ops.knn_score(qc.data, ids, q, qc.scale, qs)
    assert dispatch.counters()["knn_score"].launches == 1


def _select_rows(gen, case, b=3, n=40_009):
    """(scores, k) of one hard case for the select, on the card."""
    s = torch.randn(b, n, generator=gen, device="cuda")
    k = 1000
    if case == "all_equal":
        s.fill_(0.5)
    elif case == "tie_across_k":               # a run of 60 at ranks 980+
        v = torch.sort(s, dim=1, descending=True).values[:, 980:981]
        pos = torch.randperm(n, generator=gen, device="cuda")[:60]
        s[:, pos] = v
    elif case == "half_neginf":                # rank k falls in the -inf run
        s[:, ::2] = float("-inf")
        k = n // 2 + 500
    elif case == "few_finite":                 # fewer than k finite
        s[:, 100:] = float("-inf")
    elif case == "k_equal_n":
        s = torch.round(s * 4) / 4             # many ties everywhere
        k = n
    elif case == "zeros_signed":               # -0.0 and +0.0 are one key
        s = torch.round(s) * 0.0
    return s, k


@pytest.mark.parametrize("case", ["random", "all_equal", "tie_across_k",
                                  "half_neginf", "few_finite", "k_equal_n",
                                  "zeros_signed"])
@pytest.mark.parametrize("small_buf", [False, True])
def test_knn_select_hard_rows(card, monkeypatch, case, small_buf):
    """The all-SM radix select equals the plain stable top-k exactly: the
    lowest positions of a tie run at rank k win, -inf results carry id -1.
    ``small_buf`` makes the k-th digit's keys outgrow the filter buffer, so
    later passes read the scores again."""
    if small_buf:
        monkeypatch.setattr(knn_ops, "SELECT_BUF", 64)
    s, k = _select_rows(card, case)
    n = s.shape[1]
    ids = torch.arange(n, dtype=torch.int32, device="cuda") + 3
    dispatch.reset_counters()
    v, i = knn_ops.knn_select(s, ids, k)
    assert dispatch.counters()["knn_select"].launches == 1
    rv, ri = knn_ref.select(s, ids, k)
    assert torch.equal(v, rv), case
    assert torch.equal(i, ri), case


@pytest.mark.parametrize("k", [2048, 20000])
@pytest.mark.parametrize("global_sort", [False, True])
def test_knn_select_large_k(card, monkeypatch, k, global_sort):
    """Candidates beyond the shared-memory sort (k = 20000 always; k = 2048
    when the limit is forced down) are sorted in global scratch."""
    from repro_torch.kernels import _build
    if global_sort:
        monkeypatch.setattr(_build, "SMEM_PAIRS", 256)
    s, _ = _select_rows(card, "tie_across_k", b=2, n=100_003)
    ids = torch.arange(s.shape[1], dtype=torch.int32, device="cuda")
    v, i = knn_ops.knn_select(s, ids, k)
    rv, ri = knn_ref.select(s, ids, k)
    assert torch.equal(v, rv) and torch.equal(i, ri)


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_single_probe_kernel_matches_plain(card, dtype):
    """``probe_rhat`` (one session) against ``ref.probe_rhat``, and the
    hit / nearest record of ``cache_probe`` against the CPU path, on a
    padded ring and on unpadded shapes (ring 13, dim 45)."""
    for qmax, dim in ((64, DIM), (13, 45)):
        recs = _unit(qmax, dim, gen=card)
        psi = torch.nn.functional.normalize(
            recs[:4].mean(0) + 0.3 * _unit(dim, gen=card), dim=0)
        q_emb, q_scale = tc.store_rows(recs, dtype)
        radius = 0.3 + 0.8 * torch.rand(qmax, generator=card, device="cuda")
        if qmax == 64:
            dp = 800
            rk = probe_ops.probe_rhat(tc.pad_features(q_emb, dp),
                                      tc.pad_features(psi, dp), radius,
                                      q_scale)
            rp = probe_ref.probe_rhat(tc.pad_features(q_emb, dp),
                                      tc.pad_features(psi, dp), radius,
                                      q_scale)
            assert_close(rk, rp, 1e-4, f"probe_rhat {dtype}")
        for n_q in (0, 1, qmax, qmax + 9):
            dispatch.reset_counters()
            got = probe_ops.cache_probe(q_emb, psi, radius, n_q, 0.25,
                                        q_scale=q_scale)
            assert dispatch.counters()["probe_rhat"].launches == 1
            want = probe_ops.cache_probe(q_emb.cpu(), psi.cpu(), radius.cpu(),
                                         n_q, 0.25, q_scale=q_scale.cpu())
            assert bool(got[0]) == bool(want[0])
            assert int(got[2]) == int(want[2])
            if n_q:
                assert abs(float(got[1]) - float(want[1])) <= 1e-4


def _tile_agree(vals, pos, rv, rp, what):
    """Per (tile, row): values within TOL, positions by the rank rule, with
    -inf entries (any masked or padded position) as -1."""
    t, b, ke = vals.shape
    neg = torch.isneginf(vals)
    assert torch.equal(neg, torch.isneginf(rv)), what
    p = torch.where(neg, -1, pos).reshape(t * b, ke)
    q = torch.where(torch.isneginf(rv), -1, rp).reshape(t * b, ke)
    assert_topk_agree(vals.reshape(t * b, ke), p, rv.reshape(t * b, ke), q,
                      TOL, what)


@pytest.mark.parametrize("dtype,i8", [("fp32", False), ("bf16", False),
                                      ("int8", False), ("int8", True)])
@pytest.mark.parametrize("tile_n,k", [(None, 100), (256, 300), (64, 64)])
def test_tile_topk_kernel_matches_plain(card, dtype, i8, tile_n, k):
    n = 20011
    docs, ids = _knn_corpus(card, n, n_sentinels=30)
    qc = quant.quantize(docs, dtype)
    q = _unit(9, DIM, gen=card)
    dispatch.reset_counters()
    v, i = knn_ops.knn_search(qc.data, ids, q, k, scale=qc.scale,
                              int8_dot=i8, tile_n=tile_n, two_stage=True)
    c = dispatch.counters()
    assert (c["knn_score"].launches, c["knn_tile_topk"].launches,
            c["knn_select"].launches) == (0, 1, 1)
    qq, qs = tc.pad_features(q, 800), None
    if i8:
        qqc = quant.quantize(qq, "int8")
        qq, qs = qqc.data, qqc.scale
    t_n, k_eff = (knn_ops.autotune_knn(n, 800, 9, k, qc.data.element_size())
                  if tile_n is None else (tile_n, min(k, tile_n)))
    vk, pk = knn_ops.knn_tile_topk(qc.data, ids, qq, k_eff, t_n, qc.scale, qs)
    vr, pr = knn_ref.tile_topk(qc.data, ids, qq, k_eff, t_n, qc.scale, qs)
    _tile_agree(vk, pk, vr, pr, f"tiles {dtype} i8={i8} tile_n={t_n}")
    rv, ri = knn_ref.merge_tiles(vr, pr, ids, k)
    assert_topk_agree(v, i, rv, ri, TOL, f"two-stage {dtype} i8={i8}")
    # and the exact answer: k_eff = min(k, tile_n) keeps whole small tiles
    ev, ei = knn_ref.search(qc.data, ids, qq, k, qc.scale, qs)
    assert_topk_agree(v, i, ev, ei, TOL, f"two-stage exact {dtype}")


def _ref_tiles(docs, ids, q, k_eff, tile_n, scale=None, q_scale=None):
    """The plain tile stage, and beside it each (tile, row)'s next rank
    (the ``k_eff + 1``-th) when ``k_eff < tile_n``: a kernel may cut a run
    tied within the tolerance at the k_eff boundary elsewhere."""
    if k_eff == tile_n:
        return (*knn_ref.tile_topk(docs, ids, q, k_eff, tile_n, scale,
                                   q_scale), None)
    vr, pr = knn_ref.tile_topk(docs, ids, q, k_eff + 1, tile_n, scale,
                               q_scale)
    return vr[..., :-1], pr[..., :-1], (vr[..., -1:], pr[..., -1:])


def _tile_agree_cut(vals, pos, rv, rp, nxt, what):
    """``_tile_agree`` with the plain version's next rank appended to both
    sides (as ``test_searcher_on_card_matches_cpu`` does for its answers)."""
    if nxt is not None:
        vals, rv = (torch.cat([x, nxt[0]], dim=2) for x in (vals, rv))
        pos, rp = (torch.cat([x, nxt[1]], dim=2) for x in (pos, rp))
    _tile_agree(vals, pos, rv, rp, what)


def _tie_corpus(gen, n):
    """``_knn_corpus`` with exact ties inside a tile too (rows 17, 18, 19 and
    40) and across tiles (n // 3, 600), and query 0 on them."""
    docs, ids = _knn_corpus(gen, n, n_sentinels=25)
    tied = [17, 18, 19, 40, 600, n // 3]
    docs[tied] = docs[17].clone()
    ids[tied] = torch.tensor(tied, dtype=torch.int32, device="cuda") + 5
    return docs, ids


@pytest.mark.parametrize("b", [1, 9, 70])
@pytest.mark.parametrize("tile_n", [16, 100, 256, 512, 1024, 2048, 4096,
                                    8192])
@pytest.mark.parametrize("part", [False, True])
def test_fused_tile_topk_matches_plain(card, b, tile_n, part):
    """The fused tile kernel at every cluster size (tiles of 512 .. 4096
    span 2 .. 16 blocks) and the narrow tiles (16 and 100: whole tiles a
    block), at k_eff = tile_n and below it, with ties and a tile past N;
    one query row, one partial 64-query tile and two (B = 8 and 64 in
    ``test_two_stage_search_fused_dtypes``).  A wider tile (8192) the
    kernel refuses, and the two-stage search answers it as the fused
    search, bit for bit."""
    n = 20011
    docs, ids = _tie_corpus(card, n)
    q = tc.pad_features(_unit(b, DIM, gen=card), 800)
    q[0, :DIM] = docs[17, :DIM]
    k_eff = tile_n // 3 + 1 if part else tile_n
    if tile_n > knn_ops.FUSED_MAX_TILE:
        with pytest.raises(ValueError, match="fused tile kernel"):
            knn_ops.knn_tile_topk(docs, ids, q, k_eff, tile_n)
        dispatch.reset_counters()
        v, i = knn_ops.knn_search(docs, ids, q, k_eff, tile_n=tile_n,
                                  two_stage=True)
        c = dispatch.counters()
        assert (c["knn_tile_topk"].launches, c["knn_score"].launches,
                c["knn_select"].launches) == (0, 1, 1)
        fv, fi = knn_ops.knn_search(docs, ids, q, k_eff)
        assert torch.equal(v, fv) and torch.equal(i, fi)
        return
    dispatch.reset_counters()
    vk, pk = knn_ops.knn_tile_topk(docs, ids, q, k_eff, tile_n)
    c = dispatch.counters()
    assert (c["knn_tile_topk"].launches, c["knn_score"].launches) == (1, 0)
    tiles = -(-n // tile_n)
    assert vk.shape == pk.shape == (tiles, b, k_eff)
    vr, pr, nxt = _ref_tiles(docs, ids, q, k_eff, tile_n)
    _tile_agree_cut(vk, pk, vr, pr, nxt, f"fused tiles b={b} tile_n={tile_n}")
    # the tied rows lead query 0's first tile in position order
    if tile_n >= 64 and k_eff >= 4:
        assert pk[0, 0, :4].tolist() == [17, 18, 19, 40]


@pytest.mark.parametrize("dtype,i8", [("fp32", False), ("bf16", False),
                                      ("int8", False), ("int8", True)])
@pytest.mark.parametrize("tile_n", [100, 512, 4096])
@pytest.mark.parametrize("b", [8, 64])
def test_two_stage_search_fused_dtypes(card, dtype, i8, tile_n, b):
    """``knn_search(two_stage=True)`` under every dtype and int8-dot: one
    fused tile launch and one select launch, no score launch; the tile
    stage and the answer equal the plain two-stage version."""
    n, k = 20011, 300
    docs, ids = _tie_corpus(card, n)
    qc = quant.quantize(docs, dtype)
    q = _unit(b, DIM, gen=card)
    dispatch.reset_counters()
    v, i = knn_ops.knn_search(qc.data, ids, q, k, scale=qc.scale,
                              int8_dot=i8, tile_n=tile_n, two_stage=True)
    c = dispatch.counters()
    assert (c["knn_tile_topk"].launches, c["knn_select"].launches,
            c["knn_score"].launches) == (1, 1, 0)
    qq, qs = tc.pad_features(q, 800), None
    if i8:
        qqc = quant.quantize(qq, "int8")
        qq, qs = qqc.data, qqc.scale
    k_eff = min(k, tile_n)
    vk, pk = knn_ops.knn_tile_topk(qc.data, ids, qq, k_eff, tile_n, qc.scale,
                                   qs)
    vr, pr, nxt = _ref_tiles(qc.data, ids, qq, k_eff, tile_n, qc.scale, qs)
    _tile_agree_cut(vk, pk, vr, pr, nxt,
                    f"tiles {dtype} i8={i8} tile_n={tile_n}")
    rv, ri = knn_ref.merge_tiles(vr, pr, ids, k)
    assert_topk_agree(v, i, rv, ri, TOL, f"two-stage {dtype} i8={i8}")


def test_merge_tiles_through_select_equals_plain(card):
    """The merge through ``knn_select`` equals the plain stable sort bit for
    bit: ties across tiles, -inf runs, positions past N."""
    tiles, b, ke, n = 40, 5, 64, 2500
    vals = torch.randn(tiles, b, ke, generator=card, device="cuda")
    vals[3:9, :, 10:20] = 0.5                   # one value in six tiles
    vals[:, 1, 30:] = float("-inf")
    vals[20:, 2] = float("-inf")
    vals = torch.sort(vals, dim=2, descending=True).values
    pos = torch.randint(0, 2600, (tiles, b, ke), generator=card,
                        device="cuda", dtype=torch.int32)
    ids = torch.arange(n, dtype=torch.int32, device="cuda") + 7
    ids[::11] = -1
    for k in (1, 100, 700):
        got = knn_ops.merge_tiles(vals, pos, ids, k)
        want = knn_ref.merge_tiles(vals, pos, ids, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_two_stage_allocates_no_score_matrix(card):
    """The fused tile stage at B = 64 allocates its two outputs and nothing
    else, far below one (B, N) f32 score matrix; the whole two-stage search
    (k_eff = tile_n) holds the candidates and the merge's scratch, and no
    score matrix beside them."""
    n, b, tile_n, k_eff, k = 200_003, 64, 512, 100, 1000
    docs, ids = _knn_corpus(card, n, n_sentinels=5)
    q = tc.pad_features(_unit(b, DIM, gen=card), 800)
    knn_ops.knn_tile_topk(docs, ids, q, k_eff, tile_n)      # built, warm
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    vk, pk = knn_ops.knn_tile_topk(docs, ids, q, k_eff, tile_n)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    outs = 8 * b * -(-n // tile_n) * k_eff
    assert peak <= outs + (1 << 20) < 4 * b * n
    del vk, pk
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    knn_ops.knn_search(docs, ids, q, k, tile_n=tile_n, two_stage=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    cands = -(-n // tile_n) * min(k, tile_n)
    assert peak <= b * (8 * cands + 4 * knn_ops._select_words(cands, k)[2]) \
        + 4 * cands + 16 * b * k + (4 << 20)


@pytest.mark.parametrize("policy", ["dynamic", "static", "none"])
def test_searcher_on_card_matches_cpu(card, policy):
    """Algorithm 1 for one session on the card answers as the CPU path:
    hit, ids and r_hat per turn; the launch accounting per turn."""
    from repro_torch.core.conversation import ConversationalSearcher
    from repro_torch.core.embedding import transform_documents
    from repro_torch.core.embedding import transform_queries
    from repro_torch.core.metric_index import MetricIndex
    from repro_torch.data.conversations import WorldConfig, make_world

    w = make_world(WorldConfig(n_topics=4, docs_per_topic=500,
                               n_background=1000, dim=64, turns=5,
                               n_conversations=4, seed=3))
    docs = transform_documents(torch.as_tensor(w.doc_emb,
                                               dtype=torch.float32))[0]
    turns = {}
    for dev in ("cuda", "cpu"):
        s = ConversationalSearcher(
            MetricIndex(docs, transformed=True, device=dev), k=20, k_c=200,
            epsilon=0.04, policy=policy, cache_capacity=1400)
        turns[dev] = []
        for c in w.conversations:
            s.start_conversation()
            qs = transform_queries(torch.as_tensor(c.queries,
                                                   dtype=torch.float32))
            for q in qs:
                dispatch.reset_counters()
                rec = s.answer(q)
                turns[dev].append(rec)
                if dev == "cuda":
                    n = dispatch.counters()
                    miss = 0 if rec.hit else 1
                    cached = int(policy != "none")
                    assert n["probe_rhat"].launches == cached
                    assert n["wave_query_topk"].launches == cached
                    assert n["wave_insert_scatter"].launches == miss * cached
                    assert n["knn_score"].launches == \
                        n["knn_select"].launches == miss
    for a, b in zip(turns["cuda"], turns["cpu"]):
        assert a.hit == b.hit
        assert a.cache_docs == b.cache_docs
        assert a.r_hat == b.r_hat or abs(a.r_hat - b.r_hat) <= 1e-4
        # both cut at k = 20 with rank 21 unseen: b's last entry appended
        # to both, so a last rank tied with rank 21 may hold either doc
        da = np.r_[-a.distances, -b.distances[-1]][None]
        db = np.r_[-b.distances, -b.distances[-1]][None]
        assert_topk_agree(da, np.r_[a.ids, b.ids[-1]][None], db,
                          np.r_[b.ids, b.ids[-1]][None], 1e-4,
                          "searcher turn")


def test_kernels_refuse_bad_inputs(card):
    docs = torch.zeros(100, 800, device="cuda")
    ids = torch.arange(100, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        knn_ops.knn_select(torch.zeros(2, 2000, device="cuda"),
                           torch.arange(2000, dtype=torch.int32,
                                        device="cuda"), 2001)
    with pytest.raises(ValueError):
        knn_ops.knn_score(docs[:, :790], ids, torch.zeros(2, 790,
                                                          device="cuda"))
    with pytest.raises(ValueError):
        wave_ops.wave_query_topk(torch.zeros(1, 64, 800, device="cuda"),
                                 torch.zeros(1, 64, dtype=torch.int32,
                                             device="cuda"),
                                 torch.ones(1, 64, device="cuda"),
                                 torch.zeros(1, 800, device="cuda"), 65)
    with pytest.raises(ValueError):
        knn_ops.knn_tile_topk(docs, ids, torch.zeros(2, 800, device="cuda"),
                              65, 64)


# ------------------------------------------------------------ embedding bag
BAG_TOL = {torch.float32: 1e-5, torch.float16: 1e-3, torch.bfloat16: 1e-3}


def _bag_inputs(gen, v, d, b, l, dtype):
    """A table, ids with 20% pads and bag 1 all padding, and weights in
    [-0.5, 1.5) with bag 2 all 0 (max mode counts only weights > 0)."""
    table = torch.randn(v, d, generator=gen, device="cuda").to(dtype)
    idx = torch.randint(0, v, (b, l), generator=gen, device="cuda",
                        dtype=torch.int32)
    pad = torch.rand(b, l, generator=gen, device="cuda") < 0.2
    idx = torch.where(pad, -1, idx)
    idx[1] = -1
    w = torch.rand(b, l, generator=gen, device="cuda") * 2 - 0.5
    w[2] = 0.0
    return table, idx, w


@pytest.mark.parametrize("d", [1, 10, 64, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_kernel_matches_plain(card, mode, dtype, d):
    table, idx, w = _bag_inputs(card, 5000, d, 300, 7, dtype)
    for weights in (None, w):
        dispatch.reset_counters()
        got = bag_ops.embedding_bag(table, idx, weights, mode)
        assert dispatch.counters()["embedding_bag"].launches == 1
        want = bag_ref.embedding_bag(table, idx, weights, mode)
        assert_close(got, want, BAG_TOL[dtype], f"bag {mode} {dtype} D={d}")
        assert not got[1].any()                       # the empty bag
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("mode", ["sum", "max"])
def test_embedding_bag_unaligned_table_and_ids_past_it(card, mode):
    """A table view 4 bytes off a 16-byte boundary takes the scalar loads;
    ids >= V read row V - 1, never past the table."""
    v, d = 3000, 64
    buf = torch.randn(v * d + 1, generator=card, device="cuda")
    table = buf[1:].view(v, d)
    assert table.data_ptr() % 16 != 0
    table_, idx, w = _bag_inputs(card, v, d, 200, 5, torch.float32)
    idx[0, 0] = v
    idx[3, 2] = 2 ** 31 - 1
    got = bag_ops.embedding_bag(table, idx, w, mode)
    assert_close(got, bag_ref.embedding_bag(table, idx, w, mode), 1e-5,
                 "bag unaligned")
    got = bag_ops.embedding_bag(table_, idx, w, mode)
    assert_close(got, bag_ref.embedding_bag(table_, idx, w, mode), 1e-5,
                 "bag ids past the table")


def test_embedding_bag_table_past_int32_offsets(card):
    """A (34M, 64) f16 table holds 2.18e9 elements (> 2**31 - 1) in 4.35 GB:
    row offsets must be 64-bit."""
    v, d = 34_000_000, 64
    table = torch.empty(v, d, device="cuda", dtype=torch.float16)
    table.normal_(generator=card)
    idx = torch.randint(v - 100_000, v, (4096, 3), generator=card,
                        device="cuda", dtype=torch.int32)
    idx[:, 0] = torch.arange(4096, device="cuda", dtype=torch.int32)
    for mode in ("sum", "max"):
        got = bag_ops.embedding_bag(table, idx, None, mode)
        assert_close(got, bag_ref.embedding_bag(table, idx, None, mode),
                     1e-3, f"bag past int32 {mode}")
    del table
    torch.cuda.empty_cache()


@pytest.mark.parametrize("arch", ["dlrm-rm2", "xdeepfm"])
def test_recsys_smoke_forward_on_card_matches_cpu(card, arch):
    """The smoke config on the CPU path and, moved to the card, through the
    kernel: logits within 1e-5; 1 launch per DLRM forward, 2 per xDeepFM
    forward (field tables, linear term)."""
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    if arch == "dlrm-rm2":
        cfg = dlrm_rm2.smoke_config()
        m = rs.DLRM(cfg, device="cpu", generator=gen)
        idx = rng.integers(-1, cfg.vocab, (64, cfg.n_sparse, cfg.multi_hot))
        args = (rng.standard_normal((64, cfg.n_dense)).astype(np.float32),
                idx.astype(np.int32))
        launches = 1
    else:
        cfg = xdeepfm.smoke_config()
        m = rs.XDeepFM(cfg, device="cpu", generator=gen)
        args = (rng.integers(-1, cfg.vocab, (64, cfg.n_sparse, 1))
                .astype(np.int32),)
        launches = 2
    want = m(*args)
    want_tower = m.user_tower(*args)
    m.to("cuda")
    dispatch.reset_counters()
    got = m(*args)
    assert dispatch.counters()["embedding_bag"].launches == launches
    assert_close(got, want, 1e-5, f"{arch} logits")
    assert_close(m.user_tower(*args), want_tower, 1e-5, f"{arch} tower")


def test_embedding_bag_refuses_bad_inputs(card):
    table = torch.zeros(100, 8, device="cuda")
    idx = torch.zeros(4, 2, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):                   # strided: no copy
        bag_ops.embedding_bag(torch.zeros(8, 100, device="cuda").t(), idx)
    with pytest.raises(ValueError):                   # ids on another device
        bag_ops.embedding_bag(table, idx.cpu())
    with pytest.raises(ValueError):
        bag_ops.embedding_bag(table, idx, torch.ones(4, 3, device="cuda"))
    with pytest.raises(TypeError):
        bag_ops.embedding_bag(table, idx.long())
    with pytest.raises(TypeError):
        bag_ops.embedding_bag(table.double(), idx)
    with pytest.raises(ValueError):
        bag_ops.embedding_bag(table, idx, mode="prod")


# ------------------------------------------- chunked search, fused probe
@pytest.mark.parametrize("dtype,i8", [("fp32", False), ("bf16", False),
                                      ("int8", False), ("int8", True)])
@pytest.mark.parametrize("two_stage", [False, True])
def test_knn_search_in_chunks_equals_unchunked(card, monkeypatch, dtype, i8,
                                               two_stage):
    """B = 134 over a budget that holds 64 queries: chunks of 64, 64 and a
    tail of 6 (on the GEMM path the whole B takes), bit for bit the
    unchunked search; one launch of each kernel per chunk."""
    n, b, k = 30011, 134, 100
    docs = tc.pad_features(_unit(n, DIM, gen=card), 800)
    qc = quant.quantize(docs, dtype)
    ids = torch.arange(n, dtype=torch.int32, device="cuda")
    ids[[5, 700]] = -1
    q = _unit(b, DIM, gen=card)
    kw = dict(scale=qc.scale, int8_dot=i8, two_stage=two_stage)
    whole = knn_ops.knn_search(qc.data, ids, q, k, **kw)
    monkeypatch.setattr(knn_ops, "SCRATCH_BUDGET", 64 * 4 * n)
    dispatch.reset_counters()
    parts = knn_ops.knn_search(qc.data, ids, q, k, **kw)
    c = dispatch.counters()
    assert c["knn_select"].launches == 3
    assert c["knn_tile_topk" if two_stage else "knn_score"].launches == 3
    assert c["knn_score" if two_stage else "knn_tile_topk"].launches == 0
    assert torch.equal(parts[0], whole[0]) and torch.equal(parts[1], whole[1])
    # the tail alone, as a search of its own, takes the GEMV path: its rows
    # then need only agree by the tolerance
    tail = knn_ops.knn_search(qc.data, ids, q[128:], k, **kw)
    assert_topk_agree(tail[0], tail[1], whole[0][128:], whole[1][128:], TOL,
                      f"tail {dtype} i8={i8}")


def _probe_wave(gen, dtype, s=9, qmax=13, dim=DIM, width=None):
    """Records around each psi, edges per session: empty, 1 record, a tie
    for the best record (slots 2 and 5), every radius -inf, n_queries past
    the ring, a miss (psi flipped)."""
    width = width or dim
    psi = _unit(s, dim, gen=gen)
    noise = torch.randn(s, qmax, dim, generator=gen, device="cuda")
    spread = torch.linspace(0.2, 1.6, qmax, device="cuda")[None, :, None]
    recs = torch.nn.functional.normalize(psi[:, None] + spread * noise
                                         / dim ** 0.5, dim=2)
    radius = 0.2 + 0.9 * torch.rand(s, qmax, generator=gen, device="cuda")
    recs[3, 2] = recs[3, 5] = torch.nn.functional.normalize(
        psi[3] + 0.01 * noise[3, 0], dim=0)
    radius[3, 2] = radius[3, 5] = 1.5
    radius[4] = float("-inf")
    psi[6] = -psi[6]
    q_emb, q_scale = tc.store_rows(tc.pad_features(recs, width), dtype)
    n_q = torch.tensor([0, 1, 7, 13, 5, qmax + 9, 13, 3, 11],
                       dtype=torch.int32, device="cuda")[:s]
    return q_emb, psi, radius, n_q, q_scale


def _decision_equal(got, want, what):
    hit, best, near = got
    rhit, rbest, rnear = want
    assert torch.equal(hit, rhit), what
    assert torch.equal(near, rnear), what
    fin = torch.isfinite(rbest)
    assert torch.equal(torch.isfinite(best), fin), what
    assert_close(torch.where(fin, best, 0.0), torch.where(fin, rbest, 0.0),
                 1e-4, what)


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("width", [DIM, 800])
@pytest.mark.parametrize("max_queries", [None, 9, 0])
def test_fused_probe_decision_matches_plain(card, dtype, width, max_queries):
    """``cache_probe_batched``: one launch that folds ring validity, the
    first maximal r_hat, the hit test and nearest = -1 for an empty cache,
    against ``ref.lowquality`` over the plain r_hat on the same card
    tensors; at the unaligned width 769 (element loads) and the padded 800
    (16-byte loads), with q_scale given and absent."""
    q_emb, psi, radius, n_q, q_scale = _probe_wave(card, dtype, width=width)
    for scale in (q_scale, None):
        dispatch.reset_counters()
        got = probe_ops.cache_probe_batched(q_emb, psi, radius, n_q, 0.2,
                                            q_scale=scale,
                                            max_queries=max_queries)
        c = dispatch.counters()["cache_probe"]
        assert (c.calls, c.launches) == (1, 1)
        want = probe_ref.lowquality(q_emb, psi, radius, n_q, 0.2, scale,
                                    max_queries)
        _decision_equal(got, want, f"{dtype} width={width} "
                        f"max_queries={max_queries}")
        if max_queries is None:
            assert int(got[2][3]) == 2 and int(got[2][4]) == 0
            assert int(got[2][0]) == -1 and bool(got[0][1])
            assert not bool(got[0][6]) and not bool(got[0][4])


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_fused_single_probe_matches_plain(card, dtype):
    """``cache_probe`` for one session: one launch; an int or a device
    record count; a 64-record ring at 800 (Algorithm 1's) and a 13-record
    ring at 769."""
    for qmax, width in ((64, 800), (13, DIM)):
        q_emb, psi, radius, n_q, q_scale = _probe_wave(card, dtype, qmax=qmax,
                                                       width=width)
        for s in range(q_emb.shape[0]):
            for count in (n_q[s], int(n_q[s]), qmax + 3):
                dispatch.reset_counters()
                got = probe_ops.cache_probe(q_emb[s], psi[s], radius[s],
                                            count, 0.2, q_scale=q_scale[s],
                                            max_queries=qmax)
                assert dispatch.counters()["probe_rhat"].launches == 1
                assert all(x.shape == () and x.is_cuda for x in got)
                want = probe_ref.lowquality(
                    q_emb[s:s + 1], psi[s:s + 1], radius[s:s + 1],
                    torch.as_tensor(count, device="cuda").reshape(1), 0.2,
                    q_scale[s:s + 1], qmax)
                _decision_equal([x[None] for x in got], want,
                                f"{dtype} qmax={qmax} session {s}")


def test_probe_rhat_entries_after_the_redesign(card):
    """The r_hat entries (held against the JAX kernels) launch the same
    body in r_hat mode: every slot, radius as given."""
    q_emb, psi, radius, _, q_scale = _probe_wave(card, "fp32", width=800)
    psi_p = tc.pad_features(psi, 800)
    rk = probe_ops.probe_rhat_batched(q_emb, psi_p, radius, q_scale)
    assert_close(rk, probe_ref.probe_rhat_batched(q_emb, psi_p, radius,
                                                  q_scale), 1e-4, "batched")
    assert torch.isneginf(rk[4]).all()
    r1 = probe_ops.probe_rhat(q_emb[2], psi_p[2], radius[2], q_scale[2])
    assert_close(r1, rk[2], 1e-6, "single")


# ---------------------------------------------- embedding bag, load widths
@pytest.mark.parametrize("d", [1, 2, 10, 33, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("l", [1, 8])
def test_embedding_bag_load_widths_match_plain(card, d, dtype, l):
    """Every load width (16, 8, 4, 2 bytes) in every mode: within the
    tolerance for bags of eight, bit for bit for bags of one item."""
    table, idx, w = _bag_inputs(card, 7000, d, 2001, l, dtype)
    for mode in ("sum", "mean", "max"):
        for weights in (None, w):
            dispatch.reset_counters()
            got = bag_ops.embedding_bag(table, idx, weights, mode)
            assert dispatch.counters()["embedding_bag"].launches == 1
            want = bag_ref.embedding_bag(table, idx, weights, mode)
            if l == 1:
                assert torch.equal(got, want), f"{mode} D={d} {dtype}"
            else:
                assert_close(got, want, BAG_TOL[dtype],
                             f"bag {mode} {dtype} D={d} L={l}")


@pytest.mark.parametrize("d,dtype", [(10, torch.float32), (1, torch.float32),
                                     (64, torch.bfloat16)])
def test_embedding_bag_persistent_grid_walks_every_bag(card, d, dtype):
    """More slots than the resident grid holds (each thread walks several
    steps of 4 slots, the last partial): bags of one item bit for bit."""
    v, b = 1_000_003, 1_500_001
    table = torch.randn(v, d, generator=card, device="cuda").to(dtype)
    idx = torch.randint(-1, v + 5, (b, 1), generator=card, device="cuda",
                        dtype=torch.int32)
    got = bag_ops.embedding_bag(table, idx)
    assert torch.equal(got, bag_ref.embedding_bag(table, idx))


# ------------------------------------- the tiered wave's shapes (cluster, L2)
@pytest.mark.parametrize("b", [1, 2048, 9000])
def test_knn_assignment_shape_matches_plain(card, b):
    """k-means assignment: 64 centroids zero-padded to the corpus width as
    the corpus (less than one score tile), k = 1; equal scores keep the
    lower centroid id."""
    cents = tc.pad_features(_unit(64, DIM, gen=card), 800)
    cents[40] = cents[7]                    # a tie: id 7 must win
    ids = torch.arange(64, dtype=torch.int32, device="cuda")
    q = _unit(b, DIM, gen=card)
    q[0] = cents[7, :DIM]
    dispatch.reset_counters()
    v, i = knn_ops.knn_search(cents, ids, q, 1)
    c = dispatch.counters()
    assert c["knn_score"].launches == c["knn_select"].launches == 1
    rv, ri = knn_ref.search(cents, ids, tc.pad_features(q, 800), 1)
    assert_topk_agree(v, i, rv, ri, TOL, f"assignment b={b}")
    assert int(i[0, 0]) == 7


def test_knn_neighbour_table_shape_matches_plain(card):
    """The cluster index's neighbour tables: 64 centroids as queries, k =
    256, over a corpus of 1,000,003 documents."""
    docs, ids = _knn_corpus(card, 1_000_003)
    q = _unit(64, DIM, gen=card)
    v, i = knn_ops.knn_search(docs, ids, q, 256)
    rv, ri = knn_ref.search(docs, ids, tc.pad_features(q, 800), 256)
    assert_topk_agree(v, i, rv, ri, TOL, "neighbour tables")


def _l2_tier(gen, n_shards=4, capacity=8000):
    from repro_torch.core.shared import SharedTier

    tier = SharedTier(dim=DIM, n_shards=n_shards, capacity=capacity,
                      admission_sessions=1, device="cuda")
    tier.tick()
    for i in range(12):                      # three answers a shard
        psi = _unit(DIM, gen=gen).cpu().numpy()
        tier.offer(("s", i), psi, 0.6, _unit(1128, 800, gen=gen),
                   np.arange(1128) + 1128 * i)
    tier.flush_admissions()
    return tier


def test_l2_probe_and_query_over_repeated_shard_rows(card):
    """The L2 probe (S = 64 over 4 shard rows, 256-record rings) and the L2
    query (capacity 8000, k = 10, through rows=) against the plain
    versions on copies of the same state; the shard rows' stamps and step
    are the last occurrence's."""
    from repro_torch.core.cache_ops import probe_batched, query_batched

    tier = _l2_tier(card)
    psi = _unit(64, DIM, gen=card)
    shards = tier.route(psi.cpu().numpy())
    sub = tier.shards.gather(shards, payload=False)
    dispatch.reset_counters()
    got = tier.probe_rows(psi, shards)
    assert dispatch.counters()["cache_probe"].launches == 1
    cpu_sub = tc.CacheState(*(x.cpu() for x in sub))
    want = probe_batched(cpu_sub, psi.cpu(), tier.cfg.epsilon,
                         max_queries=256)
    assert torch.equal(got.hit.cpu(), want.hit)
    assert_close(got.r_hat, want.r_hat.cuda(), 1e-4, "L2 r_hat")
    before = tc.CacheState(*(x.clone() for x in tier.state))
    out = tier.query_rows(psi, shards, 10)
    assert dispatch.counters()["wave_query_topk"].launches == 1
    ref_sub = tc.CacheState(*(x[torch.as_tensor(shards)].cpu()
                              for x in before))
    (rv, _rd, ri, _rs), ref_sub = query_batched(ref_sub, psi.cpu(), 10)
    assert_topk_agree(out[0], out[2], rv, ri, TOL, "L2 query")
    last = {int(s): r for r, s in enumerate(shards)}
    for s, r in last.items():
        assert torch.equal(tier.state.step[s].cpu(), ref_sub.step[r])
        assert torch.equal(tier.state.doc_stamp[s].cpu(),
                           ref_sub.doc_stamp[r])


def test_admission_flush_insert_matches_plain(card):
    """The flush's insert (S <= 4 shard rows, 1128 rows each, LRU) writes
    the stacked shard state as the plain version does, bit for bit."""
    from repro_torch.core.shared import SharedTier

    states = []
    for dev in ("cuda", "cpu"):
        g = torch.Generator(device="cuda")
        g.manual_seed(5)
        tier = SharedTier(dim=DIM, n_shards=4, capacity=3000,
                          admission_sessions=1, device=dev)
        tier.tick()
        for i in range(6):
            psi = _unit(DIM, gen=g).cpu().numpy()
            tier.offer(("s", i), psi, 0.6,
                       _unit(1128, 800, gen=g).to(dev),
                       np.arange(1128) + 700 * i)
        dispatch.reset_counters()
        tier.flush_admissions()
        if dev == "cuda":
            assert dispatch.counters()["wave_insert_scatter"].launches >= 2
        states.append([x.cpu() for x in tier.state])
    for a, b, f in zip(*states, tc.CacheState._fields):
        assert torch.equal(a, b), f


def test_repeated_shard_query_keeps_the_last_rows_stamps(card):
    """A wave that queries one shard from three rows writes back that
    shard's LRU stamps and ``step`` from its last row, on the card as on
    the CPU."""
    from repro_torch.core.shared import SharedTier

    emb = _unit(40, DIM, gen=card)
    psi = _unit(DIM, gen=card).cpu().numpy()
    states = []
    for dev in ("cuda", "cpu"):
        tier = SharedTier(dim=DIM, n_shards=2, capacity=64,
                          admission_sessions=1, device=dev)
        shard = int(tier.route(psi[None])[0])
        tier.tick()
        assert tier.offer(("a", 1), psi, 0.5, emb.to(dev), np.arange(40))
        tier.flush_admissions()
        q = emb[[0, 39, 17, 5]].to(dev)
        out = tier.query_rows(q, np.array([shard, 1 - shard, shard, shard]),
                              3)
        states.append([x.cpu() for x in tier.state])
        # stamped once (step 1), at the last row's slots only
        want = np.zeros(40, np.int64)
        want[out[3][3].cpu().numpy()] = 1
        assert int(tier.state.step[shard]) == 2
        np.testing.assert_array_equal(
            tier.state.doc_stamp[shard, :40].cpu().numpy(), want)
    for a, b, f in zip(*states, tc.CacheState._fields):
        assert torch.equal(a, b), f


def test_cluster_build_is_deterministic_and_equals_cpu(card):
    """Two builds on the card are bit-identical, and equal the CPU build's
    assignments and tables (centroids within 1e-5)."""
    from repro_torch.core.cluster import build_cluster_index
    from repro_torch.core.metric_index import MetricIndex

    centres = _unit(16, DIM, gen=card)
    labels = torch.randint(0, 16, (200_003,), generator=card, device="cuda")
    docs = tc.pad_features(torch.nn.functional.normalize(
        centres[labels] + 0.02 * torch.randn(200_003, DIM, generator=card,
                                             device="cuda"), dim=1), 800)
    idx = MetricIndex(docs, transformed=True, dim=DIM, device="cuda")
    assert idx.doc_emb.data_ptr() == docs.data_ptr()      # no copy
    a = build_cluster_index(idx, 16, iters=4, max_width=64)
    b = build_cluster_index(idx, 16, iters=4, max_width=64)
    for f in ("centroids", "assign", "member_ids", "near_ids", "near_d"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    c = build_cluster_index(MetricIndex(docs.cpu(), transformed=True,
                                        dim=DIM, device="cpu"),
                            16, iters=4, max_width=64)
    assert a.n_iters == c.n_iters
    np.testing.assert_allclose(a.centroids, c.centroids, atol=1e-5)
    assert np.array_equal(a.assign, c.assign)
    np.testing.assert_allclose(a.near_d, c.near_d, atol=1e-5)


def test_tiered_engine_on_card_matches_cpu(card):
    """The tiered engine (SharedTier with a cluster index, prefetch) on
    the card answers wave for wave as the CPU path does, with the same
    counters."""
    from repro_torch.core.embedding import transform_documents
    from repro_torch.core.embedding import transform_queries
    from repro_torch.core.metric_index import MetricIndex
    from repro_torch.core.shared import SharedTier
    from repro_torch.data.conversations import WorldConfig, make_world
    from repro_torch.dist.retrieval import DeviceShard
    from repro_torch.serve.router import ShardedRouter
    from repro_torch.serve.session import BatchedEngine

    w = make_world(WorldConfig(n_topics=4, docs_per_topic=500,
                               n_background=1000, dim=64, turns=5,
                               n_conversations=3, seed=4))
    docs = transform_documents(torch.as_tensor(w.doc_emb,
                                               dtype=torch.float32))[0]
    qs = [transform_queries(torch.as_tensor(c.queries, dtype=torch.float32))
          for c in w.conversations * 2]        # two sessions a conversation
    ci = MetricIndex(docs, transformed=True, device="cuda").cluster(
        8, max_width=32)
    out = {}
    for dev in ("cuda", "cpu"):
        ids = np.arange(docs.shape[0], dtype=np.int32)
        with ShardedRouter([DeviceShard(docs, ids, device=dev)],
                           deadline_s=60) as router:
            tier = SharedTier(dim=docs.shape[1], n_shards=2, capacity=1024,
                              cluster=ci, device=dev)
            eng = BatchedEngine(router, docs, dim=docs.shape[1],
                                n_sessions=6, k=10, k_c=100, capacity=1200,
                                shared=tier, cluster=ci, prefetch_width=32,
                                validate_every=2, device=dev)
            # sessions 3-5 replay 0-2's conversations afterwards: L2 serves
            turns = [eng.answer_batch(list(g), [qs[s][t] for s in g])
                     for g in (range(3), range(3, 6)) for t in range(5)]
            out[dev] = (turns, (tier.n_promoted, tier.n_memo_served,
                                eng.prefetch_stats(), eng.tier_counts()))
    assert out["cuda"][1] == out["cpu"][1]
    assert out["cuda"][1][3]["l2"] + out["cuda"][1][3]["l2_reuse"] > 0
    for wa, wb in zip(out["cuda"][0], out["cpu"][0]):
        for a, b in zip(wa, wb):
            assert a.tier == b.tier
            assert_topk_agree(a.scores[None], a.ids[None], b.scores[None],
                              b.ids[None], TOL, "tiered engine turn")


def _lm_rows(rng, b, s, vocab, lengths):
    tok = rng.integers(0, vocab, (b, s)).astype(np.int32)
    tok[np.arange(s)[None, :] >= np.asarray(lengths)[:, None]] = -1
    return tok


@pytest.mark.parametrize("arch", ["star-encoder", "chatglm3-6b",
                                  "gemma2-9b", "mistral-large-123b"])
def test_transformer_smoke_on_card_matches_cpu(card, arch):
    """The smoke configs with the same parameters on the card and on the
    CPU: hidden states and logits within 1e-5 (f32 sums in other orders;
    TF32 off), psi within 1e-5."""
    from repro_torch.configs import registry
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import make_lm_query_encoder

    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    cfg = registry.get(arch).smoke_config()
    params = tf.init_params(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    m = tf.Transformer(cfg, params, device="cpu")
    tok = torch.as_tensor(_lm_rows(np.random.default_rng(1), 3, 32,
                                   cfg.vocab_size, [32, 20, 7]))
    want_h, want_l = m.hidden_states(tok), m(tok)
    m.to("cuda")
    assert_close(m.hidden_states(tok.cuda()), want_h, 1e-5, f"{arch} hidden")
    assert_close(m(tok.cuda()), want_l, 1e-5, f"{arch} logits")
    proj = torch.randn(cfg.d_model, 24, generator=torch.Generator()
                       .manual_seed(2)) * cfg.d_model ** -0.5
    want = make_lm_query_encoder(params, cfg, proj, device="cpu")(tok)
    got = make_lm_query_encoder(params, cfg, proj)(tok)
    assert got.is_cuda and got.shape == (3, 25)
    assert_close(got, want, 1e-5, f"{arch} psi")


def test_full_width_star_two_layers_on_card_matches_cpu(card):
    """STAR at full width (d 768, 12 heads, d_ff 3072, vocab 30,522) cut to
    two layers: hidden states within 1e-4 (sums over 768 and 3,072 terms
    in other orders), psi within 1e-5 (unit norm)."""
    import dataclasses

    from repro_torch.configs import star_encoder
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import make_lm_query_encoder

    cfg = dataclasses.replace(star_encoder.full_config(), n_layers=2)
    params = tf.init_params(cfg, generator=card)
    cpu = _tree_to(params, "cpu")
    tok = torch.as_tensor(_lm_rows(np.random.default_rng(3), 4, 64,
                                   cfg.vocab_size, [64, 40, 9, 1]))
    assert_close(tf.hidden_states(params, tok.cuda(), cfg),
                 tf.hidden_states(cpu, tok, cfg), 1e-4, "full-width hidden")
    proj = torch.randn(768, 768, generator=card, device="cuda") / 768 ** 0.5
    got = make_lm_query_encoder(params, cfg, proj)(tok)
    want = make_lm_query_encoder(cpu, cfg, proj.cpu(), device="cpu")(tok)
    assert_close(got, want, 1e-5, "full-width psi")
    norms = torch.linalg.vector_norm(got[:, :768], dim=1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def test_batched_engine_with_encoder_on_card_matches_cpu(card):
    """Token turns through the smoke STAR encoder into the wave engine: the
    card answers as the CPU path does, one encoder call a wave."""
    from repro_torch.configs import star_encoder
    from repro_torch.core.embedding import transform_documents
    from repro_torch.dist.retrieval import DeviceShard
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import make_lm_query_encoder
    from repro_torch.serve.router import ShardedRouter
    from repro_torch.serve.session import BatchedEngine

    cfg = star_encoder.smoke_config()
    rng = np.random.default_rng(5)
    params = tf.init_params(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(5))
    proj = torch.as_tensor(rng.standard_normal((32, 16)).astype(np.float32))
    cpu_enc = make_lm_query_encoder(params, cfg, proj, device="cpu")
    rows = _lm_rows(rng, 4000, 16, cfg.vocab_size, rng.integers(4, 17, 4000))
    docs = transform_documents(cpu_enc(rows)[:, :16])[0]
    prefix = rng.integers(0, cfg.vocab_size, (6, 2))
    waves = []
    for t in range(5):
        sfx = rng.integers(0, cfg.vocab_size, (6, 8))
        waves.append(np.concatenate([prefix, sfx], 1).astype(np.int32))
    waves.append(waves[1].copy())                 # a repeated turn: hits
    out = {}
    for dev in ("cuda", "cpu"):
        enc = make_lm_query_encoder(params, cfg, proj, device=dev)
        calls = []
        ids = np.arange(docs.shape[0], dtype=np.int32)
        with ShardedRouter([DeviceShard(docs, ids, device=dev)],
                           deadline_s=60) as router:
            eng = BatchedEngine(router, docs, dim=17, n_sessions=6, k=10,
                                k_c=60, capacity=600, device=dev,
                                encoder=lambda q: calls.append(1) or enc(q))
            out[dev] = [eng.answer_batch(range(6), list(w)) for w in waves]
        assert len(calls) == len(waves)
    assert all(t.tier == "l1" for t in out["cuda"][-1])
    for wa, wb in zip(out["cuda"], out["cpu"]):
        for a, b in zip(wa, wb):
            assert a.tier == b.tier
            assert_topk_agree(a.scores[None], a.ids[None], b.scores[None],
                              b.ids[None], TOL, "encoder engine turn")


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "llama4-scout-17b-16e"])
def test_moe_mla_smoke_on_card_matches_cpu(card, arch):
    """The MoE / MLA smoke configs with the same parameters on the card and
    on the CPU (f32, TF32 off): logits and aux loss of a padded prefill,
    MTP logits, three decode steps from its caches (the CPU's argmax fed
    to both) within 1e-5, and psi within 1e-5."""
    from repro_torch.configs import registry
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import make_lm_query_encoder

    cfg = registry.get(arch).smoke_config()
    params = tf.init_params(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    gpu = _tree_to(params, "cuda")
    tok = torch.as_tensor(_lm_rows(np.random.default_rng(4), 3, 32,
                                   cfg.vocab_size, [32, 20, 7]))
    want = tf.forward(params, tok, cfg, return_kv=True, kv_len=36)
    got = tf.forward(gpu, tok.cuda(), cfg, return_kv=True, kv_len=36)
    assert_close(got[0], want[0], 1e-5, f"{arch} logits")
    assert abs(float(got[1]) - float(want[1])) <= 1e-6
    if cfg.mtp:
        assert_close(tf.mtp_logits(gpu, tok.cuda(), got[2], cfg),
                     tf.mtp_logits(params, tok, want[2], cfg), 1e-5,
                     f"{arch} mtp")
    kv_c, kv_g = want[3], got[3]
    nxt = want[0][:, -1].argmax(-1)
    for t in range(3):
        lc, kv_c = tf.decode_step(params, nxt, kv_c, 33 + t, cfg)
        lg, kv_g = tf.decode_step(gpu, nxt.cuda(), kv_g, 33 + t, cfg)
        assert_close(lg, lc, 1e-5, f"{arch} decode step {t}")
        nxt = lc.argmax(-1)
    proj = torch.randn(cfg.d_model, 16, generator=torch.Generator()
                       .manual_seed(1)) * cfg.d_model ** -0.5
    assert_close(make_lm_query_encoder(gpu, cfg, proj.cuda())(tok.cuda()),
                 make_lm_query_encoder(params, cfg, proj, device="cpu")(tok),
                 1e-5, f"{arch} psi")


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "llama4-scout-17b-16e"])
def test_prefill_equals_decode_on_card(card, arch):
    """8 tokens prefilled against the same 8 fed through ``decode_step``
    one at a time (the capacity of 8 cannot bind), on the card, f32."""
    from repro_torch.configs import registry
    from repro_torch.models import transformer as tf

    cfg = registry.get(arch).smoke_config()
    params = tf.init_params(cfg, generator=card)
    tok = torch.randint(0, cfg.vocab_size, (1, 8), generator=card,
                        device="cuda")
    logits = tf.forward(params, tok, cfg)[0]
    caches = tf.init_kv_caches(cfg, 1, 8)
    for t in range(8):
        step, caches = tf.decode_step(params, tok[:, t], caches, t + 1, cfg)
        assert_close(step, logits[:, t], 1e-4, f"{arch} position {t}")


def test_moe_ffn_bf16_on_card_is_deterministic_and_near_f32(card):
    """bf16 MoE at deepseek's routing (256 experts of 7168 -> 2048, top-8,
    norm_topk, a shared expert; 512 tokens): two calls agree bit for bit
    (the combine sums choices in order, no atomics), and the RMS of its
    difference from the same routing computed in f32 is within 2e-2 of the
    output's RMS (bf16 rounding gives about 5e-3; an element several
    times the RMS may differ by 4e-2 of it)."""
    from repro_torch.models import moe

    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    cfg = moe.MoEConfig(n_experts=256, top_k=8, d_ff=2048, n_shared=1,
                        d_ff_shared=2048)
    p = moe.init_moe(cfg, 7168, torch.bfloat16, device="cuda", generator=card)
    x = torch.randn(512, 7168, generator=card, device="cuda").bfloat16()
    a, b = moe.moe_ffn(p, x, cfg), moe.moe_ffn(p, x, cfg)
    assert torch.equal(a.y, b.y) and torch.equal(a.aux_loss, b.aux_loss)
    r = moe.route(p, x, cfg)
    t = x.shape[0]
    want = moe._swiglu(x.float(), p["shared_wi"].float(),
                       p["shared_wo"].float())
    tok = torch.arange(t, device="cuda").repeat_interleave(cfg.top_k)
    for e in torch.unique(r.expert_ids[r.keep]).tolist():
        sel = (r.expert_ids == e) & r.keep
        out = moe._swiglu(x[tok[sel]].float(), p["wi"][e].float(),
                          p["wo"][e].float())
        want.index_add_(0, tok[sel], out * r.gates[sel, None])
    rms = float(want.pow(2).mean().sqrt())
    assert float((a.y.float() - want).pow(2).mean().sqrt()) <= 2e-2 * rms


@pytest.mark.parametrize("arch", ["sasrec", "bert4rec"])
def test_seqrec_smoke_on_card_matches_cpu(card, arch):
    """SASRec / BERT4Rec at their smoke configs, the same parameters on the
    card and on the CPU path, ``SessionStream`` rows (pads) and an all-pad
    row: encode, session repr and BCE within 1e-5, retrieval ids equal
    (one knn_score and one knn_select launch a search)."""
    from repro_torch.configs import registry
    from repro_torch.data.recsys import SessionStream

    cfg = registry.get(arch).smoke_config()
    m = rs.SeqRec(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    b = SessionStream(cfg.vocab, cfg.max_len, seed=1).batch(0, 33)
    b["items"][0] = -1
    args = (b["items"], b["pos"], b["neg"])
    want = (m.encode(b["items"]), m.session_repr(b["items"]),
            m.bce_loss(*args), m.retrieve(b["items"], 25, 180))
    m.to("cuda")
    dispatch.reset_counters()
    got = (m.encode(b["items"]), m.session_repr(b["items"]),
           m.bce_loss(*args), m.retrieve(b["items"], 25, 180))
    c = dispatch.counters()
    assert c["knn_score"].launches == c["knn_select"].launches == 1
    for g, w, what in zip(got[:3], want[:3], ("encode", "repr", "bce")):
        assert_close(g, w, TOL, f"{arch} {what}")
    assert_topk_agree(*got[3], *want[3], TOL, f"{arch} retrieve")
    assert int(got[3][1].max()) < 180


@pytest.mark.parametrize("b", [1, 512])
@pytest.mark.parametrize("k", [100, 1000])
@pytest.mark.parametrize("dp", [32, 64])
def test_candidate_index_matches_plain_at_retrieval_shapes(card, b, k, dp):
    """The item-table index at the served shapes: 1,048,576 rows at width
    32 (xDeepFM's padded) or 64, 1,000,000 of them valid, taken as is;
    the kernels' answer against the plain search on the card."""
    n = 1_048_576
    table = torch.randn(n, dp, generator=card, device="cuda") * dp ** -0.5
    index = rs.candidate_index(table, 1_000_000, device="cuda")
    assert index.doc_emb.data_ptr() == table.data_ptr()
    q = torch.randn(b, dp, generator=card, device="cuda")
    dispatch.reset_counters()
    got = index.search(q, k)
    assert dispatch.counters()["knn_score"].launches == 1
    rv, ri = knn_ref.search(table, index.doc_ids, q, k)
    assert_topk_agree(got.scores, got.ids, rv, ri, TOL,
                      f"candidates b={b} k={k} dp={dp}")
    assert int(got.ids.max()) < 1_000_000 and int(got.ids.min()) >= 0


def _egnn_inputs(readout):
    import dataclasses

    from repro_torch.configs import egnn as egnn_cfg
    from repro_torch.data import graph
    from repro_torch.models import egnn

    cfg = dataclasses.replace(egnn_cfg.smoke_config(), readout=readout)
    params = egnn.init_params(cfg, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    if readout == "graph":
        feat, coords, edges, gids, _ = graph.batched_molecules(
            0, 16, 30, 64, cfg.d_feat_in, cfg.n_classes)
        return cfg, params, (feat, coords, edges), dict(graph_ids=gids,
                                                        n_graphs=16)
    g = graph.random_graph(0, 3000, 40_000, cfg.d_feat_in)
    return cfg, params, (g.node_feat, g.coords, g.edge_index), {}


def _to_card(params):
    """A parameter tree moved to the card."""
    if isinstance(params, dict):
        return {k: _to_card(v) for k, v in params.items()}
    if isinstance(params, list):
        return [_to_card(v) for v in params]
    return params.to("cuda")


@pytest.mark.parametrize("readout", ["node", "graph"])
def test_egnn_on_card_matches_cpu(card, readout):
    from repro_torch.models import egnn

    cfg, params, args, kw = _egnn_inputs(readout)
    want = egnn.forward(params, *args, cfg, **kw)
    got = egnn.forward(_to_card(params), *args, cfg, **{
        k: (torch.as_tensor(v, device="cuda") if k == "graph_ids" else v)
        for k, v in kw.items()})
    for g, w, what in zip(got, want, ("logits", "coords")):
        assert g.is_cuda
        assert_close(g, w, 1e-4, f"egnn {readout} {what}")


def test_egnn_forward_is_bitwise_repeatable_on_card(card):
    """Edge chunks of 1,000 over a graph whose destinations hold about 13
    edges each, so chunks split destination runs: two forwards agree bit
    for bit (no float atomics), and within 1e-4 of one chunk."""
    from repro_torch.models import egnn

    cfg, params, args, _ = _egnn_inputs("node")
    on_card = _to_card(params)
    edges = torch.as_tensor(args[2], device="cuda")
    split = egnn.prepare(edges, 3000, edge_chunk=1000)
    assert len(split.edges.chunks) > 1
    a = egnn.forward(on_card, *args, cfg, plan=split)
    b = egnn.forward(on_card, *args, cfg, plan=split)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    one = egnn.forward(on_card, *args, cfg)
    for x, y in zip(a, one):
        assert_close(x, y, 1e-4, "egnn chunked against one chunk")


# ---------------------------------------------------------------- training
@pytest.mark.parametrize("arch", [
    "star-encoder", "deepseek-v3-671b", "llama4-scout-17b-16e", "dlrm-rm2",
    "xdeepfm", "sasrec", "bert4rec", "egnn"])
def test_smoke_train_step_on_card_matches_cpu(card, arch):
    """One step from the same parameters and batch on the card and on the
    CPU path, held by ``train.parity.assert_steps_agree``."""
    from repro_torch.train import parity

    parity.assert_steps_agree(parity.smoke_step(arch, "cpu"),
                              parity.smoke_step(arch, "cuda"), arch)


def test_embedding_bag_refuses_a_table_that_requires_grad(card):
    tables = torch.randn(3, 100, 8, generator=card, device="cuda",
                         requires_grad=True)
    idx = torch.randint(0, 100, (4, 3, 2), generator=card, device="cuda",
                        dtype=torch.int32)
    dispatch.reset_counters()
    with pytest.raises(RuntimeError, match="use_kernel=False"):
        rs.field_pool(tables, idx)
    assert dispatch.counters()["embedding_bag"].launches == 0
    with torch.no_grad():
        pooled = rs.field_pool(tables, idx)
    assert dispatch.counters()["embedding_bag"].launches == 1
    gathered = rs.field_pool(tables, idx, use_kernel=False)
    assert_close(gathered.detach(), pooled, 1e-5, "gather branch")
    gathered.sum().backward()
    assert tables.grad is not None and bool((tables.grad != 0).any())


def test_checkpoint_round_trip_on_the_card(card, tmp_path):
    from repro_torch.checkpoint import CheckpointManager, restore_tree
    from repro_torch.configs import star_encoder
    from repro_torch.models import transformer as tf
    from repro_torch.train import optimizer as topt
    from repro_torch.train import step as tstep
    from repro_torch.train import tree

    cfg = star_encoder.smoke_config()
    params = tf.init_params(cfg, device="cuda", generator=card)
    opt = topt.adamw(lr=1e-2, warmup=1)
    step = tstep.make_lm_train_step(cfg, opt)
    tok = torch.randint(0, cfg.vocab_size, (4, 16), generator=card,
                        device="cuda")
    batch = {"tokens": tok, "labels": tok.roll(-1, 1)}
    state, _ = step({"params": params, "opt": opt.init(params)}, batch)
    before = tree.map(lambda t: t.clone(), state)
    mgr = CheckpointManager(str(tmp_path), interval=1)
    mgr.maybe_save(1, state)
    state, _ = step(state, batch)                  # in place, during the save
    mgr.wait()
    out, at = mgr.restore_or(tree.map(torch.zeros_like, before))
    assert at == 1
    for a, b in zip(tree.leaves(out), tree.leaves(before)):
        assert a.is_cuda and torch.equal(a, b)
    on_cpu = restore_tree(before, str(tmp_path), device="cpu")
    assert all(a.device.type == "cpu" and torch.equal(a, b.cpu())
               for a, b in zip(tree.leaves(on_cpu), tree.leaves(before)))


# ------------------------------------------------ dist: a world of one rank

@pytest.fixture
def nccl_one(card, tmp_path):
    """A one-rank NCCL group on the card (a rendezvous file, no port),
    destroyed after the test; the (1,) and (1, 1) meshes over it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    yield (card, init_device_mesh("cuda", (1,), mesh_dim_names=("shard",)),
           init_device_mesh("cuda", (1, 1), mesh_dim_names=("data",
                                                            "model")))
    dist.destroy_process_group()


@pytest.mark.parametrize("b", [1, 64])
def test_sharded_nn_at_world_one_equals_the_local_search(nccl_one, b):
    """``MetricIndex(sharded=True)`` over a corpus on the card: no copy,
    the kNN kernels launched, ids and scores equal the single-device
    search bit for bit (the same kernels on the same slice)."""
    from repro_torch.core.metric_index import MetricIndex

    gen, flat, _mesh = nccl_one
    docs = tc.pad_features(_unit(300_000, DIM, gen=gen), 800)
    local = MetricIndex(docs, transformed=True, dim=DIM, device="cuda")
    shard = MetricIndex(docs, transformed=True, dim=DIM, device="cuda",
                        sharded=True, mesh=flat)
    assert shard.doc_emb.to_local().data_ptr() == docs.data_ptr()
    q = _unit(b, DIM, gen=gen)
    dispatch.reset_counters()
    got = shard.search(q, 1000)
    counts = dispatch.counters()
    assert counts["knn_score"].launches >= 1
    assert counts["knn_select"].launches >= 1
    want = local.search(q, 1000)
    assert torch.equal(got.ids, want.ids)
    assert torch.equal(got.scores, want.scores)


def test_batched_scorer_at_world_one_matches_candidate_index(nccl_one):
    from repro_torch.dist.retrieval import make_batched_scorer

    gen, _flat, mesh = nccl_one
    table = torch.randn(1 << 20, 64, generator=gen, device="cuda")
    q = torch.randn(1, 64, generator=gen, device="cuda")
    scorer = make_batched_scorer(mesh, k=1000, table_axes=("model",),
                                 batch_axes=("data",))
    dispatch.reset_counters()
    vals, ids = scorer(q, table, n_valid=1_000_000)
    assert dispatch.counters()["knn_score"].launches >= 1
    want = rs.candidate_index(table, n_valid=1_000_000,
                              device="cuda").search(q, 1000)
    assert_topk_agree(vals, ids, want.scores, want.ids, TOL, "scorer")
    assert int(ids.max()) < 1_000_000


def test_forward_under_rules_at_world_one_equals_plain(nccl_one):
    from repro_torch.configs import star_encoder
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.api import sharding_rules
    from repro_torch.models import transformer as tf

    gen, _flat, mesh = nccl_one
    cfg = star_encoder.smoke_config()
    params = tf.init_params(cfg, device="cuda", generator=gen)
    placed = shd.place_tree(params, mesh,
                            shd.param_specs(params, mesh, min_shard_size=1))
    tok = torch.randint(0, cfg.vocab_size, (4, 16), generator=gen,
                        device="cuda")
    with torch.no_grad():
        with sharding_rules(mesh, shd.lm_activation_rules(mesh, cfg)):
            got = tf.forward(placed, tok, cfg)[0].full_tensor()
        want = tf.forward(params, tok, cfg)[0]
    assert_close(got, want, 1e-6, "forward under rules")
