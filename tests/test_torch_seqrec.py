"""SASRec and BERT4Rec of the port against the JAX package, on the CPU.

Both archs at their smoke configs: the JAX package's parameters
(``seqrec_init`` from a JAX key) carried into the port by
``convert.seqrec_params_from_numpy``, the same numpy sessions
(``SessionStream`` rows, which hold S/2..S items, plus an all-pad row and a
full one) fed to both.  Encode, session representation, candidate scores
and the BCE loss agree within 1e-5 (f32 sums in other orders); the pad
rule is the reference's (a pad's item embedding zeroed, its position
embedding kept, attended as a key).  Retrieval is the paper's index scan:
``candidate_index`` behind ``MetricIndex.search`` (the plain kNN here)
against ``jax.lax.top_k`` of the masked ``q @ table.T``, the body of the
JAX package's ``make_batched_scorer``; ids equal, none at or past
``n_valid``.  The same holds for the DLRM and xDeepFM user towers at
``retrieval_cand``'s semantics.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import recsys as jrs
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.core import layout
from repro_torch.data.recsys import CTRSpec, CTRStream, SessionStream
from repro_torch.models import recsys as rs

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-5
ARCHS = ["sasrec", "bert4rec"]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg = jregistry.get(request.param).smoke_config()
    cfg = registry.get(request.param).smoke_config()
    jp = jrs.seqrec_init(jax.random.key(4), jcfg)
    return jcfg, cfg, jp, convert.seqrec_params_from_numpy(jp, device="cpu")


def _sessions(cfg, b=9, step=0):
    """``SessionStream`` rows (most carry pads), row 0 all pads, row 1
    full; (items, pos, neg) int32."""
    batch = SessionStream(cfg.vocab, cfg.max_len, seed=7).batch(step, b)
    items, pos, neg = batch["items"], batch["pos"], batch["neg"]
    items[0], pos[0] = -1, -1
    items[1] = np.arange(cfg.max_len) % cfg.vocab
    pos[1] = (np.arange(cfg.max_len) + 1) % cfg.vocab
    assert (items[2:] < 0).any()
    return items, pos, neg


def test_configs_mirror_the_jax_package():
    for arch in ARCHS:
        jmod, mod = jregistry.get(arch), registry.get(arch)
        for fn in ("full_config", "smoke_config"):
            a = dataclasses.asdict(getattr(jmod, fn)())
            b = dataclasses.asdict(getattr(mod, fn)())
            assert a.pop("dtype") == jnp.float32
            assert b.pop("dtype") == torch.float32
            assert a == b
        assert mod.ARCH_ID == jmod.ARCH_ID and mod.FAMILY == jmod.FAMILY


def test_encode_and_session_repr_match_jax(model):
    jcfg, cfg, jp, tp = model
    items, _, _ = _sessions(cfg)
    got = rs.seqrec_encode(tp, torch.as_tensor(items), cfg)
    want = jrs.seqrec_encode(jp, jnp.asarray(items), jcfg)
    assert tuple(got.shape) == want.shape == (9, cfg.max_len, cfg.embed_dim)
    _close(got, want)
    # pad positions come out zero; the all-pad row reads position 0
    assert not got[torch.as_tensor(items) < 0].any()
    rep = rs.seqrec_session_repr(tp, torch.as_tensor(items), cfg)
    _close(rep, jrs.seqrec_session_repr(jp, jnp.asarray(items), jcfg))
    assert not rep[0].any()


def test_score_candidates_match_jax(model):
    jcfg, cfg, jp, tp = model
    items, _, _ = _sessions(cfg, step=1)
    rep = jrs.seqrec_session_repr(jp, jnp.asarray(items), jcfg)
    cand = np.array([3, 0, cfg.vocab - 1, 17, 17], np.int32)
    for ids in (None, cand):
        got = rs.seqrec_score_candidates(
            tp, torch.as_tensor(np.array(rep)),
            None if ids is None else torch.as_tensor(ids))
        want = jrs.seqrec_score_candidates(
            jp, rep, None if ids is None else jnp.asarray(ids))
        assert tuple(got.shape) == want.shape
        _close(got, want)


def test_bce_loss_matches_jax(model):
    jcfg, cfg, jp, tp = model
    items, pos, neg = _sessions(cfg, step=2)
    got = rs.seqrec_bce_loss(tp, *map(torch.as_tensor, (items, pos, neg)),
                             cfg)
    want = jrs.seqrec_bce_loss(jp, *map(jnp.asarray, (items, pos, neg)),
                               jcfg)
    assert got.shape == () and np.isfinite(float(got))
    _close(got, want)


def test_pads_keep_their_position_and_stay_attention_keys(model):
    """The reference's pad rule, copied: a pad's item embedding is zeroed
    (its item id does not matter) but its position embedding is not, and
    it is attended to.  So in BERT4Rec a pad's position embedding reaches
    position 0; in SASRec (causal) it reaches no earlier position."""
    jcfg, cfg, jp, tp = model
    items, _, _ = _sessions(cfg, step=3)
    row = int(np.argmax((items[2:] < 0).any(axis=1))) + 2
    last_pad = cfg.max_len - 1
    assert items[row, last_pad] < 0
    base = rs.seqrec_encode(tp, torch.as_tensor(items), cfg)
    other = dict(tp, pos_emb=tp["pos_emb"].clone())
    other["pos_emb"][last_pad] += 1.0
    moved = rs.seqrec_encode(other, torch.as_tensor(items), cfg)
    changed = not torch.equal(moved[row, 0], base[row, 0])
    assert changed == (not cfg.causal)
    # the same in the JAX package
    jother = dict(jp, pos_emb=jp["pos_emb"].at[last_pad].add(1.0))
    jmoved = jrs.seqrec_encode(jother, jnp.asarray(items), jcfg)
    _close(moved, jmoved)


def test_bidirectional_position_zero_sees_later_items(model):
    """As ``tests/test_arch_smoke.py`` checks for the JAX package: BERT4Rec
    position 0 changes with the item at position 5, SASRec's does not."""
    _jcfg, cfg, _jp, tp = model
    items, _, _ = _sessions(cfg, step=4)
    items2 = items.copy()
    items2[1:, 5] = (np.maximum(items2[1:, 5], 0) + 1) % cfg.vocab
    h = rs.seqrec_encode(tp, torch.as_tensor(items), cfg)
    h2 = rs.seqrec_encode(tp, torch.as_tensor(items2), cfg)
    same = torch.allclose(h[1:, 0], h2[1:, 0])
    assert same == cfg.causal
    assert torch.equal(h[1:, :5], h2[1:, :5]) == cfg.causal


def test_row_chunks_equal_the_whole_batch_bit_for_bit(model, monkeypatch):
    """A budget shrunk to chunks of 1, 4 and 8 rows: the same bits as
    the whole 13-row batch in one chunk."""
    _jcfg, cfg, _jp, tp = model
    items = torch.as_tensor(_sessions(cfg, b=13, step=5)[0])
    assert rs.encode_rows(cfg) >= 13
    whole = rs.seqrec_encode(tp, items, cfg)
    rep = rs.seqrec_session_repr(tp, items, cfg)
    row = rs.ENCODE_BUDGET // rs.encode_rows(cfg)     # bytes of one row
    for rows in (1, 4, 8):
        monkeypatch.setattr(rs, "ENCODE_BUDGET", rows * row)
        assert rs.encode_rows(cfg) == rows
        assert torch.equal(rs.seqrec_encode(tp, items, cfg), whole)
        assert torch.equal(rs.seqrec_session_repr(tp, items, cfg), rep)


def test_encode_rows_fit_the_budget():
    for arch, rows in (("sasrec", 65_536), ("bert4rec", 4_096)):
        cfg = registry.get(arch).full_config()
        assert rs.encode_rows(cfg) == rows
        s = cfg.max_len
        per_row = 4 * s * (cfg.n_heads * s + cfg.d_ff_mult * cfg.embed_dim)
        assert rows * per_row <= rs.ENCODE_BUDGET < 2 * rows * per_row


def _jax_scorer(q, table, n_valid, k):
    """The body of ``repro.dist.retrieval.make_batched_scorer``'s scorer."""
    scores = jnp.asarray(q) @ jnp.asarray(table).T
    col = jax.lax.broadcasted_iota(jnp.int32, scores.shape, 1)
    scores = jnp.where(col < n_valid, scores, -jnp.inf)
    return jax.lax.top_k(scores, k)


def _check_search(index, q, table, n_valid, k):
    got = index.search(torch.as_tensor(np.array(q)), k)
    want_s, want_i = _jax_scorer(q, table, n_valid, k)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want_i))
    _close(got.scores, want_s)
    assert int(got.ids.max()) < n_valid and int(got.ids.min()) >= 0


@pytest.mark.parametrize("n_valid", [None, 150])
def test_retrieve_matches_the_jax_scorer(model, n_valid):
    jcfg, cfg, jp, tp = model
    items, _, _ = _sessions(cfg, step=6)
    q = np.asarray(jrs.seqrec_session_repr(jp, jnp.asarray(items), jcfg))
    table = np.asarray(jp["item_emb"])
    index = rs.candidate_index(tp["item_emb"], n_valid, device="cpu")
    assert index.doc_emb.shape == (cfg.vocab, layout.phys_dim(cfg.embed_dim))
    _check_search(index, q, table, n_valid or cfg.vocab, 20)


def test_candidate_index_takes_an_aligned_table_as_is():
    rng = np.random.default_rng(0)
    table = torch.as_tensor(rng.standard_normal((300, 64)).astype(np.float32))
    index = rs.candidate_index(table, 250, device="cpu")
    assert index.doc_emb.data_ptr() == table.data_ptr()
    assert index.dtype == "fp32"
    assert index.doc_ids[:250].tolist() == list(range(250))
    assert (index.doc_ids[250:] == -1).all()
    # a narrower table is copied once, zero-padded; the module shares that
    # payload between its indexes
    m = rs.SeqRec(registry.get("sasrec").smoke_config(), device="cpu",
                  generator=torch.Generator().manual_seed(0))
    a, b = m.index(), m.index(150)
    assert a.doc_emb.data_ptr() == b.doc_emb.data_ptr()
    assert a.doc_emb.data_ptr() != m.item_emb.data_ptr()
    m.float()                       # a move or cast drops the indexes
    assert m.index() is not a


@pytest.mark.parametrize("arch", ["dlrm-rm2", "xdeepfm"])
def test_user_towers_at_retrieval_cand_match_the_jax_scorer(arch):
    jmod, mod = jregistry.get(arch), registry.get(arch)
    jcfg, cfg = jmod.smoke_config(), mod.smoke_config()
    init = {"dlrm-rm2": jrs.dlrm_init, "xdeepfm": jrs.xdeepfm_init}[arch]
    jp = init(jax.random.key(2), jcfg)
    tp = convert.recsys_params_from_numpy(jp, device="cpu")
    n_sparse = cfg.n_sparse
    b = CTRStream(CTRSpec(n_dense=13, n_sparse=n_sparse, vocab=cfg.vocab,
                          multi_hot=getattr(cfg, "multi_hot", 1),
                          seed=3)).batch(0, 4)
    if arch == "dlrm-rm2":
        u = jrs.dlrm_user_tower(jp, jnp.asarray(b["dense"]),
                                jnp.asarray(b["sparse"]), jcfg)
        mine = rs.dlrm_user_tower(tp, torch.as_tensor(b["dense"]),
                                  torch.as_tensor(b["sparse"]), cfg)
    else:
        u = jrs.xdeepfm_user_tower(jp, jnp.asarray(b["sparse"]), jcfg)
        mine = rs.xdeepfm_user_tower(tp, torch.as_tensor(b["sparse"]), cfg)
    _close(mine, u)
    n_valid = cfg.vocab - 37
    index = rs.candidate_index(tp["tables"][0], n_valid, device="cpu")
    _check_search(index, np.asarray(u), np.asarray(jp["tables"][0]),
                  n_valid, 50)


def test_module_on_cpu_matches_the_functions(model):
    _jcfg, cfg, _jp, _tp = model
    m = rs.SeqRec(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(1))
    std = float(m.item_emb.std())
    assert abs(std - cfg.embed_dim ** -0.5) < 0.05 * cfg.embed_dim ** -0.5
    items, pos, neg = _sessions(cfg, step=7)
    p, t = m.params, torch.as_tensor(items)
    assert torch.equal(m.encode(items), rs.seqrec_encode(p, t, cfg))
    assert torch.equal(m.session_repr(items),
                       rs.seqrec_session_repr(p, t, cfg))
    assert torch.equal(m.bce_loss(items, pos, neg), rs.seqrec_bce_loss(
        p, t, torch.as_tensor(pos), torch.as_tensor(neg), cfg))
    rep = m.session_repr(items)
    assert torch.equal(m.score_candidates(rep),
                       rs.seqrec_score_candidates(p, rep))
    assert all(not q.requires_grad for q in m.parameters())
    # retrieve: the session representation through the item table's index
    for n_valid in (None, 150):
        scores, ids = m.retrieve(items, 20, n_valid)
        want = rs.candidate_index(p["item_emb"], n_valid,
                                  device="cpu").search(rep, 20)
        assert torch.equal(ids, want.ids)
        assert torch.equal(scores, want.scores)
        assert m.index(n_valid) is m.index(n_valid)
    # the module's tree carries to numpy and back unchanged
    tree = convert.seqrec_params_to_numpy(m.params)
    back = convert.seqrec_params_from_numpy(tree, device="cpu")
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b.numpy()),
                 tree, back)


def test_params_round_trip_exactly(model):
    _jcfg, _cfg, jp, tp = model
    back = convert.seqrec_params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), b), jp, back)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_shapes_equal_jax_eval_shape(arch):
    """The full published widths, built on the meta device: nothing is
    allocated."""
    want = jax.eval_shape(lambda: jrs.seqrec_init(
        jax.random.key(0), jregistry.get(arch).full_config()))
    m = rs.SeqRec(registry.get(arch).full_config(), device="meta")
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)), m.params,
                       is_leaf=lambda x: isinstance(x, torch.Tensor))
    ref = jax.tree.map(lambda s: (tuple(s.shape), "torch." + str(s.dtype)),
                       want)
    assert got == ref
