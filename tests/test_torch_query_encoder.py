"""The port's query encoder, and both engines driven through it, against the
JAX package on the CPU.

``make_lm_query_encoder`` pools the final hidden states over the real
tokens (pads are -1), projects them to the retrieval space and applies the
Eq. 1 query transform.  The JAX package's parameters and ``proj`` reach
the port through ``convert``; psi agrees within 1e-5.

Then a small world of token conversations over a corpus spread as the
encoder's outputs are: each conversation is a topic prefix drawn from
``data.lm.TokenStream`` plus a per-turn suffix, and two turns repeat an
earlier turn verbatim (psi identical: a hit).  The
single-session ``ConversationalEngine`` (the encoder wrapped as
``lambda t: encode(t[None])[0]``) and the wave ``BatchedEngine`` (rows of a
wave right-padded with -1 to its longest) answer turn for turn as the JAX
engines do: the same hits, tiers and ids, scores within 1e-5, and the same
cache slots (doc ids per slot).
"""

import importlib
import pkgutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import chatglm3_6b as j_chatglm
from repro.configs import deepseek_v3_671b as j_deepseek
from repro.configs import gemma2_9b as j_gemma
from repro.configs import llama4_scout_17b_a16e as j_llama4
from repro.configs import mistral_large_123b as j_mistral
from repro.configs import star_encoder as j_star
from repro.core.embedding import transform_documents
from repro.data import lm as jlm
from repro.dist.retrieval import DeviceShard as JShard
from repro.models import transformer as jtf
from repro.serve.engine import ConversationalEngine as JConvEngine
from repro.serve.engine import make_lm_query_encoder as j_make_encoder
from repro.serve.router import ShardedRouter as JRouter
from repro.serve.session import BatchedEngine as JBatchedEngine
import repro_torch.configs
from repro_torch import convert
from repro_torch.configs import (chatglm3_6b, deepseek_v3_671b, gemma2_9b,
                                 llama4_scout_17b_a16e, mistral_large_123b,
                                 star_encoder)
from repro_torch.dist.retrieval import DeviceShard
from repro_torch.kernels import dispatch
from repro_torch.models import transformer as ttf
from repro_torch.models.transformer import TransformerConfig
from repro_torch.serve import (BatchedEngine, ConversationalEngine,
                               ServeTelemetry, SessionManager, ShardedRouter,
                               make_lm_query_encoder)
from repro_torch.serve.engine import graphable, pad_length
from repro_torch.serve.telemetry import ENCODER_GRAPHS, SPANS

jax.config.update("jax_platform_name", "cpu")

PSI_TOL = 1e-5
L = 16                       # retrieval width (psi is L + 1 wide)
K, KC, CAP = 8, 60, 400
N_CONV, N_TURNS, PREFIX = 4, 6, 2
REPEATS = {3: 0, 5: 2}       # turn -> the earlier turn it repeats


def _encoders(jmod, tmod, seed=11):
    jcfg, cfg = jmod.smoke_config(), tmod.smoke_config()
    jp = jtf.init_params(jax.random.key(seed), jcfg)
    proj = np.random.default_rng(seed).standard_normal(
        (cfg.d_model, L)).astype(np.float32) * cfg.d_model ** -0.5
    jenc = j_make_encoder(jp, jcfg, jnp.asarray(proj))
    tenc = make_lm_query_encoder(
        convert.transformer_params_from_numpy(jp, device="cpu"), cfg,
        convert.transformer_params_from_numpy(proj, device="cpu"),
        device="cpu")
    return jenc, tenc, cfg


@pytest.fixture(scope="module")
def star():
    return _encoders(j_star, star_encoder)


def _rows(seed, b, s, vocab, lengths):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (b, s)).astype(np.int32)
    tok[np.arange(s)[None, :] >= np.asarray(lengths)[:, None]] = -1
    return tok


@pytest.mark.parametrize("jmod,tmod", [(j_star, star_encoder),
                                       (j_chatglm, chatglm3_6b),
                                       (j_gemma, gemma2_9b),
                                       (j_mistral, mistral_large_123b),
                                       (j_deepseek, deepseek_v3_671b),
                                       (j_llama4, llama4_scout_17b_a16e)])
@pytest.mark.parametrize("s,lengths", [(16, [16, 12, 5, 1]),
                                       (32, [32, 17, 16, 3])])
def test_psi_matches_jax(jmod, tmod, s, lengths):
    jenc, tenc, cfg = _encoders(jmod, tmod)
    tok = _rows(s, 4, s, cfg.vocab_size, lengths)
    want = np.asarray(jenc(jnp.asarray(tok)))
    got = tenc(torch.as_tensor(tok))
    assert got.shape == (4, L + 1) and got.dtype == torch.float32
    assert not got.requires_grad and got.is_inference()
    np.testing.assert_allclose(got.numpy(), want, atol=PSI_TOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got.numpy()[:, :L], axis=1),
                               1.0, atol=1e-6)
    assert (got[:, L] == 0).all()
    # a numpy batch and a single row through the one-session wrapper
    one = lambda t: tenc(t[None])[0]  # noqa: E731
    np.testing.assert_array_equal(one(tok[1]).numpy(),
                                  tenc(tok[1:2]).numpy()[0])


def test_pads_are_pooled_out(star):
    """Right pads change no real position (causal attention) and are not
    pooled: a row padded to 32 encodes as the unpadded row does."""
    _jenc, tenc, cfg = star
    tok = _rows(2, 2, 32, cfg.vocab_size, [12, 16])
    np.testing.assert_allclose(tenc(tok).numpy(), tenc(tok[:, :16]).numpy(),
                               atol=1e-6, rtol=0)


def _conversations(vocab, seed=0):
    """N_CONV token conversations of N_TURNS turns: a PREFIX-token topic
    drawn from the token stream, then a suffix of 4-8 tokens per turn;
    REPEATS turns copy an earlier turn verbatim."""
    stream = jlm.TokenStream(jlm.LMBatchSpec(N_CONV, 16, vocab, seed=seed))
    rng = np.random.default_rng(seed)
    convs = []
    for c in range(N_CONV):
        prefix = np.asarray(stream.batch(0)["tokens"])[c, :PREFIX]
        turns = []
        for t in range(N_TURNS):
            if t in REPEATS:
                turns.append(turns[REPEATS[t]].copy())
                continue
            n = int(rng.integers(4, 9))
            suffix = np.asarray(stream.batch(1 + t)["tokens"])[c, :n]
            turns.append(np.concatenate([prefix, suffix]).astype(np.int32))
        convs.append(turns)
    return convs


def _pad(rows, width=None):
    width = width or max(len(r) for r in rows)
    out = np.full((len(rows), width), -1, np.int32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


def _spread_corpus(jenc, cfg):
    """3,000 documents spread as the encoder's outputs are (the JAX
    encoder over random token rows, norms jittered by 5%), so that a
    k_c = 60 radius is near the distance between turns: hits and misses."""
    rng = np.random.default_rng(9)
    rows = _rows(9, 3000, 16, cfg.vocab_size, rng.integers(4, 17, 3000))
    base = np.asarray(jenc(jnp.asarray(rows)))[:, :L] \
        * (1 + 0.05 * rng.random((3000, 1))).astype(np.float32)
    docs, _ = transform_documents(jnp.asarray(base))
    return np.array(docs)


@pytest.fixture(scope="module")
def corpus(star):
    jenc, _tenc, cfg = star
    return _spread_corpus(jenc, cfg)


@pytest.fixture(scope="module", params=["deepseek-v3-671b",
                                        "llama4-scout-17b-16e"])
def moe_backbone(request):
    """A MoE backbone's encoders (deepseek's MLA + MTP tree, llama4's GQA)
    and a corpus spread as its outputs are."""
    jmod, tmod = {"deepseek-v3-671b": (j_deepseek, deepseek_v3_671b),
                  "llama4-scout-17b-16e": (j_llama4, llama4_scout_17b_a16e)
                  }[request.param]
    jenc, tenc, cfg = _encoders(jmod, tmod, seed=13)
    return jenc, tenc, cfg, _spread_corpus(jenc, cfg)


def _routers(docs):
    ids = np.arange(docs.shape[0], dtype=np.int32)
    return (JRouter([JShard(docs, ids, backend="ref", dtype="fp32")],
                    deadline_s=30),
            ShardedRouter([DeviceShard(docs, ids, device="cpu",
                                       dtype="fp32")], deadline_s=30))


def _same_turn(a, b, what):
    assert (b.hit, b.tier, b.degraded) == (a.hit, a.tier, a.degraded), what
    np.testing.assert_array_equal(b.ids, np.asarray(a.ids), err_msg=what)
    np.testing.assert_allclose(b.scores, np.asarray(a.scores), atol=PSI_TOL,
                               rtol=0, err_msg=what)


def _same_slots(jcache, tcache, what):
    a = convert.cache_state_to_numpy(jcache.state, tcache.cfg)
    b = convert.cache_state_to_numpy(tcache.state, tcache.cfg)
    for f in ("doc_ids", "n_docs", "n_queries"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f),
                                      err_msg=f"{what}: {f}")


def _one_session_matches_jax(jenc, tenc, cfg, corpus):
    convs = _conversations(cfg.vocab_size)
    jr, tr = _routers(corpus)
    kw = dict(dim=L + 1, k=K, k_c=KC, epsilon=0.04, capacity=CAP,
              dtype="fp32")
    with jr, tr:
        je = JConvEngine(jr, corpus, encoder=lambda t: jenc(t[None])[0], **kw)
        te = ConversationalEngine(tr, corpus, device="cpu",
                                  encoder=lambda t: tenc(t[None])[0], **kw)
        hits = []
        for c, turns in enumerate(convs):
            je.start_session()
            te.start_session()
            for t, tok in enumerate(turns):
                dispatch.reset_counters()
                a, b = je.answer(tok), te.answer(tok)
                _same_turn(a, b, f"conversation {c} turn {t}")
                calls = dispatch.counters()
                miss = int(not b.hit)
                assert (calls["probe_rhat"].calls,
                        calls["wave_query_topk"].calls,
                        calls["knn_score"].calls,
                        calls["wave_insert_scatter"].calls) == \
                    (1, 1, miss, miss)
                hits.append(b.hit or t == 0)
                if t in REPEATS:
                    assert b.hit, f"conversation {c}: a repeated turn missed"
            _same_slots(je.cache, te.cache, f"conversation {c}")
        assert any(hits) and not all(hits)     # misses after the first turn


def test_conversational_engine_with_encoder_matches_jax(star, corpus):
    _one_session_matches_jax(*star, corpus)


def test_moe_backbone_engine_matches_jax(moe_backbone):
    """The one-session engine behind a MoE / MLA encoder answers turn by
    turn as the JAX engine does (pads never reach a B = 1 row)."""
    _one_session_matches_jax(*moe_backbone)


def test_batched_engine_with_encoder_matches_jax(star, corpus):
    jenc, tenc, cfg = star
    convs = _conversations(cfg.vocab_size, seed=1)
    calls = {"encoder": 0}

    def counted(tokens):
        calls["encoder"] += 1
        return tenc(tokens)

    jr, tr = _routers(corpus)
    kw = dict(dim=L + 1, n_sessions=N_CONV, k=K, k_c=KC, capacity=CAP,
              dtype="fp32")
    with jr, tr:
        jeng = JBatchedEngine(jr, corpus, backend="ref", encoder=jenc, **kw)
        teng = BatchedEngine(tr, corpus, device="cpu", encoder=counted, **kw)
        tiers = []
        for t in range(N_TURNS):
            wave = _pad([c[t] for c in convs])
            dispatch.reset_counters()
            jt = jeng.answer_batch(range(N_CONV), [jnp.asarray(r)
                                                   for r in wave])
            tt = teng.answer_batch(range(N_CONV), [torch.as_tensor(r)
                                                   for r in wave])
            for s, (a, b) in enumerate(zip(jt, tt)):
                _same_turn(a, b, f"turn {t} session {s}")
            c = dispatch.counters()
            ops = (c["cache_probe"].calls + c["knn_score"].calls
                   + c["wave_insert_query"].calls
                   + c["wave_query_topk"].calls)
            misses = sum(x.tier == "backend" for x in tt)
            assert ops == (3 if misses else 2)
            assert calls["encoder"] == t + 1
            tiers.append([x.tier for x in tt])
        _same_slots(jeng.cache, teng.cache, "batched cache")
        assert teng.hit_rate() == pytest.approx(jeng.hit_rate())
        assert all(x == "l1" for t in REPEATS for x in tiers[t])
        assert any("backend" in w for w in tiers[1:])


def test_session_manager_with_encoder(star, corpus):
    """Turns submitted through the front door, every row padded to one
    width (the scheduler forms the waves), answer as direct waves do."""
    _jenc, tenc, cfg = star
    convs = _conversations(cfg.vocab_size, seed=2)
    ids = np.arange(corpus.shape[0], dtype=np.int32)
    kw = dict(dim=L + 1, n_sessions=N_CONV, k=K, k_c=KC, capacity=CAP,
              encoder=tenc, device="cpu")
    with ShardedRouter([DeviceShard(corpus, ids, device="cpu")],
                       deadline_s=30) as tr:
        eng, ref = BatchedEngine(tr, corpus, **kw), BatchedEngine(tr, corpus,
                                                                  **kw)
        with SessionManager(eng) as mgr:
            for key in range(N_CONV):
                mgr.open(key)
            for t in range(N_TURNS):
                wave = _pad([c[t] for c in convs], width=16)
                futs = [mgr.submit(key, r) for key, r in enumerate(wave)]
                got = [f.result(timeout=60) for f in futs]
                want = ref.answer_batch(range(N_CONV), list(wave))
                for a, b in zip(got, want):
                    np.testing.assert_array_equal(a.ids, b.ids)
                    assert a.tier == b.tier
        assert eng.hit_rate() == ref.hit_rate()


# --------------------------------------------- the encoder's CUDA graphs
LM_CONFIGS = sorted(
    m.name for m in pkgutil.iter_modules(repro_torch.configs.__path__)
    if getattr(importlib.import_module(f"repro_torch.configs.{m.name}"),
               "FAMILY", None) == "lm")


def test_the_lm_configs_are_found():
    assert {"star_encoder", "moonlight_16b_a3b", "deepseek_v3_671b",
            "llama4_scout_17b_a16e"} <= set(LM_CONFIGS)


def test_graphs_for_dense_trunks_and_eager_for_moe():
    """The rule reads the layers: every config with MoE layers stays
    eager, every dense one is graphed on a card; STAR's are graphed."""
    for name in LM_CONFIGS:
        mod = importlib.import_module(f"repro_torch.configs.{name}")
        for cfg in (mod.full_config(), mod.smoke_config()):
            assert isinstance(cfg, TransformerConfig)
            moe = any(kind == "moe" for kind, _ in cfg.layer_groups())
            assert graphable(cfg) is not moe, (name, cfg.name)
            if name in ("moonlight_16b_a3b", "deepseek_v3_671b",
                        "llama4_scout_17b_a16e"):
                assert not graphable(cfg), name
            if name == "star_encoder":
                assert graphable(cfg)


@pytest.mark.parametrize("s, width", [(1, 1), (3, 4), (16, 16), (17, 32),
                                      (40, 64), (64, 64), (65, 128)])
def test_pad_length_widens_rows_to_a_power_of_two(s, width):
    tok = torch.arange(2 * s).reshape(2, s)
    got = pad_length(tok, (16, 32))
    assert got.shape == (2, width)
    assert torch.equal(got[:, :s], tok) and (got[:, s:] == -1).all()
    if width == s:
        assert got is tok


def test_pad_length_keeps_a_width_the_chunks_forbid():
    """A length past a chunk that is no power of two stays as it is: the
    attention takes S within a chunk or a multiple of it."""
    tok = torch.zeros((1, 40), dtype=torch.int64)
    assert pad_length(tok, (24, 24)) is tok
    assert pad_length(tok, (64, 128)).shape == (1, 64)


def test_a_padded_row_encodes_as_the_unpadded_one(star):
    """The graphed encoder pads each row to a power-of-two length: the
    eager forward of the padded rows gives the unpadded rows' psi, to
    rounding, since causal attention and the masked pool keep pads out."""
    _jenc, tenc, cfg = star
    tok = torch.as_tensor(_rows(8, 3, 48, cfg.vocab_size, [48, 33, 5]))
    padded = pad_length(tok, (cfg.q_chunk, cfg.kv_chunk))
    assert padded.shape == (3, 64)
    torch.testing.assert_close(tenc(padded), tenc(tok), rtol=0, atol=1e-6)


@pytest.mark.parametrize("tmod", [star_encoder, deepseek_v3_671b])
def test_the_cpu_encoder_never_captures(tmod):
    """On the CPU every call runs eagerly, a dense trunk's too: the counter
    counts the eager calls, and no capture span is recorded."""
    cfg = tmod.smoke_config()
    params = ttf.init_params(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(5))
    proj = torch.randn((cfg.d_model, L), generator=torch.Generator()
                       .manual_seed(6)) * cfg.d_model ** -0.5
    encode = make_lm_query_encoder(params, cfg, proj, device="cpu")
    before = ENCODER_GRAPHS.summary()
    t0 = SPANS._start.max()
    for b in (1, 3, 3):
        psi = encode(_rows(b, b, 16, cfg.vocab_size, [16] * b))
        assert psi.shape == (b, L + 1) and psi.device.type == "cpu"
    after = ENCODER_GRAPHS.summary()
    assert after["eager"] - before["eager"] == 3
    assert after["captures"] == before["captures"]
    assert after["replays"] == before["replays"]
    assert after["shapes"] == before["shapes"]
    sp = SPANS.window(int(t0) + 1, 2 ** 62)
    assert not sp.of("serve.encoder_capture").any()
    assert not sp.of("serve.sync.encoder_capture").any()


def test_serve_telemetry_summary_carries_the_encoder_graphs(star):
    _jenc, tenc, cfg = star
    tenc(_rows(7, 2, 16, cfg.vocab_size, [16, 4]))
    got = ServeTelemetry().summary()["encoder_graphs"]
    assert got == ENCODER_GRAPHS.summary()
    assert set(got) == {"captures", "replays", "eager", "shapes"}
    assert got["eager"] >= 1
