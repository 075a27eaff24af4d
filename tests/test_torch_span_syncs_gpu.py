"""Every blocking host<->device sync of the serving path lies inside a
``serve.sync.*`` span, on the card.

Marked ``gpu``: without a CUDA device every test skips.  Run on a machine
with a card::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_span_syncs_gpu.py

Under ``telemetry.strict_syncs()`` CUDA's sync debug mode is "error"
outside the sync spans, so a blocking copy, a mask index or a
``.item()`` anywhere else on these paths raises: on the caller's thread,
or on the router's pool, where the router counts a failed shard call.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import moonlight_16b_a3b, star_encoder
from repro_torch.core.embedding import transform_documents
from repro_torch.dist.retrieval import DeviceShard
from repro_torch.models.recsys import SeqRec, SeqRecConfig
from repro_torch.models.transformer import Transformer
from repro_torch.serve.engine import make_lm_query_encoder
from repro_torch.serve.router import ShardedRouter
from repro_torch.serve.session import BatchedEngine, SessionManager
from repro_torch.serve.telemetry import ENCODER_GRAPHS, SPANS, strict_syncs

pytestmark = pytest.mark.gpu

WAVE, SEQ, N_DOCS, WIDTH = 64, 64, 200_000, 800


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return gen


def _tokens(rng, vocab):
    rows = rng.integers(0, vocab, (WAVE, SEQ))
    for r, n in enumerate(rng.integers(8, SEQ + 1, WAVE)):
        rows[r, n:] = -1
    return rows


def _window_since(t0):
    return SPANS.window(int(t0) + 1, 2 ** 62)


def _waves_sync_only_in_sync_spans(gen, cfg, out_dim):
    """Waves of the encoder of ``cfg`` through ``BatchedEngine`` and
    ``SessionManager`` under ``strict_syncs``, every power-of-two wave
    warmed first (a dense trunk's encoder captures its graphs there):
    every sync in a sync span, 18 a wave with misses and 8 without.
    Returns the span log of the waves, the encoder, and
    ``ENCODER_GRAPHS``' counts over the waves."""
    rng = np.random.default_rng(0)
    model = Transformer(cfg, generator=gen)
    proj = torch.randn((cfg.d_model, out_dim), generator=gen,
                       device="cuda") * cfg.d_model ** -0.5
    encode = make_lm_query_encoder(model.params, cfg, proj)
    raw = torch.randn((N_DOCS, out_dim), generator=gen, device="cuda")
    corpus = torch.zeros((N_DOCS, WIDTH), device="cuda")
    corpus[:, :out_dim + 1] = transform_documents(raw)[0]
    del raw
    ids = torch.arange(N_DOCS, dtype=torch.int32, device="cuda")
    router = ShardedRouter([DeviceShard(corpus, ids, dtype="fp32")],
                           deadline_s=60, hedge_after_s=60, max_retries=0,
                           n_docs=N_DOCS)
    eng = BatchedEngine(router, corpus, dim=out_dim + 1,
                        n_sessions=2 * WAVE, k=10, k_c=1000, epsilon=0.04,
                        capacity=16_000, encoder=encode, dtype="fp32")
    slots = list(range(WAVE))
    b = 1
    while b <= WAVE:                                              # warm
        eng.answer_batch(slots[:b], list(_tokens(rng, cfg.vocab_size))[:b])
        b *= 2
    for s in slots:
        eng.start_session(s)
    torch.cuda.synchronize()
    t0 = SPANS._start.max()
    graphs0 = ENCODER_GRAPHS.summary()
    waves = [list(_tokens(rng, cfg.vocab_size)) for _ in range(4)]
    with router, SessionManager(eng, max_slots=WAVE) as mgr:
        with strict_syncs():
            t_open = time.perf_counter_ns()
            made = torch.cuda.memory_stats()["allocation.all.allocated"]
            for key in slots:
                mgr.open(key)
            assert torch.cuda.memory_stats()[
                "allocation.all.allocated"] == made
            opened = SPANS.window(t_open, time.perf_counter_ns())
            turns = eng.answer_batch(slots, waves[0])      # all misses
            turns += eng.answer_batch(slots, waves[0])     # all hits
            for w in waves[1:]:
                futs = [mgr.submit(key, q) for key, q in zip(slots, w)]
                turns += [f.result(timeout=120) for f in futs]
        torch.cuda.synchronize()
    graphs = {k: ENCODER_GRAPHS.summary()[k] - graphs0[k]
              for k in ("captures", "replays", "eager")}
    assert len(turns) == 5 * WAVE and not any(t.degraded for t in turns)
    assert all(t.hit for t in turns[WAVE:2 * WAVE])
    assert router.stats.failures == 0 and router.stats.rejected == 0
    sp = _window_since(t0)
    probe = sp.of("serve.probe_wave")
    assert probe.sum() >= 5
    per_wave = {int(w): 0 for w in sp.wave[probe]}
    for w in sp.wave[sp.of("serve.sync.")]:
        if int(w) in per_wave:
            per_wave[int(w)] += 1
    # probe 5; with misses the scan's 3 and the documents' 2, and the
    # fill's 8; without, the fill's 3
    assert sorted(set(per_wave.values())) == [8, 18], per_wave
    # the opens reset their slots in place: no sync, no allocation
    assert opened.of("serve.open").sum() == WAVE
    assert not opened.of("serve.sync.").any()
    assert not sp.of("serve.encoder_capture").any()
    return sp, encode, graphs


def test_a_sessions_wave_syncs_only_in_sync_spans(card):
    """STAR's layers replay their graphs in every wave; a shape first seen
    under ``strict_syncs`` captures with its one sync in a sync span."""
    cfg = dataclasses.replace(star_encoder.full_config(), n_layers=2)
    sp, encode, graphs = _waves_sync_only_in_sync_spans(card, cfg,
                                                         cfg.d_model)
    n = int(sp.of("serve.encode").sum())
    assert graphs == {"captures": 0, "replays": n, "eager": 0}, (graphs, n)
    tok = torch.as_tensor(_tokens(np.random.default_rng(5),
                                  cfg.vocab_size)[:3], device="cuda")
    t0 = SPANS._start.max()
    with strict_syncs():
        psi = encode(tok)
    torch.cuda.synchronize()
    cap = _window_since(t0)
    assert cap.of("serve.encoder_capture").sum() == 1
    assert cap.of("serve.sync.encoder_capture").sum() == 1
    assert cap.of("serve.sync.").sum() == 1
    assert psi.shape == (3, cfg.d_model + 1)


def test_a_dropless_moe_wave_syncs_only_in_sync_spans(card):
    """Moonlight's layers at their published widths (the dense one and two
    MoE layers of 64 experts, bf16): the dropless path's sort, grouped
    products and combine add no sync to a wave, and each MoE layer of
    each encoder call is one ``serve.moe`` span."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = dataclasses.replace(moonlight_16b_a3b.full_config(), n_layers=3)
    sp, _encode, graphs = _waves_sync_only_in_sync_spans(card, cfg, 768)
    assert sp.of("serve.moe").sum() == 2 * sp.of("serve.encode").sum() > 0
    n = int(sp.of("serve.encode").sum())
    assert graphs == {"captures": 0, "replays": 0, "eager": n}, (graphs, n)


def test_a_seqrec_request_syncs_only_in_sync_spans(card):
    rng = np.random.default_rng(1)
    cfg = SeqRecConfig(vocab=1 << 16, max_len=50, embed_dim=50, n_blocks=2,
                       n_heads=1, causal=True, d_ff_mult=4)
    rec = SeqRec(cfg, generator=card)
    items = rng.integers(0, cfg.vocab, (512, cfg.max_len))
    for r, n in enumerate(rng.integers(1, cfg.max_len + 1, 512)):
        items[r, n:] = -1
    want = rec.retrieve(items, 100)                       # warm, builds
    torch.cuda.synchronize()
    t0 = SPANS._start.max()
    with strict_syncs():
        got = rec.retrieve(items, 100)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    sp = _window_since(t0)
    assert sp.of("serve.encode").sum() == 1 and sp.of("serve.scan").sum() == 1
    assert sp.of("serve.sync.items").sum() == 1
    req = sp.wave[sp.of("serve.encode")][0]
    assert req >= 0 and sp.wave[sp.of("serve.scan")][0] == req
