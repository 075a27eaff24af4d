"""The query encoder's CUDA graphs on the card: a dense trunk replays one
graph per input shape, bit for bit the eager forward, and a trunk with MoE
layers stays eager.

Marked ``gpu``: without a CUDA device every test skips.  Run on a machine
with a card::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_encoder_graph_gpu.py
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import moonlight_16b_a3b, star_encoder
from repro_torch.dist.retrieval import DeviceShard
from repro_torch.models.transformer import Transformer
from repro_torch.serve.engine import make_lm_query_encoder, pad_length
from repro_torch.serve.telemetry import ENCODER_GRAPHS, SPANS

pytestmark = pytest.mark.gpu

SEQ = 64


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return gen


@pytest.fixture
def star(card):
    """STAR at its full widths (12 layers, d 768) and its graphed
    encoder."""
    cfg = star_encoder.full_config()
    model = Transformer(cfg, generator=card)
    proj = torch.randn((cfg.d_model, cfg.d_model), generator=card,
                       device="cuda") * cfg.d_model ** -0.5
    return cfg, make_lm_query_encoder(model.params, cfg, proj)


def _tokens(rng, b, vocab):
    rows = rng.integers(0, vocab, (b, SEQ))
    for r, n in enumerate(rng.integers(1, SEQ + 1, b)):
        rows[r, n:] = -1
    return torch.as_tensor(rows, device="cuda")


def _eager(encode, tokens):
    """The encoder's body run op by op on the caller's stream."""
    with torch.inference_mode():
        return encode.body(tokens)


def test_replay_equals_the_eager_forward_bit_for_bit(star):
    cfg, encode = star
    rng = np.random.default_rng(1)
    before = ENCODER_GRAPHS.summary()
    for b in range(1, 65):
        tok = _tokens(rng, b, cfg.vocab_size)
        got = encode(tok)
        want = _eager(encode, tok)
        assert got.shape == (b, cfg.d_model + 1)
        assert torch.equal(got, want), (
            b, float((got - want).abs().max()))
        assert torch.equal(encode(tok), want)      # a replay of a held graph
    after = ENCODER_GRAPHS.summary()
    assert after["captures"] - before["captures"] == 64
    assert after["replays"] - before["replays"] == 128
    assert after["eager"] == before["eager"]
    assert {(b, SEQ) for b in range(1, 65)} <= set(after["shapes"])


def test_one_session_rows_take_a_graph_per_power_of_two(star):
    """One session's engine passes B = 1 rows of every length: padded to a
    power-of-two length, lengths 17..64 take two graphs, and each psi is
    the padded row's eager forward bit for bit and the unpadded row's to
    rounding."""
    cfg, encode = star
    chunks = (cfg.q_chunk, cfg.kv_chunk)
    rng = np.random.default_rng(5)
    before = ENCODER_GRAPHS.summary()["captures"]
    gaps = []
    for s in range(17, SEQ + 1):
        tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, s)),
                              device="cuda")
        got = encode(tok)
        assert torch.equal(got, _eager(encode, pad_length(tok, chunks)))
        gaps.append(float((got - _eager(encode, tok)).abs().max()))
    assert ENCODER_GRAPHS.summary()["captures"] - before == 2
    print(f"psi against the unpadded eager forward: largest gap "
          f"{max(gaps):.3g}")
    assert max(gaps) <= 1e-6, gaps


def test_a_returned_psi_survives_the_next_call(star):
    """Each call returns its own tensor: the next replay of the same graph
    writes the graph's output, not what an earlier call returned."""
    cfg, encode = star
    rng = np.random.default_rng(2)
    a, b = _tokens(rng, 8, cfg.vocab_size), _tokens(rng, 8, cfg.vocab_size)
    first = encode(a)
    kept = first.clone()
    second = encode(b)
    torch.cuda.synchronize()
    assert first.data_ptr() != second.data_ptr()
    assert torch.equal(first, kept) and not torch.equal(first, second)
    assert torch.equal(second, _eager(encode, b))


def test_a_capture_beside_running_scans_leaves_both_right(star):
    """A new shape is captured while another thread runs ``DeviceShard``
    scans on the same card: the scans answer as they did alone, and the
    new graph replays the eager psi."""
    cfg, encode = star
    gen = torch.Generator(device="cuda").manual_seed(3)
    docs = torch.nn.functional.normalize(
        torch.randn((200_000, 800), generator=gen, device="cuda"), dim=1)
    shard = DeviceShard(docs, torch.arange(200_000, dtype=torch.int32,
                                           device="cuda"), dtype="fp32")
    queries = torch.nn.functional.normalize(
        torch.randn((16, 800), generator=gen, device="cuda"), dim=1)
    queries = queries.cpu().numpy()
    want = shard(queries, 100)
    stop, seen, errors = threading.Event(), [], []

    def scan():
        try:
            while not stop.is_set():
                seen.append(shard(queries, 100))
        except Exception as e:          # noqa: BLE001 - reported below
            errors.append(e)

    rng = np.random.default_rng(3)
    toks = [_tokens(rng, b, cfg.vocab_size) for b in (3, 5, 6, 7)]
    worker = threading.Thread(target=scan)
    worker.start()
    try:
        while len(seen) < 2:
            assert worker.is_alive() and not errors, errors
            threading.Event().wait(0.01)
        before = ENCODER_GRAPHS.summary()["captures"]
        got = [encode(t) for t in toks]          # new shapes: captures
        assert ENCODER_GRAPHS.summary()["captures"] - before == len(toks)
        n = len(seen)
        while len(seen) < n + 2:
            assert worker.is_alive() and not errors, errors
            threading.Event().wait(0.01)
    finally:
        stop.set()
        worker.join(timeout=120)
    assert not worker.is_alive() and not errors, errors
    assert len(seen) >= 4
    for ans in seen:
        np.testing.assert_array_equal(ans.ids, want.ids)
        np.testing.assert_array_equal(ans.scores, want.scores)
    for t, psi in zip(toks, got):
        assert torch.equal(psi, _eager(encode, t))
        assert torch.equal(encode(t), psi)


def test_a_moe_trunk_stays_eager(card):
    """Moonlight's layers at their published widths, cut to its dense
    layer and two dropless MoE layers (bf16): no graph, a ``serve.moe``
    span for each MoE layer of each call."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = dataclasses.replace(moonlight_16b_a3b.full_config(), n_layers=3)
    model = Transformer(cfg, generator=card)
    proj = torch.randn((cfg.d_model, 16), generator=card, device="cuda") \
        * cfg.d_model ** -0.5
    encode = make_lm_query_encoder(model.params, cfg, proj)
    tok = _tokens(np.random.default_rng(4), 4, cfg.vocab_size)
    before = ENCODER_GRAPHS.summary()
    t0 = SPANS._start.max()
    psi = [encode(tok) for _ in range(3)]
    torch.cuda.synchronize()
    after = ENCODER_GRAPHS.summary()
    assert after["replays"] == before["replays"]
    assert after["captures"] == before["captures"]
    assert after["eager"] - before["eager"] == 3
    sp = SPANS.window(int(t0) + 1, 2 ** 62)
    assert sp.of("serve.moe").sum() == 3 * (cfg.n_layers - cfg.n_dense_layers)
    assert not sp.of("serve.encoder_capture").any()
    assert psi[0].shape == (4, 17) and torch.isfinite(psi[0]).all()
