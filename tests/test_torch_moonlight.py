"""Moonlight-16B-A3B as the query encoder, on the CPU: the port against
the plain reference (``chipbench/reference/mla_moe_encoder.py``).

At ``moonlight_16b_a3b.smoke_config()`` (f32, 1 dense + 2 MoE layers of
8 experts top-3, 2 shared): MLA with no query latent, DeepSeek-V3's
router (the choice by the biased sigmoid score, the unbiased gates
renormalised and scaled), the dropless dispatch (equal to ``moe_ffn``
where ``moe_ffn`` drops nothing; pads neither routed nor computed), and
the encoder's psi.  The full config is built on the meta device.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chipbench import inputs_mla_moe  # noqa: E402
from chipbench.reference import mla_moe_encoder as ref  # noqa: E402
from repro_torch.configs import deepseek_v3_671b  # noqa: E402
from repro_torch.configs import moonlight_16b_a3b  # noqa: E402
from repro_torch.configs import registry, star_encoder  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve.engine import make_lm_query_encoder  # noqa: E402
from repro_torch.serve.telemetry import EXPERT_LOAD, SPANS, \
    ServeTelemetry  # noqa: E402

# f32 sums taken in other orders (per-expert products against the
# reference's, blockwise attention against a full softmax) through three
# layers: psi's entries are O(0.1), their rounding O(1e-7)
ATOL = 2e-6
SEED = 12_345_678_901


def published(cfg) -> dict:
    """The published ``config.json`` keys of a config, and the benchmark's
    ``model`` group: what the reference and the weights maker read."""
    m, e = cfg.mla, cfg.moe
    return {
        "num_hidden_layers": cfg.n_layers, "hidden_size": cfg.d_model,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "intermediate_size": cfg.d_ff, "vocab_size": cfg.vocab_size,
        "q_lora_rank": m.q_lora_rank, "kv_lora_rank": m.kv_lora_rank,
        "qk_nope_head_dim": m.qk_nope_dim, "qk_rope_head_dim": m.qk_rope_dim,
        "v_head_dim": m.v_head_dim, "n_routed_experts": e.n_experts,
        "num_experts_per_tok": e.top_k, "moe_intermediate_size": e.d_ff,
        "n_shared_experts": e.n_shared, "norm_topk_prob": e.norm_topk,
        "routed_scaling_factor": e.routed_scale,
        "first_k_dense_replace": cfg.n_dense_layers,
        "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.norm_eps,
        "model": {"dtype": "float32", "out_dim": 32},
    }


@pytest.fixture(scope="module")
def smoke():
    cfg = moonlight_16b_a3b.smoke_config()
    enc = published(cfg)
    w = inputs_mla_moe.encoder_weights(enc, SEED, "cpu")
    return cfg, enc, w


def _rows(seed, b, s, vocab, lengths):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (b, s)).astype(np.int32)
    tok[np.arange(s)[None, :] >= np.asarray(lengths)[:, None]] = -1
    return torch.as_tensor(tok)


def test_full_config_counts_and_stays_out_of_the_registry():
    """15.62 B parameters without the LM head (31.25 GB in bf16), 2.24 B
    active a token without the embedding; a MoE layer's MLA 13.76 M; not a
    twin of the JAX package's registry."""
    cfg = moonlight_16b_a3b.full_config()
    p = tf.init_params(cfg, device="meta")
    head = cfg.d_model * cfg.vocab_size
    assert tf.param_count(p) - head == 15_624_565_888
    assert tf.active_param_count(cfg, p) - head - cfg.vocab_size \
        * cfg.d_model == 2_243_687_552
    attn = p["group1_moe"]["attn"]
    assert set(attn) == {"wq", "wdkv", "kv_norm", "wkr", "wuk", "wuv", "wo"}
    assert sum(t[0].numel() for t in attn.values()) == 13_763_072
    assert p["group1_moe"]["ffn"]["score_bias"].shape == (26, 64)
    assert moonlight_16b_a3b.ARCH_ID not in registry.PORTED


def test_weights_maker_gives_the_program_tree(smoke):
    """The benchmark's seeded weights have the tree, shapes and dtypes of
    ``init_params`` (without the LM head)."""
    cfg, _enc, w = smoke
    want = tf.init_params(cfg, device="meta")
    want.pop("lm_head")

    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict) else
                (tuple(v.shape), v.dtype) for k, v in t.items()}
    assert shapes(w["params"]) == shapes(want)


def test_mla_without_a_query_latent_matches_the_reference(smoke):
    cfg, enc, w = smoke
    a = tf._layer(w["params"]["group1_moe"], 0)["attn"]
    x = torch.randn(3, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    got, _kv = tf._attn_mla(a, x, tf._rope(cfg, torch.arange(16)), 0, cfg,
                            {})
    want = ref.attention(a, x, enc, "f32")
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def _router_case(bias_flips: bool):
    """Scores of 4 tokens over 8 experts and a bias that does (or does
    not) change token 0's choice."""
    cfg = moonlight_16b_a3b.smoke_config().moe
    d = 16
    g = torch.Generator().manual_seed(3)
    p = {"router": torch.randn(d, cfg.n_experts, generator=g),
         "score_bias": torch.zeros(cfg.n_experts)}
    x = torch.randn(4, d, generator=g)
    s = torch.sigmoid(x @ p["router"])
    if bias_flips:
        # lift token 0's least expert above its k-th
        order = torch.argsort(s[0], descending=True)
        p["score_bias"][order[-1]] = float(s[0, order[0]] - s[0, order[-1]]
                                           + 0.1)
    return cfg, p, x, s


@pytest.mark.parametrize("bias_flips", [False, True])
def test_v3_router_follows_its_formula(bias_flips):
    """Choice by score + bias, gates the unbiased scores of the chosen,
    over their sum, times routed_scale."""
    cfg, p, x, s = _router_case(bias_flips)
    scores, gates, ids = moe._router(p, x, cfg)
    torch.testing.assert_close(scores, s)
    want_ids = torch.argsort(s + p["score_bias"], dim=-1, descending=True,
                             stable=True)[:, :cfg.top_k]
    assert torch.equal(ids, want_ids)
    chosen = s.gather(1, want_ids)
    torch.testing.assert_close(
        gates, chosen / chosen.sum(-1, keepdim=True) * cfg.routed_scale)
    plain = torch.argsort(s, dim=-1, descending=True)[:, :cfg.top_k]
    assert torch.equal(ids[0], plain[0]) != bias_flips
    # the reference's router gives each token the same gate of each expert
    enc = {"num_experts_per_tok": cfg.top_k, "norm_topk_prob": True,
           "routed_scaling_factor": cfg.routed_scale}
    rg, rids = ref.route(p, x, enc)

    def dense(g_, i_):
        return torch.zeros_like(s).scatter(1, i_, g_)
    torch.testing.assert_close(dense(rg, rids), dense(gates, ids))


@pytest.mark.parametrize("scoring", ["softmax", "sigmoid"])
def test_dropless_equals_moe_ffn_when_nothing_is_dropped(scoring):
    """``moe_ffn`` with room for every choice, against the dropless form
    with every row real: the same routing and products, combined in the
    same order."""
    cfg = moonlight_16b_a3b.smoke_config().moe._replace(scoring=scoring)
    d, t = 32, 40
    g = torch.Generator().manual_seed(7)
    p = moe.init_moe(cfg, d, torch.float32, generator=g)
    if scoring == "sigmoid":
        p["score_bias"].normal_(generator=g).mul_(0.05)
    x = torch.randn(t, d, generator=g)
    want = moe.moe_ffn(p, x, cfg._replace(capacity_factor=1.25),
                       capacity=t * cfg.top_k)
    got = moe.moe_ffn_dropless(p, x, cfg)
    torch.testing.assert_close(got.y, want.y, atol=1e-6, rtol=1e-6)


def test_dropless_pads_are_neither_routed_nor_computed(monkeypatch):
    """A pad row's routed part is zero and the experts never see it: the
    products run over the real rows' choices alone."""
    cfg = moonlight_16b_a3b.smoke_config().moe
    d, t = 32, 24
    g = torch.Generator().manual_seed(9)
    p = moe.init_moe(cfg, d, torch.float32, generator=g)
    x = torch.randn(t, d, generator=g)
    real = torch.arange(t) % 3 != 2
    seen = []
    products = moe.expert_products

    def spy(rows, wi, wo, ends=None):
        if ends is not None:
            seen.append(int(ends[-1]))
        return products(rows, wi, wo, ends)

    monkeypatch.setattr(moe, "expert_products", spy)
    got = moe.moe_ffn_dropless(p, x, cfg, real)
    assert seen == [int(real.sum()) * cfg.top_k]
    shared = moe._swiglu(x, p["shared_wi"], p["shared_wo"])
    torch.testing.assert_close(got.y[~real], shared[~real])
    alone = moe.moe_ffn_dropless(p, x[real], cfg)
    torch.testing.assert_close(got.y[real], alone.y, atol=1e-6, rtol=0)


def test_encoder_matches_the_reference(smoke):
    """psi of right-padded rows through ``make_lm_query_encoder`` (the
    serving path) against the plain reference in f32."""
    cfg, enc, w = smoke
    tok = _rows(11, 4, 32, cfg.vocab_size, [32, 20, 9, 1])
    encode = make_lm_query_encoder(w["params"], cfg, w["proj"], device="cpu")
    got = encode(tok)
    with torch.no_grad():
        want = ref.encode(w, tok, enc, "f32")
    assert got.shape == (4, 33) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_a_rows_psi_does_not_depend_on_its_wave(smoke):
    """The same row alone, among other rows, and padded wider: psi equal
    up to f32 rounding (the capacity path would drop its choices behind
    its wave-mates' and route its pads)."""
    cfg, _enc, w = smoke
    encode = make_lm_query_encoder(w["params"], cfg, w["proj"], device="cpu")
    tok = _rows(13, 8, 32, cfg.vocab_size, [30, 5, 32, 12, 17, 1, 32, 8])
    row = tok[3:4]
    alone = encode(row)
    wide = torch.full((1, 64), -1, dtype=tok.dtype)
    wide[:, :32] = row
    torch.testing.assert_close(encode(tok)[3:4], alone, atol=1e-6, rtol=0)
    torch.testing.assert_close(encode(wide), alone, atol=1e-6, rtol=0)


def test_only_the_dropless_path_gets_the_real_token_mask(monkeypatch):
    """``_trunk`` builds the mask for a dropless MoE config alone: the
    dense STAR encoder and the capacity path of deepseek-v3 get none."""
    got = {}
    block = tf._block

    def spy(*a, real=None, layer=None, **kw):
        got.setdefault(kw["cfg"].name, set()).add(real is None)
        return block(*a, real=real, layer=layer, **kw)

    monkeypatch.setattr(tf, "_block", spy)
    for cfg in (star_encoder.smoke_config(), deepseek_v3_671b.smoke_config(),
                moonlight_16b_a3b.smoke_config()):
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
        p = tf.init_params(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(0))
        tf.hidden_states(p, _rows(1, 2, 16, cfg.vocab_size, [16, 7]), cfg)
    assert got == {star_encoder.smoke_config().name: {True},
                   deepseek_v3_671b.smoke_config().name: {True},
                   moonlight_16b_a3b.smoke_config().name: {False}}


def test_moe_spans_and_the_expert_load_counter(smoke):
    """One ``serve.moe`` span a MoE layer a forward; the counter adds each
    MoE layer's routed real tokens per expert (k a real token) and the pad
    rows it skipped, on the tensors' device, and ``summary()`` reads it."""
    cfg, _enc, w = smoke
    encode = make_lm_query_encoder(w["params"], cfg, w["proj"], device="cpu")
    tok = _rows(17, 3, 16, cfg.vocab_size, [16, 9, 4])
    n_moe = cfg.n_layers - cfg.n_dense_layers
    before = EXPERT_LOAD.snapshot()
    t0 = SPANS._start.max()
    encode(tok)
    sp = SPANS.window(int(t0) + 1, 2 ** 62)
    assert sp.of("serve.moe").sum() == n_moe
    got = EXPERT_LOAD.read(before)
    k = cfg.moe.top_k
    moe_layers = range(cfg.n_dense_layers, cfg.n_layers)
    assert [int(got["routed"][i].sum()) for i in moe_layers] == \
        [29 * k] * n_moe
    assert [int(got["pad_rows"][i]) for i in moe_layers] == [19] * n_moe
    assert not got["routed"][:cfg.n_dense_layers].any()
    summary = ServeTelemetry().summary()["expert_load"]
    assert set(summary) == set(moe_layers)
    assert all(v["max_over_mean"] >= 1.0 for v in summary.values())


def test_the_reference_control_moves_psi_more_than_bf16(smoke):
    """fp8 products (the control) move psi further from the f32 reference
    than bf16 products do, on the same rows."""
    cfg, enc, w = smoke
    tok = _rows(19, 4, 32, cfg.vocab_size, [32, 20, 9, 14])
    with torch.no_grad():
        exact = ref.encode(w, tok, enc, "f32")
        gap = {p: float(torch.linalg.vector_norm(
            ref.encode(w, tok, enc, p) - exact, dim=-1).max())
            for p in ("bf16", "fp8")}
    assert 0 < gap["bf16"] < gap["fp8"]


def test_rope_of_the_reference_is_the_programs():
    """The reference's rotary layout is the program's (halves of the rope
    dims), at Moonlight's theta."""
    x = torch.randn(2, 8, 3, 64, generator=torch.Generator().manual_seed(2))
    got = cm.rotate(x, *cm.rope_angles(torch.arange(8), 64, 50000.0))
    torch.testing.assert_close(got, ref.rope(x, 50000.0), atol=1e-6, rtol=0)
