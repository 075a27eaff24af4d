"""The port's dense transformer against the JAX package, on the CPU.

The four dense configs at smoke size (star-encoder, chatglm3-6b,
gemma2-9b, mistral-large-123b): the JAX package's parameters
(``init_params`` from a JAX key) are carried into the port by
``convert.transformer_params_from_numpy``, and the same numpy token rows,
right-padded with -1, go through ``repro.models.transformer.forward(...,
remat="none")`` and the port's ``forward`` / ``hidden_states``.  Logits
and hidden states agree within atol 2e-5, rtol 1e-5 (f32 sums in other
orders through a few layers).  One case per trap: the -1 pad reads the
last embedding row; GQA maps query head h to KV head h // g
(``jnp.repeat``, not a tile); chatglm's interleaved half rotary; gemma2's
window schedule, softcaps and post / zero-centred norms.  The full configs
are built on the meta device against ``jax.eval_shape``: the same tree,
shapes and dtypes, and the same parameter count.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import chatglm3_6b as j_chatglm
from repro.configs import gemma2_9b as j_gemma
from repro.configs import mistral_large_123b as j_mistral
from repro.configs import star_encoder as j_star
from repro.models import common as jcm
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import (chatglm3_6b, gemma2_9b, mistral_large_123b,
                                 registry, star_encoder)
from repro_torch.models import common as cm
from repro_torch.models import transformer as tf
from repro_torch.models.moe import MoEConfig

jax.config.update("jax_platform_name", "cpu")

ATOL, RTOL = 2e-5, 1e-5
ARCHS = {"star-encoder": (j_star, star_encoder),
         "chatglm3-6b": (j_chatglm, chatglm3_6b),
         "gemma2-9b": (j_gemma, gemma2_9b),
         "mistral-large-123b": (j_mistral, mistral_large_123b)}


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want),
                               atol=atol, rtol=rtol)


@pytest.fixture(scope="module", params=list(ARCHS))
def model(request):
    jmod, tmod = ARCHS[request.param]
    jcfg, cfg = jmod.smoke_config(), tmod.smoke_config()
    jp = jtf.init_params(jax.random.key(7), jcfg)
    return jcfg, cfg, jp, convert.transformer_params_from_numpy(jp,
                                                                device="cpu")


def _tokens(seed, b, s, vocab, lengths=None):
    """(b, s) int32 ids, row i right-padded with -1 after lengths[i]."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (b, s)).astype(np.int32)
    if lengths is not None:
        tok[np.arange(s)[None, :] >= np.asarray(lengths)[:, None]] = -1
    return tok


@pytest.mark.parametrize("s,lengths", [(16, [16, 9, 1]), (48, [48, 30, 17])])
def test_forward_matches_jax(model, s, lengths):
    """One q / kv block (s = 16) and three of each, pads included."""
    jcfg, cfg, jp, tp = model
    tok = _tokens(s, 3, s, cfg.vocab_size, lengths)
    jl, jaux, jh, jkv = jtf.forward(jp, jnp.asarray(tok), jcfg, remat="none")
    logits, aux, hidden, kv = tf.forward(tp, torch.as_tensor(tok), cfg)
    _close(hidden, jh)
    _close(logits, jl)
    assert float(aux) == float(jaux) == 0.0 and kv is None and jkv is None
    _close(tf.hidden_states(tp, torch.as_tensor(tok), cfg), jh)


def test_pad_reads_the_last_embedding_row(model):
    """Trap (a): tensor indexing wraps -1 to the last row, as JAX's gather
    does; ``F.embedding`` would raise.  Right pads leave every real
    position's hidden state as the unpadded row has it."""
    jcfg, cfg, jp, tp = model
    tok = _tokens(3, 2, 32, cfg.vocab_size, [16, 16])
    emb = tp["embed"][torch.as_tensor(tok)]
    assert torch.equal(emb[0, 20], tp["embed"][-1])
    _close(emb, jp["embed"][jnp.asarray(tok)], atol=0, rtol=0)
    with pytest.raises(IndexError):
        torch.nn.functional.embedding(torch.as_tensor(tok), tp["embed"])
    padded = tf.hidden_states(tp, torch.as_tensor(tok), cfg)
    alone = tf.hidden_states(tp, torch.as_tensor(tok[:, :16]), cfg)
    _close(padded[:, :16], alone)
    _close(padded, jtf.forward(jp, jnp.asarray(tok), jcfg, remat="none")[2])


@pytest.mark.parametrize("h,kv", [(8, 2), (4, 4), (6, 3)])
@pytest.mark.parametrize("window,cap", [(None, None), (8, 50.0), (0, None)])
def test_blockwise_attention_matches_jax(h, kv, window, cap):
    """Trap (b): query head h reads KV head h // g, as ``jnp.repeat``; a
    tiled mapping (``repeat``) gives other numbers.  Windows (0 means
    unlimited) and the logit softcap, over 3 x 3 blocks."""
    rng = np.random.default_rng(h * 10 + kv)
    b, s, dh = 2, 48, 8
    q = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, dh)).astype(np.float32)
    kw = dict(causal=True, window=window, q_chunk=16, kv_chunk=16,
              logit_cap=cap)
    want = jcm.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), **kw)
    got = cm.blockwise_attention(torch.as_tensor(q), torch.as_tensor(k),
                                 torch.as_tensor(v), **kw)
    _close(got, want)
    if kv < h:
        g = h // kv
        tiled = cm.blockwise_attention(
            torch.as_tensor(q), torch.as_tensor(np.tile(k, (1, 1, g, 1))),
            torch.as_tensor(np.tile(v, (1, 1, g, 1))), **kw)
        assert not np.allclose(tiled.numpy(), np.asarray(want), atol=1e-3)


def test_blockwise_attention_keeps_the_chunk_assertion():
    """Trap (f): a sequence longer than its chunk must be a multiple of
    it, as in JAX."""
    x = torch.zeros(1, 24, 2, 4)
    with pytest.raises(AssertionError):
        cm.blockwise_attention(x, x, x, q_chunk=16, kv_chunk=16)
    assert cm.blockwise_attention(x, x, x, q_chunk=128,
                                  kv_chunk=128).shape == x.shape


@pytest.mark.parametrize("window", [None, 0, 5])
def test_mask_block_matches_jax(window):
    qp, kp = np.arange(16, 32), np.arange(0, 32)
    want = jcm._mask_block(jnp.asarray(qp), jnp.asarray(kp), causal=True,
                           window=window)
    got = cm._mask_block(torch.as_tensor(qp), torch.as_tensor(kp),
                         causal=True, window=window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("frac,interleaved", [(1.0, False), (0.5, True),
                                              (0.5, False), (1.0, True)])
def test_rope_matches_jax(frac, interleaved):
    """Trap (c): the interleaved form stacks each rotated pair and folds it
    back, the half-split form concatenates; unrotated dims pass through."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12), (2, 12)).astype(np.int32)
    want = jcm.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4, frac,
                          interleaved)
    got = cm.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 1e4, frac,
                        interleaved)
    _close(got, want, atol=1e-6)
    if frac < 1.0:
        np.testing.assert_array_equal(got.numpy()[..., 8:], x[..., 8:])


@pytest.mark.parametrize("zero_centered", [False, True])
def test_rms_norm_and_softcap_match_jax(zero_centered):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32) * 3
    w = rng.standard_normal((32,)).astype(np.float32)
    _close(cm.rms_norm(torch.as_tensor(x), torch.as_tensor(w), 1e-6,
                       zero_centered),
           jcm.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6,
                        zero_centered), atol=1e-6)
    _close(cm.softcap(torch.as_tensor(x), 2.0),
           jcm.softcap(jnp.asarray(x), 2.0), atol=1e-6)
    t = torch.as_tensor(x)
    assert cm.softcap(t, None) is t


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_init_shapes_and_count_equal_jax(arch):
    """Smoke size on the CPU, full size on the meta device (nothing is
    allocated): the JAX tree, shapes and dtypes; scales near JAX's."""
    jmod, tmod = ARCHS[arch]
    for size in ("smoke_config", "full_config"):
        jcfg, cfg = getattr(jmod, size)(), getattr(tmod, size)()
        want = jax.eval_shape(lambda c=jcfg: jtf.init_params(
            jax.random.key(0), c))
        dev = "cpu" if size == "smoke_config" else "meta"
        got = tf.init_params(cfg, device=dev,
                             generator=torch.Generator().manual_seed(0)
                             if dev == "cpu" else None)
        assert _shapes(got) == _shapes(want)
        assert tf.param_count(got) == sum(
            int(np.prod(x.shape)) for x in jax.tree.leaves(want))
    p = tf.init_params(tmod.smoke_config(), device="cpu",
                       generator=torch.Generator().manual_seed(1))
    assert abs(float(p["embed"].std()) - 0.02) < 0.002


def test_star_encoder_counts():
    """136.7 M parameters at full width: 23.4 M in the tied embedding,
    113.3 M in the layers."""
    p = tf.init_params(star_encoder.full_config(), device="meta")
    layers = tf.param_count(p["group0_dense"])
    assert layers == 113_264_640
    assert tf.param_count(p) == layers + 30522 * 768 + 768


@pytest.mark.parametrize("arch", list(ARCHS))
def test_config_twins_equal_jax(arch):
    jmod, tmod = ARCHS[arch]
    assert (tmod.ARCH_ID, tmod.FAMILY) == (jmod.ARCH_ID, jmod.FAMILY) \
        == (arch, "lm")
    assert registry.get(arch) is tmod
    for size in ("smoke_config", "full_config"):
        a = dataclasses.asdict(getattr(jmod, size)())
        b = dataclasses.asdict(getattr(tmod, size)())
        for f in ("attn_unroll", "layer_unroll"):
            a.pop(f)
        assert jnp.dtype(a.pop("dtype")).name == \
            str(b.pop("dtype")).removeprefix("torch.")
        assert a == b
        jc, tc_ = getattr(jmod, size)(), getattr(tmod, size)()
        assert tc_.window_schedule() == tuple(
            int(w) for w in jc.window_schedule())
        assert (tc_.head_dim, tc_.v_head_dim, tc_.layer_groups()) == \
            (jc.head_dim, jc.v_head_dim, jc.layer_groups())


def test_mla_moe_and_decode_name_their_roadmap_item():
    """MLA, MoE, MTP and the decode path now run (items 13a and 13b); the
    archs still waiting (seqrec, egnn) name theirs."""
    cfg = star_encoder.smoke_config()
    mla = dataclasses.replace(cfg, attention="mla", mla=tf.MLAConfig(
        q_lora_rank=16, kv_lora_rank=8, qk_nope_dim=4, qk_rope_dim=4,
        v_head_dim=4))
    moe = dataclasses.replace(cfg, moe=MoEConfig(n_experts=4, top_k=2,
                                                 d_ff=16), n_dense_layers=1)
    assert moe.layer_groups() == [("dense", 1), ("moe", 1)]
    assert dataclasses.replace(cfg, attention="mla",
                               mla=tf.MLAConfig()).head_dim == 192
    assert tf.MLAConfig().v_head_dim == 128 and mla.v_head_dim == 4
    tok = torch.zeros(1, 4, dtype=torch.int32)
    for c in (cfg, mla, moe, dataclasses.replace(mla, moe=moe.moe,
                                                 n_dense_layers=1, mtp=True)):
        p = tf.init_params(c, device="cpu",
                           generator=torch.Generator().manual_seed(0))
        logits, aux, hidden, kv = tf.forward(p, tok, c, return_kv=True,
                                             kv_len=8)
        assert logits.shape == (1, 4, c.vocab_size)
        assert (float(aux) > 0) == (c.moe is not None)
        step, kv = tf.decode_step(p, tok[:, 0], kv, 5, c)
        assert step.shape == (1, c.vocab_size)
        assert torch.isfinite(step).all()
        assert len(tf.init_kv_caches(c, 1, 8, device="cpu")) == \
            len(c.layer_groups())
        if c.mtp:
            assert tf.mtp_logits(p, tok, hidden, c).shape == logits.shape
    for arch, item in (("sasrec", "13c"), ("bert4rec", "13c"),
                       ("egnn", "13d")):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            registry.get(arch)
    for arch in ("deepseek-v3-671b", "llama4-scout-17b-16e"):
        assert registry.get(arch).full_config().name == arch


def test_module_holds_frozen_params_and_matches_the_functions():
    cfg = gemma2_9b.smoke_config()
    m = tf.Transformer(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    assert all(not p.requires_grad for p in m.parameters())
    assert tf.param_count(m.params) == sum(p.numel() for p in m.parameters())
    tok = torch.as_tensor(_tokens(5, 2, 32, cfg.vocab_size, [32, 20]))
    assert torch.equal(m(tok), tf.forward(m.params, tok, cfg)[0])
    assert torch.equal(m.hidden_states(tok),
                       tf.hidden_states(m.params, tok, cfg))
    # the tree carries to numpy and back unchanged, and into a new module
    tree = convert.transformer_params_to_numpy(m.params)
    back = tf.Transformer(cfg, convert.transformer_params_from_numpy(
        tree, device="cpu"), device="cpu")
    assert torch.equal(back(tok), m(tok))


def test_bf16_leaves_carry_across():
    """A bf16 config's JAX tree (numpy bfloat16 leaves) arrives as
    torch.bfloat16, bit for bit, and goes back widened to f32."""
    jcfg = dataclasses.replace(j_mistral.smoke_config(), dtype=jnp.bfloat16)
    jp = jtf.init_params(jax.random.key(2), jcfg)
    tp = convert.transformer_params_from_numpy(jp, device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    assert tp["final_norm"].dtype == torch.float32
    back = convert.transformer_params_to_numpy(tp)
    np.testing.assert_array_equal(
        back["group0_dense"]["attn"]["wq"],
        np.asarray(jp["group0_dense"]["attn"]["wq"]).astype(np.float32))
    cfg = dataclasses.replace(mistral_large_123b.smoke_config(),
                              dtype=torch.bfloat16)
    tok = _tokens(6, 2, 16, cfg.vocab_size, [16, 11])
    got = tf.hidden_states(tp, torch.as_tensor(tok), cfg)
    want = jtf.forward(jp, jnp.asarray(tok), jcfg, remat="none")[2]
    assert got.dtype == torch.bfloat16
    # bf16 keeps 8 bits: the two frameworks round the layers' sums apart
    _close(got.float(), np.asarray(want).astype(np.float32), atol=0.1,
           rtol=0.05)
