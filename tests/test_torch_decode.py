"""The port's decode path against the JAX package, on the CPU.

All five LM smoke configs: gemma2-9b (the local window and both softcaps),
chatglm3-6b (kv=2, interleaved half rotary), mistral-large-123b,
deepseek-v3-671b (the absorbed MLA against its latent cache) and
llama4-scout-17b-16e (GQA + MoE).  The JAX package's parameters carried
across by ``convert.transformer_params_from_numpy`` and its caches by
``convert.kv_caches_from_numpy``:

  * ``init_kv_caches``: the same shapes and dtypes, zeroed;
  * ``forward(return_kv=True, kv_len=)``: the same caches (the prompt's
    entries, zeros up to ``kv_len``);
  * three greedy ``decode_step``s after the prefill, the JAX package's
    argmax fed to both: logits and caches;

all within atol 2e-5 / rtol 1e-5 (f32 sums in other orders).  In the port
alone, a prefill of B x S <= 8 tokens (so the MoE capacity of 8 cannot
bind) equals the same tokens fed through ``decode_step`` one at a time,
within 1e-4: the decode path (absorbed MLA, ``decode_attention``) against
the prefill's (up-projected MLA, ``blockwise_attention``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import common as jcm
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.models import common as cm
from repro_torch.models import transformer as tf

jax.config.update("jax_platform_name", "cpu")

ATOL, RTOL = 2e-5, 1e-5
ARCHS = ["gemma2-9b", "chatglm3-6b", "mistral-large-123b",
         "deepseek-v3-671b", "llama4-scout-17b-16e"]


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(convert.to_numpy(got),
                               np.asarray(want).astype(np.float32),
                               atol=atol, rtol=rtol)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg = jregistry.get(request.param).smoke_config()
    cfg = registry.get(request.param).smoke_config()
    jp = jtf.init_params(jax.random.key(9), jcfg)
    return jcfg, cfg, jp, convert.transformer_params_from_numpy(jp,
                                                                device="cpu")


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)) \
        .astype(np.int32)


def _shapes(caches):
    return [tuple((tuple(c.shape), str(c.dtype).removeprefix("torch."))
                  for c in group) for group in caches]


def test_init_kv_caches_match_jax(model):
    jcfg, cfg, _jp, _tp = model
    want = jtf.init_kv_caches(jcfg, 3, 20)
    got = tf.init_kv_caches(cfg, 3, 20, device="cpu")
    assert _shapes(got) == [tuple((tuple(c.shape), jnp.dtype(c.dtype).name)
                                  for c in g) for g in want]
    assert all(not c.any() for g in got for c in g)
    assert len(got) == len(cfg.layer_groups())


def test_prefill_caches_match_jax(model):
    """Caches of a 32-token prefill (two q / kv blocks), padded to kv_len
    40; gemma2's window (8) is shorter than the prompt."""
    jcfg, cfg, jp, tp = model
    tok = _tokens(1, 2, 32, cfg.vocab_size)
    jl, _, _, jkv = jtf.forward(jp, jnp.asarray(tok), jcfg, remat="none",
                                return_kv=True, kv_len=40)
    logits, _, _, kv = tf.forward(tp, torch.as_tensor(tok), cfg,
                                  return_kv=True, kv_len=40)
    _close(logits, jl)
    assert _shapes(kv) == _shapes(convert.kv_caches_from_numpy(jkv, "cpu"))
    for group, jgroup in zip(kv, jkv):
        for c, jc in zip(group, jgroup):
            _close(c, jc)
            assert not c[:, :, 32:].any()
    # kv_len defaults to the prompt's length
    short = tf.forward(tp, torch.as_tensor(tok), cfg, return_kv=True)[3]
    assert all(c.shape[2] == 32 for g in short for c in g)


def test_greedy_decode_matches_jax(model):
    """Three greedy steps after a 16-token prefill, the JAX argmax fed to
    both packages."""
    jcfg, cfg, jp, tp = model
    tok = _tokens(2, 2, 16, cfg.vocab_size)
    jl, _, _, jkv = jtf.forward(jp, jnp.asarray(tok), jcfg, remat="none",
                                return_kv=True, kv_len=20)
    _, _, _, kv = tf.forward(tp, torch.as_tensor(tok), cfg, return_kv=True,
                             kv_len=20)
    nxt = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
    for t in range(3):
        jlog, jkv = jtf.decode_step(jp, jnp.asarray(nxt), jkv,
                                    jnp.asarray(17 + t), jcfg)
        log, kv = tf.decode_step(tp, torch.as_tensor(nxt), kv, 17 + t, cfg)
        assert log.shape == (2, cfg.vocab_size)
        _close(log, jlog)
        nxt = np.asarray(jlog).argmax(-1).astype(np.int32)
    for group, jgroup in zip(kv, jkv):
        for c, jc in zip(group, jgroup):
            _close(c, jc)


def test_decode_from_empty_caches_matches_jax(model):
    """``tests/test_arch_smoke.py``'s decode: three steps from zeroed
    caches, two rows."""
    jcfg, cfg, jp, tp = model
    jc = jtf.init_kv_caches(jcfg, 2, 24)
    c = tf.init_kv_caches(cfg, 2, 24, device="cpu")
    tok = np.asarray([1, 2], np.int32)
    for t in range(3):
        jlog, jc = jtf.decode_step(jp, jnp.asarray(tok), jc,
                                   jnp.asarray(t + 1), jcfg)
        log, c = tf.decode_step(tp, torch.as_tensor(tok), c, t + 1, cfg)
        _close(log, jlog)
        tok = np.asarray(jlog).argmax(-1).astype(np.int32)


@pytest.mark.parametrize("b,s", [(1, 8), (2, 4)])
def test_prefill_equals_token_by_token_decode(model, b, s):
    """B x S <= 8 tokens: every expert's queue holds at most 8 choices,
    so the capacity (at least 8) cannot bind and routing sees each token
    alone in both paths."""
    _jcfg, cfg, _jp, tp = model
    tok = torch.as_tensor(_tokens(3 + s, b, s, cfg.vocab_size))
    logits, _, _, kv = tf.forward(tp, tok, cfg, return_kv=True, kv_len=s)
    caches = tf.init_kv_caches(cfg, b, s, device="cpu")
    for t in range(s):
        step, caches = tf.decode_step(tp, tok[:, t], caches, t + 1, cfg)
        torch.testing.assert_close(step, logits[:, t], atol=1e-4, rtol=1e-4)
    for group, pre in zip(caches, kv):
        for c, p in zip(group, pre):
            torch.testing.assert_close(c, p, atol=1e-5, rtol=1e-5)


def test_decode_step_refuses_positions_outside_the_cache(model):
    _jcfg, cfg, _jp, tp = model
    caches = tf.init_kv_caches(cfg, 1, 4, device="cpu")
    for bad in (0, 5):
        with pytest.raises(ValueError, match="cur_len"):
            tf.decode_step(tp, torch.zeros(1, dtype=torch.int32), caches,
                           bad, cfg)
    with pytest.raises(ValueError, match="kv_len"):
        tf.forward(tp, torch.zeros(1, 6, dtype=torch.int32), cfg,
                   return_kv=True, kv_len=4)


@pytest.mark.parametrize("h,kv", [(8, 2), (4, 4), (6, 3)])
@pytest.mark.parametrize("window,cap", [(None, None), (5, 50.0), (0, None),
                                        (30, None)])
@pytest.mark.parametrize("cur", [1, 9, 24])
def test_decode_attention_matches_jax(h, kv, window, cap, cur):
    """Query head h reads KV head h // g; the window keeps positions >=
    cur_len - w (w <= 0 or None: all); entries at and past cur_len are
    masked whatever they hold."""
    rng = np.random.default_rng(h * 100 + kv * 10 + cur)
    b, smax, dh = 2, 24, 8
    q = rng.standard_normal((b, 1, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, smax, kv, dh)).astype(np.float32)
    v = rng.standard_normal((b, smax, kv, dh)).astype(np.float32)
    kw = dict(window=window, logit_cap=cap)
    want = jcm.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(cur), **kw)
    got = cm.decode_attention(torch.as_tensor(q), torch.as_tensor(k),
                              torch.as_tensor(v), cur, **kw)
    _close(got, want, atol=1e-6)


def test_kv_caches_carry_across_and_back():
    jcfg = jregistry.get("deepseek-v3-671b").smoke_config()
    jcfg = type(jcfg)(**{**jcfg.__dict__, "dtype": jnp.bfloat16})
    jc = jtf.init_kv_caches(jcfg, 2, 8)
    jc = [tuple(c.at[:, :, 3].set(1.5) for c in g) for g in jc]
    tc = convert.kv_caches_from_numpy(jc, device="cpu")
    assert tc[0][0].dtype == torch.bfloat16 and isinstance(tc[0], tuple)
    back = convert.kv_caches_to_numpy(tc)
    for g, jg in zip(back, jc):
        for c, j in zip(g, jg):
            assert c.dtype == np.float32
            np.testing.assert_array_equal(c, np.asarray(j).astype(np.float32))
