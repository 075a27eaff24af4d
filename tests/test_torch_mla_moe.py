"""The port's MLA, MoE and MTP transformer against the JAX package, on the CPU.

deepseek-v3-671b (MLA, 1 dense + 3 MoE layers of 8 experts top-2, MTP)
and llama4-scout-17b-16e (GQA kv=2, 4 MoE layers of 4 experts top-1) at
smoke size: the JAX package's parameters carried across by
``convert.transformer_params_from_numpy``, the same numpy token rows
(right-padded with -1; pads are tokens to the router) through
``repro.models.transformer.forward(..., remat="none")`` and the port's
``forward`` / ``hidden_states`` / ``mtp_logits``.  Logits, hidden states
and MTP logits agree within atol 2e-5 / rtol 1e-5 (f32 sums in other
orders through four layers), the aux loss within 1e-6.  The full configs
are built on the meta device against ``jax.eval_shape``: the same tree,
shapes and dtypes, parameter count and active parameter count.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepseek_v3_671b as j_deepseek
from repro.configs import llama4_scout_17b_a16e as j_llama4
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import deepseek_v3_671b, llama4_scout_17b_a16e
from repro_torch.configs import registry
from repro_torch.models import common as cm
from repro_torch.models import transformer as tf

jax.config.update("jax_platform_name", "cpu")

ATOL, RTOL = 2e-5, 1e-5
ARCHS = {"deepseek-v3-671b": (j_deepseek, deepseek_v3_671b),
         "llama4-scout-17b-16e": (j_llama4, llama4_scout_17b_a16e)}


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want),
                               atol=atol, rtol=rtol)


@pytest.fixture(scope="module", params=list(ARCHS))
def model(request):
    jmod, tmod = ARCHS[request.param]
    jcfg, cfg = jmod.smoke_config(), tmod.smoke_config()
    jp = jtf.init_params(jax.random.key(5), jcfg)
    return jcfg, cfg, jp, convert.transformer_params_from_numpy(jp,
                                                                device="cpu")


def _tokens(seed, b, s, vocab, lengths):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (b, s)).astype(np.int32)
    tok[np.arange(s)[None, :] >= np.asarray(lengths)[:, None]] = -1
    return tok


@pytest.mark.parametrize("s,lengths", [(16, [16, 9, 1]), (48, [48, 30, 17])])
def test_forward_matches_jax(model, s, lengths):
    """One q / kv block (s = 16) and three of each, pads included."""
    jcfg, cfg, jp, tp = model
    tok = _tokens(s, 3, s, cfg.vocab_size, lengths)
    jl, jaux, jh, _ = jtf.forward(jp, jnp.asarray(tok), jcfg, remat="none")
    logits, aux, hidden, kv = tf.forward(tp, torch.as_tensor(tok), cfg)
    _close(hidden, jh)
    _close(logits, jl)
    assert kv is None and aux.dtype == torch.float32
    assert float(jaux) > 0 and abs(float(aux) - float(jaux)) <= 1e-6
    _close(tf.hidden_states(tp, torch.as_tensor(tok), cfg), jh)


@pytest.mark.parametrize("s", [16, 32])
def test_mtp_logits_match_jax(s):
    """MTP: hidden_t and the embedding of token t+1 through one dense MLA
    block and the shared head."""
    jcfg, cfg = j_deepseek.smoke_config(), deepseek_v3_671b.smoke_config()
    jp = jtf.init_params(jax.random.key(s), jcfg)
    tp = convert.transformer_params_from_numpy(jp, device="cpu")
    assert set(tp["mtp"]) == {"proj", "block", "norm_h", "norm_e"}
    assert tp["mtp"]["block"]["attn"]["wdq"].dim() == 2      # unstacked
    tok = _tokens(s + 1, 2, s, cfg.vocab_size, [s, s - 5])
    _, _, jh, _ = jtf.forward(jp, jnp.asarray(tok), jcfg, remat="none")
    _, _, h, _ = tf.forward(tp, torch.as_tensor(tok), cfg)
    nxt = np.roll(tok, -1, axis=1)
    want = jtf.mtp_logits(jp, jnp.asarray(nxt), jh, jcfg)
    got = tf.mtp_logits(tp, torch.as_tensor(nxt), h, cfg)
    assert got.shape == (2, s, cfg.vocab_size)
    _close(got, want)


def test_mla_rope_rotates_only_the_rope_dims():
    """Trap: MLA's head_dim is qk_nope + qk_rope (192 at full width), but
    RoPE rotates only the qk_rope dims, full rotary and not interleaved,
    whatever rotary_frac says; angles from head_dim give other numbers."""
    cfg = deepseek_v3_671b.smoke_config()
    m = cfg.mla
    assert cfg.head_dim == m.qk_nope_dim + m.qk_rope_dim
    pos = torch.arange(8)
    cos, sin = tf._rope(dataclasses.replace(cfg, rotary_frac=0.5,
                                            rope_interleaved=True), pos)
    want = cm.rope_angles(pos, m.qk_rope_dim, cfg.rope_theta)
    assert torch.equal(cos, want[0]) and torch.equal(sin, want[1])
    assert cos.shape[-1] == m.qk_rope_dim // 2
    wrong = cm.rope_angles(pos, cfg.head_dim, cfg.rope_theta)[0]
    assert not torch.allclose(wrong[..., :m.qk_rope_dim // 2], cos)
    full = deepseek_v3_671b.full_config()
    assert (full.head_dim, tf._rope(full, pos)[0].shape[-1]) == (192, 32)


def test_module_runs_moe_and_carries_the_tree_across():
    cfg = deepseek_v3_671b.smoke_config()
    m = tf.Transformer(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    tok = torch.as_tensor(_tokens(4, 2, 16, cfg.vocab_size, [16, 10]))
    assert torch.equal(m(tok), tf.forward(m.params, tok, cfg)[0])
    tree = convert.transformer_params_to_numpy(m.params)
    assert tree["group1_moe"]["ffn"]["router"].dtype == np.float32
    back = tf.Transformer(cfg, convert.transformer_params_from_numpy(
        tree, device="cpu"), device="cpu")
    assert torch.equal(back(tok), m(tok))
    assert tf.param_count(back.params) == tf.param_count(m.params)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("size", ["smoke_config", "full_config"])
def test_init_shapes_and_counts_equal_jax(arch, size):
    """Smoke size on the CPU, full size on the meta device (nothing is
    allocated): the JAX tree, shapes and dtypes, parameter count and
    active parameter count."""
    jmod, tmod = ARCHS[arch]
    jcfg, cfg = getattr(jmod, size)(), getattr(tmod, size)()
    want = jax.eval_shape(lambda: jtf.init_params(jax.random.key(0), jcfg))
    dev = "cpu" if size == "smoke_config" else "meta"
    got = tf.init_params(cfg, device=dev,
                         generator=torch.Generator().manual_seed(0)
                         if dev == "cpu" else None)
    assert _shapes(got) == _shapes(want)
    assert tf.param_count(got) == jtf.param_count(want)
    assert tf.active_param_count(cfg, got) == \
        jtf.active_param_count(jcfg, want)


def test_full_config_counts():
    """deepseek-v3: 671.7 B parameters with the MTP block (38.2 B active a
    token); llama4-scout: 107.8 B (17.2 B active).  Cut to 4 layers, the
    sizes the card holds: 31.60 GB and 21.76 GB of parameters."""
    for cfg, n, active, cut in (
            (deepseek_v3_671b.full_config(), 671_712_662_528,
             38_238_540_800, 31_598_596_096),
            (llama4_scout_17b_a16e.full_config(), 107_769_861_120,
             17_172_894_720, 21_755_514_880)):
        p = tf.init_params(cfg, device="meta")
        assert (tf.param_count(p), tf.active_param_count(cfg, p)) == \
            (n, active)
        p = tf.init_params(dataclasses.replace(cfg, n_layers=4),
                           device="meta")
        assert sum(x.numel() * x.element_size()
                   for x in tf._leaves(p)) == cut


@pytest.mark.parametrize("arch", list(ARCHS))
def test_config_twins_equal_jax(arch):
    jmod, tmod = ARCHS[arch]
    assert (tmod.ARCH_ID, tmod.FAMILY) == (jmod.ARCH_ID, jmod.FAMILY) \
        == (arch, "lm")
    assert registry.get(arch) is tmod
    for size in ("smoke_config", "full_config"):
        jc, tc_ = getattr(jmod, size)(), getattr(tmod, size)()
        a, b = dataclasses.asdict(jc), dataclasses.asdict(tc_)
        for f in ("attn_unroll", "layer_unroll"):
            a.pop(f)
        assert jnp.dtype(a.pop("dtype")).name == \
            str(b.pop("dtype")).removeprefix("torch.")
        ja, tb = a.pop("moe")._asdict(), b.pop("moe")._asdict()
        assert jnp.dtype(ja.pop("router_dtype")).name == \
            str(tb.pop("router_dtype")).removeprefix("torch.")
        # the port's DeepSeek-V3 router fields, left at the JAX softmax
        assert (tb.pop("scoring"), tb.pop("routed_scale")) == \
            ("softmax", 1.0)
        assert ja == tb
        assert a == b
        assert (tc_.head_dim, tc_.v_head_dim, tc_.layer_groups()) == \
            (jc.head_dim, jc.v_head_dim, jc.layer_groups())
        assert tc_.window_schedule() == tuple(
            int(w) for w in jc.window_schedule())
