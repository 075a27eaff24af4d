"""The port's MoE FFN against the JAX package's ``moe_ffn``, on the CPU.

Two shapes, as the smoke configs route: deepseek-like (8 experts, top-2,
``norm_topk``, one shared expert) and llama4-like (4 experts, top-1, no
``norm_topk``, one shared expert), d_model 64.  The JAX package's
parameters (``init_moe`` from a JAX key) are carried into the port by
``convert.transformer_params_from_numpy``, and the same numpy rows go
through both.  Routing is compared with the JAX package's own steps
(``repro/models/moe.py:71-95``, replayed below with its ``jnp`` calls):
expert ids, queue positions and the kept mask are equal, on inputs
without near-ties in the router's probabilities (a precondition each test
asserts); gates agree within f32 rounding (the router's product sums in
another order).  f32 outputs agree within atol 2e-5 / rtol 1e-5, the aux
loss within 1e-6; bf16 outputs within 3e-2 (8 bits of mantissa through
two products and the combine).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.dist.api import MeshShape
from repro_torch.models import moe

jax.config.update("jax_platform_name", "cpu")

ATOL, RTOL = 2e-5, 1e-5
D = 64
SHAPES = {
    "deepseek": dict(n_experts=8, top_k=2, d_ff=32, n_shared=1,
                     d_ff_shared=32),
    "llama4": dict(n_experts=4, top_k=1, d_ff=96, n_shared=1,
                   d_ff_shared=96, norm_topk=False),
}


def _cfgs(name, **over):
    kw = {**SHAPES[name], **over}
    return jmoe.MoEConfig(**kw), moe.MoEConfig(**kw)


def _params(jcfg, seed=0, dtype=jnp.float32):
    jp = jmoe.init_moe(jax.random.key(seed), jcfg, D, dtype)
    return jp, convert.transformer_params_from_numpy(jp, device="cpu")


def _rows(seed, t, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((t, D)).astype(dtype)


def _jax_routing(params, x, cfg, capacity=None):
    """The routing steps of ``repro.models.moe.moe_ffn`` (lines 71-95)."""
    t = x.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    if capacity is None:
        capacity = int(t * k / e * cfg.capacity_factor) + 1
    capacity = max(8, -(-capacity // 8) * 8)
    probs = jax.nn.softmax(x.astype(cfg.router_dtype) @ params["router"], -1)
    gate_vals, expert_ids = jax.lax.top_k(probs, k)
    if cfg.norm_topk:
        gate_vals = gate_vals / jnp.maximum(
            gate_vals.sum(-1, keepdims=True), 1e-9)
    flat_ids = expert_ids.reshape(-1)
    pos_in_e = jnp.cumsum(jax.nn.one_hot(flat_ids, e, dtype=jnp.int32), 0) - 1
    pos = jnp.take_along_axis(pos_in_e, flat_ids[:, None], axis=1)[:, 0]
    keep = pos < capacity
    return (np.asarray(flat_ids), np.asarray(pos), np.asarray(keep),
            np.asarray(gate_vals.reshape(-1) * keep), capacity,
            np.asarray(probs))


def _no_near_ties(probs, k, gap=1e-5):
    """The k-th and (k+1)-th probabilities of every row lie apart (and the
    chosen k are distinct): the inputs decide the routing."""
    p = -np.sort(-probs, axis=1)
    assert (p[:, :k] - p[:, 1:k + 1]).min() > gap


def _same_routing(tp, jp, x, tcfg, jcfg, capacity=None):
    ids, pos, keep, gates, cap, probs = _jax_routing(jp, jnp.asarray(x), jcfg,
                                                     capacity)
    _no_near_ties(probs, jcfg.top_k)
    r = moe.route(tp, torch.as_tensor(x), tcfg, capacity)
    np.testing.assert_array_equal(r.expert_ids.numpy(), ids)
    np.testing.assert_array_equal(r.pos.numpy(), pos)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_allclose(r.gates.numpy(), gates, atol=1e-6, rtol=1e-6)
    assert r.capacity == cap
    return r


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(convert.to_numpy(got),
                               np.asarray(want).astype(np.float32),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("t", [16, 96])
def test_routing_matches_jax(name, t):
    jcfg, cfg = _cfgs(name)
    jp, tp = _params(jcfg)
    r = _same_routing(tp, jp, _rows(t, t), cfg, jcfg)
    assert r.keep.all() or t > 16


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("t", [16, 96])
def test_moe_ffn_matches_jax_f32(name, t):
    jcfg, cfg = _cfgs(name)
    jp, tp = _params(jcfg, seed=1)
    x = _rows(t + 1, t)
    want = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    got = moe.moe_ffn(tp, torch.as_tensor(x), cfg)
    _close(got.y, want.y)
    assert got.aux_loss.dtype == torch.float32
    assert abs(float(got.aux_loss) - float(want.aux_loss)) <= 1e-6


@pytest.mark.parametrize("name", list(SHAPES))
def test_forced_capacity_drops_tokens(name):
    """capacity=8 of 64 tokens: most choices drop, and a dropped choice adds
    nothing (its gate is 0), as in JAX."""
    jcfg, cfg = _cfgs(name)
    jp, tp = _params(jcfg, seed=2)
    x = _rows(5, 64)
    r = _same_routing(tp, jp, x, cfg, jcfg, capacity=5)
    assert r.capacity == 8 and (~r.keep).sum() > 0
    assert (r.gates[~r.keep] == 0).all()
    want = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg, capacity=5)
    got = moe.moe_ffn(tp, torch.as_tensor(x), cfg, capacity=5)
    _close(got.y, want.y)
    # a token whose every choice dropped gets only the shared expert
    t, k = x.shape[0], cfg.top_k
    gone = (~r.keep).view(t, k).all(1)
    assert gone.any()
    shared = moe._swiglu(torch.as_tensor(x), tp["shared_wi"],
                         tp["shared_wo"])
    assert torch.equal(got.y[gone], shared[gone])


@pytest.mark.parametrize("name", list(SHAPES))
def test_pad_rows_take_capacity(name):
    """Pad tokens (id -1) all read the last embedding row: identical rows,
    routed alike.  Ahead of the real rows they fill their expert's queue,
    and the real rows routed there drop, in both packages; without them
    those rows are kept.  Skipping pads would change real outputs."""
    jcfg, cfg = _cfgs(name)
    jp, tp = _params(jcfg, seed=3)
    real = _rows(7, 24)
    pad = np.repeat(_rows(8, 1), 16, axis=0)
    x = np.concatenate([pad, real])
    r = _same_routing(tp, jp, x, cfg, jcfg, capacity=8)
    pad_expert = int(r.expert_ids[0])
    k = cfg.top_k
    real_ids = r.expert_ids.view(-1, k)[16:]
    hit = (real_ids == pad_expert).any(1)
    assert hit.any()
    assert not r.keep.view(-1, k)[16:][real_ids == pad_expert].any()
    want = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg, capacity=8)
    got = moe.moe_ffn(tp, torch.as_tensor(x), cfg, capacity=8)
    _close(got.y, want.y)
    alone = moe.moe_ffn(tp, torch.as_tensor(real), cfg, capacity=8)
    assert not torch.allclose(alone.y[hit], got.y[16:][hit], atol=1e-3)


@pytest.mark.parametrize("name", list(SHAPES))
def test_moe_ffn_bf16_matches_jax(name):
    jcfg, cfg = _cfgs(name)
    jp, tp = _params(jcfg, seed=4, dtype=jnp.bfloat16)
    assert tp["wi"].dtype == torch.bfloat16
    assert tp["router"].dtype == torch.float32
    x = _rows(9, 48)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    want = jmoe.moe_ffn(jp, jx, jcfg)
    got = moe.moe_ffn(tp, torch.as_tensor(x).to(torch.bfloat16), cfg)
    assert got.y.dtype == torch.bfloat16
    _close(got.y, want.y, atol=3e-2, rtol=3e-2)
    assert abs(float(got.aux_loss) - float(want.aux_loss)) <= 1e-6


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_calls_are_bit_identical(name, dtype):
    _jcfg, cfg = _cfgs(name)
    params = moe.init_moe(cfg, D, dtype, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    x = torch.as_tensor(_rows(10, 40)).to(dtype)
    a = moe.moe_ffn(params, x, cfg, capacity=8)
    b = moe.moe_ffn(params, x, cfg, capacity=8)
    assert torch.equal(a.y, b.y) and torch.equal(a.aux_loss, b.aux_loss)


@pytest.mark.parametrize("t,cap", [(1, None), (7, None), (8, None),
                                   (100, None), (4096, None), (16, 3),
                                   (16, 9), (16, 24)])
def test_capacity_rule_matches_jax(t, cap):
    """At least 8 slots, rounded up to a multiple of 8 (moe.py:71-74)."""
    for name in SHAPES:
        jcfg, cfg = _cfgs(name)
        want = int(t * jcfg.top_k / jcfg.n_experts * jcfg.capacity_factor) \
            + 1 if cap is None else cap
        want = max(8, -(-want // 8) * 8)
        assert moe.capacity_for(t, cfg, cap) == want


@pytest.mark.parametrize("name", list(SHAPES))
def test_config_and_init_mirror_jax(name):
    jcfg, cfg = _cfgs(name)
    a, b = jcfg._asdict(), cfg._asdict()
    assert jnp.dtype(a.pop("router_dtype")).name == \
        str(b.pop("router_dtype")).removeprefix("torch.")
    assert a == b
    want = jax.eval_shape(lambda: jmoe.init_moe(jax.random.key(0), jcfg, D,
                                                jnp.bfloat16))
    got = moe.init_moe(cfg, D, torch.bfloat16, lead=(3,), device="meta")
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in got.items()} == \
        {k: ((3,) + tuple(v.shape), jnp.dtype(v.dtype).name)
         for k, v in want.items()}


def test_moe_ffn_sharded_refuses_what_does_not_split():
    """The expert-parallel form (held against the JAX one on 4 ranks in
    ``test_torch_dist_moe.py``) needs the experts to split over "model"
    and the tokens over the data axes, as the JAX version asserts; it
    checks both before it touches a tensor or a process group."""
    _jcfg, cfg = _cfgs("deepseek")
    with pytest.raises(ValueError, match="8 experts do not split"):
        moe.moe_ffn_sharded({}, torch.zeros(8, D), cfg,
                            MeshShape(("data", "model"), (1, 3)))
    with pytest.raises(ValueError, match="9 tokens do not split"):
        moe.moe_ffn_sharded({}, torch.zeros(9, D), cfg,
                            MeshShape(("data", "model"), (2, 2)))
