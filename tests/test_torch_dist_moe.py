"""The port's expert-parallel MoE against the JAX package's
``moe_ffn_sharded``, on the CPU.

deepseek-v3's smoke MoE layer in f32 (8 experts, top 2, one shared
expert, d_model 64) on 64 tokens: the JAX version on a (2, 2) mesh of
``AxisType.Auto`` axes in the pytest process, the port on a (2, 2)
``DeviceMesh`` of 4 gloo ranks (``test_torch_dist_ranks.py``).  The
port's gradients come from autograd through its collectives (DTensor
redistributions), the JAX ones from ``jax.grad`` through ``shard_map``:
both are the gradients of the global sum(y * w) + aux.  Bars: y within
1e-5, aux within 1e-6, the gradients with respect to x, the router, wi and
wo within 1e-5; with the default capacity and with 8 slots an expert
(choices dropped).  The whole smoke model under ``lm_activation_rules``
(its MoE layers through ``moe_ffn_sharded`` in both packages): logits
within 1e-4.  At a world of one, the sharded form equals ``moe_ffn``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AxisType

import test_torch_dist_ranks as ranks
from repro.configs import registry as jregistry
from repro.dist import api as japi
from repro.dist import sharding as jshd
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch.launch.hostdevices import run_ranks

jax.config.update("jax_platform_name", "cpu")

CAPACITIES = (None, 8)


def _jcfg():
    return dataclasses.replace(jregistry.get("deepseek-v3-671b")
                               .smoke_config(), dtype=jnp.float32)


def _moe_case():
    jcfg = _jcfg()
    m = jcfg.moe
    cfg_kw = dict(n_experts=m.n_experts, top_k=m.top_k, d_ff=m.d_ff,
                  n_shared=m.n_shared, d_ff_shared=m.d_ff_shared,
                  capacity_factor=m.capacity_factor,
                  aux_loss_weight=m.aux_loss_weight, norm_topk=m.norm_topk)
    params = jmoe.init_moe(jax.random.key(5), m, jcfg.d_model, jnp.float32)
    return m, cfg_kw, jax.tree.map(np.asarray, params)


def _mesh():
    return jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:4])


@pytest.fixture(scope="module")
def world4():
    jcfg = _jcfg()
    _m, cfg_kw, params = _moe_case()
    jp = jtf.init_params(jax.random.key(0), jcfg)
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (4, 16)).astype(np.int32)
    got = run_ranks(ranks.moe_world4_all, 4, params, cfg_kw, CAPACITIES,
                    jax.tree.map(np.asarray, jp), tokens, timeout=150)
    return got, jp, tokens


@pytest.mark.parametrize("capacity", CAPACITIES)
def test_moe_ffn_sharded_matches_jax(world4, capacity):
    got = world4[0]["moe"][capacity]
    m, _kw, params = _moe_case()
    x, w = ranks.moe_inputs(d=params["wi"].shape[1])
    mesh = _mesh()

    def loss(x, p):
        out = jmoe.moe_ffn_sharded(p, x, m, mesh, capacity=capacity)
        return jnp.sum(out.y * w) + out.aux_loss, out

    (_l, out), (gx, gp) = jax.value_and_grad(loss, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(x), jax.tree.map(jnp.asarray, params))
    np.testing.assert_allclose(got["y"], np.asarray(out.y), atol=1e-5)
    assert abs(got["aux"] - float(out.aux_loss)) <= 1e-6
    np.testing.assert_allclose(got["grad_x"], np.asarray(gx), atol=1e-5)
    for k in ("router", "wi", "wo", "shared_wi", "shared_wo"):
        np.testing.assert_allclose(got[f"grad_{k}"], np.asarray(gp[k]),
                                   atol=1e-5, err_msg=k)
    assert np.abs(got["grad_wi"]).max() > 0


def test_moe_layers_under_rules_match_jax(world4):
    got, jp, tokens = world4
    jcfg = _jcfg()
    mesh = _mesh()
    with japi.sharding_rules(mesh, jshd.lm_activation_rules(mesh, jcfg,
                                                            "train")):
        logits, aux, _h, _kv = jax.jit(
            lambda p, t: jtf.forward(p, t, jcfg, remat="none"))(
            jp, jnp.asarray(tokens))
    np.testing.assert_allclose(got["forward"]["logits"], np.asarray(logits),
                               atol=1e-4)
    assert abs(got["forward"]["aux"] - float(aux)) <= 1e-6


def test_moe_ffn_sharded_at_world_one_equals_moe_ffn():
    _m, cfg_kw, params = _moe_case()
    got = run_ranks(ranks.moe_world1, 1, params, cfg_kw, 8, timeout=90)
    (y, aux), (y_ref, aux_ref) = got["sharded"], got["plain"]
    np.testing.assert_allclose(y, y_ref, atol=1e-6)
    assert abs(aux - aux_ref) <= 1e-7
