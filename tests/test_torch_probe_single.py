"""The port's single-session probe against the JAX package, on the CPU.

The same numpy records go through JAX ``cache_probe`` (its Pallas kernel in
interpret mode) and the port's ``cache_probe`` on CPU tensors (the plain
``ref.probe_rhat`` beside the CUDA kernel): fp32, bf16 and int8 payloads;
an empty ring, a partly filled one, a full one and a wrapped one; states at
each package's padded layout and unpadded shapes (ring 13, dim 45).  Hit
and nearest record are equal; r_hat agrees within 1e-5 (the packages sum
the f32 dot in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache_ops as jc
from repro.kernels.cache_probe.cache_probe import probe_rhat as jprobe_rhat
from repro.kernels.cache_probe.ops import cache_probe as jcache_probe
from repro_torch import convert
from repro_torch.core import cache_ops as tc
from repro_torch.kernels import dispatch
from repro_torch.kernels.cache_probe import ops as probe_ops
from repro_torch.kernels.cache_probe import ref as probe_ref

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-5
EPS = 0.2


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _records(rng, psi, n, dtype):
    """n records scattered around psi at growing distances, stored in
    ``dtype`` as the JAX package stores them: (payload, scale, radius)."""
    dim = psi.shape[0]
    noise = rng.standard_normal((n, dim))
    recs = _unit(psi + np.linspace(0.2, 1.6, n)[:, None] * noise
                 / np.sqrt(dim)).astype(np.float32)
    data, scale = jc.store_rows(jnp.asarray(recs), dtype)
    radius = rng.uniform(0.2, 1.1, n).astype(np.float32)
    return np.array(data), np.array(scale, np.float32), radius


def _same(port, ref, what):
    hit, r_hat, idx = port
    assert bool(hit) == bool(ref[0]), what
    assert int(idx) == int(ref[2]), what
    if np.isfinite(float(ref[1])):
        assert abs(float(r_hat) - float(ref[1])) <= TOL, what
    else:
        assert float(r_hat) == float(ref[1]), what


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_probe_on_padded_states_matches_jax(dtype):
    """JAX states from ``init_cache`` carried into the port's layout; rings
    empty, partial, full and wrapped."""
    rng = np.random.default_rng(21)
    dim, qmax = 67, 13
    jcfg = jc.CacheConfig(capacity=16, dim=dim, max_queries=qmax,
                          store_dtype=dtype)
    tcfg = tc.CacheConfig(capacity=16, dim=dim, max_queries=qmax,
                          store_dtype=dtype)
    psi = _unit(rng.standard_normal(dim)).astype(np.float32)
    data, scale, radius = _records(rng, psi, qmax, dtype)
    hits = set()
    for n_q in (0, 1, 6, qmax, 2 * qmax + 3):
        st = jc.init_cache(jcfg)
        leaves = {f: np.array(getattr(st, f)) for f in jc.CacheState._fields}
        live = min(n_q, qmax)
        leaves["q_emb"][:live, :dim] = data[:live]
        leaves["q_scale"][:live] = scale[:live]
        leaves["q_radius"][:live] = radius[:live]
        leaves["n_queries"] = np.int32(n_q)
        jst = jc.CacheState(**{f: jnp.asarray(v) for f, v in leaves.items()})
        ref = jcache_probe(jst.q_emb, jnp.asarray(psi), jst.q_radius,
                           jst.n_queries, EPS, q_scale=jst.q_scale,
                           interpret=True, max_queries=qmax)
        tst = convert.cache_state_from_numpy(jst, tcfg, device="cpu")
        dispatch.reset_counters()
        port = probe_ops.cache_probe(tst.q_emb, torch.as_tensor(psi),
                                     tst.q_radius, tst.n_queries, EPS,
                                     q_scale=tst.q_scale, max_queries=qmax)
        assert dispatch.counters()["probe_rhat"].calls == 1
        _same(port, ref, f"{dtype} n_queries={n_q}")
        hits.add(bool(ref[0]))
        if n_q == 0:
            assert int(port[2]) == -1 and not bool(port[0])
    assert hits == {True, False}, "inputs must mix hits and misses"


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_probe_on_unpadded_shapes_matches_jax(dtype):
    """A ring of 13 records at dim 45: both wrappers take their padding
    branches (the port to 16 x 64, the JAX package to 16 x 128)."""
    rng = np.random.default_rng(5)
    dim, qmax = 45, 13
    psi = _unit(rng.standard_normal(dim)).astype(np.float32)
    data, scale, radius = _records(rng, psi, qmax, dtype)
    jdata = jnp.asarray(data) if dtype != "bf16" \
        else jnp.asarray(data, jnp.bfloat16)
    tdata = torch.as_tensor(data.astype(np.float32)).to(
        {"fp32": torch.float32, "bf16": torch.bfloat16,
         "int8": torch.int8}[dtype])
    for n_q, mq in ((0, None), (4, None), (13, None), (40, None), (40, 9)):
        ref = jcache_probe(jdata, jnp.asarray(psi), jnp.asarray(radius),
                           jnp.int32(n_q), EPS, q_scale=jnp.asarray(scale),
                           interpret=True, max_queries=mq)
        port = probe_ops.cache_probe(tdata, torch.as_tensor(psi),
                                     torch.as_tensor(radius), n_q, EPS,
                                     q_scale=torch.as_tensor(scale),
                                     max_queries=mq)
        _same(port, ref, f"{dtype} n_queries={n_q} max_queries={mq}")


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_probe_rhat_plain_matches_jax_kernel(dtype):
    """``ref.probe_rhat`` — the plain version the card holds its kernel
    against — equals the interpret-mode Pallas ``probe_rhat``."""
    rng = np.random.default_rng(9)
    qp, dp, dim = 16, 128, 100
    psi = np.zeros(dp, np.float32)
    psi[:dim] = _unit(rng.standard_normal(dim))
    data, scale, radius = _records(rng, psi[:dim], qp, dtype)
    pdata = np.zeros((qp, dp), np.float32)
    pdata[:, :dim] = data.astype(np.float32)
    jdata = jnp.asarray(pdata).astype(jc.quant.storage_dtype(dtype))
    psi8 = np.zeros((8, dp), np.float32)
    psi8[0] = psi
    ref = jprobe_rhat(jdata, jnp.asarray(psi8), jnp.asarray(radius)[:, None],
                      jnp.asarray(scale)[:, None], interpret=True)[:, 0]
    tdata = torch.as_tensor(pdata).to(
        {"fp32": torch.float32, "bf16": torch.bfloat16,
         "int8": torch.int8}[dtype])
    port = probe_ref.probe_rhat(tdata, torch.as_tensor(psi),
                                torch.as_tensor(radius),
                                torch.as_tensor(scale))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=TOL,
                               rtol=0)
    # the wrapper on a CPU tensor is the plain version
    np.testing.assert_array_equal(
        probe_ops.probe_rhat(tdata, torch.as_tensor(psi),
                             torch.as_tensor(radius),
                             torch.as_tensor(scale)).numpy(), port.numpy())
