"""The probe's decision (``cache_probe.cu`` in decision mode) on the CPU.

``ref.lowquality`` is the plain version of the kernel's decision: ring
validity, the first maximal r_hat, the hit test and nearest_q = -1 for an
empty cache.  On the same seeded numpy records it must give the hit, the
nearest record and best_r (within 1e-5) of the JAX package's wrappers
(``repro.kernels.cache_probe.ops``, the Pallas kernel in interpret mode)
and cache ops (``repro.core.cache_ops.probe`` / ``probe_batched``), at the
edges the kernel decides alone: exact ties, an empty ring, a ring whose
records all have r_hat = -inf, n_queries above the ring length, and a
logical ring (``max_queries``) shorter than the physical one.  The port's
wrappers on CPU tensors are that plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache_ops as jc
from repro.kernels.cache_probe.ops import cache_probe as jcache_probe
from repro.kernels.cache_probe.ops import \
    cache_probe_batched as jcache_probe_batched
from repro_torch.kernels import dispatch
from repro_torch.kernels.cache_probe import ops as probe_ops
from repro_torch.kernels.cache_probe import ref as probe_ref

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-5
EPS = 0.2
DIM, QMAX = 45, 13          # a ring of 13 records: 16 physical slots here
STORE = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _wave(dtype, seed=3):
    """Seven sessions, one edge each: an empty ring; 3 live records; n_queries
    above the ring length; an exact tie for the best record (slots 2 and 5);
    every record at radius -inf; a ring past max_queries = 9 (12 records);
    and a far query (a miss).  Returns numpy (q_emb, scale, psi, radius,
    n_queries) in the JAX package's storage."""
    rng = np.random.default_rng(seed)
    s = 7
    psi = _unit(rng.standard_normal((s, DIM))).astype(np.float32)
    noise = rng.standard_normal((s, QMAX, DIM))
    spread = np.linspace(0.2, 1.6, QMAX)[None, :, None]
    recs = _unit(psi[:, None, :] + spread * noise / np.sqrt(DIM))
    radius = rng.uniform(0.2, 1.1, (s, QMAX)).astype(np.float32)
    recs[3, 5] = recs[3, 2] = _unit(psi[3] + 0.01 * noise[3, 0])
    radius[3, 2] = radius[3, 5] = 1.5
    radius[4] = -np.inf
    psi[6] = -psi[6]
    data, scale = jc.store_rows(jnp.asarray(recs.astype(np.float32)), dtype)
    n_q = np.array([0, 3, QMAX + 5, QMAX, 7, 12, QMAX], np.int32)
    return np.array(data.astype(jnp.float32)), np.array(scale, np.float32), \
        psi, radius, n_q


def _port_inputs(data, scale, psi, radius, n_q, dtype):
    return (torch.as_tensor(data).to(STORE[dtype]), torch.as_tensor(psi),
            torch.as_tensor(radius), torch.as_tensor(n_q),
            torch.as_tensor(scale))


def _jax_inputs(data, scale, psi, radius, n_q, dtype):
    jd = jnp.asarray(data, jnp.bfloat16) if dtype == "bf16" \
        else jnp.asarray(data.astype(np.int8) if dtype == "int8" else data)
    return (jd, jnp.asarray(psi), jnp.asarray(radius), jnp.asarray(n_q),
            jnp.asarray(scale))


def _same(port, ref, what):
    hit, best_r, near = (np.asarray(x) for x in port)
    rhit, rbest, rnear = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(hit, rhit, err_msg=what)
    np.testing.assert_array_equal(near, rnear, err_msg=what)
    fin = np.isfinite(rbest)
    np.testing.assert_array_equal(np.isfinite(best_r), fin, err_msg=what)
    np.testing.assert_allclose(best_r[fin], rbest[fin], atol=TOL, rtol=0,
                               err_msg=what)
    np.testing.assert_array_equal(best_r[~fin], rbest[~fin], err_msg=what)


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("max_queries", [None, 9, 0])
def test_plain_decision_matches_jax_wrapper(dtype, max_queries):
    inputs = _wave(dtype)
    q, psi, radius, n_q, scale = _port_inputs(*inputs, dtype)
    got = probe_ref.lowquality(q, psi, radius, n_q, EPS, scale, max_queries)
    jq, jpsi, jrad, jn, jscale = _jax_inputs(*inputs, dtype)
    want = jcache_probe_batched(jq, jpsi, jrad, jn, EPS, q_scale=jscale,
                                interpret=True, max_queries=max_queries)
    _same(got, want, f"{dtype} max_queries={max_queries}")
    hit, _, near = got
    if max_queries is None:
        assert hit[[1, 2, 3, 5]].all() and not hit[[0, 4, 6]].any()
        assert int(near[3]) == 2                 # the tie: the lower slot
        assert int(near[0]) == -1 and int(near[4]) == 0
    if max_queries == 0:                         # nothing live anywhere
        assert not hit.any()
        assert near.tolist() == [-1] + [0] * 6
    for s in range(q.shape[0]):                  # one session at a time
        one = jcache_probe(jq[s], jpsi[s], jrad[s], jn[s], EPS,
                           q_scale=jscale[s], interpret=True,
                           max_queries=max_queries)
        _same([x[s:s + 1] for x in got], [np.asarray(x)[None] for x in one],
              f"{dtype} session {s}")


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_plain_decision_matches_jax_cache_ops(dtype):
    """The same sessions as JAX cache states (``init_batched_cache`` with
    the records written in): ``probe_batched`` and the scalar ``probe``."""
    data, scale, psi, radius, n_q = _wave(dtype, seed=8)
    cfg = jc.CacheConfig(capacity=16, dim=DIM, max_queries=QMAX,
                         store_dtype=dtype)
    st = jc.init_batched_cache(cfg, psi.shape[0])
    leaves = {f: np.array(getattr(st, f)) for f in jc.CacheState._fields}
    leaves["q_emb"][:, :QMAX, :DIM] = data
    leaves["q_scale"][:, :QMAX] = scale
    leaves["q_radius"][:, :QMAX] = radius
    leaves["n_queries"] = n_q
    jst = jc.CacheState(**{f: jnp.asarray(v).astype(getattr(st, f).dtype)
                           for f, v in leaves.items()})
    want = jc.probe_batched(jst, jnp.asarray(psi), EPS, backend="ref",
                            max_queries=QMAX)
    q, tpsi, trad, tn, tscale = _port_inputs(data, scale, psi, radius, n_q,
                                             dtype)
    got = probe_ref.lowquality(q, tpsi, trad, tn, EPS, tscale, QMAX)
    _same(got, want, dtype)
    for s in range(psi.shape[0]):
        one = jc.probe(jax.tree_util.tree_map(lambda x: x[s], jst),
                       jnp.asarray(psi[s]), EPS, max_queries=QMAX)
        _same([x[s:s + 1] for x in got], [np.asarray(x)[None] for x in one],
              f"{dtype} scalar probe, session {s}")


def test_wrappers_on_the_cpu_are_the_plain_decision():
    """``cache_probe_batched`` and ``cache_probe`` on CPU tensors: one call
    each, no launch, the plain decision bit for bit; a missing q_scale and
    an int record count give the same answers as ones and a tensor.  One
    session at a time sums its dots in a product of its own (best_r within
    1e-5 of the wave's)."""
    q, psi, radius, n_q, scale = _port_inputs(*_wave("fp32"), "fp32")
    want = probe_ref.lowquality(q, psi, radius, n_q, EPS, scale, 9)
    dispatch.reset_counters()
    got = probe_ops.cache_probe_batched(q, psi, radius, n_q, EPS,
                                        q_scale=scale, max_queries=9)
    c = dispatch.counters()["cache_probe"]
    assert (c.calls, c.launches) == (1, 0)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    ones = probe_ref.lowquality(q, psi, radius, n_q, EPS, torch.ones_like(scale))
    no_scale = probe_ops.cache_probe_batched(q, psi, radius, n_q, EPS)
    for a, b in zip(no_scale, ones):
        assert torch.equal(a, b)
    for s in range(q.shape[0]):
        for count in (n_q[s], int(n_q[s])):
            one = probe_ops.cache_probe(q[s], psi[s], radius[s], count, EPS,
                                        q_scale=scale[s], max_queries=9)
            assert all(x.shape == () for x in one)
            _same([x[None] for x in one], [x[s:s + 1] for x in want],
                  f"session {s}")
    assert dispatch.counters()["probe_rhat"].launches == 0
