"""The port's optimizers against the JAX package, on the CPU.

The same numpy trees (a factored (130, 128) leaf, unfactored vectors and a
small matrix, a layer-stacked (2, 128, 130) leaf whose slices factor, a
stacked (2, 4, 5) leaf whose slices do not, a list) and the same numpy
gradients go through ``repro.train.optimizer`` and
``repro_torch.train.optimizer`` for one and three steps: parameters and
state within atol 1e-6 (f32), the step equal.  A bf16 tree with
``stochastic_rounding=False`` agrees within one bf16 ulp.  ``global_norm``
within rtol 1e-6.  The port's stochastic rounding is held to its own
properties (its draws cannot be JAX's): the result is the bf16 just below
or just above the f32 value, only the low 16 bits of the f32 pattern
change, the int32 add wraps as the uint32 one, and the mean over many draws
is the f32 value.  The update writes parameters and moments in place (a
divergence from the JAX package, pinned here) and never the gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as jopt
from repro_torch import convert
from repro_torch.train import optimizer as topt
from repro_torch.train import tree

jax.config.update("jax_platform_name", "cpu")

ATOL = 1e-6


def _params(dtype=np.float32):
    rng = np.random.default_rng(0)

    def a(*shape):
        return rng.standard_normal(shape).astype(dtype)

    return {"embed": a(130, 128), "norm": a(16), "small": a(3, 16),
            "stack": a(2, 128, 130), "stack_small": a(2, 4, 5),
            "list": [a(7), {"w": a(5, 3)}]}


def _grads(params, i):
    rng = np.random.default_rng(100 + i)
    return jax.tree.map(
        lambda p: (rng.standard_normal(p.shape) * 0.1).astype(p.dtype),
        params)


def _pair(name, **kw):
    return getattr(jopt, name)(**kw), getattr(topt, name)(**kw)


def _np(x):
    return convert.to_numpy(x) if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _assert_trees(jt, tt, atol):
    jl = jax.tree_util.tree_flatten_with_path(jt)[0]
    tl = tree.leaves_with_path(tt)
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [
        "".join(f"[{k!r}]" if not k.isdigit() else f"[{k}]" for k in p)
        for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        np.testing.assert_allclose(_np(b), _np(a), atol=atol, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


CASES = [("adamw", dict(lr=1e-2, warmup=2, weight_decay=0.1)),
         ("adamw", dict(lr=3e-3, warmup=1, grad_clip=None)),
         ("adafactor", dict(lr=1e-2, warmup=2, stochastic_rounding=False)),
         ("adafactor", dict(lr=3e-2, warmup=1, decay=0.5,
                            clip_threshold=0.5, stochastic_rounding=False))]


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("name,kw", CASES)
def test_update_matches_jax(name, kw, steps):
    jo, to = _pair(name, **kw)
    params = _params()
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(torch.tensor, params)
    js, ts = jo.init(jp), to.init(tp)
    _assert_trees(js.inner, ts.inner, 0)
    for i in range(steps):
        g = _grads(params, i)
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = to.update(jax.tree.map(torch.tensor, g), ts, tp)
    assert int(ts.step) == int(js.step) == steps
    assert ts.step.dtype == torch.int32 and ts.step.dim() == 0
    _assert_trees(jp, tp, ATOL)
    _assert_trees(js.inner, ts.inner, ATOL)


def test_adafactor_factors_each_slice_of_a_stacked_leaf():
    _, to = _pair("adafactor")
    st = to.init(jax.tree.map(torch.tensor, _params())).inner["v"]
    assert set(st["embed"]) == {"vr", "vc"}
    assert st["stack"]["vr"].shape == (2, 128)
    assert st["stack"]["vc"].shape == (2, 130)
    assert set(st["stack_small"]) == {"v"} and set(st["norm"]) == {"v"}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_bf16_tree_within_one_ulp(name):
    kw = dict(lr=1e-2, warmup=1)
    if name == "adafactor":
        kw["stochastic_rounding"] = False
    jo, to = _pair(name, **kw)
    params = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                          _params())
    jp = jax.tree.map(jnp.asarray, params)
    tp = convert.transformer_params_from_numpy(params, device="cpu")
    js, ts = jo.init(jp), to.init(tp)
    for i in range(2):
        g = _grads(_params(), i)
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = to.update(jax.tree.map(torch.tensor, g), ts, tp)
    for a, b in zip(jax.tree.leaves(jp), tree.leaves(tp)):
        assert b.dtype == torch.bfloat16
        want = np.asarray(a, np.float32)
        # one bf16 ulp at the larger magnitude: 2 ** (exponent - 7)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert (np.abs(_np(b) - want) <= ulp).all()


def test_global_norm_matches_jax():
    g = _grads(_params(), 0)
    want = float(jopt.global_norm(jax.tree.map(jnp.asarray, g)))
    got = topt.global_norm(jax.tree.map(torch.tensor, g))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_update_writes_params_and_moments_in_place_not_grads():
    _, to = _pair("adamw", lr=1e-2, warmup=1)
    tp = jax.tree.map(torch.tensor, _params())
    ts = to.init(tp)
    g = jax.tree.map(torch.tensor, _grads(_params(), 0))
    g_before = jax.tree.map(lambda t: t.clone(), g)
    ptrs = [t.data_ptr() for t in tree.leaves(tp)]
    p0 = tree.leaves(tp)[0].clone()
    new_p, new_s = to.update(g, ts, tp)
    assert [t.data_ptr() for t in tree.leaves(new_p)] == ptrs
    assert new_s.inner is ts.inner and int(ts.step) == 0
    assert not torch.equal(tree.leaves(tp)[0], p0)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(g),
                                                 tree.leaves(g_before)))


def _sr(x32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return topt._stochastic_round_bf16(x32, gen)


def test_stochastic_rounding_lands_on_a_neighbour_and_keeps_high_bits():
    rng = np.random.default_rng(3)
    x = torch.tensor(np.concatenate([
        rng.standard_normal(4096) * 10.0 ** rng.integers(-20, 20, 4096),
        [0.0, -0.0, 1.0, -1.0, 3.4e38, -3.4e38]]).astype(np.float32))
    out = _sr(x)
    assert out.dtype == torch.bfloat16
    bits = x.view(torch.int32)
    got = out.float().view(torch.int32)
    # only the low 16 bits of the f32 pattern may change
    assert torch.equal(got & -65536, got)
    down = bits & -65536                      # toward zero in magnitude
    up = down + 65536
    exact = (bits & 0xFFFF) == 0
    assert bool(((got == down) | ((got == up) & ~exact)).all())


def test_stochastic_rounding_add_wraps_as_uint32():
    """The draw (below 2 ** 16) added to the int32 bits of f32 patterns at
    the edges (the largest finite, -0 + 1 ulp, all ones) gives the JAX
    package's uint32 sum modulo 2 ** 32, masked to the high 16 bits,
    wherever that is not a NaN."""
    pats = np.array([0x7F7FFFFF, 0x7F7F0001, -1 & 0xFFFFFFFF,
                     0x80000001, 0xFF7FFFFF, 0x00000001, 0x3F80FFFF],
                    np.uint32)
    x = torch.from_numpy(pats.view(np.int32).copy()).view(torch.float32)
    for seed in range(20):
        out = _sr(x, seed).float()
        noise = torch.randint(0, 1 << 16, x.shape, dtype=torch.int32,
                              generator=torch.Generator().manual_seed(seed))
        want = ((pats.astype(np.uint64) + noise.numpy().astype(np.uint64))
                % (1 << 32)).astype(np.uint32) & np.uint32(0xFFFF0000)
        got = out.view(torch.int32).numpy().view(np.uint32)
        finite = ~np.isnan(want.view(np.float32))
        np.testing.assert_array_equal(got[finite], want[finite])


def test_stochastic_rounding_is_unbiased():
    x = torch.full((200_000,), 1.0 + 3 * 2.0 ** -10, dtype=torch.float32)
    out = _sr(x).double()
    assert set(out.unique().tolist()) == {1.0, 1.0 + 2.0 ** -7}
    mean = float(out.mean())
    # rounds up with probability 0.375: the standard error of the mean is
    # 2 ** -7 * sqrt(0.375 * 0.625 / 200000), about 8.5e-6
    assert abs(mean - float(x[0])) < 5e-5, mean


def test_adafactor_stochastic_rounding_reproducible_from_seed_and_step():
    params = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                          _params())
    g = jax.tree.map(torch.tensor, _grads(_params(), 0))
    outs = []
    for _ in range(2):
        _, to = _pair("adafactor", lr=1e-2, warmup=1, seed=5)
        tp = convert.transformer_params_from_numpy(params, device="cpu")
        tp, _ = to.update(g, to.init(tp), tp)
        outs.append(tp)
    assert all(torch.equal(a, b) for a, b in zip(*map(tree.leaves, outs)))


def test_tree_walks_in_jax_order():
    t = {"b": {"y": 1, "x": 2}, "a": [3, {"z": 4}], "c": None,
         "o": topt.OptState(5, {"m": 6})}
    got = [tree.path_key(p) for p, _ in tree.leaves_with_path(t)]
    assert got == ["a|0", "a|1|z", "b|x", "b|y", "o|.step", "o|.inner|m"]
    assert tree.leaves(t) == jax.tree.leaves(t) == [3, 4, 2, 1, 5, 6]
    back = tree.unflatten(t, [10 * v for v in tree.leaves(t)])
    assert back["o"].step == 50 and back["b"]["y"] == 10 and back["c"] is None
