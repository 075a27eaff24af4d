"""The port's embedding bag against the JAX package's, on the CPU.

The same numpy inputs go through the JAX op with its Pallas kernel in
interpret mode (``use_kernel=True``), and through the port's wrapper on CPU
tensors (the plain PyTorch version beside ``csrc/embedding_bag.cu``): the
cases of ``tests/test_kernels_embedding_bag.py`` plus the widths on the
recsys path that are not multiples of 4 (D = 1, the xDeepFM linear term;
D = 10, its fields), and every load width of the kernel (D = 1, 2, 10, 33
and 64 in f32, f16 and bf16, bags of one item and of eight).  Tolerances: 1e-5 for f32 tables (the two packages
sum the same products in other orders), 1e-3 for f16 / bf16 tables, as
the JAX dtype sweep.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag.ops import embedding_bag as jbag
from repro.kernels.embedding_bag.ref import embedding_bag_ref as jbag_ref
from repro_torch.kernels import dispatch
from repro_torch.kernels.embedding_bag import ref
from repro_torch.kernels.embedding_bag.ops import embedding_bag

jax.config.update("jax_platform_name", "cpu")

SHAPES = [
    (100, 16, 4, 8),
    (1000, 64, 16, 26),     # dlrm-ish: 26 sparse fields
    (5000, 10, 8, 39),      # xdeepfm-ish fields, D = 10
    (64, 200, 2, 5),        # D = 200: the JAX wrapper pads it to 256 lanes
    (300, 1, 16, 4),        # the xdeepfm linear term, D = 1
]


def _case(seed, v, d, b, l, pad_frac=0.2, dtype=np.float32):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((v, d)).astype(dtype)
    idx = rng.integers(0, v, (b, l)).astype(np.int32)
    idx = np.where(rng.random((b, l)) < pad_frac, -1, idx).astype(np.int32)
    w = rng.random((b, l)).astype(np.float32)
    return table, idx, w


def _both(table, idx, w, mode, jdtype=None, tdtype=None):
    """(port on CPU tensors, JAX interpret kernel) as numpy."""
    jt = jnp.asarray(table, jdtype) if jdtype else jnp.asarray(table)
    tt = torch.as_tensor(table)
    if tdtype is not None:
        tt = tt.to(tdtype)
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else torch.as_tensor(w)
    got = embedding_bag(tt, torch.as_tensor(idx), tw, mode=mode)
    want = jbag(jt, jnp.asarray(idx), jw, mode=mode, use_kernel=True,
                interpret=True)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("v,d,b,l", SHAPES)
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_bag_matches_jax_kernel(v, d, b, l, mode, weighted):
    table, idx, w = _case(v + d + b + l, v, d, b, l)
    got, want = _both(table, idx, w if weighted else None, mode)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("mode", ["sum", "max"])
def test_bag_table_dtypes(dtype, mode):
    table, idx, w = _case(11, 128, 32, 4, 6)
    got, want = _both(table, idx, w, mode, jdtype=getattr(jnp, dtype),
                      tdtype=getattr(torch, dtype))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("d", [1, 2, 10, 33, 64])
@pytest.mark.parametrize("l", [1, 8])
@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_bag_load_widths_match_jax_kernel(d, l, dtype):
    """The widths the kernel loads in 4, 8 and 16 bytes (or 2, one half),
    in bags of one item (the recsys models') and of eight, weighted, in
    every mode; a bag of one unweighted item is the row itself."""
    tol = 1e-5 if dtype == "float32" else 1e-3
    table, idx, w = _case(d * 10 + l, 200, d, 6, l)
    for mode in ("sum", "mean", "max"):
        for weights in (None, w):
            got, want = _both(table, idx, weights, mode,
                              jdtype=getattr(jnp, dtype),
                              tdtype=getattr(torch, dtype))
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    if l == 1:
        tt = torch.as_tensor(table).to(getattr(torch, dtype))
        got = embedding_bag(tt, torch.as_tensor(idx))
        rows = tt.float()[torch.as_tensor(idx[:, 0]).clamp(min=0).long()]
        rows[torch.as_tensor(idx[:, 0]) < 0] = 0
        assert torch.equal(got, rows)


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_bag_all_padding_bag_is_zero(mode):
    table, idx, w = _case(7, 50, 8, 3, 4)
    idx[1] = -1
    got, want = _both(table, idx, w, mode)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[1], 0.0)


def test_bag_linear_in_weights():
    """bag(w1 + w2) == bag(w1) + bag(w2) in sum mode, and the port equals
    the JAX kernel on each."""
    table, idx, w = _case(17, 80, 24, 6, 7)
    w2 = w * 0.37 + 0.1
    outs = [_both(table, idx, x, "sum") for x in (w, w2, w + w2)]
    for got, want in outs:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(outs[0][0] + outs[1][0], outs[2][0],
                               rtol=1e-4, atol=1e-4)


def test_bag_mean_equals_jax_fallback():
    table, idx, w = _case(13, 300, 12, 8, 10)
    got = embedding_bag(torch.as_tensor(table), torch.as_tensor(idx),
                        torch.as_tensor(w), mode="mean").numpy()
    want = np.asarray(jbag(jnp.asarray(table), jnp.asarray(idx),
                           jnp.asarray(w), mode="mean", use_kernel=False))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_max_mode_follows_the_kernel_not_the_jnp_reference():
    """The two JAX tiers differ in max mode: the Pallas kernel counts an
    item only where its weight is > 0, the jnp reference every valid item.
    A bag whose weights are all 0 answers 0 in the kernel and the row max
    in the reference; the port follows the kernel."""
    table, idx, w = _case(23, 60, 16, 5, 6, pad_frac=0.0)
    w[2] = 0.0                            # bag 2: every weight 0
    w[3, :3] = -1.0                       # bag 3: some items excluded
    got, want = _both(table, idx, w, "max")
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[2], 0.0)
    jref = np.asarray(jbag_ref(jnp.asarray(table), jnp.asarray(idx),
                               jnp.asarray(w), mode="max"))
    np.testing.assert_allclose(jref[2], table[idx[2]].max(axis=0), rtol=1e-6)
    assert np.abs(jref[2] - got[2]).max() > 0.1
    np.testing.assert_allclose(got[3], table[idx[3, 3:]].max(axis=0),
                               rtol=1e-6)
    for b in (0, 1, 4):                   # positive weights: the tiers agree
        np.testing.assert_allclose(got[b], jref[b], rtol=1e-6)


def test_ids_past_the_table_read_its_last_row():
    """Ids >= V are outside the contract; the port never reads past the
    table: it clamps to row V - 1, as XLA's gather does."""
    table, idx, _ = _case(29, 40, 8, 3, 2, pad_frac=0.0)
    idx[0, 0] = 40
    idx[1, 1] = 10 ** 6
    got = embedding_bag(torch.as_tensor(table), torch.as_tensor(idx)).numpy()
    want = np.asarray(jbag_ref(jnp.asarray(table), jnp.asarray(idx)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[0], table[39] + table[idx[0, 1]],
                               rtol=1e-6)


def test_empty_bags_and_empty_batch():
    table = torch.randn(10, 4, generator=torch.Generator().manual_seed(0))
    for mode in ("sum", "mean", "max"):
        out = embedding_bag(table, torch.zeros((3, 0), dtype=torch.int32),
                            mode=mode)
        assert torch.equal(out, torch.zeros(3, 4))
        out = embedding_bag(table, torch.zeros((0, 2), dtype=torch.int32),
                            mode=mode)
        assert tuple(out.shape) == (0, 4)


def test_wrapper_counts_calls_and_no_launch_on_cpu():
    table, idx, w = _case(31, 20, 4, 2, 3)
    dispatch.reset_counters()
    embedding_bag(torch.as_tensor(table), torch.as_tensor(idx))
    c = dispatch.counters()["embedding_bag"]
    assert (c.calls, c.launches) == (1, 0)


def test_plain_version_is_the_cpu_path():
    table, idx, w = _case(37, 90, 12, 5, 4)
    for mode in ("sum", "mean", "max"):
        a = embedding_bag(torch.as_tensor(table), torch.as_tensor(idx),
                          torch.as_tensor(w), mode=mode)
        b = ref.embedding_bag(torch.as_tensor(table), torch.as_tensor(idx),
                              torch.as_tensor(w), mode=mode)
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["mode", "table_dtype", "table_rank",
                                 "idx_dtype", "idx_rank", "weights_shape",
                                 "empty_table"])
def test_bag_refuses_bad_inputs(bad):
    table = torch.zeros(10, 4)
    idx = torch.zeros(3, 2, dtype=torch.int32)
    w, mode = None, "sum"
    if bad == "mode":
        mode = "prod"
    elif bad == "table_dtype":
        table = table.double()
    elif bad == "table_rank":
        table = table[None]
    elif bad == "idx_dtype":
        idx = idx.float()
    elif bad == "idx_rank":
        idx = idx[None]
    elif bad == "weights_shape":
        w = torch.ones(3, 3)
    else:
        table = table[:0]
    with pytest.raises((TypeError, ValueError)):
        embedding_bag(table, idx, w, mode=mode)
