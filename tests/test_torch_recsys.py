"""The port's recsys serving path against the JAX package, on the CPU.

DLRM-RM2 and xDeepFM at their smoke configs: the JAX package's parameters
(``dlrm_init`` / ``xdeepfm_init`` from a JAX key) are carried into the port
by ``convert.recsys_params_from_numpy``, and the same numpy batches go
through both.  The JAX side runs under both ``field_pool`` branches: the
gather branch (``use_kernel=False``) and the flattened Pallas kernel in
interpret mode (``use_kernel=True``, batch <= 16: it steps the grid one bag
item at a time).  The port has one branch, the plain embedding bag on CPU
tensors.  Tolerance: rtol 1e-4 / atol 1e-5 on pooled rows and logits (the
packages sum the same f32 products in other orders; the MLPs and the
interaction grow the differences).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dlrm_rm2 as jdlrm_cfg
from repro.configs import xdeepfm as jxdeepfm_cfg
from repro.data import recsys as jdata
from repro.models import recsys as jrs
from repro_torch import convert
from repro_torch.configs import dlrm_rm2, registry, xdeepfm
from repro_torch.data import recsys as tdata
from repro_torch.kernels import dispatch
from repro_torch.models import recsys as rs

jax.config.update("jax_platform_name", "cpu")

RTOL, ATOL = 1e-4, 1e-5
BRANCHES = [False, True]          # the JAX field_pool: gather, kernel


def _close(got, want):
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _ids(seed, b, f, l, v, pad_frac=0.25):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, v, (b, f, l)).astype(np.int32)
    return np.where(rng.random((b, f, l)) < pad_frac, -1, idx) \
        .astype(np.int32)


def _dlrm():
    jcfg, cfg = jdlrm_cfg.smoke_config(), dlrm_rm2.smoke_config()
    jp = jrs.dlrm_init(jax.random.key(0), jcfg)
    return jcfg, cfg, jp, convert.recsys_params_from_numpy(jp, device="cpu")


def _xdeepfm():
    jcfg, cfg = jxdeepfm_cfg.smoke_config(), xdeepfm.smoke_config()
    jp = jrs.xdeepfm_init(jax.random.key(1), jcfg)
    return jcfg, cfg, jp, convert.recsys_params_from_numpy(jp, device="cpu")


def _ctr_batch(cfg, step, b):
    spec = tdata.CTRSpec(n_dense=cfg.n_dense, n_sparse=cfg.n_sparse,
                         vocab=cfg.vocab, multi_hot=cfg.multi_hot)
    batch = tdata.CTRStream(spec).batch(step, b)
    batch["sparse"][0, 1] = -1             # a padded field
    batch["sparse"][1, 0, 0] = -1          # a padded item
    return batch


def test_configs_mirror_the_jax_package():
    for jmod, mod in ((jdlrm_cfg, dlrm_rm2), (jxdeepfm_cfg, xdeepfm)):
        for fn in ("full_config", "smoke_config"):
            a = dataclasses.asdict(getattr(jmod, fn)())
            b = dataclasses.asdict(getattr(mod, fn)())
            assert a.pop("dtype") == jnp.float32
            assert b.pop("dtype") == torch.float32
            assert a == b
        assert mod.ARCH_ID == jmod.ARCH_ID and mod.FAMILY == jmod.FAMILY


@pytest.mark.parametrize("use_kernel", BRANCHES)
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_field_pool_matches_jax(use_kernel, mode):
    rng = np.random.default_rng(3)
    tables = rng.standard_normal((5, 40, 6)).astype(np.float32)
    idx = _ids(4, 7, 5, 3, 40)
    idx[2] = -1                            # a row with every field padded
    got = rs.field_pool(torch.as_tensor(tables), torch.as_tensor(idx), mode)
    want = jrs.field_pool(jnp.asarray(tables), jnp.asarray(idx), mode,
                          use_kernel=use_kernel)
    assert tuple(got.shape) == want.shape == (7, 5, 6)
    _close(got, want)
    np.testing.assert_array_equal(got[2].numpy(), 0.0)


def test_field_pool_ids_past_vocab_clamp_within_their_field():
    """Ids >= V are outside the contract; the port clamps them to the last
    row of their own field's table, as the JAX gather branch does."""
    rng = np.random.default_rng(5)
    tables = rng.standard_normal((3, 20, 4)).astype(np.float32)
    idx = _ids(6, 4, 3, 2, 20, pad_frac=0.0)
    idx[0, 0, 0], idx[1, 1, 1], idx[2, 2, 0] = 20, 37, 10 ** 6
    got = rs.field_pool(torch.as_tensor(tables), torch.as_tensor(idx))
    want = jrs.field_pool(jnp.asarray(tables), jnp.asarray(idx))
    _close(got, want)


def test_flat_table_is_a_view_and_one_launch_per_pool():
    tables = torch.randn(4, 30, 8, generator=torch.Generator().manual_seed(0))
    flat, flat_idx = rs.flatten_fields(
        tables, torch.as_tensor(_ids(7, 5, 4, 2, 30)))
    assert flat.data_ptr() == tables.data_ptr() and flat.shape == (120, 8)
    assert flat_idx.dtype == torch.int32 and flat_idx.shape == (20, 2)
    dispatch.reset_counters()
    rs.field_pool(tables, torch.as_tensor(_ids(7, 5, 4, 2, 30)))
    assert dispatch.counters()["embedding_bag"].calls == 1


@pytest.mark.parametrize("use_kernel", BRANCHES)
def test_dlrm_logits_match_jax(use_kernel):
    jcfg, cfg, jp, tp = _dlrm()
    b = _ctr_batch(cfg, 0, 16 if use_kernel else 64)
    dispatch.reset_counters()
    got = rs.dlrm_forward(tp, torch.as_tensor(b["dense"]),
                          torch.as_tensor(b["sparse"]), cfg)
    assert dispatch.counters()["embedding_bag"].calls == 1
    want = jrs.dlrm_forward(jp, jnp.asarray(b["dense"]),
                            jnp.asarray(b["sparse"]), jcfg,
                            use_kernel=use_kernel)
    assert tuple(got.shape) == want.shape
    _close(got, want)


@pytest.mark.parametrize("use_kernel", BRANCHES)
def test_xdeepfm_logits_match_jax(use_kernel):
    jcfg, cfg, jp, tp = _xdeepfm()
    idx = _ids(8, 16 if use_kernel else 48, cfg.n_sparse, 1, cfg.vocab)
    dispatch.reset_counters()
    got = rs.xdeepfm_forward(tp, torch.as_tensor(idx), cfg)
    assert dispatch.counters()["embedding_bag"].calls == 2
    want = jrs.xdeepfm_forward(jp, jnp.asarray(idx), jcfg,
                               use_kernel=use_kernel)
    assert tuple(got.shape) == want.shape
    _close(got, want)


def test_user_towers_match_jax():
    jcfg, cfg, jp, tp = _dlrm()
    b = _ctr_batch(cfg, 1, 32)
    _close(rs.dlrm_user_tower(tp, torch.as_tensor(b["dense"]),
                              torch.as_tensor(b["sparse"]), cfg),
           jrs.dlrm_user_tower(jp, jnp.asarray(b["dense"]),
                               jnp.asarray(b["sparse"]), jcfg))
    jcfg, cfg, jp, tp = _xdeepfm()
    idx = _ids(9, 32, cfg.n_sparse, 2, cfg.vocab)
    _close(rs.xdeepfm_user_tower(tp, torch.as_tensor(idx), cfg),
           jrs.xdeepfm_user_tower(jp, jnp.asarray(idx), jcfg))


def test_interactions_take_pooled_rows_from_anywhere():
    """forward == interact(pool): the split ``chip_smoke.py`` feeds with the
    plain pooled rows on the card."""
    _, cfg, _, tp = _dlrm()
    b = _ctr_batch(cfg, 2, 24)
    dense, sparse = torch.as_tensor(b["dense"]), torch.as_tensor(b["sparse"])
    emb = rs.field_pool(tp["tables"], sparse)
    assert torch.equal(rs.dlrm_interact(tp, dense, emb, cfg),
                       rs.dlrm_forward(tp, dense, sparse, cfg))
    _, cfg, _, tp = _xdeepfm()
    idx = torch.as_tensor(_ids(10, 24, cfg.n_sparse, 1, cfg.vocab))
    x0, lin = (rs.field_pool(tp[k], idx) for k in ("tables", "linear"))
    assert torch.equal(rs.xdeepfm_interact(tp, x0, lin, cfg),
                       rs.xdeepfm_forward(tp, idx, cfg))


def test_dot_interaction_pair_order_matches_jax():
    iu, ju = torch.triu_indices(27, 27, offset=1)
    jiu, jju = jnp.triu_indices(27, k=1)
    assert len(iu) == 351
    np.testing.assert_array_equal(iu.numpy(), np.asarray(jiu))
    np.testing.assert_array_equal(ju.numpy(), np.asarray(jju))


@pytest.mark.parametrize("step", [0, 3])
def test_ctr_stream_batches_equal_jax_package(step):
    for n_sparse, multi_hot in ((26, 1), (4, 2)):
        kw = dict(n_dense=13, n_sparse=n_sparse, vocab=1_048_576,
                  multi_hot=multi_hot, seed=5)
        a = tdata.CTRStream(tdata.CTRSpec(**kw)).batch(step, 257)
        b = jdata.CTRStream(jdata.CTRSpec(**kw)).batch(step, 257)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


def test_session_stream_batches_equal_jax_package():
    a = tdata.SessionStream(1000, 20, seed=2).batch(4, 9)
    b = jdata.SessionStream(1000, 20, seed=2).batch(4, 9)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


@pytest.mark.parametrize("arch", ["dlrm-rm2", "xdeepfm"])
def test_full_config_shapes_equal_jax_eval_shape(arch):
    """The full published widths, built on the meta device: nothing is
    allocated."""
    jmod = {"dlrm-rm2": jdlrm_cfg, "xdeepfm": jxdeepfm_cfg}[arch]
    init = {"dlrm-rm2": jrs.dlrm_init, "xdeepfm": jrs.xdeepfm_init}[arch]
    model = {"dlrm-rm2": rs.DLRM, "xdeepfm": rs.XDeepFM}[arch]
    want = jax.eval_shape(lambda: init(jax.random.key(0),
                                       jmod.full_config()))
    m = model(registry.get(arch).full_config(), device="meta")
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)), m.params,
                       is_leaf=lambda x: isinstance(x, torch.Tensor))
    ref = jax.tree.map(lambda s: (tuple(s.shape), "torch." + str(s.dtype)),
                       want)
    assert got == ref
    assert all(p.device.type == "meta" and not p.requires_grad
               for p in m.parameters())


def test_modules_on_cpu_match_the_functions():
    gen = torch.Generator().manual_seed(0)
    cfg = dlrm_rm2.smoke_config()
    m = rs.DLRM(cfg, device="cpu", generator=gen)
    std = float(m.tables.std())
    assert abs(std - cfg.embed_dim ** -0.5) < 0.05 * cfg.embed_dim ** -0.5
    b = _ctr_batch(cfg, 0, 12)
    assert torch.equal(m(b["dense"], b["sparse"]),
                       rs.dlrm_forward(m.params, torch.as_tensor(b["dense"]),
                                       torch.as_tensor(b["sparse"]), cfg))
    assert m.user_tower(b["dense"], b["sparse"]).shape == (12, cfg.embed_dim)
    cfg = xdeepfm.smoke_config()
    x = rs.XDeepFM(cfg, device="cpu", generator=gen)
    idx = _ids(11, 12, cfg.n_sparse, 1, cfg.vocab)
    assert torch.equal(x(idx), rs.xdeepfm_forward(x.params,
                                                  torch.as_tensor(idx), cfg))
    assert x.user_tower(idx).shape == (12, cfg.embed_dim)
    # the module's tree carries to numpy and back unchanged
    tree = convert.recsys_params_to_numpy(x.params)
    back = convert.recsys_params_from_numpy(tree, device="cpu")
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b.numpy()),
                 tree, back)


def test_models_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: rs.DLRM(dlrm_rm2.smoke_config()),
                 lambda: rs.XDeepFM(xdeepfm.smoke_config()),
                 lambda: convert.recsys_params_from_numpy({"w": np.ones(2)})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_registry_serves_ported_archs_and_names_the_rest():
    """Every arch of the JAX package's registry resolves in the port, to
    its own config module; an unknown arch is a KeyError."""
    from repro.configs import registry as jregistry

    assert registry.get("dlrm-rm2") is dlrm_rm2
    assert registry.get("xdeepfm") is xdeepfm
    assert set(registry.PORTED) == set(jregistry._MODULES)
    for arch in jregistry._MODULES:
        mod = registry.get(arch)
        assert mod.ARCH_ID == arch and mod.__name__.startswith("repro_torch.")
        assert mod.FAMILY == jregistry.get(arch).FAMILY
    with pytest.raises(KeyError):
        registry.get("nope")
    assert registry.RECSYS_SHAPES["serve_p99"]["batch"] == 512
    assert registry.RECSYS_SHAPES["serve_bulk"]["batch"] == 262144
    assert registry.RECSYS_SHAPES["retrieval_cand"] == dict(
        kind="retrieval", batch=1, n_candidates=1_000_000)
