"""The port's distributed layer against the JAX package's ``repro.dist``, on
the CPU.

Each ``tests/test_dist.py`` test has its counterpart here (but
``test_cells_build_on_host_mesh``: ``launch/cells`` is not ported).  The
JAX side runs in the pytest process on conftest's 8 host devices; the
port side runs in worlds of 1, 2, 4 and 8 gloo ranks
(``repro_torch.launch.hostdevices.run_ranks``, the rank bodies in
``test_torch_dist_ranks.py``), and rank 0's numpy results come back.
Inputs are made from seeds with numpy, the same on both sides.

The JAX meshes here are made with ``AxisType.Auto`` axes: the installed
jax's ``jax.make_mesh`` defaults to ``Explicit`` ones, on which
``with_sharding_constraint`` refuses a spec ("can only refer to Auto
axes of the mesh"); that is why three ``test_dist.py`` tests fail, and
the reference's behaviour on an Auto mesh is what the port is held to.

Bars: specs and rules equal leaf for leaf (a port ``MeshShape`` against a
JAX mesh of the same axes); every rank's block of a ``constrain``ed or
placed tensor equal to the block JAX puts on the device at the same mesh
coordinate; ``sharded_nn``, ``MetricIndex(sharded=True)`` and the batched
scorer's ids equal to JAX's and to ``exact_nn``, scores within rtol 1e-6;
bf16 / int8 corpora at the quantization floors (rank overlap >= 0.95 /
0.90 with fp32); the STAR forward under rules within 1e-4 of JAX's and
1e-5 of the port's unsharded forward, EGNN's under the GNN rules alike
(its tests' rtol / atol 1e-4 against JAX); a ``grad_shardings`` step within
``train.parity``'s bars of the unsharded step; a checkpoint written by 2
ranks restored onto 1 and back (and by the JAX package) with equal full
tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

import test_torch_dist_ranks as ranks
from repro.checkpoint import manager as jckpt
from repro.configs import egnn as jegnn_cfg
from repro.configs import registry as jregistry
from repro.core import embedding as jemb
from repro.core.metric_index import MetricIndex as JIndex
from repro.core.metric_index import exact_nn as jexact_nn
from repro.dist import api as japi
from repro.dist import retrieval as jdr
from repro.dist import sharding as jshd
from repro.models import egnn as jegnn
from repro.models import transformer as jtf
from repro.serve.router import ShardedRouter as JRouter
from repro.train import optimizer as jopt
from repro_torch.configs import registry
from repro_torch.core.metric_index import MetricIndex
from repro_torch.data import graph as egraph
from repro_torch.dist import api
from repro_torch.dist import retrieval as dr
from repro_torch.dist import sharding as shd
from repro_torch.dist.api import MeshShape, P
from repro_torch.launch.hostdevices import run_ranks
from repro_torch.models import transformer as tf
from repro_torch.serve.router import ShardedRouter
from repro_torch.train import optimizer as topt
from repro_torch.train import parity, tree

jax.config.update("jax_platform_name", "cpu")

MESHES = {"model8": ((8,), ("model",)),
          "data2_model4": ((2, 4), ("data", "model")),
          "pod2_data2_model2": ((2, 2, 2), ("pod", "data", "model"))}


def _jmesh(shape, names):
    n = int(np.prod(shape))
    return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(
        shape), devices=jax.devices()[:n])


def _jshards(arr, mesh):
    """{mesh coordinate: the block of ``arr`` on that device}."""
    by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    return {idx: by_dev[d] for idx, d in np.ndenumerate(mesh.devices)}


def _rank(idx, shape):
    """The port's rank at a mesh coordinate (``init_device_mesh`` lays
    ranks out row-major)."""
    return int(np.ravel_multi_index(idx, shape))


def _jkey(path) -> str:
    return "|".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _jspec_dict(specs) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))
    return {_jkey(p): tuple(s) for p, s in flat}


def _spec_dict(specs) -> dict:
    return {tree.path_key(p): tuple(s)
            for p, s in tree.leaves_with_path(specs)}


@pytest.fixture(scope="module")
def world8():
    return run_ranks(ranks.world8, 8, timeout=120)


# ----------------------------------------------------------------- dist.api

def test_multi_device_topology(world8):
    """8 JAX host devices here; 8 gloo ranks on the port's side."""
    assert jax.device_count() >= 8
    assert len(world8["api"]["y_blocks"]) == 8


def test_constrain_identity_without_context():
    x = torch.ones(4, 8)
    assert api.constrain(x, "act_bsd") is x
    assert api.active_mesh() is None and api.active_rules() == {}
    jx = jnp.ones((4, 8))
    assert japi.constrain(jx, "act_bsd") is jx
    # a plain tensor inside a context is the identity too
    mesh = MeshShape(("data", "model"), (2, 4))
    with api.sharding_rules(mesh, {"act_bsd": P("data", None, "model")}):
        assert api.active_mesh() is mesh
        assert api.constrain(x, "act_bsd") is x
    assert api.active_mesh() is None


def test_sharding_rules_context_applies_and_fits(world8):
    got = world8["api"]
    shape = (2, 4)
    mesh = _jmesh(shape, ("data", "model"))
    rules = {"act_bsd": JP("data", None, "model")}
    x = np.arange(4 * 8 * 16, dtype=np.float32).reshape(4, 8, 16)
    with japi.sharding_rules(mesh, rules):
        y = jax.jit(lambda a: japi.constrain(a, "act_bsd"))(jnp.asarray(x))
        z = jax.jit(lambda a: japi.constrain(a, "act_bsd"))(
            jnp.zeros((3, 8, 6)))
    assert y.addressable_shards[0].data.shape == (2, 8, 4)
    for idx, block in _jshards(y, mesh).items():
        np.testing.assert_array_equal(got["y_blocks"][_rank(idx, shape)],
                                      block)
    np.testing.assert_array_equal(got["y_full"], x)
    # non-divisible dims: the offending axes dropped, no error
    assert got["z_shape"] == got["z_local"] == z.shape == (3, 8, 6)
    assert got["identity"] and got["active_inside"] and got["active_after"]


@pytest.mark.parametrize("case", ["tuple_blocks", "two_dim_blocks",
                                  "cube_blocks"])
def test_placements_put_the_blocks_jax_puts(world8, case):
    """``to_placements``: a tuple entry splits one dim over several axes,
    the first the major one, as JAX orders the blocks."""
    t = np.arange(16 * 6, dtype=np.float32).reshape(16, 6)
    shape, names, spec, arr = {
        "tuple_blocks": ((2, 4), ("data", "model"),
                         JP(("data", "model"), None), t),
        "two_dim_blocks": ((2, 4), ("data", "model"), JP("model", "data"),
                           t[:8, :4]),
        "cube_blocks": ((2, 2, 2), ("pod", "data", "model"),
                        JP(("pod", "data"), "model"), t),
    }[case]
    mesh = _jmesh(shape, names)
    placed = jax.device_put(arr, JNamedSharding(mesh, spec))
    for idx, block in _jshards(placed, mesh).items():
        np.testing.assert_array_equal(world8["api"][case][_rank(idx, shape)],
                                      block)


def test_to_placements_refuses_axes_out_of_mesh_order():
    mesh = MeshShape(("data", "model"), (2, 4))
    with pytest.raises(ValueError, match="not in mesh order"):
        api.to_placements(P(("model", "data")), mesh)


def test_fit_spec_pads_and_drops():
    mesh = MeshShape(("data", "model"), (2, 4))
    jmesh = _jmesh((2, 4), ("data", "model"))
    for spec, shape in ((("data",), (6, 7)), (("data", "model"), (6, 7)),
                        (("data", None, None), (6,)),
                        ((("data", "model"), None), (16, 3))):
        got = api.fit_spec(P(*spec), shape, mesh)
        want = japi.fit_spec(JP(*spec), shape, jmesh)
        assert (got is None) == (want is None)
        if want is not None:
            assert tuple(got) == tuple(want)
    assert tuple(api.fit_spec(P("data"), (6, 7), mesh)) == ("data", None)
    assert api.fit_spec(P("data", None, None), (6,), mesh) is None
    assert api.data_axes(mesh) == japi.data_axes(jmesh) == ("data",)


# ------------------------------------------------------------ dist.sharding

def _shapes(arch, full):
    jmod, tmod = jregistry.get(arch), registry.get(arch)
    jcfg = jmod.full_config() if full else jmod.smoke_config()
    cfg = tmod.full_config() if full else tmod.smoke_config()
    jshapes = jax.eval_shape(lambda: jtf.init_params(jax.random.key(0), jcfg))
    return jshapes, tf.init_params(cfg, device="meta"), cfg


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,full", [("star-encoder", True),
                                       ("deepseek-v3-671b", False)])
def test_param_specs_full_rank_and_divisible(arch, full, mesh_name):
    shape, names = MESHES[mesh_name]
    jshapes, shapes, _cfg = _shapes(arch, full)
    jmesh, mesh = _jmesh(shape, names), MeshShape(names, shape)
    specs = shd.param_specs(shapes, mesh)
    want = _jspec_dict(jshd.param_specs(jshapes, jmesh))
    got = _spec_dict(specs)
    assert got == want
    n_sharded = 0
    for (_path, leaf), (_p, spec) in zip(tree.leaves_with_path(shapes),
                                         tree.leaves_with_path(specs)):
        assert isinstance(spec, P) and len(spec) == leaf.dim()
        assert tuple(api.fit_spec(spec, tuple(leaf.shape), mesh)) == spec
        n_sharded += any(e is not None for e in spec)
    assert n_sharded > 0


def test_param_specs_moe_expert_parallel():
    jshapes, shapes, cfg = _shapes("deepseek-v3-671b", False)
    mesh = MeshShape(("data", "model"), (2, 4))
    specs = shd.param_specs(shapes, mesh, min_shard_size=1)
    assert _spec_dict(specs) == _jspec_dict(jshd.param_specs(
        jshapes, _jmesh((2, 4), ("data", "model")), min_shard_size=1))
    for gname, group in specs.items():
        if "moe" in gname:
            wi = group["ffn"]["wi"]           # (layers, E, d, 2ff)
            assert wi[1] == ("model" if cfg.moe.n_experts % 4 == 0
                             else None)


def test_param_specs_need_a_model_axis_in_both():
    """Both packages' heuristic names "model" whatever the mesh: a mesh
    without that axis raises the same ``KeyError``."""
    jshapes, shapes, _cfg = _shapes("star-encoder", False)
    with pytest.raises(KeyError, match="model"):
        jshd.param_specs(jshapes, _jmesh((8,), ("data",)), min_shard_size=1)
    with pytest.raises(KeyError, match="model"):
        shd.param_specs(shapes, MeshShape(("data",), (8,)), min_shard_size=1)


def test_lm_activation_rules_cover_all_constrain_names():
    mesh = MeshShape(("data", "model"), (2, 4))
    jmesh = _jmesh((2, 4), ("data", "model"))
    names = ("act_bsd", "act_bsf", "act_bshd", "act_bskd", "attn_scores",
             "kv_cache", "mla_cache", "mla_cache_r", "logits", "moe_buf",
             "moe_hidden", "moe_out", "act_bfd")
    for arch in ("gemma2-9b", "deepseek-v3-671b"):
        cfg = registry.get(arch).full_config()
        jcfg = jregistry.get(arch).full_config()
        for kind in ("train", "decode"):
            rules = shd.lm_activation_rules(mesh, cfg, kind)
            want = jshd.lm_activation_rules(jmesh, jcfg, kind)
            assert set(names) <= set(rules)
            assert {k: tuple(v) for k, v in rules.items()} == \
                {k: tuple(v) for k, v in want.items()}

    class Dummy:     # the recsys stub of launch/cells
        n_heads = 1
        n_kv_heads = 1
        attention = "gqa"

    rules = shd.lm_activation_rules(mesh, Dummy(), "train")
    assert rules["act_bshd"][2] is None      # 1 head cannot split 4 ways
    assert tuple(rules["act_bshd"]) == tuple(
        jshd.lm_activation_rules(jmesh, Dummy(), "train")["act_bshd"])


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_gnn_activation_rules_match_jax(mesh_name):
    shape, names = MESHES[mesh_name]
    got = shd.gnn_activation_rules(MeshShape(names, shape))
    want = jshd.gnn_activation_rules(_jmesh(shape, names))
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in want.items()}


def _egnn_case():
    """EGNN's smoke config on a 64-node, 256-edge graph (the JAX
    package's parameters)."""
    jcfg = jegnn_cfg.smoke_config()
    jp = jegnn.init_params(jax.random.key(4), jcfg)
    g = egraph.random_graph(2, 64, 256, jcfg.d_feat_in, jcfg.n_classes)
    return jcfg, jp, (np.asarray(g.node_feat, np.float32),
                      np.asarray(g.coords, np.float32),
                      np.asarray(g.edge_index, np.int32))


@pytest.fixture(scope="module")
def world4():
    jcfg = jregistry.get("star-encoder").smoke_config()
    jp = jtf.init_params(jax.random.key(0), jcfg)
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (4, 16)).astype(np.int32)
    _ecfg, ejp, graph = _egnn_case()
    got = run_ranks(ranks.forward_world4, 4, jax.tree.map(np.asarray, jp),
                    tokens, (jax.tree.map(np.asarray, ejp), *graph),
                    timeout=150)
    return got, jcfg, jp, tokens


def test_forward_under_sharding_rules_matches_unsharded(world4):
    got, jcfg, jp, tokens = world4
    ref = jtf.forward(jp, jnp.asarray(tokens), jcfg, remat="none")[0]
    mesh = _jmesh((2, 2), ("data", "model"))
    with japi.sharding_rules(mesh, jshd.lm_activation_rules(mesh, jcfg,
                                                            "train")):
        jout = jax.jit(lambda p, t: jtf.forward(p, t, jcfg, remat="none")[0])(
            jp, jnp.asarray(tokens))
    np.testing.assert_allclose(np.asarray(ref), np.asarray(jout), atol=1e-4)
    np.testing.assert_allclose(got["sharded"], np.asarray(jout), atol=1e-4)
    np.testing.assert_allclose(got["sharded"], got["plain"], atol=1e-5)
    # logits are P(data, None, model); the table is vocab-parallel
    assert got["placements"] == [("Shard", 0), ("Shard", 2)]
    assert got["embed"] == [("Replicate", None), ("Shard", 0)]


def test_egnn_under_gnn_rules_matches_jax(world4):
    """Edges and nodes over the whole (2, 2) mesh (ROADMAP 13f trains
    ``ogb_products`` this way): logits and coordinates within the EGNN
    tests' 1e-4 of JAX's under the same rules, 1e-5 of the port's
    unsharded forward."""
    got = world4[0]
    jcfg, jp, (feat, coords, edges) = _egnn_case()
    mesh = _jmesh((2, 2), ("data", "model"))
    with japi.sharding_rules(mesh, jshd.gnn_activation_rules(mesh)):
        want = jax.jit(lambda p, f, c, e: jegnn.forward(p, f, c, e, jcfg))(
            jp, jnp.asarray(feat), jnp.asarray(coords), jnp.asarray(edges))
    for a, b, c in zip(got["egnn_sharded"], want, got["egnn_plain"]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(a, c, atol=1e-5)


# ----------------------------------------------------------- dist.retrieval

def _jcorpus(n, dim, seed=0, n_dup=0):
    phi, q = ranks.corpus(n, dim, seed, n_dup)
    docs, _ = jemb.transform_documents(jnp.asarray(phi))
    return docs, jnp.arange(n, dtype=jnp.int32), jemb.transform_queries(
        jnp.asarray(q))


@pytest.mark.parametrize("n", [4096, 5003])
def test_sharded_nn_bit_identical_to_exact(world8, n):
    got = world8["retrieval"]
    docs, ids, q = _jcorpus(n, 32, n_dup=16)
    ref = jexact_nn(docs, ids, q, 25)
    np.testing.assert_array_equal(got[(n, "exact")][0], np.asarray(ref.ids))
    for name in ("flat", "shard8", "data2_model4"):
        g_ids, g_scores, g_dist = got[(n, name)]
        np.testing.assert_array_equal(g_ids, np.asarray(ref.ids))
        np.testing.assert_allclose(g_scores, np.asarray(ref.scores),
                                   rtol=1e-6)
        assert (np.diff(g_dist, axis=1) >= -1e-6).all()
        shape, names = ((8,), ("shard",)) if name != "data2_model4" else \
            ((2, 4), ("data", "model"))
        j = jdr.sharded_nn(docs, ids, q, 25, mesh=_jmesh(shape, names),
                           chunk=512)
        np.testing.assert_array_equal(g_ids, np.asarray(j.ids))


def test_sharded_nn_k_larger_than_shard(world8):
    """k = 120 over 300 documents on 8 ranks (38 rows a slice)."""
    got = world8["retrieval"]
    docs, ids, q = _jcorpus(300, 16, seed=3)
    ref = jexact_nn(docs, ids, q, 120)
    np.testing.assert_array_equal(got["k120"], np.asarray(ref.ids))
    np.testing.assert_array_equal(got["k120_exact"], np.asarray(ref.ids))
    j = jdr.sharded_nn(docs, ids, q, 120, chunk=64)
    np.testing.assert_array_equal(got["k120"], np.asarray(j.ids))
    assert got["k120_calls"] == 1           # one scan_topk a rank


def _index_case():
    rng = np.random.default_rng(7)
    raw = rng.standard_normal((3000, 48)).astype(np.float32)
    return raw, rng.standard_normal((4, 48)).astype(np.float32)


def test_metric_index_sharded_path_matches_local(world8):
    got = world8["retrieval"]
    raw, q = _index_case()
    local = JIndex(jnp.asarray(raw), chunk=256)
    shard = JIndex(jnp.asarray(raw), chunk=256, sharded=True)
    jq = local.transform_queries(jnp.asarray(q))
    a = np.asarray(local.search(jq, 30).ids)
    np.testing.assert_array_equal(a, np.asarray(shard.search(jq, 30).ids))
    np.testing.assert_array_equal(got["mi_local"], a)
    np.testing.assert_array_equal(got[("mi", "fp32")], a)
    assert got[("mi_rows", "fp32")][0] == 375      # 3000 rows / 8 ranks
    # 1-D query convenience path
    assert got["mi_1d"] == (1, 10)


@pytest.mark.parametrize("dtype,floor", [("bf16", 0.95), ("int8", 0.90)])
def test_sharded_quantized_corpora_keep_the_floors(world8, dtype, floor):
    got = world8["retrieval"]
    ref = got["mi_local"]

    def overlap(a):
        return np.mean([len(set(x) & set(y)) / len(y) for x, y in zip(a, ref)])

    assert overlap(got[("mi", dtype)]) >= floor
    assert overlap(got[("mi_local", dtype)]) >= floor
    # every slice scores the same documents as the local index
    assert np.mean([len(set(x) & set(y)) / len(y) for x, y in zip(
        got[("mi", dtype)], got[("mi_local", dtype)])]) >= 0.99


def test_batched_scorer_masks_and_matches_reference(world8):
    got = world8["retrieval"]
    table, q = ranks.scorer_inputs()
    mesh = _jmesh((2, 4), ("data", "model"))
    scorer = jdr.make_batched_scorer(mesh, k=10, table_axes=("model",),
                                     batch_axes=("data",))
    j_scores, j_idx = jax.jit(lambda a, b: scorer(a, b, n_valid=300))(
        jnp.asarray(q), jnp.asarray(table))
    ref = (q @ table.T)[:, :300]
    ref_idx = np.argsort(-ref, axis=1)[:, :10]
    np.testing.assert_array_equal(np.asarray(j_idx), ref_idx)
    s, i = got["scorer"]
    np.testing.assert_array_equal(i, ref_idx)
    np.testing.assert_array_equal(i, np.asarray(j_idx))
    assert int(i.max()) < 300
    np.testing.assert_allclose(s, np.take_along_axis(ref, ref_idx, 1),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s, np.asarray(j_scores), rtol=1e-5, atol=1e-5)
    assert got["scorer_calls"] == 1          # each rank's block: one scan
    for a, b in zip(got["scorer_placed"], got["scorer"]):
        np.testing.assert_array_equal(a, b)  # a table laid out already
    s, i = got["scorer_every"]               # rows over both axes, no mask
    np.testing.assert_array_equal(
        i, np.argsort(-(q @ table.T), axis=1, kind="stable")[:, :10])


def test_sharded_nn_refuses_without_a_process_group():
    docs = torch.eye(4)
    with pytest.raises(RuntimeError, match="init_process_group"):
        dr.sharded_nn(docs, torch.arange(4), docs[:1], 2)


def test_device_shards_front_the_router():
    rng = np.random.default_rng(5)
    raw = rng.standard_normal((2000, 32)).astype(np.float32)
    q = rng.standard_normal((3, 32)).astype(np.float32)
    jindex = JIndex(jnp.asarray(raw))
    index = MetricIndex(raw, device="cpu")
    shards = dr.make_device_shards(index.doc_emb, index.doc_ids,
                                   devices=["cpu"] * 8)
    assert [s.n_docs for s in shards] == [250] * 8
    tq = index.transform_queries(torch.as_tensor(q)).numpy()
    with ShardedRouter(shards, deadline_s=30) as router:
        ans, degraded = router.search(tq, 15)
    assert not degraded
    np.testing.assert_array_equal(ans.ids, index.search(tq, 15).ids.numpy())
    jshards = jdr.make_device_shards(jindex.doc_emb, jindex.doc_ids)
    jq = np.asarray(jindex.transform_queries(jnp.asarray(q)))
    jans, _ = JRouter(jshards, deadline_s=30).search(jq, 15)
    np.testing.assert_array_equal(ans.ids, jans.ids)


def test_router_over_devices_constructor():
    rng = np.random.default_rng(9)
    raw = rng.standard_normal((500, 16)).astype(np.float32)
    q = rng.standard_normal((2, 16)).astype(np.float32)
    index = MetricIndex(raw, device="cpu")
    tq = index.transform_queries(torch.as_tensor(q)).numpy()
    with ShardedRouter.over_devices(index.doc_emb, index.doc_ids,
                                    devices=["cpu"] * 4,
                                    deadline_s=30) as router:
        ans, degraded = router.search(tq, 10)
    assert not degraded and ans.ids.shape == (2, 10)
    np.testing.assert_array_equal(ans.ids, index.search(tq, 10).ids.numpy())
    jindex = JIndex(jnp.asarray(raw))
    jans, _ = JRouter.over_devices(jindex.doc_emb, jindex.doc_ids,
                                   deadline_s=30).search(
        np.asarray(jindex.transform_queries(jnp.asarray(q))), 10)
    np.testing.assert_array_equal(ans.ids, jans.ids)


# ------------------------------------- optimizer state, step, checkpoint

@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_state_spec_matches_jax(name):
    jshapes, shapes, _cfg = _shapes("star-encoder", True)
    mesh = MeshShape(("data", "model"), (2, 4))
    jmesh = _jmesh((2, 4), ("data", "model"))
    specs = shd.param_specs(shapes, mesh)
    jspecs = jshd.param_specs(jshapes, jmesh)
    got = getattr(topt, name)().state_spec(shapes, specs)
    want = getattr(jopt, name)().state_spec(jshapes, jspecs)
    assert _spec_dict(got) == _jspec_dict(want)
    assert got.step == P()
    if name == "adafactor":         # factored moments drop an entry
        wq = specs["group0_dense"]["attn"]["wq"]
        vq = got.inner["v"]["group0_dense"]["attn"]["wq"]
        assert (vq["vr"], vq["vc"]) == (P(*wq[:-1]), P(*(wq[:-2] + wq[-1:])))


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("elastic"))


@pytest.fixture(scope="module")
def trained(ckpt_dir):
    return run_ranks(ranks.train_world2, 2, ckpt_dir, timeout=120)


def test_grad_shardings_step_matches_unsharded(trained):
    """AdamW, 2 microbatches, the parameters FSDP-split over "data" on a
    (2, 1) mesh; gradients pinned to the parameters' layouts."""
    parity.assert_steps_agree(trained["ref"], trained["got"],
                              "grad_shardings step")
    assert ("Shard", 1) in [p[0] for p in trained["param_placements"]]


def test_elastic_restore_from_two_ranks_onto_one_and_back(trained,
                                                          ckpt_dir):
    saved = trained["saved"]
    one = run_ranks(ranks.restore_world, 1, ckpt_dir, 1, 2, timeout=120)
    assert one["local_shapes"] == one["global_shapes"]
    two = run_ranks(ranks.restore_world, 2, ckpt_dir, 2, None, timeout=120)
    assert two["local_shapes"] != two["global_shapes"]
    for got in (one["leaves"], two["leaves"]):
        assert len(got) == len(saved)
        for a, b in zip(got, saved):
            np.testing.assert_array_equal(a, b)
    # the JAX package's elastic restore reads the 2-rank checkpoint alike
    jcfg = jregistry.get("star-encoder").smoke_config()
    jp = jtf.init_params(jax.random.key(0), jcfg)
    opt = jopt.adamw()
    template = {"params": jp, "opt": opt.init(jp)}
    jmesh = _jmesh((2, 1), ("data", "model"))
    pspecs = jshd.param_specs(jp, jmesh, min_shard_size=1)
    specs = {"params": pspecs, "opt": opt.state_spec(jp, pspecs)}
    shardings = jax.tree.map(lambda s: JNamedSharding(jmesh, s), specs,
                             is_leaf=lambda x: isinstance(x, JP))
    out = jckpt.restore_tree(template, ckpt_dir, 1, shardings)
    for a, b in zip(jax.tree.leaves(out), saved):
        np.testing.assert_array_equal(np.asarray(a), b)
