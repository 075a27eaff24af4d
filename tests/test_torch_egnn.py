"""The port's EGNN and graph data against the JAX package, on the CPU.

``data.graph`` is a copy of the JAX package's numpy module: the same seed
(or the same ``rng``) gives equal arrays.  The forward at the smoke config
(and with an edge feature) takes the JAX package's parameters, carried
across by ``convert.egnn_params_from_numpy``, and the same numpy graphs:
node readout on a random graph, graph readout on batched molecules, a
sampled block with -1 pads over its host graph.  Logits and coordinates
agree within 1e-4 (four layers of f32 sums in other orders, and the
port's segment sums in a fixed order of their own); a rotation and
translation leave the logits and move the coordinates within 2e-4, the
JAX package's own bound (``tests/test_arch_smoke.py``).  ``SegmentPlan``
is the port's ``jax.ops.segment_sum``: chunked sums equal the one-chunk
sum within f32 tolerance, and one chunk size gives equal bits every run.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import egnn as jegnn_cfg
from repro.data import graph as jgraph
from repro.models import egnn as jegnn
from repro_torch import convert
from repro_torch.configs import egnn as egnn_cfg
from repro_torch.configs import registry
from repro_torch.data import graph
from repro_torch.models import egnn

jax.config.update("jax_platform_name", "cpu")

TOL, EQUI_TOL = 1e-4, 2e-4


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want),
                               rtol=tol, atol=tol)


def _params(cfg_port, cfg_jax, seed=0):
    jp = jegnn.init_params(jax.random.key(seed), cfg_jax)
    return jp, convert.egnn_params_from_numpy(jp, device="cpu")


def _pair(**kw):
    return (dataclasses.replace(egnn_cfg.smoke_config(), **kw),
            dataclasses.replace(jegnn_cfg.smoke_config(), **kw))


def _both(jp, tp, jcfg, cfg, feat, coords, edges, **kw):
    got = egnn.forward(tp, torch.as_tensor(feat), torch.as_tensor(coords),
                       torch.as_tensor(edges), cfg,
                       **{k: (torch.as_tensor(v) if isinstance(v, np.ndarray)
                              else v) for k, v in kw.items()})
    want = jegnn.forward(jp, jnp.asarray(feat), jnp.asarray(coords),
                         jnp.asarray(edges), jcfg,
                         **{k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                                else v) for k, v in kw.items()})
    return got, want


def test_configs_mirror_the_jax_package():
    assert egnn_cfg.SHAPES == jegnn_cfg.SHAPES
    for cfg, jcfg in ((egnn_cfg.smoke_config(), jegnn_cfg.smoke_config()),
                      (egnn_cfg.full_config(602, "graph"),
                       jegnn_cfg.full_config(602, "graph")),
                      (egnn_cfg.full_config(), jegnn_cfg.full_config())):
        a, b = dataclasses.asdict(jcfg), dataclasses.asdict(cfg)
        assert a.pop("dtype") == jnp.float32
        assert b.pop("dtype") == torch.float32
        assert a == b
    assert egnn_cfg.ARCH_ID == jegnn_cfg.ARCH_ID
    assert egnn_cfg.FAMILY == jegnn_cfg.FAMILY == "gnn"
    assert registry.get("egnn") is egnn_cfg


def _equal_arrays(a, b):
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_generators_and_sampler_equal_the_jax_package():
    for seed in (0, 5):
        a = graph.random_graph(seed, 300, 2000, 12)
        b = jgraph.random_graph(seed, 300, 2000, 12)
        for f in ("node_feat", "coords", "edge_index", "labels"):
            _equal_arrays(getattr(a, f), getattr(b, f))
        for x, y in zip(graph.batched_molecules(seed, 4, 6, 10, 8),
                        jgraph.batched_molecules(seed, 4, 6, 10, 8)):
            _equal_arrays(x, y)
        sa = graph.NeighborSampler(a.edge_index, 300)
        sb = jgraph.NeighborSampler(b.edge_index, 300)
        _equal_arrays(sa.nbr, sb.nbr)
        _equal_arrays(sa.ptr, sb.ptr)
        seeds = np.arange(0, 300, 7)
        _equal_arrays(sa.sample(seeds, (5, 3), np.random.default_rng(seed)),
                      sb.sample(seeds, (5, 3), np.random.default_rng(seed)))


def test_node_readout_matches_jax():
    cfg, jcfg = _pair()
    jp, tp = _params(cfg, jcfg)
    g = graph.random_graph(1, 120, 700, cfg.d_feat_in)
    (lg, xg), (lw, xw) = _both(jp, tp, jcfg, cfg, g.node_feat, g.coords,
                               g.edge_index)
    assert tuple(lg.shape) == lw.shape == (120, cfg.n_classes)
    _close(lg, lw)
    _close(xg, xw)


def test_graph_readout_matches_jax():
    cfg, jcfg = _pair(readout="graph")
    jp, tp = _params(cfg, jcfg, seed=1)
    feat, coords, edges, gids, _ = graph.batched_molecules(
        2, 6, 9, 20, cfg.d_feat_in, cfg.n_classes)
    (lg, xg), (lw, xw) = _both(jp, tp, jcfg, cfg, feat, coords, edges,
                               graph_ids=gids, n_graphs=6)
    assert tuple(lg.shape) == lw.shape == (6, cfg.n_classes)
    _close(lg, lw)
    _close(xg, xw)


def test_sampled_block_with_pads_matches_jax():
    """A fixed-size block from ``NeighborSampler`` (src = dst = -1 pads,
    which the JAX package maps to node 0 with zero weight) over its host
    graph's nodes."""
    cfg, jcfg = _pair()
    jp, tp = _params(cfg, jcfg, seed=2)
    g = graph.random_graph(3, 400, 1500, cfg.d_feat_in)
    block = graph.NeighborSampler(g.edge_index, 400).sample(
        np.arange(24), (6, 4), np.random.default_rng(0))
    assert (block[0] < 0).any() and (block[0] >= 0).any()
    (lg, xg), (lw, xw) = _both(jp, tp, jcfg, cfg, g.node_feat, g.coords,
                               block)
    _close(lg, lw)
    _close(xg, xw)


def test_edge_features_match_jax():
    cfg, jcfg = _pair(d_edge=3)
    jp, tp = _params(cfg, jcfg, seed=3)
    g = graph.random_graph(4, 90, 500, cfg.d_feat_in)
    attr = np.random.default_rng(4).standard_normal((500, 3)) \
        .astype(np.float32)
    (lg, xg), (lw, xw) = _both(jp, tp, jcfg, cfg, g.node_feat, g.coords,
                               g.edge_index, edge_attr=attr)
    _close(lg, lw)
    _close(xg, xw)


def test_rotation_and_translation_are_equivariant():
    cfg, jcfg = _pair(readout="graph")
    _jp, tp = _params(cfg, jcfg)
    feat, coords, edges, gids, _ = graph.batched_molecules(
        0, 4, 6, 10, cfg.d_feat_in, cfg.n_classes)
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    t = rng.standard_normal(3)
    kw = dict(graph_ids=torch.as_tensor(gids), n_graphs=4)
    l1, x1 = egnn.forward(tp, feat, coords, edges, cfg, **kw)
    l2, x2 = egnn.forward(tp, feat, (coords @ q.T + t).astype(np.float32),
                          edges, cfg, **kw)
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), atol=EQUI_TOL)
    np.testing.assert_allclose(x1.numpy() @ q.T + t, x2.numpy(),
                               atol=EQUI_TOL)


def _segments(seed, n_rows, n_seg, width=5):
    rng = np.random.default_rng(seed)
    index = rng.integers(0, n_seg, n_rows)
    keep = rng.random(n_rows) < 0.8
    vals = rng.standard_normal((n_rows, width)).astype(np.float32)
    want = np.zeros((n_seg, width), np.float64)
    np.add.at(want, index[keep], vals[keep].astype(np.float64))
    return (torch.as_tensor(index), torch.as_tensor(keep),
            torch.as_tensor(vals), want)


@pytest.mark.parametrize("chunk", [1, 7, 64, 10 ** 6])
def test_segment_plan_sums_in_a_fixed_order(chunk):
    index, keep, vals, want = _segments(0, 900, 37)
    plan = egnn.SegmentPlan(index, 37, keep=keep, chunk=chunk)
    got = plan.sum(vals)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    whole = egnn.SegmentPlan(index, 37, keep=keep, chunk=10 ** 6).sum(vals)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-5)
    # the same chunk size, the same bits; integer counts exact
    again = egnn.SegmentPlan(index, 37, keep=keep, chunk=chunk).sum(vals)
    assert torch.equal(got, again)
    np.testing.assert_array_equal(
        plan.counts.numpy(), np.bincount(index[keep].numpy(), minlength=37))
    assert len(plan.chunks) == -(-int(keep.sum()) // chunk)


def test_segment_plan_of_no_rows_sums_to_zero():
    plan = egnn.SegmentPlan(torch.zeros(4, dtype=torch.int64), 3,
                            keep=torch.zeros(4, dtype=torch.bool))
    assert plan.chunks == [] and not plan.sum(torch.ones(4, 2)).any()


def test_edge_chunks_that_split_destination_runs():
    """A chunk smaller than a destination's run of edges: the forward
    within f32 tolerance of the one-chunk forward, the same bits on two
    runs."""
    cfg, jcfg = _pair()
    _jp, tp = _params(cfg, jcfg)
    g = graph.random_graph(5, 60, 900, cfg.d_feat_in)
    plans = [egnn.prepare(torch.as_tensor(g.edge_index), 60, edge_chunk=c)
             for c in (10 ** 6, 13)]
    assert int(plans[0].edges.counts.max()) > 13
    one, split = (egnn.forward(tp, g.node_feat, g.coords, g.edge_index, cfg,
                               plan=p) for p in plans)
    for a, b in zip(one, split):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
    again = egnn.forward(tp, g.node_feat, g.coords, g.edge_index, cfg,
                         plan=plans[1])
    assert all(torch.equal(a, b) for a, b in zip(split, again))


def test_params_round_trip_exactly():
    cfg, jcfg = _pair(d_edge=2)
    jp, tp = _params(cfg, jcfg)
    back = convert.egnn_params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), b), jp, back)


def test_init_shapes_equal_jax_eval_shape():
    cfg = egnn_cfg.full_config(d_feat=100)
    want = jax.eval_shape(lambda: jegnn.init_params(
        jax.random.key(0), jegnn_cfg.full_config(d_feat=100)))
    got = egnn.init_params(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    assert jax.tree.map(lambda t: tuple(t.shape), got) == \
        jax.tree.map(lambda s: tuple(s.shape), want)
    w = got["layers"][0]["phi_e"][0]["w"]
    assert abs(float(w.std()) - w.shape[0] ** -0.5) < 0.1 * w.shape[0] ** -0.5
