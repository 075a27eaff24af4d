"""EGNN's per-edge-chunk checkpointing against the plain backward and JAX.

``forward(remat=True)`` checkpoints each edge chunk of each layer: the
backward recomputes the chunk's gathers, MLPs and the values it hands to
the plan.  The recompute replays the same operations into the same
autograd graph, so on the CPU the loss and every gradient equal the
un-checkpointed ones bit for bit (a graph of a few hundred edges, with
padded edges and unlabelled nodes, in chunks of 16 edges; node and graph
readout).  The same loss against the JAX package's ``jax.grad`` (its
layers under ``jax.checkpoint``) holds at ``train.parity``'s bars: loss
within rtol 1e-5, each gradient leaf within atol 1e-6 + rtol 1e-4 of its
largest |gradient|.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import common as jcm
from repro.models import egnn as jegnn
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.data import graph
from repro_torch.models import egnn
from repro_torch.train import parity
from repro_torch.train import step as tstep
from repro_torch.train import tree

jax.config.update("jax_platform_name", "cpu")

CHUNK = 16


def _case(readout):
    cfg = dataclasses.replace(registry.get("egnn").smoke_config(),
                              readout=readout)
    jcfg = dataclasses.replace(jregistry.get("egnn").smoke_config(),
                               readout=readout)
    if readout == "node":
        g = graph.random_graph(3, 80, 400, cfg.d_feat_in, cfg.n_classes)
        edges = g.edge_index.copy()
        edges[:, -24:] = -1                       # padded edges
        labels = g.labels.copy()
        labels[::4] = -1                          # unlabelled nodes
        batch = {"feat": g.node_feat, "coords": g.coords,
                 "edge_index": edges, "labels": labels}
        n_graphs = None
    else:
        feat, coords, edges, gids, labels = graph.batched_molecules(
            3, 8, 12, 40, cfg.d_feat_in, cfg.n_classes)
        batch = {"feat": feat, "coords": coords, "edge_index": edges,
                 "graph_ids": gids, "labels": labels}
        n_graphs = 8
    return cfg, jcfg, batch, n_graphs


def _port_grads(cfg, tp, batch, n_graphs, remat):
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    plan = egnn.prepare(b["edge_index"], b["feat"].shape[0],
                        b.get("graph_ids"), n_graphs, edge_chunk=CHUNK)
    assert len(plan.edges.chunks) > 10             # many chunks

    def loss_fn(params, bb):
        logits, _ = egnn.forward(params, bb["feat"], bb["coords"],
                                 bb["edge_index"], cfg,
                                 graph_ids=bb.get("graph_ids"),
                                 n_graphs=n_graphs, plan=plan, remat=remat)
        return tstep.cm.cross_entropy(logits[None], bb["labels"][None]), {}

    (loss, _), grads = tstep.value_and_grad(loss_fn)(tp, b)
    return loss, grads


@pytest.mark.parametrize("readout", ["node", "graph"])
def test_chunk_remat_gradients_equal_plain_bit_for_bit(readout):
    cfg, _, batch, n_graphs = _case(readout)
    tp = egnn.init_params(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(5))
    loss0, g0 = _port_grads(cfg, tp, batch, n_graphs, remat=False)
    loss1, g1 = _port_grads(cfg, tp, batch, n_graphs, remat=True)
    assert torch.equal(loss0, loss1)
    for (path, a), b in zip(tree.leaves_with_path(g0), tree.leaves(g1)):
        assert torch.equal(a, b), path
    # the encoder's and the first layer's gradients pass every chunk
    assert bool(torch.any(g1["encoder"][0]["w"] != 0))
    assert bool(torch.any(g1["layers"][0]["phi_e"][0]["w"] != 0))


def test_chunk_remat_keeps_only_node_level_tensors():
    """Under remat the autograd graph saves no (edges, ...) tensor: the
    largest saved tensor has at most N rows."""
    cfg, _, batch, n_graphs = _case("node")
    tp = egnn.init_params(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(5))
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    n = b["feat"].shape[0]
    plan = egnn.prepare(b["edge_index"], n, edge_chunk=CHUNK)
    params = tree.map(lambda p: p.detach().requires_grad_(), tp)
    rows = {True: [], False: []}
    for remat in (True, False):
        def pack(t, remat=remat):
            rows[remat].append(t.shape[0] if t.dim() else 0)
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            logits, _ = egnn.forward(params, b["feat"], b["coords"],
                                     b["edge_index"], cfg, plan=plan,
                                     remat=remat)
        del logits
    n_edges = int(plan.edges.counts.sum())
    assert max(rows[True]) <= max(n, n_edges // len(plan.edges.chunks) + 1,
                                  2 * cfg.d_hidden + 1)
    assert max(r for r in rows[True] if r != n_edges) < n_edges
    # the plain forward keeps chunk-sized activations of every chunk
    assert rows[False].count(CHUNK) > rows[True].count(CHUNK)


@pytest.mark.parametrize("readout", ["node", "graph"])
def test_chunk_remat_gradients_match_jax(readout):
    cfg, jcfg, batch, n_graphs = _case(readout)
    jp = jegnn.init_params(jax.random.key(2), jcfg)
    tp = convert.egnn_params_from_numpy(jp, device="cpu")

    def jloss(p, b):
        logits, _ = jegnn.forward(p, b["feat"], b["coords"],
                                  b["edge_index"], jcfg,
                                  graph_ids=b.get("graph_ids"),
                                  n_graphs=n_graphs)
        return jcm.cross_entropy(logits[None], b["labels"][None])

    jb = jax.tree.map(jnp.asarray, batch)
    jl, jg = jax.value_and_grad(jloss)(jp, jb)
    tl, tg = _port_grads(cfg, tp, batch, n_graphs, remat=True)
    np.testing.assert_allclose(float(tl), float(jl), rtol=parity.LOSS_RTOL)
    for want, got in zip(jax.tree.leaves(jg), tree.leaves(tg)):
        want, got = np.asarray(want), convert.to_numpy(got)
        assert want.shape == got.shape
        tol = parity.G_ATOL + parity.G_RTOL * float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_egnn_loss_fn_trains_through_chunk_remat():
    """``train.step.egnn_loss_fn`` (remat on) gives the plain loss."""
    cfg, _, batch, n_graphs = _case("node")
    tp = egnn.init_params(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(5))
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    plan = egnn.prepare(b["edge_index"], b["feat"].shape[0],
                        edge_chunk=CHUNK)
    loss = functools.partial(tstep.egnn_loss_fn, cfg=cfg, plan=plan)
    (l_remat, _), g_remat = tstep.value_and_grad(loss)(tp, b)
    l_plain, _ = _port_grads(cfg, tp, batch, n_graphs, remat=False)
    assert torch.equal(l_remat, l_plain)
    assert all(bool(torch.isfinite(g).all()) for g in tree.leaves(g_remat))
