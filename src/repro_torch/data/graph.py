"""Graph data: synthetic generators and a layered neighbour sampler.

A copy of ``repro.data.graph`` (numpy only), kept in the port so the port
imports nothing of the JAX package: the same seed (or the same ``rng``)
gives the same arrays in both packages.

``minibatch_lg`` needs GraphSAGE-style fanout sampling (15-10) from a CSR
adjacency; the sampler is host-side numpy (sampling on the host, compute
on the card) and emits fixed-size padded edge blocks.  Padding
convention: ``src < 0`` marks invalid edges (masked inside the model).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["GraphData", "random_graph", "batched_molecules",
           "NeighborSampler"]


@dataclasses.dataclass
class GraphData:
    node_feat: np.ndarray     # (N, F)
    coords: np.ndarray        # (N, 3)
    edge_index: np.ndarray    # (2, E)
    labels: np.ndarray        # (N,)


def random_graph(seed: int, n_nodes: int, n_edges: int, d_feat: int,
                 n_classes: int = 8) -> GraphData:
    rng = np.random.default_rng(seed)
    # community structure so labels are learnable from features
    comm = rng.integers(0, n_classes, n_nodes)
    centers = rng.standard_normal((n_classes, d_feat))
    feat = centers[comm] + 0.5 * rng.standard_normal((n_nodes, d_feat))
    src = rng.integers(0, n_nodes, n_edges)
    # homophily: half the edges connect within-community nodes
    dst = np.where(rng.random(n_edges) < 0.5,
                   rng.integers(0, n_nodes, n_edges),
                   np.roll(src, 1))
    coords = rng.standard_normal((n_nodes, 3))
    return GraphData(feat.astype(np.float32), coords.astype(np.float32),
                     np.stack([src, dst]).astype(np.int32), comm.astype(np.int32))


def batched_molecules(seed: int, batch: int, n_nodes: int, n_edges: int,
                      d_feat: int, n_classes: int = 8):
    """Disjoint union of ``batch`` small graphs with offset edge indices."""
    rng = np.random.default_rng(seed)
    feats, coords, edges, gids, labels = [], [], [], [], []
    for g in range(batch):
        feats.append(rng.standard_normal((n_nodes, d_feat)))
        coords.append(rng.standard_normal((n_nodes, 3)))
        src = rng.integers(0, n_nodes, n_edges) + g * n_nodes
        dst = rng.integers(0, n_nodes, n_edges) + g * n_nodes
        edges.append(np.stack([src, dst]))
        gids.append(np.full(n_nodes, g))
        labels.append(rng.integers(0, n_classes))
    return (np.concatenate(feats).astype(np.float32),
            np.concatenate(coords).astype(np.float32),
            np.concatenate(edges, axis=1).astype(np.int32),
            np.concatenate(gids).astype(np.int32),
            np.asarray(labels, np.int32))


class NeighborSampler:
    """Layered (GraphSAGE) fanout sampler over a CSR adjacency."""

    def __init__(self, edge_index: np.ndarray, n_nodes: int):
        src, dst = edge_index
        order = np.argsort(dst, kind="stable")
        self.nbr = src[order]
        counts = np.bincount(dst, minlength=n_nodes)
        self.ptr = np.concatenate([[0], np.cumsum(counts)])
        self.n_nodes = n_nodes

    def sample(self, seed_nodes: np.ndarray, fanouts, rng) -> np.ndarray:
        """Fixed-size padded edge block rooted at ``seed_nodes``: layer i
        contributes exactly |seeds| * prod(fanouts[:i+1]) edge slots (static
        shapes for the jitted step); src=-1 marks padding."""
        blocks = []
        frontier = np.asarray(seed_nodes, np.int64)
        slots = frontier.size
        for fan in fanouts:
            fpad = np.full(slots, -1, np.int64)
            fpad[:min(frontier.size, slots)] = frontier[:slots]
            srcs = np.full((slots, fan), -1, np.int64)
            for i, node in enumerate(fpad):
                if node < 0:
                    continue
                lo, hi = self.ptr[node], self.ptr[node + 1]
                deg = int(hi - lo)
                if deg == 0:
                    continue
                take = min(fan, deg)
                picks = rng.choice(deg, size=take, replace=deg < fan)
                srcs[i, :take] = self.nbr[lo + picks]
            dsts = np.broadcast_to(fpad[:, None], srcs.shape)
            valid = srcs >= 0
            blocks.append(np.stack([srcs.ravel(),
                                    np.where(valid, dsts, -1).ravel()]))
            nxt = np.unique(srcs[valid])
            frontier = nxt if nxt.size else frontier
            slots = slots * fan
        return np.concatenate(blocks, axis=1).astype(np.int32)
