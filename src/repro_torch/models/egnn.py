"""E(n)-Equivariant GNN (Satorras et al., arXiv:2102.09844) on one device.

The port of ``repro.models.egnn``: message passing over an explicit edge
list (gather -> MLP -> segment sum), coordinates updated only along
relative difference vectors scaled by a scalar MLP of the invariant
message.  Batched small graphs (``molecule``) are one disjoint graph with
offset edge indices; ``graph_ids`` drives the graph readout.  Edges with
``src < 0`` are padding: the JAX package masks their messages to zero,
the port leaves them out of every sum (the same values).

``jax.ops.segment_sum`` becomes ``SegmentPlan``: the kept rows sorted by
segment once (the graph is the same for every layer), walked in chunks of
``EDGE_CHUNK`` rows, each chunk's rows laid out by rank within their
segment and summed over that axis, the chunks' partial sums added in
order.  No float atomics (``index_add_`` on the card adds with them, so
its last bits change from run to run): two forwards agree bit for bit,
for one chunk size.  The chunks also bound the edge tensors: at
``ogb_products`` (61,859,140 edges) one layer's unchunked message input
alone is 31.9 GB.  The JAX package shards edges across devices instead.

Training differentiates the forward as it is: the plan's sums write each
row to its own position of a fresh buffer and add it in (``index_put``),
which autograd takes.  ``forward(remat=True)`` checkpoints each edge chunk
of each layer (``torch.utils.checkpoint``, non-reentrant): the chunk's
gathers, ``dx``, ``dist2``, phi_e, phi_x and the (rows, d + 3) values it
hands to the plan are recomputed in the backward, so a layer keeps only
its node-level tensors and its sums.  The JAX package checkpoints whole
layers (``jax.checkpoint``) and shards the edges over devices; on one card
at ``ogb_products`` one layer's edge activations alone are over 60 GB.
The recompute replays the same operations into the same autograd graph,
so the values and gradients equal the plain forward's.  On the card the
backward of the gathers at edge endpoints adds with float atomics, so a
gradient's last bits change from run to run.

The products are plain ``torch`` calls (XLA's in the JAX package), float32
with TF32 off.  The JAX package has no TPU kernel here, so neither has the
port.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.dist.api import constrain
from repro_torch.kernels.dispatch import resolve_device

__all__ = ["EDGE_CHUNK", "EGNNConfig", "init_params", "SegmentPlan",
           "GraphPlan", "prepare", "egnn_layer", "forward"]

# edges a chunk of the segment sums (and of each layer's edge tensors)
EDGE_CHUNK = 1 << 22


@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    name: str = "egnn"
    n_layers: int = 4
    d_hidden: int = 64
    d_feat_in: int = 16
    d_edge: int = 0
    coords_dim: int = 3
    n_classes: int = 8
    readout: str = "node"      # "node" | "graph"
    residual: bool = True
    dtype: torch.dtype = torch.float32


def _mlp_init(sizes, *, dtype, device, generator):
    return [{"w": torch.randn((a, b), generator=generator, dtype=dtype,
                              device=device).mul_(a ** -0.5),
             "b": torch.zeros((b,), dtype=dtype, device=device)}
            for a, b in zip(sizes[:-1], sizes[1:])]


def _mlp(layers, x, last_act=False):
    for i, layer in enumerate(layers):
        x = torch.addmm(layer["b"], x, layer["w"])          # x @ w + b
        if i < len(layers) - 1 or last_act:
            x = torch.nn.functional.silu(x)
    return x


def init_params(cfg: EGNNConfig, *, device=None, generator=None) -> dict:
    """The JAX package's distributions (not its values) drawn from
    ``generator`` on ``device``."""
    kw = dict(dtype=cfg.dtype, device=resolve_device(device),
              generator=generator)
    d = cfg.d_hidden
    d_msg_in = 2 * d + 1 + cfg.d_edge
    return {
        "encoder": _mlp_init([cfg.d_feat_in, d], **kw),
        "layers": [{"phi_e": _mlp_init([d_msg_in, d, d], **kw),
                    "phi_x": _mlp_init([d, d, 1], **kw),
                    "phi_h": _mlp_init([2 * d, d, d], **kw)}
                   for _ in range(cfg.n_layers)],
        "head": _mlp_init([d, d, cfg.n_classes], **kw),
    }


class SegmentPlan:
    """Fixed-order sums of rows into segments: ``jax.ops.segment_sum``
    without float atomics.

    ``index`` (E,) holds each row's segment in [0, n_segments); only the
    rows where ``keep`` is true take part.  They are sorted stably by
    segment (``rows``) and walked in chunks of ``chunk``.  In a chunk the
    rows of each segment form a run; row r of a run goes to (run, r) of a
    zeroed (runs, width, C) buffer, which is summed over its rank axis, and
    the chunk's sums are added to the output's rows in chunk order.  Every
    write goes to its own position, so the answer is the same on every
    run; a segment split by a chunk boundary is summed in two parts, so it
    depends on ``chunk``.  ``counts`` (n_segments,) is each segment's
    number of kept rows, an exact integer.  Building the plan waits for
    the device once; adding does not."""

    def __init__(self, index: torch.Tensor, n_segments: int, *,
                 keep: Optional[torch.Tensor] = None,
                 chunk: int = EDGE_CHUNK):
        dev = index.device
        index = index.long()
        rows = (torch.arange(index.shape[0], device=dev) if keep is None
                else torch.nonzero(keep).squeeze(1))
        seg = index[rows]
        order = torch.argsort(seg, stable=True)
        self.rows, seg = rows[order], seg[order]
        self.n_segments = n_segments
        self.counts = torch.bincount(seg, minlength=n_segments)
        n = self.rows.shape[0]
        pos = torch.arange(n, device=dev)
        new = torch.ones(n, dtype=torch.bool, device=dev)
        new[1:] = seg[1:] != seg[:-1]
        new[::chunk] = True                    # a chunk starts new runs
        run = torch.cumsum(new, 0) - 1
        starts = torch.nonzero(new).squeeze(1)
        self._rank = pos - starts[run]
        self._run_seg = seg[starts]
        first = run[::chunk]
        of = pos // chunk
        self._local = run - first[of]
        width = torch.zeros_like(first).scatter_reduce_(
            0, of, self._rank + 1, "amax")
        ends = torch.clamp((torch.arange(first.shape[0], device=dev) + 1)
                           * chunk, max=n) - 1
        meta = torch.stack([first, run[ends] + 1, width], 1).tolist() \
            if n else []
        # (first row, end row, first run, end run, width) of each chunk
        self.chunks = [(i * chunk, min((i + 1) * chunk, n), r0, r1, w)
                       for i, (r0, r1, w) in enumerate(meta)]

    def add(self, out: torch.Tensor, i: int, values: torch.Tensor) -> None:
        """Add chunk ``i``'s sums into ``out`` (n_segments, C); ``values``
        are its rows' (in ``rows`` order), (end - first, C)."""
        lo, hi, r0, r1, width = self.chunks[i]
        buf = values.new_zeros((r1 - r0, width, values.shape[1]))
        buf[self._local[lo:hi], self._rank[lo:hi]] = values
        seg = self._run_seg[r0:r1]
        out[seg] = out[seg] + buf.sum(dim=1)

    def sum(self, values: torch.Tensor) -> torch.Tensor:
        """segment_sum of ``values`` (E, C): (n_segments, C)."""
        out = values.new_zeros((self.n_segments, values.shape[1]))
        for i, (lo, hi, *_) in enumerate(self.chunks):
            self.add(out, i, values[self.rows[lo:hi]])
        return out


class GraphPlan(NamedTuple):
    """What a forward over one graph sums by: its edges by destination
    (padded edges left out) and, for a graph readout, its nodes by
    graph."""
    edges: SegmentPlan
    graphs: Optional[SegmentPlan]


def prepare(edge_index, n_nodes: int, graph_ids=None,
            n_graphs: Optional[int] = None, *,
            edge_chunk: int = EDGE_CHUNK) -> GraphPlan:
    """The ``GraphPlan`` of a graph (edge_index (2, E) on the device it
    will run on); a forward builds its own when given none."""
    edge_index = torch.as_tensor(edge_index)
    edges = SegmentPlan(edge_index[1], n_nodes, keep=edge_index[0] >= 0,
                        chunk=edge_chunk)
    graphs = None
    if graph_ids is not None:
        graphs = SegmentPlan(torch.as_tensor(graph_ids,
                                             device=edge_index.device),
                             n_graphs)
    return GraphPlan(edges, graphs)


def _edge_values(p: dict, h: torch.Tensor, x: torch.Tensor,
                 src: torch.Tensor, dst: torch.Tensor,
                 edge_attr: Optional[torch.Tensor], e: torch.Tensor):
    """One edge chunk's (rows, d + 3) values: the message m beside the
    coordinate term dx * phi_x(m), for the edges ``e`` (in plan order)."""
    s, t = src[e].long(), dst[e].long()
    dx = x[s] - x[t]                                        # (Ec, 3)
    dist2 = torch.sum(dx * dx, dim=-1, keepdim=True)
    feats = [h[s], h[t], dist2]
    if edge_attr is not None:
        feats.append(edge_attr[e])
    m = constrain(_mlp(p["phi_e"], torch.cat(feats, dim=-1), last_act=True),
                  "edges")
    # equivariant: x_t += C * sum_j dx_ij * phi_x(m_ij)
    coef = torch.clamp(_mlp(p["phi_x"], m), -100.0, 100.0)
    return torch.cat([m, dx * coef], dim=-1)


def egnn_layer(p: dict, h: torch.Tensor, x: torch.Tensor,
               edge_index: torch.Tensor, edge_attr: Optional[torch.Tensor],
               n_nodes: int, residual: bool = True, *,
               plan: Optional[SegmentPlan] = None, remat: bool = False):
    """h (N, d); x (N, 3); edge_index (2, E) [src, dst] (dst aggregates;
    src < 0 marks a padded edge).  ``plan``: the edges' ``SegmentPlan``
    (None: built here).  ``remat``: each edge chunk's work is checkpointed
    while autograd records.  Returns (h_new, x_new)."""
    if plan is None:
        plan = prepare(edge_index, n_nodes).edges
    src, dst = edge_index[0], edge_index[1]
    d = h.shape[1]
    values = functools.partial(_edge_values, p, src=src, dst=dst,
                               edge_attr=edge_attr)
    if remat and torch.is_grad_enabled():
        values = functools.partial(ckpt.checkpoint, values,
                                   use_reentrant=False)
    # the message sums (N, d) and the coordinate sums (N, 3), side by side
    agg = h.new_zeros((n_nodes, d + x.shape[1]))
    for i, (lo, hi, *_) in enumerate(plan.chunks):
        plan.add(agg, i, values(h, x, e=plan.rows[lo:hi]))
    deg = plan.counts.to(x.dtype)
    x_new = x + agg[:, d:] / torch.clamp(deg, min=1.0)[:, None]
    m_agg = constrain(agg[:, :d], "nodes")
    h_new = _mlp(p["phi_h"], torch.cat([h, m_agg], dim=-1))
    if residual:
        h_new = h + h_new
    return h_new, x_new


def forward(params: dict, node_feat, coords, edge_index, cfg: EGNNConfig,
            edge_attr=None, graph_ids=None, n_graphs: Optional[int] = None,
            *, plan: Optional[GraphPlan] = None, remat: bool = False):
    """Returns (logits, coords_out): logits (N, C) node-level or (G, C).
    Inputs (tensors or arrays) go to the parameters' device; ``plan``
    (None: built here, ``prepare``) is the graph's.  ``remat``
    checkpoints each layer's edge chunks while autograd records."""
    dev = params["encoder"][0]["w"].device
    node_feat, coords, edge_index = (torch.as_tensor(a, device=dev)
                                     for a in (node_feat, coords, edge_index))
    if edge_attr is not None:
        edge_attr = torch.as_tensor(edge_attr, device=dev).to(cfg.dtype)
    n = node_feat.shape[0]
    if cfg.readout == "graph" and (graph_ids is None or n_graphs is None):
        raise ValueError("a graph readout needs graph_ids and n_graphs")
    if plan is None:
        plan = prepare(edge_index, n,
                       graph_ids if cfg.readout == "graph" else None,
                       n_graphs)
    h = constrain(_mlp(params["encoder"], node_feat.to(cfg.dtype)), "nodes")
    x = coords.to(cfg.dtype)
    for p in params["layers"]:
        h, x = egnn_layer(p, h, x, edge_index, edge_attr, n, cfg.residual,
                          plan=plan.edges, remat=remat)
        h = constrain(h, "nodes")
    if cfg.readout == "graph":
        cnt = plan.graphs.counts.to(h.dtype)
        h = plan.graphs.sum(h) / torch.clamp(cnt, min=1.0)[:, None]
    return _mlp(params["head"], h), x
