"""Mixture-of-Experts FFN: top-k routing + capacity-bucketed dispatch.

The port of ``repro.models.moe`` (its single-device path, ``moe_ffn``).
Routing is a softmax over the experts, the stable top-k of it, optionally
renormalised over the chosen k (DeepSeek), and the Switch / GShard
auxiliary load-balancing loss.  ``MoEConfig.scoring`` "sigmoid" is
DeepSeek-V3's router instead (``noaux_tc`` with one group): sigmoid
scores in f32, the k experts chosen by score + a learned correction bias
(``score_bias``), the chosen *unbiased* scores as gates, renormalised
over the k and scaled by ``routed_scale``.  Each (token, choice) takes
the next slot of its expert's queue in token-major order; a choice past
``capacity`` is dropped.  The expert product is batched over all E
experts, each on its (capacity, d) slot buffer, as the JAX package
computes it: a decode step of a few tokens reads every expert's weights.
Shared experts (DeepSeek, Llama 4) run densely beside the routed path.

``moe_ffn_dropless`` is the serving form, chosen by ``capacity_factor``
None: no choice is dropped and pad rows are neither routed nor computed.
The real tokens' (token, choice) pairs are sorted by expert, the routed
products run as one grouped product over the experts with the group ends
kept on the device (``expert_products``: ``torch._grouped_mm`` on the
card, a loop on the CPU), and the results combine in choice order in f32
with no atomics.  It takes no host sync and allocates by shape alone.
Each call is a ``serve.moe`` span and adds its routed real tokens per
expert to ``serve.telemetry.EXPERT_LOAD``.

``moe_ffn_sharded`` is the expert-parallel form over a ``DeviceMesh``
(the JAX package's ``shard_map`` version): tokens split over the data
axes, experts over ``"model"``, each model rank running its own experts on
its data rank's tokens and the partial outputs summed over ``"model"``.

The products are plain ``torch`` calls (XLA's in the JAX package); there
is no kernel of the port.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.dist.api import P, axis_sizes, constrain, data_axes, \
    to_placements
from repro_torch.models import common as cm

__all__ = ["MoEConfig", "init_moe", "MoEOut", "Routing", "capacity_for",
           "route", "moe_ffn", "moe_ffn_dropless", "expert_products",
           "moe_ffn_sharded"]


class MoEConfig(NamedTuple):
    n_experts: int
    top_k: int
    d_ff: int                    # per routed expert
    n_shared: int = 0
    d_ff_shared: int = 0         # defaults to d_ff * n_shared when 0
    # slots an expert per even share; None: ``moe_ffn_dropless``
    capacity_factor: Optional[float] = 1.25
    aux_loss_weight: float = 1e-3
    norm_topk: bool = True       # renormalize selected gates (DeepSeek)
    router_dtype: torch.dtype = torch.float32
    scoring: str = "softmax"     # "sigmoid": DeepSeek-V3's biased choice
    routed_scale: float = 1.0    # gates times this (routed_scaling_factor)


def init_moe(cfg: MoEConfig, d_model: int, dtype, *, lead=(), device=None,
             generator: Optional[torch.Generator] = None) -> dict:
    """The JAX ``init_moe`` tree, shapes and scales (not its values), each
    leaf with the leading dims ``lead`` (a stack of layers)."""
    kw = dict(dtype=dtype, device=device, generator=generator)
    lead = tuple(lead)
    e, f = cfg.n_experts, cfg.d_ff
    p = {
        "router": cm.normal(lead + (d_model, e), d_model ** -0.5,
                            **{**kw, "dtype": torch.float32}),
        "wi": cm.normal(lead + (e, d_model, 2 * f), d_model ** -0.5, **kw),
        "wo": cm.normal(lead + (e, f, d_model), f ** -0.5, **kw),
    }
    if cfg.scoring == "sigmoid":
        # DeepSeek-V3's e_score_correction_bias: zero until trained
        p["score_bias"] = torch.zeros(lead + (e,), dtype=torch.float32,
                                      device=device)
    elif cfg.scoring != "softmax":
        raise ValueError(f"scoring {cfg.scoring!r}: expected softmax or "
                         f"sigmoid")
    if cfg.n_shared:
        fs = cfg.d_ff_shared or f * cfg.n_shared
        p["shared_wi"] = cm.normal(lead + (d_model, 2 * fs),
                                   d_model ** -0.5, **kw)
        p["shared_wo"] = cm.normal(lead + (fs, d_model), fs ** -0.5, **kw)
    return p


def _swiglu(x: torch.Tensor, wi: torch.Tensor,
            wo: torch.Tensor) -> torch.Tensor:
    gate, up = (x @ wi).chunk(2, dim=-1)
    return (torch.nn.functional.silu(gate) * up) @ wo


class MoEOut(NamedTuple):
    y: torch.Tensor
    aux_loss: torch.Tensor


class Routing(NamedTuple):
    """Where each (token, choice) goes, flattened token-major (T * K,)."""
    expert_ids: torch.Tensor     # (T * K,) int64
    pos: torch.Tensor            # (T * K,) slot in its expert's queue
    keep: torch.Tensor           # (T * K,) bool: pos < capacity
    gates: torch.Tensor          # (T * K,) f32, 0 where dropped
    capacity: int
    aux_loss: torch.Tensor       # () f32


def capacity_for(t: int, cfg: MoEConfig,
                 capacity: Optional[int] = None) -> int:
    """Slots per expert for ``t`` tokens: ``capacity_factor`` times the even
    share unless given, then at least 8 and a multiple of 8."""
    if capacity is None:
        capacity = int(t * cfg.top_k / cfg.n_experts * cfg.capacity_factor) + 1
    return max(8, -(-capacity // 8) * 8)


def route(params: dict, x: torch.Tensor, cfg: MoEConfig,
          capacity: Optional[int] = None) -> Routing:
    """The router of ``moe_ffn`` on x (T, d)."""
    capacity = capacity_for(x.shape[0], cfg, capacity)
    probs, gate_vals, expert_ids = _router(params, x, cfg)
    flat = expert_ids.reshape(-1)                                    # (T*K,)
    aux, pos = _aux_and_positions(probs, flat, cfg)
    keep = pos < capacity
    return Routing(flat, pos, keep, gate_vals.reshape(-1) * keep, capacity,
                   aux.to(torch.float32))


def _router(params: dict, x: torch.Tensor, cfg: MoEConfig):
    """(the router's scores (T, E), the chosen gates and experts (T, K)
    each) of x (T, d): the product in f32 (x.astype(f32) @ router in the
    JAX package), then the softmax's top k, or DeepSeek-V3's choice."""
    logits = x.to(cfg.router_dtype) @ params["router"]               # (T, E)
    if cfg.scoring == "sigmoid":
        scores = torch.sigmoid(logits)
        return (scores,) + _biased_top_k(scores, params["score_bias"], cfg)
    probs = torch.softmax(logits, dim=-1)
    return (probs,) + _top_k(probs, cfg)


def _biased_top_k(scores: torch.Tensor, bias: torch.Tensor, cfg: MoEConfig):
    """DeepSeek-V3's choice (``noaux_tc`` with one group, which selects
    nothing): the stable top k of ``scores + bias``, the chosen unbiased
    scores as gates, over their sum (+ 1e-20) when ``norm_topk``, times
    ``routed_scale``."""
    _, expert_ids = torch.sort(scores + bias, dim=-1, descending=True,
                               stable=True)
    expert_ids = expert_ids[:, :cfg.top_k]
    gate_vals = torch.gather(scores, 1, expert_ids)
    if cfg.norm_topk:
        gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-20)
    return gate_vals * cfg.routed_scale, expert_ids


def _top_k(probs: torch.Tensor, cfg: MoEConfig):
    """The chosen (gates, experts) of each token: the stable top-k of the
    router's softmax (lax.top_k: the lower expert id wins a tie; a stable
    sort, never torch.topk), renormalised when ``norm_topk``."""
    gate_vals, expert_ids = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    k = cfg.top_k
    gate_vals, expert_ids = gate_vals[:, :k], expert_ids[:, :k]
    if cfg.norm_topk:
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(-1, keepdim=True), min=1e-9)
    return gate_vals, expert_ids


def _aux_and_positions(probs: torch.Tensor, flat: torch.Tensor,
                       cfg: MoEConfig):
    """The Switch / GShard load-balancing loss of the router's ``probs``
    (T, E) and choices ``flat`` (T*K,), and each choice's place in its
    expert's queue in token-major order."""
    e = cfg.n_experts
    # integer counts, exact in any order (bincount would wait for the card)
    counts = torch.zeros(e, dtype=flat.dtype, device=flat.device) \
        .scatter_add(0, flat, torch.ones_like(flat))
    ce = counts.to(torch.float32) / flat.numel()
    aux = cfg.aux_loss_weight * e * torch.sum(probs.mean(dim=0) * ce)
    # the JAX package's cumsum over a (T*K, E) one-hot, computed by a
    # stable sort on the expert id (the same integers, bit for bit)
    order = torch.argsort(flat, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(flat)
    pos[order] = (torch.arange(flat.numel(), device=flat.device)
                  - starts[flat[order]])
    return aux, pos


def moe_ffn(params: dict, x: torch.Tensor, cfg: MoEConfig,
            capacity: Optional[int] = None) -> MoEOut:
    """x: (T, d) token-major.  Returns combined output + aux loss.

    Every row of x is a token to the router, pad rows included: they take
    capacity ahead of later rows, as in the JAX package.
    """
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    r = route(params, x, cfg, capacity)
    c = r.capacity
    ids = r.expert_ids.view(t, k)
    # dropped choices write to an extra slot C, which no product reads:
    # every kept (expert, slot) receives exactly one token
    slot = torch.where(r.keep, r.pos, c).view(t, k)
    buf = x.new_zeros((e, c + 1, d))
    for kk in range(k):
        buf[ids[:, kk], slot[:, kk]] = x
    buf = constrain(buf[:, :c], "moe_buf")  # experts over "model"

    # expert compute, batched over E
    h = constrain(torch.bmm(buf, params["wi"]), "moe_hidden")
    gate_h, up_h = h.chunk(2, dim=-1)
    out = constrain(torch.bmm(torch.nn.functional.silu(gate_h) * up_h,
                              params["wo"]), "moe_buf")

    # combine: the k choices one at a time, in choice order, into a zero
    # buffer of the model dtype (XLA's in-order scatter-add; no atomics, so
    # two runs agree bit for bit).  A dropped choice reads the clamped slot
    # C - 1, as the JAX gather clamps, times its zero gate.
    gates = r.gates.to(x.dtype).view(t, k)
    slot = slot.clamp(max=c - 1)
    y = x.new_zeros((t, d))
    for kk in range(k):
        y = y + out[ids[:, kk], slot[:, kk]] * gates[:, kk, None]
    y = constrain(y, "moe_out")

    if "shared_wi" in params:
        y = y + _swiglu(x, params["shared_wi"], params["shared_wo"])
    return MoEOut(y, r.aux_loss)


def expert_products(x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
                    ends: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SwiGLU experts over the rows of x (M, d).

    With ``ends`` (G,) int32 on x's device, the rows [ends[g - 1],
    ends[g]) go through expert g of ``wi`` (G, d, 2f) and ``wo`` (G, f,
    d): on the card two grouped products (``torch._grouped_mm``, the group
    ends read on the device), on the CPU a loop over the experts.  Rows
    past ends[-1] are not computed and their output rows are left
    undefined.  Without ``ends``, every row through the one expert ``wi``
    (d, 2f), ``wo`` (f, d).

    The serving path calls it by its module name, so a caller can wrap it
    (the benchmark puts a range around each call)."""
    if ends is None:
        return _swiglu(x, wi, wo)
    if x.is_cuda:
        gate, up = torch._grouped_mm(x, wi, offs=ends).chunk(2, dim=-1)
        return torch._grouped_mm(torch.nn.functional.silu(gate) * up, wo,
                                 offs=ends)
    out = x.new_zeros((x.shape[0], wo.shape[-1]))
    lo = 0
    for g, hi in enumerate(ends.tolist()):
        if hi > lo:
            out[lo:hi] = _swiglu(x[lo:hi], wi[g], wo[g])
        lo = hi
    return out


def moe_ffn_dropless(params: dict, x: torch.Tensor, cfg: MoEConfig,
                     real: Optional[torch.Tensor] = None,
                     layer: Optional[int] = None) -> MoEOut:
    """x: (T, d) token-major; ``real`` (T,) bool marks the real tokens
    (None: every row).  Every real token's k choices are computed; a pad
    row is neither routed nor computed and its routed part is zero (its
    shared experts run, as its attention does).  Returns the output and a
    zero aux loss (the serving form; DeepSeek-V3 balances by its bias).

    The (token, choice) pairs are sorted by expert, pads' after every
    expert's, and gathered into one (T * K, d) block; ``expert_products``
    runs the experts over their runs of it, with the runs' ends as a
    device tensor.  The combine gathers each token's k results back in
    choice order and sums them, times their gates, in f32.  With ``layer``
    the routed real tokens per expert go into ``EXPERT_LOAD`` (on the
    device)."""
    # imported here: the serving package imports this module
    from repro_torch.serve.telemetry import EXPERT_LOAD, SPANS
    with SPANS.kind("serve.moe"):
        t, d = x.shape
        e, k = cfg.n_experts, cfg.top_k
        _scores, gates, ids = _router(params, x, cfg)
        flat = ids.reshape(-1)                                       # (T*K,)
        if real is not None:
            # a pad's choices go to bucket E, past every expert's run
            flat = torch.where(real[:, None].expand(t, k).reshape(-1), flat,
                               e)
        counts = torch.zeros(e + 1, dtype=torch.int64, device=x.device) \
            .scatter_add_(0, flat, torch.ones_like(flat))
        order = torch.argsort(flat, stable=True)
        out = expert_products(x[order // k], params["wi"], params["wo"],
                              torch.cumsum(counts[:e], 0).to(torch.int32))
        # where each (token, choice) went in the sorted block
        pos = torch.empty_like(order).scatter_(
            0, order, torch.arange(order.numel(), device=x.device)).view(t, k)
        y = torch.zeros((t, d), dtype=torch.float32, device=x.device)
        for kk in range(k):
            y = y + out[pos[:, kk]].to(torch.float32) * gates[:, kk, None]
        if real is not None:
            # pads read rows past the last run, which hold no result
            y = torch.where(real[:, None], y, 0.0)
        y = constrain(y.to(x.dtype), "moe_out")
        if "shared_wi" in params:
            y = y + expert_products(x, params["shared_wi"],
                                    params["shared_wo"])
        if layer is not None:
            EXPERT_LOAD.add(layer, counts, k)
    return MoEOut(y, torch.zeros((), dtype=torch.float32, device=x.device))


def _moe_local(x: torch.Tensor, router: torch.Tensor, wi: torch.Tensor,
               wo: torch.Tensor, cfg: MoEConfig, e0: int, capacity: int):
    """One rank's share of ``moe_ffn_sharded``: its data rank's tokens x
    (T_loc, d), routed over all E experts, of which it keeps the choices
    that land in its slice [e0, e0 + E_loc) (``wi`` / ``wo``, E_loc
    experts).  Returns (its partial output, the aux loss of its tokens)."""
    t, d = x.shape
    k, e_loc = cfg.top_k, wi.shape[0]
    # routed in the activation dtype, softmax in f32, as the JAX version
    logits = (x @ router.to(x.dtype)).to(cfg.router_dtype)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = _top_k(probs, cfg)
    flat = expert_ids.reshape(-1)
    aux, pos = _aux_and_positions(probs, flat, cfg)
    mine = (flat >= e0) & (flat < e0 + e_loc)
    keep = (pos < capacity) & mine
    # a choice that is not kept goes to the extra expert E_loc, slot C,
    # which no product reads
    eid = torch.where(keep, flat - e0, e_loc).view(t, k)
    slot = torch.where(keep, pos, capacity).view(t, k)
    gates = (gate_vals.reshape(-1) * keep).view(t, k)

    # dispatch and combine one choice at a time, in choice order
    buf = x.new_zeros((e_loc + 1, capacity + 1, d))
    for kk in range(k):
        buf[eid[:, kk], slot[:, kk]] = x * (gates[:, kk] > 0)[:, None] \
            .to(x.dtype)
    gate_h, up_h = torch.bmm(buf[:e_loc, :capacity], wi).chunk(2, dim=-1)
    out = torch.bmm(torch.nn.functional.silu(gate_h) * up_h, wo)
    y = torch.zeros_like(x)
    eid, slot = eid.clamp(max=e_loc - 1), slot.clamp(max=capacity - 1)
    for kk in range(k):
        y = y + out[eid[:, kk], slot[:, kk]] * gates[:, kk, None].to(x.dtype)
    return y, aux


def moe_ffn_sharded(params: dict, x: torch.Tensor, cfg: MoEConfig, mesh,
                    capacity: Optional[int] = None) -> MoEOut:
    """Expert parallelism over ``mesh`` (a ``DeviceMesh`` with a
    ``"model"`` axis; every other axis is a data axis), called by every
    rank.

    ``x`` (T, d) and the parameters are ``DTensor``s on ``mesh`` or plain
    tensors holding the same global value on every rank.  The tokens split
    over the data axes and are replicated over ``"model"``; ``wi`` / ``wo``
    split their experts over ``"model"``.  Each rank routes its data
    rank's T / dp tokens over all experts and keeps the choices in its own
    slice, with ``capacity`` slots an expert (None: ``capacity_for`` the
    local tokens); the partial outputs are summed over ``"model"`` and the
    aux loss averaged over the data ranks.  The local body is checkpointed
    (recomputed in the backward), as the JAX version's ``jax.checkpoint``.
    The collectives are DTensor redistributions, which autograd
    differentiates: the gradients are those of the global function.
    Returns ``DTensor``s for a ``DTensor`` x, else plain tensors.
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if cfg.scoring != "softmax" or cfg.capacity_factor is None:
        raise ValueError("the expert-parallel form routes by softmax into "
                         "capacity slots")
    sizes = axis_sizes(mesh)
    names = tuple(sizes)
    dp = data_axes(mesh)
    tp = sizes["model"]
    e = cfg.n_experts
    if e % tp:
        raise ValueError(f"{e} experts do not split over a model axis of "
                         f"{tp}")
    dp_prod = 1
    for a in dp:
        dp_prod *= sizes[a]
    t = x.shape[0]
    if t % dp_prod:
        raise ValueError(f"{t} tokens do not split over {dp_prod} data "
                         f"ranks")
    capacity = capacity_for(t // dp_prod, cfg, capacity)
    nd = len(names)
    rep = [Replicate()] * nd

    def on_mesh(a):
        if isinstance(a, DTensor):
            return a
        return DTensor.from_local(a, mesh, rep, run_check=False)

    def local(a, placements, grad_placements):
        return on_mesh(a).redistribute(mesh, placements).to_local(
            grad_placements=grad_placements)

    x_pl = to_placements(P(dp or None, None), mesh)
    w_pl = to_placements(P("model", None, None), mesh)
    # the gradient each rank computes is its share of the whole: over
    # "model" for the tokens (its experts' part), over the data axes for
    # the experts (its tokens' part), over both for the router
    partial_model = [Partial() if n == "model" else p
                     for n, p in zip(names, x_pl)]
    partial_data = [p if n == "model" else Partial()
                    for n, p in zip(names, w_pl)]
    x_loc = local(x, x_pl, partial_model)
    router = local(params["router"], rep, [Partial()] * nd)
    wi = local(params["wi"], w_pl, partial_data)
    wo = local(params["wo"], w_pl, partial_data)
    e0 = mesh.get_local_rank("model") * (e // tp)
    y_part, aux = ckpt.checkpoint(_moe_local, x_loc, router, wi, wo, cfg, e0,
                                  capacity, use_reentrant=False)
    y = DTensor.from_local(y_part, mesh, partial_model,
                           run_check=False).redistribute(mesh, x_pl)
    # the mean over data ranks of an aux that every model rank shares
    aux = DTensor.from_local(aux.to(torch.float32) / mesh.size(), mesh,
                             [Partial()] * nd,
                             run_check=False).redistribute(mesh, rep)
    if "shared_wi" in params:
        y = y + _swiglu(on_mesh(x), on_mesh(params["shared_wi"]),
                        on_mesh(params["shared_wo"]))
    if isinstance(x, DTensor):
        return MoEOut(y, aux)
    return MoEOut(y.full_tensor(), aux.full_tensor())
