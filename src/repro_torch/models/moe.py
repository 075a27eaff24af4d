"""Mixture-of-Experts FFN: top-k routing + capacity-bucketed dispatch.

The port of ``repro.models.moe`` (its single-device path, ``moe_ffn``).
Routing is a softmax over the experts, the stable top-k of it, optionally
renormalised over the chosen k (DeepSeek), and the Switch / GShard
auxiliary load-balancing loss.  Each (token, choice) takes the next slot of
its expert's queue in token-major order; a choice past ``capacity`` is
dropped.  The expert product is batched over all E experts, each on its
(capacity, d) slot buffer, as the JAX package computes it: a decode step
of a few tokens reads every expert's weights.  Shared experts (DeepSeek,
Llama 4) run densely beside the routed path.

The products are plain ``torch`` calls (XLA's in the JAX package); there
is no kernel.  ``moe_ffn_sharded`` needs a device mesh and is not ported
(ROADMAP queue 1, item 12).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models import common as cm

__all__ = ["MoEConfig", "init_moe", "MoEOut", "Routing", "capacity_for",
           "route", "moe_ffn", "moe_ffn_sharded"]

_SHARDED = "ROADMAP.md queue 1, item 12 (dist: meshes and sharding)"


class MoEConfig(NamedTuple):
    n_experts: int
    top_k: int
    d_ff: int                    # per routed expert
    n_shared: int = 0
    d_ff_shared: int = 0         # defaults to d_ff * n_shared when 0
    capacity_factor: float = 1.25
    aux_loss_weight: float = 1e-3
    norm_topk: bool = True       # renormalize selected gates (DeepSeek)
    router_dtype: torch.dtype = torch.float32


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
    t = x.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    capacity = capacity_for(t, cfg, capacity)
    # the router's product in f32 (x.astype(f32) @ router in the JAX package)
    logits = x.to(cfg.router_dtype) @ params["router"]               # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k is stable (the lower expert id wins a tie): a stable sort,
    # never torch.topk
    gate_vals, expert_ids = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_ids = gate_vals[:, :k], expert_ids[:, :k]
    if cfg.norm_topk:
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(-1, keepdim=True), min=1e-9)

    # aux load-balancing loss (Switch / GShard)
    flat = expert_ids.reshape(-1)                                    # (T*K,)
    # integer counts, exact in any order (bincount would wait for the card)
    counts = torch.zeros(e, dtype=flat.dtype, device=x.device).scatter_add_(
        0, flat, torch.ones_like(flat))
    ce = counts.to(torch.float32) / (t * k)
    aux = cfg.aux_loss_weight * e * torch.sum(probs.mean(dim=0) * ce)

    # each (token, choice)'s place in its expert's queue, in token-major
    # order: the JAX package's cumsum over a (T*K, E) one-hot, computed by
    # a stable sort on the expert id (the same integers, bit for bit)
    order = torch.argsort(flat, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(flat)
    pos[order] = (torch.arange(flat.numel(), device=x.device)
                  - starts[flat[order]])
    keep = pos < capacity
    return Routing(flat, pos, keep, gate_vals.reshape(-1) * keep, capacity,
                   aux.to(torch.float32))


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

    # expert compute, batched over E
    gate_h, up_h = torch.bmm(buf[:, :c], params["wi"]).chunk(2, dim=-1)
    out = torch.bmm(torch.nn.functional.silu(gate_h) * up_h, params["wo"])

    # combine: the k choices one at a time, in choice order, into a zero
    # buffer of the model dtype (XLA's in-order scatter-add; no atomics, so
    # two runs agree bit for bit).  A dropped choice reads the clamped slot
    # C - 1, as the JAX gather clamps, times its zero gate.
    gates = r.gates.to(x.dtype).view(t, k)
    slot = slot.clamp(max=c - 1)
    y = x.new_zeros((t, d))
    for kk in range(k):
        y = y + out[ids[:, kk], slot[:, kk]] * gates[:, kk, None]

    if "shared_wi" in params:
        y = y + _swiglu(x, params["shared_wi"], params["shared_wo"])
    return MoEOut(y, r.aux_loss)


def moe_ffn_sharded(params: dict, x: torch.Tensor, cfg: MoEConfig, mesh,
                    capacity: Optional[int] = None) -> MoEOut:
    """Expert parallelism over a device mesh: not ported yet."""
    raise NotImplementedError(f"moe_ffn_sharded is not ported yet: "
                              f"{_SHARDED}")
