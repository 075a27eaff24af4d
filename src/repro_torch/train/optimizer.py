"""Optimizers of the port: AdamW and factored Adafactor over parameter trees.

The port of ``repro.train.optimizer``.  ``Optimizer(init, update)`` is
functional over the JAX package's trees: ``init(params)`` gives an
``OptState(step, inner)`` (the step an int32 scalar tensor, ``inner`` the
moments in the params' structure), ``update(grads, state, params)`` gives
``(params, state)``.  Leaves are walked in the JAX package's order
(``train.tree``), so the f32 sum of ``global_norm`` and Adafactor's
per-leaf random draws follow it.

One divergence: ``update`` writes the new values into the tensors of
``params`` and of the moments (``torch.no_grad``, in place) and returns
those same tensors with a new step; the JAX update returns new arrays.
DLRM's 6.98 GB of tables would otherwise hold a second copy of the
parameters and moments at once.  A caller that needs the old values
clones them first.  ``grads`` are never written.  Each leaf's update holds
at most two f32 temporaries of the leaf's size (three for a bf16 leaf
while its f32 copy is rounded back).

Adafactor updates a leaf of three or more dims one slice of its leading
(layer) axis at a time, as the JAX package does: factoring and the update's
RMS clip are decided per slice, and the f32 temporaries are a slice's.  Its
stochastic rounding of bf16 parameters draws from a ``torch.Generator``
seeded from (seed, step), so a resumed run draws what an uninterrupted one
would; the draws are not JAX's (its PRNG cannot be reproduced here), so
parity with the JAX package holds with ``stochastic_rounding=False``.

``state_spec(param_shapes, param_specs)`` gives the state's partition
specs (``dist.api.P``) from the parameters': the moments mirror their
parameter, so the state shards as the parameters do (ZeRO-style); a
factored Adafactor row / column moment drops the last / second-to-last
entry.  The step is replicated (``P()``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.dist.api import P, is_dtensor
from repro_torch.train import tree

__all__ = ["OptState", "Optimizer", "adamw", "adafactor", "global_norm",
           "OPTIMIZERS"]

F32 = torch.float32


class OptState(NamedTuple):
    step: torch.Tensor            # () int32
    inner: dict


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable          # (grads, state, params) -> (params, state)
    # (param_shapes, param_specs) -> the state's tree of specs
    state_spec: Callable = None


def _schedule(lr: float, warmup: int, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup from the step after ``step``: the first update (step
    1) already takes ``lr * 2 / warmup``, as in the JAX package."""
    s = step.to(F32)
    return torch.clamp((s + 1) / max(warmup, 1), max=1.0) * lr


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=F32, device=p.device)


def _step0(params) -> torch.Tensor:
    first = tree.leaves(params)[0]
    return torch.zeros((), dtype=torch.int32, device=first.device)


def adamw(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          warmup: int = 100, grad_clip: Optional[float] = 1.0) -> Optimizer:
    def init(params):
        return OptState(_step0(params), {"m": tree.map(_zeros_f32, params),
                                         "v": tree.map(_zeros_f32, params)})

    @torch.no_grad()
    def update(grads, state, params):
        step = state.step + 1
        scale = None
        if grad_clip is not None:
            gnorm = global_norm(grads)
            scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
        lr_t = _schedule(lr, warmup, step)
        s = step.to(F32)
        # 1 - b ** step in f32, as the JAX package computes it
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=F32, device=s.device), s)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=F32, device=s.device), s)

        def upd(p, g, m, v):
            g = g.to(F32)
            if scale is not None:
                g = g * scale           # a temporary: grads are never written
            t = g * (1 - b1)
            m.mul_(b1).add_(t)
            torch.mul(g, 1 - b2, out=t).mul_(g)          # (1 - b2) * g * g
            v.mul_(b2).add_(t)
            del g
            torch.div(v, bc2, out=t).sqrt_().add_(eps)
            u = m / bc1
            u.div_(t)
            del t
            if weight_decay:
                u.add_(p.to(F32) * weight_decay)
            u.mul_(lr_t)
            if p.dtype == F32:
                p.sub_(u)
            else:
                p.copy_(p.to(F32).sub_(u))

        tree.map(upd, params, grads, state.inner["m"], state.inner["v"])
        return params, OptState(step, state.inner)

    def state_spec(param_shapes, param_specs):
        return OptState(P(), {"m": param_specs, "v": param_specs})

    return Optimizer(init, update, state_spec)


def _factored(shape) -> bool:
    # only genuine matrices (both trailing dims substantial); layer-stacked
    # vectors such as (L, d) norms stay unfactored, so the state never
    # couples across the stack axis
    return len(shape) >= 2 and shape[-1] >= 128 and shape[-2] >= 128


def adafactor(lr: float = 1e-2, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, warmup: int = 100,
              stochastic_rounding: bool = True, seed: int = 0) -> Optimizer:
    """Factored Adafactor (no momentum): O(rows + cols) state for
    matrices."""

    def init(params):
        def st(p):
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], dtype=F32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=F32, device=p.device)}
            return {"v": _zeros_f32(p)}
        return OptState(_step0(params), {"v": tree.map(st, params)})

    @torch.no_grad()
    def update(grads, state, params):
        step = state.step + 1
        t = step.to(F32)
        beta = 1.0 - t ** -decay            # 0 at the first step
        lr_t = _schedule(lr, warmup, step)
        gen = None

        def upd_slice(p, g, v):
            """One slice: ``v`` (its state views) updated in place, the
            new parameter values written into ``p``."""
            g = g.to(F32)
            g2 = g * g
            g2.add_(eps)
            if _factored(p.shape):
                vr = beta * v["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * v["vc"] + (1 - beta) * g2.mean(dim=-2)
                del g2
                v["vr"].copy_(vr)
                v["vc"].copy_(vc)
                r = vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
                u = g * torch.rsqrt(r)[..., :, None]
                u.mul_(torch.rsqrt(torch.clamp(vc, min=eps))[..., None, :])
            else:
                g2.mul_(1 - beta)
                vv = v["v"].mul_(beta).add_(g2)
                del g2
                u = g * torch.rsqrt(vv)
            # update clipping (RMS)
            rms = torch.sqrt(torch.mean(u * u) + 1e-30)
            u.div_(torch.clamp(rms / clip_threshold, min=1.0))
            u.mul_(lr_t)
            if p.dtype == F32:
                p.sub_(u)
                return
            p32 = p.to(F32).sub_(u)
            del u
            if p.dtype == torch.bfloat16 and stochastic_rounding:
                p32 = _stochastic_round_bf16(p32, _gen(p))
            p.copy_(p32)

        def _gen(p):
            nonlocal gen
            if gen is None:
                # one stream per (seed, step), drawn leaf by leaf and
                # slice by slice in JAX order: a resumed run draws alike
                # (a data-free meta tensor draws from a host generator)
                dev = "cpu" if p.device.type == "meta" else p.device
                gen = torch.Generator(device=dev)
                gen.manual_seed(seed * 1_000_003 + int(step))
            return gen

        def upd(p, g, v):
            if p.dim() >= 3:
                for j in range(p.shape[0]):
                    upd_slice(p[j], g[j], {k: a[j] for k, a in v.items()})
            else:
                upd_slice(p, g, v)

        tree.map(upd, params, grads, state.inner["v"])
        return params, OptState(step, state.inner)

    def state_spec(param_shapes, param_specs):
        def st(p, spec):
            full = tuple(spec) + (None,) * (len(p.shape) - len(spec))
            if _factored(p.shape):
                return {"vr": P(*full[:-1]), "vc": P(*(full[:-2] + full[-1:]))}
            return {"v": P(*full)}
        return OptState(P(), {"v": tree.map(st, param_shapes, param_specs)})

    return Optimizer(init, update, state_spec)


def _stochastic_round_bf16(x32: torch.Tensor,
                           generator: torch.Generator) -> torch.Tensor:
    """Unbiased f32 -> bf16 rounding: uniform noise below the bf16 LSB added
    to the f32 bits, the low 16 bits then cleared.  The int32 add wraps as
    the JAX package's uint32 one (two's complement); the result is the
    bf16 just below or just above ``x32``, exact in bf16."""
    bits = x32.view(torch.int32)
    noise = torch.randint(0, 1 << 16, x32.shape, generator=generator,
                          dtype=torch.int32, device=x32.device)
    if is_dtensor(bits):
        noise = bits + noise        # the sum in the DTensor's layout
    else:
        noise.add_(bits)
    noise.bitwise_and_(-65536)
    return noise.view(F32).to(torch.bfloat16)


def _sum_sq(leaf: torch.Tensor) -> torch.Tensor:
    """Sum of squares in f32; a leaf of three or more dims one slice at a
    time (its f32 copy is a slice's), the slices' sums added in order."""
    if leaf.dim() >= 3:
        acc = torch.zeros((), dtype=F32, device=leaf.device)
        for j in range(leaf.shape[0]):
            s = leaf[j].to(F32)
            acc = acc + torch.sum(s * s)
        return acc
    x = leaf.to(F32)
    return torch.sum(x * x)


@torch.no_grad()
def global_norm(grads) -> torch.Tensor:
    total = torch.zeros((), dtype=F32,
                        device=tree.leaves(grads)[0].device)
    for leaf in tree.leaves(grads):      # chained adds in JAX order
        total = total + _sum_sq(leaf)
    return torch.sqrt(total)


# the JAX package's ``launch/cells.make_optimizer``: a config's OPTIMIZER
# name to its factory (defaults as there)
OPTIMIZERS = {"adamw": adamw, "adafactor": adafactor}
