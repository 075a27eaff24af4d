"""Train steps of the port: losses, gradient accumulation, the update.

The port of ``repro.train.step``, plus the loss closures that the JAX
package's ``launch/cells.py`` builds inline (the CTR BCE, the seqrec BCE
and the GNN CE), here as named functions.

``make_train_step(loss_fn, optimizer, accum_steps, accum_dtype)`` returns
``train_step(state, batch) -> (state, metrics)`` over ``state =
{"params": ..., "opt": OptState}``.  With ``accum_steps`` > 1 the batch's
leading axis splits into contiguous microbatches (rows ``[i*B/a,
(i+1)*B/a)``, a reshape as in JAX); each one's gradients are added into an
accumulator made as ``p * 0`` in ``accum_dtype``, which is divided by
``accum_steps`` after the sum; the loss and metrics are the microbatches'
means.  With one step the gradients keep the parameters' dtype and the
optimizer upcasts them.  ``grad_norm`` is taken on those gradients, before
any clipping.  The step follows the parameters' device: batch arrays go
there.  The update writes the parameters and moments in place (see
``train.optimizer``): the returned state holds the same tensors.

``grad_shardings`` (a tree of ``dist.api.NamedSharding`` in the params'
structure, for parameters that are ``DTensor``s) pins the accumulator and
each microbatch's gradients to those layouts before they are added, as
the JAX step's ``with_sharding_constraint`` keeps them reduce-scattered
onto the parameters' shardings (a plain tensor's gradient stays as it
is); None pins a ``DTensor`` parameter's gradients to its own layout
(autograd gives a replicated parameter's gradient as a pending sum).
``unroll_accum`` (an XLA knob) has no counterpart and is left out.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from repro_torch.dist.api import is_dtensor
from repro_torch.models import common as cm
from repro_torch.models import egnn
from repro_torch.models import recsys as rs
from repro_torch.models import transformer as tf
from repro_torch.train import tree
from repro_torch.train.optimizer import Optimizer, global_norm

__all__ = ["value_and_grad", "make_train_step", "lm_loss_fn",
           "make_lm_train_step", "ctr_loss_fn", "seqrec_loss_fn",
           "egnn_loss_fn"]


def value_and_grad(loss_fn: Callable) -> Callable:
    """``jax.value_and_grad(loss_fn, has_aux=True)``: ``(params, batch) ->
    ((loss, metrics), grads)``, grads in the params' structure (zeros for
    a leaf the loss does not reach), everything detached.  The params'
    tensors are read through detached aliases: their ``requires_grad``
    flags are left as they are.  Batch arrays go to the params' device."""

    def fn(params, batch):
        batch = _to_device(batch, tree.leaves(params)[0].device)
        aliases = tree.map(lambda p: p.detach().requires_grad_(), params)
        leaves = tree.leaves(aliases)
        with torch.enable_grad():
            loss, metrics = loss_fn(aliases, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (loss.detach(), metrics), tree.unflatten(params, grads)

    return fn


def _to_device(batch: dict, dev: torch.device) -> dict:
    return tree.map(lambda a: torch.as_tensor(a, device=dev), batch)


def make_train_step(loss_fn: Callable, optimizer: Optimizer,
                    accum_steps: int = 1,
                    accum_dtype: torch.dtype = torch.float32,
                    grad_shardings=None) -> Callable:
    """``loss_fn(params, microbatch) -> (scalar, metrics dict)``; returns
    ``train_step(state, batch) -> (state, metrics)``."""
    grad_fn = value_and_grad(loss_fn)

    def pin(t, params):
        # the gradients on the parameters' layouts (``grad_shardings``, or
        # each DTensor parameter's own: a replicated parameter's gradient
        # comes back a pending sum); a plain tensor is the whole value on
        # every rank, as under ``constrain``
        if grad_shardings is not None:
            return tree.map(lambda g, s: g.redistribute(s.mesh, s.placements)
                            if is_dtensor(g) else g, t, grad_shardings)
        return tree.map(lambda g, p: g.redistribute(p.device_mesh,
                                                    p.placements)
                        if is_dtensor(g) and is_dtensor(p) else g, t, params)

    def train_step(state, batch):
        params = state["params"]
        batch = _to_device(batch, tree.leaves(params)[0].device)
        if accum_steps == 1:
            (loss, metrics), grads = grad_fn(params, batch)
            grads = pin(grads, params)
        else:
            def micro(i):
                def rows(x):
                    n = x.shape[0] // accum_steps
                    if n * accum_steps != x.shape[0]:
                        raise ValueError(f"{x.shape[0]} rows do not split "
                                         f"into {accum_steps} microbatches")
                    return x[i * n:(i + 1) * n]
                return tree.map(rows, batch)

            with torch.no_grad():
                acc = pin(tree.map(lambda p: (p * 0).to(accum_dtype),
                                   params), params)
            losses, metricses = [], []
            for i in range(accum_steps):
                (l, m), g = grad_fn(params, micro(i))
                with torch.no_grad():
                    tree.map(lambda a, b: a.add_(b.to(accum_dtype)), acc,
                             pin(g, params))
                del g
                losses.append(l)
                metricses.append(m)
            with torch.no_grad():
                grads = tree.map(lambda a: a.div_(accum_steps), acc)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in metricses]).mean()
                       for k in metricses[0]}
        new_params, new_opt = optimizer.update(grads, state["opt"], params)
        metrics = dict(metrics, loss=loss, grad_norm=global_norm(grads))
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


# ------------------------------------------------------------------- LM

def lm_loss_fn(params, batch, cfg: tf.TransformerConfig,
               remat: str = "full"):
    """CE of the next token, plus the MoE aux loss and, for an MTP config,
    ``mtp_weight`` times the CE of the token after it (labels shifted once
    more, the last position padded with -1)."""
    logits, aux, hidden, _ = tf.forward(params, batch["tokens"], cfg,
                                        remat=remat)
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    loss = cm.cross_entropy(logits, labels)
    total = loss + aux
    if cfg.mtp:
        m_logits = tf.mtp_logits(params, batch["tokens"], hidden, cfg)
        mtp_labels = torch.nn.functional.pad(labels[:, 1:], (0, 1), value=-1)
        total = total + cfg.mtp_weight * cm.cross_entropy(m_logits,
                                                          mtp_labels)
    return total, {"ce": loss, "aux": aux}


def make_lm_train_step(cfg: tf.TransformerConfig, optimizer: Optimizer,
                       accum_steps: int = 1, remat: str = "full",
                       accum_dtype: torch.dtype = torch.float32,
                       grad_shardings=None) -> Callable:
    return make_train_step(functools.partial(lm_loss_fn, cfg=cfg,
                                             remat=remat),
                           optimizer, accum_steps, accum_dtype,
                           grad_shardings)


# ---------------------------------------------------- the cells' losses

def _bce_with_logits(x: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """The JAX package's formula: mean of max(x, 0) - x * l +
    log1p(exp(-|x|))."""
    return torch.mean(torch.clamp(x, min=0) - x * label
                      + torch.log1p(torch.exp(-torch.abs(x))))


def ctr_loss_fn(params, batch, cfg):
    """DLRM (``dense``, ``sparse``, ``label``) or xDeepFM (``sparse``,
    ``label``): BCE with logits over the forward through the gather
    branch, as ``launch/cells.py`` trains them."""
    if isinstance(cfg, rs.DLRMConfig):
        logits = rs.dlrm_forward(params, batch["dense"], batch["sparse"],
                                 cfg, use_kernel=False)
    else:
        logits = rs.xdeepfm_forward(params, batch["sparse"], cfg,
                                    use_kernel=False)
    return _bce_with_logits(logits, batch["label"]), {}


def seqrec_loss_fn(params, batch, cfg: rs.SeqRecConfig):
    """SASRec / BERT4Rec (``items``, ``pos``, ``neg``): the BCE of one
    positive and one sampled negative per position."""
    return rs.seqrec_bce_loss(params, batch["items"], batch["pos"],
                              batch["neg"], cfg), {}


def egnn_loss_fn(params, batch, cfg: egnn.EGNNConfig,
                 n_graphs: Optional[int] = None,
                 plan: Optional[egnn.GraphPlan] = None):
    """EGNN (``feat``, ``coords``, ``edge_index``, ``labels``, and
    ``graph_ids`` for a graph readout): the CE of the logits over the
    labels (< 0 masked), each layer's edge chunks checkpointed."""
    logits, _ = egnn.forward(params, batch["feat"], batch["coords"],
                             batch["edge_index"], cfg,
                             graph_ids=batch.get("graph_ids"),
                             n_graphs=n_graphs, plan=plan, remat=True)
    return cm.cross_entropy(logits[None], batch["labels"][None]), {}
