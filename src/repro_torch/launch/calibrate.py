"""Layer-count extrapolation of an LM cell's dry-run costs.

The port of ``repro.launch.calibrate``.  There XLA's ``cost_analysis``
counts a scanned layer once, and calibration compiles unrolled variants
at 1 and 2 layers and extrapolates.  The port's dry-run
(``launch.dryrun``) runs eagerly and counts every layer, so here
calibration is the fast path for a cell too deep to trace whole: the same
variants (dense: 1 and 2 layers; MoE: (dense, MoE) = (1, 1), (2, 1) and
(2, 2)), traced at full width, and the same extrapolation

  total(kinds) = trunk + sum_kind L_kind * delta_kind

which is exact for the counts that are linear in the layers: flops,
bytes, each kind of collective bytes, and the argument and output bytes.
The peak of live bytes is extrapolated alike (each layer adds its
parameters, optimizer state, gradients and saved activations).
``_with_layers`` sets ``n_layers`` and ``n_dense_layers``; the JAX
version also unrolls its scans, which eager PyTorch does not have.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import registry
from repro_torch.launch import roofline as rl

__all__ = ["calibrated_costs"]


def _costs(arch: str, shape: str, mesh, cfg) -> dict:
    from repro_torch.launch.cells import build_lm_cell
    from repro_torch.launch.dryrun import trace_cell
    c = trace_cell(build_lm_cell(arch, shape, mesh, cfg_override=cfg))
    coll = rl.collective_bytes(c.collectives)
    return {"flops": float(c.flops), "bytes": float(c.bytes),
            "coll": float(coll["total"]),
            **{k: float(coll[k]) for k in rl.COLLECTIVES},
            "peak": float(c.peak_bytes), "arg": float(c.arg_bytes),
            "out": float(c.out_bytes), "alias": float(c.alias_bytes)}


def _with_layers(cfg, n_dense: int, n_moe: int):
    return dataclasses.replace(cfg, n_layers=n_dense + n_moe,
                               n_dense_layers=n_dense)


def calibrated_costs(arch: str, shape: str, mesh) -> dict:
    """Extrapolated per-device flops / bytes / collective bytes (``total``
    by kind too) and memory of the cell, with the trunk and per-layer
    deltas they came from."""
    cfg = registry.get(arch).full_config()
    if cfg.moe is None:
        l_dense, l_moe = cfg.n_layers, 0
        c1 = _costs(arch, shape, mesh, _with_layers(cfg, 1, 0))
        c2 = _costs(arch, shape, mesh, _with_layers(cfg, 2, 0))
        delta_d = {k: c2[k] - c1[k] for k in c1}
        trunk = {k: c1[k] - delta_d[k] for k in c1}
        total = {k: trunk[k] + l_dense * delta_d[k] for k in c1}
        per_layer = {"dense": delta_d}
    else:
        l_dense = max(cfg.n_dense_layers, 0)
        l_moe = cfg.n_layers - l_dense
        # MoE capacity depends only on token count, not layer count -> the
        # per-layer deltas transfer exactly.
        c11 = _costs(arch, shape, mesh, _with_layers(cfg, 1, 1))
        c21 = _costs(arch, shape, mesh, _with_layers(cfg, 2, 1))
        c22 = _costs(arch, shape, mesh, _with_layers(cfg, 2, 2))
        delta_d = {k: c21[k] - c11[k] for k in c11}
        delta_m = {k: c22[k] - c21[k] for k in c11}
        trunk = {k: c11[k] - delta_d[k] - delta_m[k] for k in c11}
        total = {k: trunk[k] + l_dense * delta_d[k] + l_moe * delta_m[k]
                 for k in c11}
        per_layer = {"dense": delta_d, "moe": delta_m}
    return {"total": total, "trunk": trunk, "per_layer": per_layer,
            "layers": {"dense": l_dense, "moe": l_moe}}
