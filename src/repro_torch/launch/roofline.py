"""Roofline terms of the port on an NVIDIA H100, and the cost counts of the
paths ``chip_smoke.py`` bounds.

The port of ``repro.launch.roofline``, whose hardware model is a TPU v5e.
Here ``HW`` is the H100 SXM data sheet (dense rates, at the 700 W power
limit): figures from the data sheet, not measurements.

  * ``Roofline`` has the JAX module's fields, properties and ``to_dict``
    keys; ``t_collective`` runs the collective bytes over one NVLink 4
    direction.
  * ``collective_bytes(records)`` totals per kind the output bytes of the
    collectives a dry-run recorded (``launch.dryrun``): for an all-gather
    the gathered result, the JAX module's convention (an upper bound on
    the per-device ring traffic; a reduce-scatter's scattered output
    understates it by about (n - 1) / n).  The JAX module parses them out
    of HLO text, which PyTorch has no counterpart of.
  * ``analyze(counts, model_flops, n_devices)`` and ``memory_summary``
    read a dry-run's ``Counts``.

The cost counts below (``bound``, ``lm_costs``, ``lm_bound``,
``lm_train_ops``, ``recsys_train_ops``, ``egnn_costs``) give the bounds
PERF.md quotes for the card's paths: the least time for the bytes a path
must move at ``HBM_BPS`` against its operations at the rate of their
type.
"""

from __future__ import annotations

import dataclasses

__all__ = ["HW", "HBM_BPS", "BF16_OPS", "F32_OPS", "I8_OPS", "COLLECTIVES",
           "collective_bytes", "Roofline", "analyze", "memory_summary",
           "bound", "lm_costs", "lm_bound", "lm_train_ops",
           "recsys_train_ops", "egnn_costs"]

# H100 SXM data sheet (dense, 700 W): not a measurement
HW = {
    "flops_bf16": 989e12,     # bf16 on the tensor cores
    "flops_f32": 67e12,       # f32 on the CUDA cores
    "ops_int8": 1979e12,      # int8 on the tensor cores
    "hbm_bw": 3.35e12,        # bytes/s
    "link_bw": 450e9,         # NVLink 4, bytes/s a direction
}
HBM_BPS, F32_OPS, I8_OPS = HW["hbm_bw"], HW["flops_f32"], HW["ops_int8"]
BF16_OPS = HW["flops_bf16"]

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def collective_bytes(records) -> dict:
    """Per-kind byte totals (per device) of ``records``: (kind, output
    bytes) pairs, ``kind`` one of ``COLLECTIVES``."""
    out = {k: 0 for k in COLLECTIVES}
    for kind, nbytes in records:
        out[kind] += int(nbytes)
    out["total"] = sum(out[k] for k in COLLECTIVES)
    return out


@dataclasses.dataclass
class Roofline:
    flops: float              # per-device flops
    hbm_bytes: float          # per-device bytes accessed
    coll_bytes: float         # per-device collective bytes
    model_flops: float        # analytic useful flops (global)
    n_devices: int

    @property
    def t_compute(self) -> float:
        return self.flops / HW["flops_bf16"]

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HW["hbm_bw"]

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / HW["link_bw"]

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        total = self.flops * self.n_devices
        return self.model_flops / total if total else float("nan")

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the dominant-roofline bound spent doing useful model
        flops: (model_flops / chips / peak) / bound_time."""
        ideal = self.model_flops / self.n_devices / HW["flops_bf16"]
        return ideal / self.bound_time if self.bound_time else float("nan")

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "collective_bytes_per_device": self.coll_bytes,
            "model_flops": self.model_flops,
            "n_devices": self.n_devices,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def analyze(counts, model_flops: float, n_devices: int):
    """(``Roofline``, per-kind collective bytes) of a dry-run's
    ``Counts``."""
    coll = collective_bytes(counts.collectives)
    rl = Roofline(flops=float(counts.flops), hbm_bytes=float(counts.bytes),
                  coll_bytes=float(coll["total"]), model_flops=model_flops,
                  n_devices=n_devices)
    return rl, coll


def memory_summary(counts) -> dict:
    """The JAX module's ``memory_analysis`` keys from a dry-run's
    ``Counts``: the arguments' and outputs' local bytes, the bytes the
    outputs share with the arguments (updated in place), the peak of live
    local storage (``total_hbm_bytes``) and what it holds beyond the
    arguments and outputs (``temp_size_in_bytes``)."""
    arg, out, alias = counts.arg_bytes, counts.out_bytes, counts.alias_bytes
    peak = counts.peak_bytes
    return {"argument_size_in_bytes": int(arg),
            "output_size_in_bytes": int(out),
            "alias_size_in_bytes": int(alias),
            "temp_size_in_bytes": int(max(peak - (arg + out - alias), 0)),
            "total_hbm_bytes": int(peak)}


# ------------------------------------------------- the card's path costs

def bound(nbytes: float, ops: float, rate: float):
    """(least time in ms, what bounds it) for moving ``nbytes`` through
    device memory and doing ``ops`` at ``rate``."""
    tb, to = nbytes / HBM_BPS * 1e3, ops / rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def lm_costs(cfg, params, b, s, ctx, kept):
    """(bf16 operations, f32 operations, bytes) of one forward of ``s`` new
    tokens a row over ``ctx`` positions (a prefill: s = ctx; a decode step:
    s = 1) with ``kept`` routed (token, choice) pairs over its MoE layers.  The
    products count at their operand dtype (attention and the router in f32,
    as the reference computes them), attention over the causal pairs it
    needs.  The bytes: every layer weight and the head read once (every
    expert, as the reference's expert product over all E reads them), the
    embedding rows, the caches read or written, the logits written."""
    from repro_torch.models import transformer as tf

    t, d, h = b * s, cfg.d_model, cfg.n_heads
    pairs = b * (s * (s + 1) // 2 if s == ctx else ctx)
    bf, f32 = 0, 0
    if cfg.attention == "mla":
        m = cfg.mla
        dn, dr, dv, r = (m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim,
                         m.kv_lora_rank)
        bf += 2 * t * (d * m.q_lora_rank + m.q_lora_rank * h * (dn + dr)
                       + d * (r + dr) + h * dv * d)
        if s == ctx:        # up-projected keys and values, f32 attention
            bf += 2 * t * r * h * (dn + dv)
            f32 += 2 * pairs * h * (dn + dr + dv)
        else:               # absorbed: q_lat in bf16, the rest in f32
            bf += 2 * t * h * dn * r
            f32 += 2 * pairs * h * (2 * r + dr) + 2 * t * h * r * dv
        cache_row = r + dr
    else:
        dh, kv = cfg.head_dim, cfg.n_kv_heads
        bf += 2 * t * d * (h + 2 * kv) * dh + 2 * t * h * dh * d
        f32 += 2 * pairs * h * 2 * dh
        cache_row = 2 * kv * dh
    bf, f32 = bf * cfg.n_layers, f32 * cfg.n_layers
    for kind, count in cfg.layer_groups():
        if kind == "moe":
            mo = cfg.moe
            fs = mo.d_ff_shared or mo.d_ff * mo.n_shared
            bf += 2 * 3 * d * (kept * mo.d_ff
                               + (count * t * fs if mo.n_shared else 0))
            f32 += count * 2 * t * d * mo.n_experts
        else:
            bf += count * 2 * t * 3 * d * cfg.d_ff
    bf += 2 * t * d * cfg.vocab_size
    el = cfg.dtype.itemsize
    weights = sum(v.numel() * v.element_size() for k, tree in params.items()
                  if k not in ("embed", "mtp") for v in tf._leaves(tree))
    nbytes = (weights + t * d * el + b * ctx * cache_row * el * cfg.n_layers
              + t * cfg.vocab_size * el)
    return bf, f32, nbytes


def lm_bound(bf, f32, nbytes):
    """(ms, what bounds it): the bytes at HBM_BPS against the bf16
    operations at BF16_OPS plus the f32 ones at F32_OPS."""
    tb = nbytes / HBM_BPS * 1e3
    to = (bf / BF16_OPS + f32 / F32_OPS) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def lm_train_ops(cfg, layer, tokens, b, s):
    """Operations of one LM train step with remat "full": 6 x the active
    parameters that enter a product (the head's D x V included, the
    embedding's gather not) x tokens, the layers' forward again (remat),
    and attention's QK^T and PV over the whole (s, s) block, 4 times (the
    forward, the recompute and the backward's two)."""
    attn = 4 * b * s * s * cfg.n_heads * cfg.head_dim * cfg.n_layers
    head = cfg.d_model * cfg.vocab_size
    return 6 * (layer + head) * tokens + 2 * layer * tokens + 4 * attn


def recsys_train_ops(arch, cfg, b) -> float:
    """Operations of one recsys train step: 3 x the forward's count of
    ``launch/cells.py``'s ``_recsys_flops`` (forward and backward), 4 x for
    the seqrec encode (each chunk encoded again in the backward)."""
    if arch == "dlrm-rm2":
        mlp = sum(a * o for a, o in zip(cfg.bot_mlp[:-1], cfg.bot_mlp[1:]))
        tops = [cfg.embed_dim + 27 * 26 // 2, *cfg.top_mlp_hidden]
        mlp += sum(a * o for a, o in zip(tops[:-1], tops[1:]))
        return 3 * 2.0 * b * (mlp + 27 * 27 * cfg.embed_dim)
    if arch == "xdeepfm":
        m, dd = cfg.n_sparse, cfg.embed_dim
        cin, h_prev = 0, m
        for h in cfg.cin_layers:
            cin += h_prev * m * dd + h * h_prev * m * dd
            h_prev = h
        sizes = [m * dd, *cfg.mlp, 1]
        dnn = sum(a * o for a, o in zip(sizes[:-1], sizes[1:]))
        return 3 * 2.0 * b * (cin + dnn)
    d, s = cfg.embed_dim, cfg.max_len
    per_tok = 4 * d * d + 2 * cfg.d_ff_mult * d * d + 2 * s * d
    return 4 * 2.0 * b * s * cfg.n_blocks * per_tok


def egnn_costs(cfg, n_nodes, n_edges, n_out, d_feat):
    """(bytes, operations) of one forward: ``launch/cells.py``'s message
    passing count over the edges and nodes this run holds (valid edges
    only), plus the encoder and the head; the inputs read once (features,
    coordinates, edge ids) and the outputs written once."""
    dh = cfg.d_hidden
    per_edge = 2 * ((2 * dh + 1) * dh + dh * dh + dh * dh + dh)
    per_node = 2 * (2 * dh * dh + dh * dh)
    ops = (cfg.n_layers * (n_edges * per_edge + n_nodes * per_node)
           + 2 * n_nodes * d_feat * dh
           + 2 * n_out * (dh * dh + dh * cfg.n_classes))
    nbytes = (n_nodes * (d_feat + 3) * 4 + n_edges * 8
              + n_out * cfg.n_classes * 4 + n_nodes * 12)
    return nbytes, ops
