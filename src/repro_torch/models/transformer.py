"""Config-driven LM transformer family.

The port of ``repro.models.transformer``.  One implementation covers the
JAX package's LM architectures:

  * GQA attention (chatglm3 kv=2, mistral kv=8, gemma2 kv=8, llama4 kv=8,
    STAR kv=H) through ``models.common.blockwise_attention``;
  * MLA latent attention (deepseek-v3): the prefill up-projects the
    latent to per-head keys and values, the decode step attends in the
    latent space against the (c_kv, k_rope) cache (the absorbed form);
    with ``q_lora_rank`` None (Moonlight) q is one projection of x;
  * MoE FFN with shared experts (``models.moe``: deepseek 256 experts
    top-8 + 1 shared, llama4-scout 16 top-1 + 1 shared) after
    ``n_dense_layers`` dense ones, and deepseek's MTP head
    (``mtp_logits``); a dropless MoE config (``capacity_factor`` None)
    gets the real-token mask of the rows (ids >= 0), so that pads are
    neither routed nor computed, and nothing else builds it;
  * RoPE (full, chatglm's interleaved half), per-layer local / global
    window schedules, attention and final logit softcaps, pre + post and
    zero-centred RMSNorms (gemma2), scaled embeddings, tied or untied head;
  * the decode path: ``forward(return_kv=True, kv_len=)`` returns the
    prefill's caches zero-padded to ``kv_len``, ``init_kv_caches`` empty
    ones, and ``decode_step`` appends one token for the whole batch.

Parameters keep the JAX package's tree: ``embed`` (V, D), ``final_norm``,
``lm_head`` (D, V) when untied, the layers stacked in ``group{i}_{kind}``
with a leading layer axis (``kind`` dense or moe), and ``mtp/{proj,
block, norm_h, norm_e}`` (``block`` one unstacked dense layer); weights
(d_in, d_out) for ``x @ w``.  Carrying JAX weights across is a copy of
arrays (``repro_torch.convert.transformer_params_from_numpy``).
``forward`` loops over the stacked layers and indexes each layer's slice
(a view, no copy): the JAX package's ``lax.scan``.  Its ``remat`` picks
what a layer keeps for the backward (``REMAT_POLICIES``): ``"none"``
everything, ``"full"`` only its input (``torch.utils.checkpoint`` around
each block, recomputed in the backward), ``"dots"`` its matrix products'
outputs (selective checkpointing: ``mm`` / ``bmm`` saved, the rest
recomputed).  The values are the same under every policy; a policy only
applies while autograd records, so the serving forward is untouched.  The
JAX forward defaults to ``"full"``; the port's to ``"none"`` (serving),
and its ``train.step.lm_loss_fn`` to ``"full"`` as the JAX one.

``hidden_states`` is the forward without the head: an encoder pools the
hidden states and never needs logits (under ``jax.jit`` XLA drops the
unused head; an eager head would cost the STAR encoder 2 x 4,096 x 768 x
30,522 operations and a 500 MB output at 64 x 64 tokens).

The matrix products are plain ``torch`` calls (XLA's in the JAX package):
float32 configs expect TF32 off, PyTorch's default for matmul; bf16
configs expect f32 accumulation (XLA's), i.e.
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
False on the card.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.dist.api import active_mesh, active_rules, axis_sizes, \
    constrain, data_axes, fit_spec, is_dtensor, to_placements
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import common as cm
from repro_torch.models.moe import MoEConfig, init_moe, moe_ffn, \
    moe_ffn_dropless, moe_ffn_sharded

__all__ = ["REMAT_POLICIES", "MLAConfig", "TransformerConfig",
           "init_params", "param_count", "active_param_count",
           "hidden_states", "forward", "mtp_logits", "init_kv_caches",
           "decode_step", "Transformer"]


# --------------------------------------------------------------- configs

@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: Optional[int] = 1536       # None: q = x @ wq, no latent
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None
    attention: str = "gqa"                  # "gqa" | "mla"
    mla: Optional[MLAConfig] = None
    rope_theta: float = 1e4
    rotary_frac: float = 1.0                # 0.5 => chatglm partial rotary
    rope_interleaved: bool = False
    window: Optional[int] = None
    layer_pattern: Optional[str] = None     # cycled, e.g. "lg" (gemma2)
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    moe: Optional[MoEConfig] = None
    n_dense_layers: int = 0                 # leading dense layers when MoE
    mtp: bool = False                       # deepseek multi-token prediction
    mtp_weight: float = 0.3
    norm_eps: float = 1e-6
    use_post_norm: bool = False             # gemma2 pre+post norms
    zero_centered_norm: bool = False        # gemma-style (1 + w)
    embed_scale: bool = False               # multiply embeddings by sqrt(d)
    tie_embeddings: bool = True
    dtype: torch.dtype = torch.bfloat16
    q_chunk: int = 512
    kv_chunk: int = 1024

    @property
    def head_dim(self) -> int:
        if self.attention == "mla":
            m = self.mla or MLAConfig()
            return m.qk_nope_dim + m.qk_rope_dim
        return self.d_head or self.d_model // self.n_heads

    @property
    def v_head_dim(self) -> int:
        if self.attention == "mla":
            return (self.mla or MLAConfig()).v_head_dim
        return self.d_head or self.d_model // self.n_heads

    def layer_groups(self):
        """[(kind, count)] — dense-prefix then MoE remainder."""
        if self.moe is None:
            return [("dense", self.n_layers)]
        nd = self.n_dense_layers
        out = []
        if nd:
            out.append(("dense", nd))
        out.append(("moe", self.n_layers - nd))
        return out

    def window_schedule(self) -> tuple:
        """Per-layer window sizes as Python ints; 0 = unlimited (global)."""
        if self.layer_pattern is None:
            return (self.window or 0,) * self.n_layers
        pat = (self.layer_pattern * self.n_layers)[: self.n_layers]
        return tuple((self.window or 0) if c == "l" else 0 for c in pat)


# ------------------------------------------------------------ param init

def _norm_init(cfg: TransformerConfig, shape, device) -> torch.Tensor:
    fill = torch.zeros if cfg.zero_centered_norm else torch.ones
    return fill(shape, dtype=torch.float32, device=device)


def _init_attn(cfg: TransformerConfig, lead: tuple, kw: dict) -> dict:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = d ** -0.5
    if cfg.attention == "mla":
        m = cfg.mla or MLAConfig()
        dn, dr, dv, r = (m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim,
                         m.kv_lora_rank)
        ones = dict(dtype=torch.float32, device=kw["device"])
        if m.q_lora_rank is None:
            q = {"wq": cm.normal(lead + (d, h * (dn + dr)), s, **kw)}
        else:
            q = {"wdq": cm.normal(lead + (d, m.q_lora_rank), s, **kw),
                 "q_norm": torch.ones(lead + (m.q_lora_rank,), **ones),
                 "wuq": cm.normal(lead + (m.q_lora_rank, h * (dn + dr)),
                                  m.q_lora_rank ** -0.5, **kw)}
        return {
            **q,
            "wdkv": cm.normal(lead + (d, r), s, **kw),
            "kv_norm": torch.ones(lead + (r,), **ones),
            "wkr": cm.normal(lead + (d, dr), s, **kw),
            "wuk": cm.normal(lead + (r, h * dn), r ** -0.5, **kw),
            "wuv": cm.normal(lead + (r, h * dv), r ** -0.5, **kw),
            "wo": cm.normal(lead + (h * dv, d),
                            (h * dv) ** -0.5 / (2 * cfg.n_layers) ** 0.5,
                            **kw),
        }
    return {
        "wq": cm.normal(lead + (d, h * dh), s, **kw),
        "wk": cm.normal(lead + (d, kv * dh), s, **kw),
        "wv": cm.normal(lead + (d, kv * dh), s, **kw),
        "wo": cm.normal(lead + (h * dh, d),
                        (h * dh) ** -0.5 / (2 * cfg.n_layers) ** 0.5, **kw),
    }


def _init_layers(cfg: TransformerConfig, kind: str, lead: tuple,
                 kw: dict) -> dict:
    """Layers of ``kind`` with leading dims ``lead``: ``(count,)`` for a
    stacked group (the JAX package vmaps ``_init_layer``), ``()`` for the
    MTP block.  Its distributions, not its values."""
    d, dev = cfg.d_model, kw["device"]
    p = {"attn": _init_attn(cfg, lead, kw),
         "pre_attn_norm": _norm_init(cfg, lead + (d,), dev),
         "pre_ffn_norm": _norm_init(cfg, lead + (d,), dev)}
    if cfg.use_post_norm:
        p["post_attn_norm"] = _norm_init(cfg, lead + (d,), dev)
        p["post_ffn_norm"] = _norm_init(cfg, lead + (d,), dev)
    if kind == "moe":
        p["ffn"] = init_moe(cfg.moe, d, cfg.dtype, lead=lead,
                            device=dev, generator=kw["generator"])
    else:
        p["ffn"] = {
            "wi": cm.normal(lead + (d, 2 * cfg.d_ff), d ** -0.5, **kw),
            "wo": cm.normal(lead + (cfg.d_ff, d),
                            cfg.d_ff ** -0.5 / (2 * cfg.n_layers) ** 0.5,
                            **kw),
        }
    return p


def init_params(cfg: TransformerConfig, *, device=None,
                generator: Optional[torch.Generator] = None) -> dict:
    """The JAX package's tree, shapes and scales (not its values), drawn
    from ``generator`` on ``device`` (None means ``cuda``)."""
    dev = resolve_device(device)
    kw = dict(dtype=cfg.dtype, device=dev, generator=generator)
    d = cfg.d_model
    params = {
        "embed": cm.normal((cfg.vocab_size, d), 0.02, **kw),
        "final_norm": _norm_init(cfg, (d,), dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = cm.normal((d, cfg.vocab_size), d ** -0.5, **kw)
    for gi, (kind, count) in enumerate(cfg.layer_groups()):
        params[f"group{gi}_{kind}"] = _init_layers(cfg, kind, (count,), kw)
    if cfg.mtp:
        params["mtp"] = {
            "proj": cm.normal((2 * d, d), (2 * d) ** -0.5, **kw),
            "block": _init_layers(cfg, "dense", (), kw),
            "norm_h": torch.ones((d,), dtype=torch.float32, device=dev),
            "norm_e": torch.ones((d,), dtype=torch.float32, device=dev),
        }
    return params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def param_count(params) -> int:
    return sum(int(x.numel()) for x in _leaves(params))


def active_param_count(cfg: TransformerConfig, params) -> int:
    """Active params per token (MoE: top_k + shared experts only)."""
    total = param_count(params)
    if cfg.moe is None:
        return total
    m = cfg.moe
    routed_per_layer = m.n_experts * (cfg.d_model * 2 * m.d_ff
                                      + m.d_ff * cfg.d_model)
    n_moe = cfg.n_layers - cfg.n_dense_layers
    inactive = n_moe * routed_per_layer * (1 - m.top_k / m.n_experts)
    return int(total - inactive)


def _layer(stack: dict, i: int) -> dict:
    """Layer ``i`` of a stacked group: views, no copy."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stack.items()}


def _rope(cfg: TransformerConfig, positions: torch.Tensor):
    """(cos, sin) of a forward, shared by its layers.  MLA rotates only its
    ``qk_rope_dim`` dims (of q_rope and the one shared k_rope head), full
    rotary and never interleaved, whatever ``head_dim`` (192 for deepseek)
    and ``rotary_frac`` say: the JAX package calls ``apply_rope`` there
    with its defaults."""
    if cfg.attention == "mla":
        return cm.rope_angles(positions, (cfg.mla or MLAConfig()).qk_rope_dim,
                              cfg.rope_theta)
    return cm.rope_angles(positions, cfg.head_dim, cfg.rope_theta,
                          cfg.rotary_frac)


# ------------------------------------------------------------- attention

def _write(cache: torch.Tensor, new: torch.Tensor, cur_len: int) -> None:
    """The new token's entry at position cur_len - 1 of a (B, Smax, ...)
    cache, in place.  A ``DTensor`` cache is written block by block: the
    rank whose block of positions holds cur_len - 1 writes it there (a
    sequence-sharded cache cannot take a sliced copy)."""
    if not is_dtensor(cache):
        cache[:, cur_len - 1:cur_len] = new
        return
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, pl = cache.device_mesh, list(cache.placements)
    if not is_dtensor(new):
        new = DTensor.from_local(new, mesh, [Replicate()] * len(pl),
                                 run_check=False)
    shape, offset = compute_local_shape_and_global_offset(cache.shape, mesh,
                                                          pl)
    pos = cur_len - 1 - offset[1]
    row = new.redistribute(mesh, [Replicate() if p.is_shard(1) else p
                                  for p in pl]).to_local()
    if 0 <= pos < shape[1]:
        cache.to_local()[:, pos:pos + 1] = row


def _heads(t: torch.Tensor, n: int, dh: int, name: str) -> torch.Tensor:
    """(b, s, n * dh) -> (b, s, n, dh).  A ``DTensor`` is first laid out
    as the rule ``name`` lays out the heads: its flat dim cannot be split
    in place where it is sharded over more ranks than the heads divide
    (40 heads over a model axis of 16; GSPMD pads such a split)."""
    b, s, _ = t.shape
    spec = active_rules().get(name)
    if spec is not None and is_dtensor(t):
        mesh = active_mesh()
        heads = fit_spec(spec, (b, s, n, dh), mesh)
        if heads is not None:
            t = t.redistribute(mesh, to_placements(
                fit_spec(heads[:3], tuple(t.shape), mesh), mesh))
    return t.view(b, s, n, dh)


def _attn_gqa(p: dict, x: torch.Tensor, rope, window: int,
              cfg: TransformerConfig, masks: dict, cache=None,
              cur_len: Optional[int] = None):
    """GQA self-attention of one layer: causal over x (prefill), or one
    token against ``cache`` (decode).  Returns (out, (k, v)): the layer's
    keys and values (prefill) or the updated cache."""
    b, s, _d = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _heads(x @ p["wq"], h, dh, "act_bshd")
    k = _heads(x @ p["wk"], kv, dh, "act_bskd")
    v = _heads(x @ p["wv"], kv, dh, "act_bskd")
    q = constrain(cm.rotate(q, *rope, cfg.rope_interleaved), "act_bshd")
    k = constrain(cm.rotate(k, *rope, cfg.rope_interleaved), "act_bskd")
    v = constrain(v, "act_bskd")
    if cache is not None:
        k_cache, v_cache = cache
        _write(k_cache, k, cur_len)
        _write(v_cache, v, cur_len)
        # the query's heads laid out as the cache's KV heads (each group
        # of H / KV query heads reads one)
        o = cm.decode_attention(constrain(q, "act_bskd"),
                                constrain(k_cache, "kv_cache"),
                                constrain(v_cache, "kv_cache"), cur_len,
                                window=window, logit_cap=cfg.attn_softcap)
        new = cache
    else:
        o = cm.blockwise_attention(q, k, v, causal=True, window=window,
                                   q_chunk=cfg.q_chunk,
                                   kv_chunk=cfg.kv_chunk,
                                   logit_cap=cfg.attn_softcap, masks=masks)
        new = (k, v)
    o = constrain(o, "act_bshd")
    return o.reshape(b, s, h * dh) @ p["wo"], new


def _attn_mla(p: dict, x: torch.Tensor, rope, window: int,
              cfg: TransformerConfig, masks: dict, cache=None,
              cur_len: Optional[int] = None):
    """MLA: latent-compressed KV.  The prefill up-projects the latent to
    per-head keys and values (the faithful form); the decode step uses the
    absorbed form against the (c_kv, k_rope) cache.  Returns (out,
    (c_kv, k_rope)) as ``_attn_gqa`` does."""
    m = cfg.mla or MLAConfig()
    b, s, _d = x.shape
    h = cfg.n_heads
    dn, dr, dv, r = m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim, m.kv_lora_rank

    if m.q_lora_rank is None:
        qall = (x @ p["wq"]).view(b, s, h, dn + dr)
    else:
        cq = cm.rms_norm(x @ p["wdq"], p["q_norm"], cfg.norm_eps)
        qall = (cq @ p["wuq"]).view(b, s, h, dn + dr)
    q_nope = qall[..., :dn]
    q_rope = cm.rotate(qall[..., dn:], *rope)
    ckv = cm.rms_norm(x @ p["wdkv"], p["kv_norm"], cfg.norm_eps)    # (b,s,r)
    # the one k_rope head all query heads share: (b, s, dr)
    kr = cm.rotate((x @ p["wkr"])[:, :, None, :], *rope)[:, :, 0, :]
    scale = (dn + dr) ** -0.5

    if cache is not None:
        ckv_cache, kr_cache = cache
        _write(ckv_cache, ckv, cur_len)
        _write(kr_cache, kr, cur_len)
        ckv_cache = constrain(ckv_cache, "mla_cache")
        kr_cache = constrain(kr_cache, "mla_cache_r")
        # absorbed attention, scored in the latent space: q_lat in the
        # model dtype, then scores, softmax and o_lat in f32
        f32 = torch.float32
        q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope,
                             p["wuk"].view(r, h, dn))               # (b,1,h,r)
        c = ckv_cache.to(f32)
        sc = (torch.einsum("bqhr,bsr->bhqs", q_lat.to(f32), c)
              + torch.einsum("bqhe,bse->bhqs", q_rope.to(f32),
                             kr_cache.to(f32))) * scale
        valid = torch.arange(c.shape[1], device=x.device) < cur_len
        sc = torch.where(valid, sc, cm.NEG_INF)
        o_lat = torch.einsum("bhqs,bsr->bqhr", torch.softmax(sc, dim=-1), c)
        o = torch.einsum("bqhr,rhv->bqhv", o_lat,
                         p["wuv"].view(r, h, dv).to(f32))
        new = cache
    else:
        k_nope = (ckv @ p["wuk"]).view(b, s, h, dn)
        vfull = (ckv @ p["wuv"]).view(b, s, h, dv)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, kr[:, :, None, :].expand(b, s, h, dr)],
                      dim=-1)
        q = constrain(q, "act_bshd")
        k = constrain(k, "act_bshd")
        vfull = constrain(vfull, "act_bshd")
        o = cm.blockwise_attention(q, k, vfull, causal=True, window=window,
                                   q_chunk=cfg.q_chunk,
                                   kv_chunk=cfg.kv_chunk,
                                   logit_cap=cfg.attn_softcap, scale=scale,
                                   masks=masks)
        new = (ckv, kr)
    o = constrain(o.to(x.dtype), "act_bshd")
    return o.reshape(b, s, h * dv) @ p["wo"], new


# ----------------------------------------------------------------- block

def _dense_ffn(p: dict, x: torch.Tensor) -> torch.Tensor:
    gate, up = (x @ p["wi"]).chunk(2, dim=-1)
    h = constrain(torch.nn.functional.silu(gate) * up, "act_bsf")
    return h @ p["wo"]


def _moe(p: dict, x: torch.Tensor, cfg: MoEConfig,
         real: Optional[torch.Tensor] = None, layer: Optional[int] = None):
    """The MoE FFN of x (T, d): ``moe_ffn_dropless`` for a dropless config
    (``real`` the real-token mask, ``layer`` the layer's index), else
    ``moe_ffn_sharded`` under an active mesh of more than one rank whose
    ``"model"`` axis divides the experts and whose data ranks divide the
    tokens (the JAX package's rule: a tiny decode batch takes
    ``moe_ffn``), else ``moe_ffn``."""
    if cfg.capacity_factor is None:
        return moe_ffn_dropless(p, x, cfg, real, layer)
    mesh = active_mesh()
    if mesh is not None:
        sizes = axis_sizes(mesh)
        dp_prod = 1
        for a in data_axes(mesh):
            dp_prod *= sizes[a]
        world = dp_prod * sizes.get("model", 1)
        if "model" in sizes and cfg.n_experts % sizes["model"] == 0 \
                and world > 1 and x.shape[0] % dp_prod == 0:
            return moe_ffn_sharded(p, x, cfg, mesh)
    return moe_ffn(p, x, cfg)


def _block(p: dict, x: torch.Tensor, rope, window: int,
           cfg: TransformerConfig, kind: str, masks: dict, cache=None,
           cur_len: Optional[int] = None,
           real: Optional[torch.Tensor] = None, layer: Optional[int] = None):
    """One layer.  Returns (x, aux loss or None for a dense layer, the
    attention's (k, v) / latent pair or the updated cache).  ``real`` (B *
    S,) and ``layer`` go to a dropless MoE layer."""
    def norm(t, scale):
        return cm.rms_norm(t, scale, cfg.norm_eps, cfg.zero_centered_norm)

    attn = _attn_mla if cfg.attention == "mla" else _attn_gqa
    a_out, kv = attn(p["attn"], norm(x, p["pre_attn_norm"]), rope, window,
                     cfg, masks, cache, cur_len)
    if cfg.use_post_norm:
        a_out = norm(a_out, p["post_attn_norm"])
    x = constrain(x + a_out, "act_bsd")
    f_in = norm(x, p["pre_ffn_norm"])
    aux = None
    if kind == "moe":
        # every (batch, position) row is a token to the router, pads too,
        # unless the dropless path is given the real-token mask
        b, s, d = f_in.shape
        f_out, aux = _moe(p["ffn"], f_in.reshape(b * s, d), cfg.moe, real,
                          layer)
        f_out = constrain(f_out, "moe_out").view(b, s, d)
    else:
        f_out = _dense_ffn(p["ffn"], f_in)
    if cfg.use_post_norm:
        f_out = norm(f_out, p["post_ffn_norm"])
    return constrain(x + f_out, "act_bsd"), aux, kv


# --------------------------------------------------------------- forward

def _save_dots(ctx, op, *args, **kwargs):
    if op in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


# what a layer keeps for the backward: the JAX package's policies
REMAT_POLICIES = {
    "none": None,
    "full": {},
    "dots": {"context_fn": functools.partial(
        ckpt.create_selective_checkpoint_contexts, _save_dots)},
}


def _remat(fn, remat: str):
    """``fn`` (one layer of x) under the ``remat`` policy: checkpointed
    while autograd records, else as it is."""
    kw = REMAT_POLICIES[remat]
    if kw is None or not torch.is_grad_enabled():
        return fn
    return functools.partial(ckpt.checkpoint, fn, use_reentrant=False, **kw)


def _embed(params: dict, tokens, cfg: TransformerConfig):
    """(tokens on the parameters' device, their embeddings in the model's
    dtype).  Tensor indexing, as ``params["embed"][tokens]`` in JAX: a pad
    id of -1 reads the LAST row in both (where ``F.embedding`` raises)."""
    embed = params["embed"]
    tokens = torch.as_tensor(tokens, device=embed.device)
    x = embed[tokens].to(cfg.dtype)
    if cfg.embed_scale:
        # sqrt(d) rounded to the model's dtype first, as JAX's
        # jnp.asarray(d ** 0.5, cfg.dtype); a host scalar, no copy to the card
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype).item()
    return tokens, constrain(x, "act_bsd")


def _final_norm(params: dict, x: torch.Tensor, cfg: TransformerConfig):
    return cm.rms_norm(x, params["final_norm"], cfg.norm_eps,
                       zero_centered=cfg.zero_centered_norm)


def _trunk(params: dict, tokens, cfg: TransformerConfig,
           kv_len: Optional[int] = None, remat: str = "none"):
    """Embedding, layers and final norm over ``tokens`` (B, S).  Returns
    (hidden, aux loss summed over the MoE layers, per-group caches when
    ``kv_len`` is given: each layer's (k, v) / latent pair written into
    zeroed (count, B, kv_len, ...) buffers).  ``remat`` applies to each
    layer (not with ``kv_len``: the caches are a serving output)."""
    tokens, x = _embed(params, tokens, cfg)
    b, s = tokens.shape
    if kv_len is not None and kv_len < s:
        raise ValueError(f"kv_len {kv_len} is shorter than the prompt ({s})")
    rope = _rope(cfg, torch.arange(s, device=x.device))
    windows = cfg.window_schedule()
    masks: dict = {}
    # the dropless MoE path alone reads which rows are real
    real = (tokens.reshape(-1) >= 0 if cfg.moe is not None
            and cfg.moe.capacity_factor is None else None)
    kv_names = (("mla_cache", "mla_cache_r") if cfg.attention == "mla"
                else ("kv_cache", "kv_cache"))
    total_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    base = 0
    for gi, (kind, count) in enumerate(cfg.layer_groups()):
        stack = params[f"group{gi}_{kind}"]
        group_aux, bufs = None, None
        for i in range(count):
            block = functools.partial(_block, _layer(stack, i),
                                      rope=rope, window=windows[base + i],
                                      cfg=cfg, kind=kind, masks=masks,
                                      real=real, layer=base + i)
            if kv_len is None:
                x, aux = _remat(lambda x, f=block: f(x)[:2], remat)(x)
                kv = None
            else:
                x, aux, kv = block(x)
            if aux is not None:
                group_aux = aux if group_aux is None else group_aux + aux
            if kv_len is not None:
                kv = tuple(constrain(c, n) for c, n in zip(kv, kv_names))
                if bufs is None:
                    bufs = tuple(c.new_zeros((count, b, kv_len)
                                             + c.shape[2:]) for c in kv)
                for buf, c in zip(bufs, kv):
                    buf[i, :, :s] = c
        if group_aux is not None:
            total_aux = total_aux + group_aux
        caches.append(bufs)
        base += count
    return _final_norm(params, x, cfg), total_aux, caches


def hidden_states(params: dict, tokens: torch.Tensor,
                  cfg: TransformerConfig) -> torch.Tensor:
    """Final-normed hidden states (B, S, D) of a causal forward over
    ``tokens`` (B, S) on the parameters' device: ``forward`` without the
    head.  With right padding (-1), causal attention keeps pads out of
    every real position; so does a dropless MoE config, which neither
    routes nor computes them.  On the capacity path (the JAX package's)
    pads are tokens to the router and take capacity."""
    return _trunk(params, tokens, cfg)[0]


def _head(params: dict, hidden: torch.Tensor,
          cfg: TransformerConfig) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return constrain(cm.softcap(hidden @ w.to(cfg.dtype), cfg.final_softcap),
                     "logits")


def forward(params: dict, tokens: torch.Tensor, cfg: TransformerConfig, *,
            return_kv: bool = False, kv_len: Optional[int] = None,
            remat: str = "none"):
    """Causal forward pass (training / prefill); ``remat`` a key of
    ``REMAT_POLICIES``.

    Returns (logits, aux_loss, hidden, kv_caches_per_group) as the JAX
    package does: the aux loss summed over the MoE layers (0 for a dense
    model); with ``return_kv`` a list of per-group tuples ((k, v), or
    (c_kv, k_rope) for MLA), each (count, B, kv_len, ...) with the prompt's
    entries first and zeros after (``kv_len`` None means S), else None.
    """
    hidden, aux, caches = _trunk(
        params, tokens, cfg,
        (kv_len or torch.as_tensor(tokens).shape[1]) if return_kv else None,
        remat)
    return (_head(params, hidden, cfg), aux, hidden,
            caches if return_kv else None)


def mtp_logits(params: dict, tokens: torch.Tensor, hidden: torch.Tensor,
               cfg: TransformerConfig) -> torch.Tensor:
    """DeepSeek-style MTP (depth 1): predict token t+2 from hidden_t and the
    embedding of token t+1 (``tokens``, teacher-forced): one dense block,
    window 0, then the shared final norm and head."""
    p = params["mtp"]
    embed = params["embed"]
    tokens = torch.as_tensor(tokens, device=embed.device)
    # no embed_scale, as JAX
    emb_next = constrain(embed[tokens].to(cfg.dtype), "act_bsd")
    hidden = constrain(hidden, "act_bsd")
    s = tokens.shape[1]
    h = constrain(torch.cat([cm.rms_norm(hidden, p["norm_h"], cfg.norm_eps),
                             cm.rms_norm(emb_next, p["norm_e"], cfg.norm_eps)],
                            dim=-1) @ p["proj"], "act_bsd")
    rope = _rope(cfg, torch.arange(s, device=h.device))
    h, _aux, _kv = _block(p["block"], h, rope, 0, cfg, "dense", {})
    return _head(params, cm.rms_norm(h, params["final_norm"], cfg.norm_eps),
                 cfg)


# ----------------------------------------------------------------- decode

def init_kv_caches(cfg: TransformerConfig, batch: int, max_len: int, *,
                   device=None):
    """Per-group stacked decode caches, zeroed, on ``device`` (None means
    ``cuda``): (k, v) each (count, B, max_len, KV, Dh), or for MLA (c_kv
    (count, B, max_len, kv_lora_rank), k_rope (count, B, max_len,
    qk_rope_dim)), in the model's dtype."""
    dev = resolve_device(device)
    caches = []
    for _kind, count in cfg.layer_groups():
        if cfg.attention == "mla":
            m = cfg.mla or MLAConfig()
            shapes = [(count, batch, max_len, m.kv_lora_rank),
                      (count, batch, max_len, m.qk_rope_dim)]
        else:
            shapes = [(count, batch, max_len, cfg.n_kv_heads,
                       cfg.head_dim)] * 2
        caches.append(tuple(torch.zeros(sh, dtype=cfg.dtype, device=dev)
                            for sh in shapes))
    return caches


def decode_step(params: dict, token, caches, cur_len: int,
                cfg: TransformerConfig):
    """One token for the whole batch; writes the caller's caches in place.

    token: (B,) ids; cur_len: the sequence length *including* this token
    (an int, the same for every row).  The token's entries go into the
    tensors of ``caches`` at cur_len - 1 (the JAX package returns new
    arrays instead: a caller that branches two continuations from one
    prefill clones first).  Returns (logits (B, V), caches), the same
    cache objects."""
    cur_len = int(cur_len)
    max_len = caches[0][0].shape[2]
    if not 1 <= cur_len <= max_len:
        raise ValueError(f"cur_len {cur_len} outside the cache's 1..{max_len}")
    token, x = _embed(params, token, cfg)
    x = x[:, None, :]
    rope = _rope(cfg, torch.arange(cur_len - 1, cur_len, device=x.device))
    windows = cfg.window_schedule()
    base = 0
    for gi, (kind, count) in enumerate(cfg.layer_groups()):
        stack = params[f"group{gi}_{kind}"]
        for i in range(count):
            x, _aux, _kv = _block(_layer(stack, i), x, rope,
                                  windows[base + i], cfg, kind, {},
                                  tuple(c[i] for c in caches[gi]), cur_len)
        base += count
    return _head(params, _final_norm(params, x, cfg), cfg)[:, 0], caches


# ---------------------------------------------------------------- module

def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


class Transformer(nn.Module):
    """A transformer of any config on one device, its parameters held frozen
    (``device=None`` means the card): ``params`` (the JAX package's tree,
    e.g. from ``convert.transformer_params_from_numpy``) moved there, else
    ``init_params`` drawn from ``generator``.  ``params`` rebuilds the tree
    the functions take."""

    def __init__(self, cfg: TransformerConfig, params: Optional[dict] = None,
                 *, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if params is None:
            params = init_params(cfg, device=dev, generator=generator)
        self.cfg = cfg
        self._paths = []
        for path, leaf in _flatten(params):
            self.register_parameter("__".join(path), nn.Parameter(
                torch.as_tensor(leaf, device=dev), requires_grad=False))
            self._paths.append(path)

    @property
    def params(self) -> dict:
        tree: dict = {}
        for path in self._paths:
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = getattr(self, "__".join(path))
        return tree

    def hidden_states(self, tokens) -> torch.Tensor:
        return hidden_states(self.params, tokens, self.cfg)

    def forward(self, tokens) -> torch.Tensor:
        """Logits (B, S, V)."""
        return forward(self.params, tokens, self.cfg)[0]
