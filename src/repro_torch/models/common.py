"""Shared model building blocks: norms, RoPE, blockwise (flash-style) attention.

The port of ``repro.models.common``'s forward pieces.  Attention is the
same *blockwise online softmax* over (q_chunk, kv_chunk) blocks with f32
accumulators, written as two Python loops over the chunks (the JAX
package's two ``lax.scan``s): peak memory O(B*H*q_chunk*kv_chunk).  The
JAX package has no attention kernel (plain ``jnp`` under XLA), so neither
has the port: every step is a plain ``torch`` call.  ``decode_attention``
is one token's attention against a KV cache (the decode path).
``cross_entropy`` is the training loss.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.dist.api import constrain

__all__ = ["NEG_INF", "normal", "rms_norm", "softcap", "rope_frequencies",
           "rope_angles", "apply_rope", "rotate", "blockwise_attention",
           "decode_attention", "cross_entropy"]

NEG_INF = -1e30


def normal(shape, scale, *, dtype, device, generator) -> torch.Tensor:
    """Parameters drawn from N(0, scale^2) in ``dtype`` (the JAX package's
    ``jax.random.normal(key, shape, dtype) * scale``: its distribution,
    not its values)."""
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=device).mul_(scale)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             zero_centered: bool = False) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    w = (1.0 + scale) if zero_centered else scale
    return (y * w).to(dt)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


# ------------------------------------------------------------------ RoPE
def rope_frequencies(dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def _rot_dims(dh: int, rotary_frac: float) -> int:
    rot = int(dh * rotary_frac)
    return rot - rot % 2


def rope_angles(positions: torch.Tensor, dh: int, theta: float = 1e4,
                rotary_frac: float = 1.0):
    """(cos, sin), each (..., S, 1, rot/2) f32, for heads of ``dh`` dims:
    what ``apply_rope`` rotates by.  A forward computes them once and
    shares them across its layers."""
    freqs = rope_frequencies(_rot_dims(dh, rotary_frac), theta,
                             positions.device)
    ang = positions[..., None].to(torch.float32) * freqs      # (..., S, rot/2)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
           interleaved: bool = False) -> torch.Tensor:
    """RoPE with precomputed angles: the first ``2 * cos.shape[-1]`` dims
    of x (..., S, H, Dh) rotate, the rest pass through."""
    rot = 2 * cos.shape[-1]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    if interleaved:
        # pairs (0, 1), (2, 3), ...: stack the rotated pair on a new last
        # axis and fold it back, as the JAX package does
        x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                          dim=-1).reshape(x_rot.shape)
    else:
        half = rot // 2
        x1, x2 = x_rot[..., :half], x_rot[..., half:]
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4,
               rotary_frac: float = 1.0,
               interleaved: bool = False) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: (..., S) integers.  Rotates the first
    rotary_frac*Dh dims (chatglm-style partial rotary when frac=0.5)."""
    cos, sin = rope_angles(positions, x.shape[-1], theta, rotary_frac)
    return rotate(x, cos, sin, interleaved)


# ------------------------------------------------- blockwise attention
def _mask_block(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
                window: Optional[int]) -> torch.Tensor:
    """(q_chunk, k_chunk) bool mask: True = attend.  ``window`` None is
    unlimited; an int <= 0 is unlimited too (a per-layer schedule's global
    layers, as in gemma2)."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window is not None and window > 0:
        m &= q_pos[:, None] - k_pos[None, :] < window
    return m


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        q_chunk: int = 1024, kv_chunk: int = 1024,
                        logit_cap: Optional[float] = None,
                        scale: Optional[float] = None,
                        masks: Optional[dict] = None) -> torch.Tensor:
    """q/k: (B, Sq|Sk, H|KV, Dh); v: (B, Sk, KV, Dv) with H % KV == 0 (GQA:
    query head h reads KV head h // (H / KV)).

    Online softmax over KV chunks nested in a loop over Q chunks; f32
    accumulators; memory O(B*H*q_chunk*kv_chunk).  ``masks`` is an
    optional dict that caches each block's mask by (q chunk, kv chunk,
    window), so the layers of one forward build each mask once.
    """
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = scale if scale is not None else dh ** -0.5
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, sk)
    assert sq % q_chunk == 0 and sk % kv_chunk == 0
    nq, nk = sq // q_chunk, sk // kv_chunk
    masks = {} if masks is None else masks
    dev = q.device
    qf = q.to(torch.float32)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    if g > 1:             # jnp.repeat(x, g, axis=2): heads h*g..h*g+g-1 <- h
        kf = kf.repeat_interleave(g, dim=2)
        vf = vf.repeat_interleave(g, dim=2)

    outs = []
    for qi in range(nq):
        qblk = qf[:, qi * q_chunk:(qi + 1) * q_chunk]      # (B, qc, H, Dh)
        for ki in range(nk):
            kblk = kf[:, ki * kv_chunk:(ki + 1) * kv_chunk]  # (B, kc, H, D*)
            vblk = vf[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            s = torch.einsum("bqhd,bphd->bhqp", qblk, kblk) * scale
            s = softcap(s, logit_cap)
            key = (qi, ki, window)
            if key not in masks:
                masks[key] = _mask_block(
                    torch.arange(qi * q_chunk, (qi + 1) * q_chunk, device=dev),
                    torch.arange(ki * kv_chunk, (ki + 1) * kv_chunk,
                                 device=dev), causal=causal, window=window)
            s = torch.where(masks[key], s, NEG_INF)
            s = constrain(s, "attn_scores")
            if ki == 0:
                # the first block from the empty carry (m = NEG_INF, l = o =
                # 0): exp(NEG_INF - m) is 0, so the JAX update reduces to this
                m_prev = s.amax(dim=-1)
                p = torch.exp(s - m_prev[..., None])
                l_prev = p.sum(dim=-1)
                o_prev = torch.einsum("bhqp,bphd->bhqd", p, vblk)
                continue
            m_new = torch.maximum(m_prev, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_prev - m_new)
            l_prev = l_prev * corr + p.sum(dim=-1)
            o_prev = o_prev * corr[..., None] + torch.einsum(
                "bhqp,bphd->bhqd", p, vblk)
            m_prev = m_new
        o = o_prev / torch.clamp(l_prev[..., None], min=1e-30)
        outs.append(o.transpose(1, 2))                     # (B, qc, H, Dv)
    out = outs[0] if nq == 1 else torch.cat(outs, dim=1)
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_len, *,
                     window: Optional[int] = None,
                     logit_cap: Optional[float] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token attention against a (B, Smax, KV, Dh) cache.

    ``cur_len`` (an int, or a (B,) tensor) counts the valid cache entries,
    the new token's already written at cur_len - 1.  Query head h reads KV
    head h // (H / KV), as in ``blockwise_attention``.  A window w > 0
    keeps the entries at positions >= cur_len - w; None or w <= 0 keeps
    all.  f32 scores, softmax and values, as the JAX package computes them.
    """
    b, _one, h, dh = q.shape
    kv = k_cache.shape[2]
    g = h // kv
    scale = scale if scale is not None else dh ** -0.5
    qg = q.reshape(b, kv, g, dh).to(torch.float32)
    s = torch.einsum("bkgd,bpkd->bkgp", qg,
                     k_cache.to(torch.float32)) * scale
    s = softcap(s, logit_cap)
    pos = torch.arange(k_cache.shape[1], device=q.device)[None, :]
    # an int bound is a host scalar: no copy to the card, no wait for it
    cur = cur_len if isinstance(cur_len, int) else \
        torch.as_tensor(cur_len, device=q.device).reshape(-1, 1)
    valid = pos < cur
    if window is not None and window > 0:
        valid &= pos >= cur - window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgp,bpkd->bkgd", p, v_cache.to(torch.float32))
    return o.reshape(b, 1, h, dh).to(q.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 0.0) -> torch.Tensor:
    """Mean token CE in f32; optional z-loss.  Labels < 0 are masked; the
    denominator is the count of the others, at least 1.  The label's
    log-prob is a gather (the JAX package's masked reduction keeps a
    vocab-sharded axis sharded; one device has none): the same value."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    labels = torch.as_tensor(labels, device=logits.device)
    ll = torch.gather(logits, -1,
                      labels.clamp(min=0).long()[..., None])[..., 0]
    nll = lse - ll
    if z_loss:
        nll = nll + z_loss * lse ** 2
    mask = labels >= 0
    return (nll * mask).sum() / mask.sum().clamp(min=1)
