"""Quantized storage formats for the corpus scan and the cache payloads.

The port of ``repro.core.quant``.  Formats (``DTYPES``):

  * ``fp32`` — identity;
  * ``bf16`` — elementwise downcast, no scale;
  * ``int8`` — symmetric per-row quantization with an f32 scale chosen as
    ``||x|| / ||q_int||`` (not ``amax / 127``), so the dequantized row keeps
    the norm of the original exactly: Eq. 1 vectors live on the unit sphere
    and the distance algebra relies on it.

Every scorer applies the same dequantization rule: cast the payload to f32,
take the dot in f32 and multiply the *score* by the per-row scale
(``scale_scores``).  ``REPRO_CORPUS_DTYPE`` and ``REPRO_INT8_DOT`` are the
same process policies the JAX package reads, so one environment drives
both packages.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch

__all__ = ["DTYPES", "QuantizedCorpus", "default_dtype", "resolve_dtype",
           "storage_dtype", "quantize", "dequantize",
           "scale_scores", "int8_dot_default", "resolve_int8_dot"]

DTYPES = ("fp32", "bf16", "int8")

_STORAGE = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


class QuantizedCorpus(NamedTuple):
    """data (n, d) payload; scale (n,) f32 or None (fp32 / bf16)."""

    data: torch.Tensor
    scale: Optional[torch.Tensor]
    dtype: str


def default_dtype() -> str:
    """Process-wide storage policy (``REPRO_CORPUS_DTYPE``, else fp32)."""
    env = os.environ.get("REPRO_CORPUS_DTYPE", "").strip().lower()
    if not env:
        return "fp32"
    if env not in DTYPES:
        raise ValueError(f"REPRO_CORPUS_DTYPE={env!r}: expected one of {DTYPES}")
    return env


def resolve_dtype(dtype: Optional[str]) -> str:
    if dtype is None:
        return default_dtype()
    if dtype not in DTYPES:
        raise ValueError(f"dtype {dtype!r}: expected one of {DTYPES}")
    return dtype


def int8_dot_default() -> bool:
    """Process-wide int8 x int8 -> int32 scoring policy (``REPRO_INT8_DOT``)."""
    env = os.environ.get("REPRO_INT8_DOT", "").strip().lower()
    return env in ("1", "true", "yes", "on")


def resolve_int8_dot(flag: Optional[bool], payload_dtype) -> bool:
    """The explicit ``flag`` (env policy when None), active for int8 only."""
    use = int8_dot_default() if flag is None else bool(flag)
    return use and payload_dtype == torch.int8


def storage_dtype(dtype: str) -> torch.dtype:
    return _STORAGE[resolve_dtype(dtype)]


def quantize(x: torch.Tensor, dtype: Optional[str] = None) -> QuantizedCorpus:
    """Quantize (..., d) rows.  int8 keeps each row's norm exactly; an
    all-zero row quantizes to a zero payload with scale 1."""
    dtype = resolve_dtype(dtype)
    if dtype == "fp32":
        return QuantizedCorpus(x.to(torch.float32), None, dtype)
    if dtype == "bf16":
        return QuantizedCorpus(x.to(torch.bfloat16), None, dtype)
    x = x.to(torch.float32)
    amax = x.abs().amax(dim=-1, keepdim=True)
    step = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x / step), -127, 127).to(torch.int8)
    qnorm = torch.linalg.vector_norm(q.to(torch.float32), dim=-1)
    xnorm = torch.linalg.vector_norm(x, dim=-1)
    scale = torch.where(qnorm > 0, xnorm / torch.clamp(qnorm, min=1e-30),
                        torch.ones_like(qnorm))
    return QuantizedCorpus(q, scale.to(torch.float32), dtype)


def dequantize(qc: QuantizedCorpus) -> torch.Tensor:
    """f32 view of the payload (the value every scorer scores against)."""
    x = qc.data.to(torch.float32)
    if qc.scale is None:
        return x
    return x * qc.scale[..., None]


def scale_scores(scores: torch.Tensor,
                 scale: Optional[torch.Tensor]) -> torch.Tensor:
    """Score-side per-row scale: (..., n) * (n,); no-op when None."""
    if scale is None:
        return scores
    return scores * scale
