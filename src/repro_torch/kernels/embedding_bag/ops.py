"""EmbeddingBag: the pooled lookup of every recsys field (``field_pool``).

The port of ``repro.kernels.embedding_bag.ops.embedding_bag``: the JAX
wrapper pads D to 128 lanes (a TPU rule) and copies the table to do so; this
one reads the (V, D) table in place, whatever its width, and never copies
or pads it (DLRM's flattened table is 6.98 GB).  Weights are zeroed at pads,
mean divides by the count of valid items clamped to 1, and max maps a
non-finite result to 0 -- all inside the one kernel launch.

``embedding_bag`` dispatches on the table's device: CUDA launches
``csrc/embedding_bag.cu`` (counter ``embedding_bag``), CPU runs ``ref``.
The kernel has no backward (nor has the JAX package's), so on the card it
refuses a table or weights that require a gradient while autograd records:
it never hands back pooled rows without their history.  Training pools
through ``models.recsys.field_pool(..., use_kernel=False)``, the gather
branch, as the JAX package trains.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, dispatch
from repro_torch.kernels.embedding_bag import ref

__all__ = ["embedding_bag", "COUNTER", "MODES", "TABLE_DTYPES"]

COUNTER = dispatch.counter("embedding_bag")
MODES = {"sum": 0, "mean": 1, "max": 2}
# the table dtypes the kernel reads (storage codes: ``_build.STORE``)
TABLE_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_longlong] \
    + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def _validate(table, indices, weights, mode):
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {tuple(MODES)}")
    if table.dim() != 2 or table.dtype not in TABLE_DTYPES:
        raise TypeError(f"table must be (V, D) f32 / f16 / bf16, got "
                        f"{table.dtype} {tuple(table.shape)}")
    if table.shape[0] < 1:
        raise ValueError("table has no rows")
    if indices.dim() != 2 or indices.dtype != torch.int32:
        raise TypeError(f"indices must be (B, L) int32, got {indices.dtype} "
                        f"{tuple(indices.shape)}")
    if indices.device != table.device:
        raise ValueError(f"indices on {indices.device}, table on "
                         f"{table.device}")
    if weights is not None and (tuple(weights.shape) != tuple(indices.shape)
                                or not weights.is_floating_point()
                                or weights.device != table.device):
        raise ValueError(f"weights must be floating {tuple(indices.shape)} "
                         f"on {table.device}, got {weights.dtype} "
                         f"{tuple(weights.shape)} on {weights.device}")


@dispatch.kernel_extent
def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  weights: torch.Tensor | None = None,
                  mode: str = "sum") -> torch.Tensor:
    """(B, D) f32 pooled rows of ``table`` (V, D) for ``indices`` (B, L)
    int32 (< 0 padding), weighted by ``weights`` (B, L) (None: ones), in
    ``mode`` sum / mean / max."""
    COUNTER.call()
    _validate(table, indices, weights, mode)
    if not dispatch.is_kernel(table):
        return ref.embedding_bag(table, indices, weights, mode)
    if torch.is_grad_enabled() and (table.requires_grad or (
            weights is not None and weights.requires_grad)):
        raise RuntimeError(
            "embedding_bag: the kernel has no backward and cannot give the "
            "gradient this table (or its weights) requires; train through "
            "the gather branch, models.recsys.field_pool(..., "
            "use_kernel=False)")
    v, d = table.shape
    if table.stride() != (d, 1):
        raise ValueError(f"table must be row-major contiguous (stride "
                         f"{table.stride()}): the kernel reads it in place")
    b, l = indices.shape
    if b >= 2 ** 31:
        raise ValueError(f"{b} bags exceed the kernel's int32 bag index")
    indices = indices.contiguous()
    if weights is not None:
        weights = weights.to(torch.float32).contiguous()
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    fn = _build.function("embedding_bag", "embedding_bag", _ARGS)
    COUNTER.launch()
    code = fn(table.data_ptr(), indices.data_ptr(),
              None if weights is None else weights.data_ptr(), out.data_ptr(),
              b, l, d, v, _build.STORE[table.dtype], MODES[mode],
              _build.stream_of(table))
    _build.check(code, "embedding_bag")
    return out
