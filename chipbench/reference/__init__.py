"""The plain reference the outputs are held against.

Plain PyTorch in float32, written from the published descriptions and the
configuration's sizes, with no kernel, cache or batching of the program:
it imports neither ``jax``, the JAX package nor ``repro_torch``, and takes
nothing the program made (it makes its weights and corpus again from the
seed through ``chipbench.inputs``).

``precision`` is "f32" (the configuration's precision: full float32
products, TF32 off) or "tf32": every product's operands rounded to TF32's
10-bit mantissa and summed in float32, what TF32 tensor cores compute.
The second is the control of ``correct``: the step below the stated
precision that a later change might take.
"""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("f32", "tf32")


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to the nearest TF32 value (10 mantissa bits)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` in float32, or with TF32 operands."""
    if precision == "tf32":
        a, b = to_tf32(a), to_tf32(b)
    elif precision != "f32":
        raise ValueError(f"precision {precision!r}: expected {PRECISIONS}")
    return a @ b


@contextlib.contextmanager
def full_f32():
    """Products in full float32 while the reference runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])
