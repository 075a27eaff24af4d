"""Op traces for the zero-copy launch contract.

The port's counterpart of ``repro.kernels.jaxpr_util``.  The pre-padded
cache layout (``core.layout``) promises that a serving wave moves only
wave-sized operands outside its kernel launches: no copy of the
O(S * capacity * dim) stacked ``CacheState`` payload.  JAX checks that on
a traced jaxpr, walking its outer equations and never a ``pallas_call``'s
body.  Here ``trace(fn, *args)`` runs ``fn`` eagerly under a
``TorchDispatchMode`` that records every aten op outside a kernel
wrapper's extent (``kernels/dispatch.kernel_extent``: on the CPU the
plain version runs inside it, and is the launch's work, not overhead),
and counts the wrappers' calls.  From an ``OpTrace``:

  * ``kernel_call_count`` counts the kernels called (``pallas_call_count``);
  * ``payload_copy_ops(min_size)`` lists the copying ops whose output
    holds at least ``min_size`` elements (``payload_copy_eqns``): copies,
    clones, concatenations, pads and index reads and writes, and a
    payload-sized ``where`` (it reads and writes the whole payload);
  * ``moved_bytes`` totals the bytes those ops produce, ``where`` aside
    (the wave's overhead traffic).

Views move nothing in eager PyTorch (a slice is a view, unlike JAX's
``slice``), so they are not counted.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import dispatch

__all__ = ["MOVED_OPS", "COPY_OPS", "TracedOp", "OpTrace", "trace",
           "kernel_call_count", "payload_copy_ops", "moved_bytes"]

# ops that materialise a copy or a re-layout of their operand
MOVED_OPS = frozenset({
    "copy", "copy_", "clone", "_to_copy", "cat", "stack",
    "constant_pad_nd", "index", "index_select", "gather", "take",
    "scatter", "scatter_", "scatter_add", "scatter_add_", "index_put",
    "index_put_", "_index_put_impl_", "index_copy", "index_copy_",
    "slice_scatter", "select_scatter", "masked_scatter", "masked_scatter_",
})
# the payload-copy guard also flags a payload-sized select
COPY_OPS = MOVED_OPS | {"where"}


class TracedOp(NamedTuple):
    name: str             # the aten op's name, without overload
    numel: int            # elements of its largest output
    nbytes: int           # bytes of all its outputs


class OpTrace(NamedTuple):
    ops: list             # TracedOps outside every kernel's extent
    kernel_calls: dict    # {kernel: wrapper calls} during the trace


class _Recorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not dispatch.in_kernel():
            outs = [out] if isinstance(out, torch.Tensor) else [
                t for t in (out if isinstance(out, (list, tuple)) else ())
                if isinstance(t, torch.Tensor)]
            self.ops.append(TracedOp(
                func._overloadpacket.__name__,
                max((t.numel() for t in outs), default=0),
                sum(t.numel() * t.element_size() for t in outs)))
        return out


def trace(fn, *args, **kwargs) -> OpTrace:
    """Run ``fn(*args, **kwargs)`` once and record it."""
    before = {n: c.calls for n, c in dispatch.counters().items()}
    rec = _Recorder()
    with rec:
        fn(*args, **kwargs)
    calls = {n: c.calls - before.get(n, 0)
             for n, c in dispatch.counters().items()}
    return OpTrace(rec.ops, {n: k for n, k in calls.items() if k})


def kernel_call_count(tr: OpTrace) -> int:
    return sum(tr.kernel_calls.values())


def payload_copy_ops(tr: OpTrace, min_size: int) -> list:
    """Copying ops whose output holds >= ``min_size`` elements: empty for
    a zero-copy wave traced at the stacked payload size."""
    return [op for op in tr.ops
            if op.name in COPY_OPS and op.numel >= min_size]


def moved_bytes(tr: OpTrace) -> int:
    """Bytes produced by the copying ops outside the launches."""
    return sum(op.nbytes for op in tr.ops if op.name in MOVED_OPS)
