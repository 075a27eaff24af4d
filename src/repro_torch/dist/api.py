"""Logical activation sharding: ``constrain`` and the ``sharding_rules``
context.

The port of ``repro.dist.api``.  Model code names *logical* layouts::

    x = constrain(x, "act_bsd")

and never a mesh.  A caller binds a mesh and a rule table (``{logical
name: P}``) around the computation::

    with sharding_rules(mesh, rules):
        out = forward(dparams, tokens, cfg)

A spec ``P`` has one entry per tensor dim: ``None`` (replicated), a mesh
axis name, or a tuple of names (the dim split over those axes, the first
the major one).  A mesh is a ``DeviceMesh`` with ``mesh_dim_names``, or a
device-free ``MeshShape(names, sizes)``: the spec functions read only axis
names and sizes, so spec logic is tested in one process.

Inside a context ``constrain`` redistributes a ``DTensor`` to the fitted
placements (``to_placements``); it is the identity on a plain tensor,
outside a context, for a name without a rule, and where ``fit_spec`` gives
None, so the same model code runs unannotated on one device.  Inside a
context a plain tensor that meets a ``DTensor`` in an op counts as
replicated (DTensor's ``implicit_replication``): under the SPMD contract
every rank holds the same global value of it (token ids, masks, RoPE
tables made from shapes), as every array of a JAX program is global.

Rules are advisory: an axis assignment that does not divide the dimension
is dropped per dimension rather than raising (``fit_spec``).
"""

from __future__ import annotations

import contextlib
import sys
import threading
from typing import Mapping, NamedTuple, Optional, Sequence, Tuple

import torch

__all__ = ["P", "MeshShape", "NamedSharding", "constrain", "sharding_rules",
           "active_mesh", "active_rules", "data_axes", "fit_spec",
           "axis_sizes", "to_placements", "place", "mesh_device",
           "is_dtensor"]


class P(tuple):
    """A partition spec: ``P("data", None, ("pod", "model"))``.  A tuple
    of one name is that name, as JAX's ``PartitionSpec`` stores it."""

    # a leaf of a tree (``train.tree``), not a node of its entries
    _tree_leaf = True

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


class MeshShape(NamedTuple):
    """A mesh without devices: axis ``names`` and their ``sizes``."""
    names: Tuple[str, ...]
    sizes: Tuple[int, ...]


class NamedSharding(NamedTuple):
    """Where a tensor lives: a ``DeviceMesh`` and a spec over its axes."""
    mesh: object
    spec: P
    _tree_leaf = True       # a leaf of a tree of shardings

    @property
    def placements(self) -> list:
        return to_placements(self.spec, self.mesh)


class _Stack(threading.local):
    """Per-thread stack of (mesh, rules) contexts: router threads must not
    see a context entered on the main thread."""

    def __init__(self):
        self.items = []


_CTX = _Stack()


def _names(mesh) -> Tuple[str, ...]:
    if isinstance(mesh, MeshShape):
        return tuple(mesh.names)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the DeviceMesh has no mesh_dim_names")
    return tuple(names)


def axis_sizes(mesh) -> dict:
    """{axis name: size} in mesh order."""
    sizes = mesh.sizes if isinstance(mesh, MeshShape) else mesh.shape
    return dict(zip(_names(mesh), (int(s) for s in sizes)))


@contextlib.contextmanager
def sharding_rules(mesh, rules: Mapping[str, P]):
    """Bind ``mesh`` and logical-name rules for ``constrain``."""
    from torch.distributed.tensor.experimental import implicit_replication
    _CTX.items.append((mesh, dict(rules)))
    try:
        with implicit_replication():
            yield
    finally:
        _CTX.items.pop()


def active_mesh():
    """The mesh of the innermost ``sharding_rules`` context, or None."""
    return _CTX.items[-1][0] if _CTX.items else None


def active_rules() -> dict:
    """The rule table of the innermost context ({} when none is active)."""
    return dict(_CTX.items[-1][1]) if _CTX.items else {}


def data_axes(mesh) -> Tuple[str, ...]:
    """Every mesh axis but the tensor-parallel ``"model"``: the axes that
    batch-like dims shard over."""
    return tuple(a for a in _names(mesh) if a != "model")


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _entry_size(sizes: dict, entry) -> int:
    out = 1
    for a in _entry_axes(entry):
        out *= sizes[a]
    return out


def fit_spec(spec: Sequence, shape: Tuple[int, ...], mesh) -> Optional[P]:
    """Clamp a logical spec to a concrete shape: missing trailing dims are
    padded with None, an entry whose axes' product does not divide its dim
    is dropped.  None when the spec has more entries than the tensor has
    dims (the caller skips the constraint)."""
    entries = tuple(spec)
    if len(entries) > len(shape):
        return None
    entries = entries + (None,) * (len(shape) - len(entries))
    sizes = axis_sizes(mesh)
    return P(*(e if dim % _entry_size(sizes, e) == 0 else None
               for dim, e in zip(shape, entries)))


def to_placements(spec: Sequence, mesh) -> list:
    """DTensor placements of ``spec``: one per mesh axis, ``Shard(d)`` on
    each axis that names tensor dim d, ``Replicate()`` elsewhere.  A tuple
    entry puts ``Shard(d)`` on each of its axes; DTensor splits over mesh
    axes in mesh order, so a tuple must list its axes in that order (the
    major one first, as JAX orders the blocks).  An axis of one rank holds
    the whole dim either way and gets ``Replicate()``: DTensor refuses a
    view that folds away a size-one dim sharded over it (a (1, S, D)
    activation into a matrix product)."""
    from torch.distributed.tensor import Replicate, Shard
    names = _names(mesh)
    sizes = axis_sizes(mesh)
    out = [Replicate() for _ in names]
    used: dict = {}
    for d, entry in enumerate(tuple(spec)):
        axes = _entry_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in mesh order "
                             f"{names}")
        for i in idx:
            if used.get(i, d) != d:
                raise ValueError(f"mesh axis {names[i]!r} used twice in "
                                 f"{spec!r}")
            used[i] = d
            if sizes[names[i]] > 1:
                out[i] = Shard(d)
    return out


def mesh_device(mesh) -> torch.device:
    """The device a ``DeviceMesh`` places this rank's blocks on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def place(x: torch.Tensor, mesh, spec: Sequence):
    """``x`` (the same global value on every rank) as a ``DTensor`` laid
    out by ``spec`` on ``mesh``, on the mesh's device: each rank keeps its
    own block and no collective runs."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(torch.as_tensor(x).to(mesh_device(mesh)), mesh,
                             to_placements(spec, mesh), src_data_rank=None)


def is_dtensor(x) -> bool:
    """True for a ``DTensor`` (without importing DTensor's module in a
    process that has made none)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def constrain(x: torch.Tensor, name: str) -> torch.Tensor:
    """Apply the active rule ``name`` to ``x``: a ``DTensor`` is
    redistributed to the fitted placements.  The identity with no context,
    no rule of that name, a spec that cannot fit, or a plain tensor."""
    if not _CTX.items or not is_dtensor(x):
        return x
    mesh, rules = _CTX.items[-1]
    spec = rules.get(name)
    if spec is None:
        return x
    spec = fit_spec(spec, tuple(x.shape), mesh)
    if spec is None:
        return x
    return x.redistribute(mesh, to_placements(spec, mesh))
