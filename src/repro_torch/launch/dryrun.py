"""Multi-pod dry-run of the port: run every (arch x shape) cell once on the
host over a fake production mesh and record rank 0's costs.

The port of ``repro.launch.dryrun``, which lowers and compiles each cell
for a 256- (or 512-) device mesh.  PyTorch has no ahead-of-time compile of
a sharded program, so here the cell's step function runs once, eagerly,
on tensors that hold no data:

  * the mesh is ``make_production_mesh(device_type="cpu")`` over a fake
    process group of 256 (or 512) ranks (``FakeStore``, backend
    ``"fake"``, rank 0): its collectives complete at once and move
    nothing;
  * the arguments are ``DTensor``s laid out by the cell's
    ``in_shardings``, each rank's block a tensor of rank 0's local shape
    on the ``meta`` device (shapes and dtypes, no data; the model's own
    factory calls follow its inputs' device); on a mesh of one rank,
    plain ``meta`` tensors;
  * ``fn`` runs inside ``sharding_rules(mesh, cell.rules)`` under
    ``CostMode``, a dispatch mode that lets each ``DTensor`` op desugar
    into its local ops and collectives and then counts those: the flops
    of rank 0's products (``torch.utils.flop_counter``'s formulas at the
    local shapes), the bytes each op reads and writes, each collective's
    output bytes by kind, and the live bytes of rank 0's local storage
    (every argument block, and every op output until its storage is
    freed), whose peak is the memory estimate.  The global-shape ops that
    ``DTensor`` runs on fake tensors to propagate output metadata are not
    rank 0's work and are skipped.

This is a host tool: the fake mesh is a CPU mesh, and the kernel wrappers
take their plain versions on its tensors (``kernels/dispatch.is_kernel``),
so a dry-run launches no kernel (checked).  Eager PyTorch runs every layer
and every microbatch, so a record counts them all; XLA's
``cost_analysis`` counts a scanned body once (``launch.calibrate`` is the
JAX package's correction for that, and here the fast path for a cell too
deep to trace whole).  ``lower_s`` and ``compile_s`` of the JAX record
are the trace's time here (``compile_s`` 0).

An EGNN cell's ``SegmentPlan`` (``nonzero``, ``tolist``) cannot be built
from tensors without data: the dry-run builds it on the host from a
random edge index of the cell's shape (uniform endpoints from a seeded
generator), moves its index tensors to ``meta`` and hands it to the
step.  DTensor on a CPU mesh has no all-to-all (it gathers and chunks
instead), so a redistribution that would be an all-to-all on the card's
mesh is counted as the all-gather it runs here.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2-9b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--calibrate]
      [--out artifacts/dryrun_torch]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import registry
from repro_torch.dist.api import NamedSharding, sharding_rules
from repro_torch.launch import roofline as rl
from repro_torch.launch.cells import BuiltCell, build_cell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.train import tree

__all__ = ["Counts", "CostMode", "fake_world", "trace_cell", "run_cell",
           "main"]

# functional collectives (DTensor's redistributions) by kind
_COLLECTIVE_KIND = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_COLLECTIVE_NS = ("_c10d_functional", "_c10d_functional_autograd")
# allocations: no byte is read or written
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "wait_tensor", "_wrap_tensor_autograd"}
# a collective's result handed on: the same buffer
_SAME_BUFFER = ("wait_tensor", "_wrap_tensor_autograd")


@dataclasses.dataclass
class Counts:
    """Rank 0's costs of one run of a cell's step."""
    flops: float = 0.0            # products' flops at the local shapes
    bytes: float = 0.0            # bytes read and written by the local ops
    collectives: list = dataclasses.field(default_factory=list)
    peak_bytes: int = 0           # peak of live local storage
    arg_bytes: int = 0            # the arguments' local blocks
    out_bytes: int = 0            # the outputs' local blocks
    alias_bytes: int = 0          # output bytes that are argument storage
    n_ops: int = 0
    trace: list = dataclasses.field(default_factory=list)


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for t in out if isinstance(t, torch.Tensor)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostMode(TorchDispatchMode):
    """Counts rank 0's local ops (module docstring).  ``DTensor`` ops are
    handed back (``NotImplemented``) so that they desugar first."""

    def __init__(self, record_trace: bool = False):
        super().__init__()
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        self._dtensor = DTensor
        self._fake = FakeTensor
        self._flops = flop_registry
        self.counts = Counts()
        self._record = record_trace
        self._live: dict = {}
        self._now = 0

    # live local storage
    def _free(self, key, n):
        if self._live.pop(key, None) is not None:
            self._now -= n

    def track(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage live until it is freed; its bytes, or 0
        when it is counted already."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return 0
        n = st.nbytes()
        self._live[key] = n
        self._now += n
        self.counts.peak_bytes = max(self.counts.peak_bytes, self._now)
        weakref.finalize(st, self._free, key, n)
        return n

    def _rename(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        """``dst`` is ``src`` (a collective's result handed on; on the
        ``meta`` device it comes back with storage of its own): its
        storage takes over ``src``'s count."""
        a, b = src.untyped_storage(), dst.untyped_storage()
        if id(a) == id(b) or id(a) not in self._live:
            return
        n = self._live.pop(id(a))
        self._live[id(b)] = n
        weakref.finalize(b, self._free, id(b), n)

    def live_keys(self) -> set:
        return set(self._live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if any(isinstance(t, self._fake) for t in outs):
            return out          # DTensor's metadata propagation
        c = self.counts
        c.n_ops += 1
        name = func._overloadpacket.__name__
        if func.namespace in _COLLECTIVE_NS and name in _COLLECTIVE_KIND:
            c.collectives.append((_COLLECTIVE_KIND[name],
                                  sum(_nbytes(t) for t in outs)))
        elif func._overloadpacket in self._flops:
            c.flops += self._flops[func._overloadpacket](
                *args, **kwargs, out_val=out)
        if name not in _NO_TRAFFIC and not func.is_view:
            ins = [a for a in args if isinstance(a, torch.Tensor)]
            for a in args:
                if isinstance(a, (list, tuple)):
                    ins += [t for t in a if isinstance(t, torch.Tensor)]
            c.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        if name in _SAME_BUFFER:
            self._rename(args[0], out)
        elif not func.is_view:
            for t in outs:
                self.track(t)
        if self._record:
            c.trace.append(f"{func} -> "
                           + ", ".join(f"{t.dtype}{list(t.shape)}"
                                       for t in outs))
        return out


@contextlib.contextmanager
def fake_world(world: int):
    """The default process group as a fake one of ``world`` ranks, this
    process rank 0; destroyed on exit.  Refuses when a group exists: the
    default group is process-wide."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group exists: the dry-run needs the "
                           "default group for its fake mesh")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local(meta: torch.Tensor, sharding: NamedSharding, position: int):
    """Rank 0's block of ``meta`` (on the ``meta`` device) as a
    ``DTensor`` laid out by ``sharding``; a 0-dim integer (a decode
    step's position) as the host constant ``position``.  On a mesh of
    one rank every block is the whole tensor: a plain one, as a world of
    one runs on the card."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    if meta.dim() == 0 and not meta.is_floating_point():
        return torch.tensor(position, dtype=meta.dtype)
    if sharding.mesh.size() == 1:
        return torch.empty(meta.shape, dtype=meta.dtype, device="meta")
    placements = sharding.placements
    shape, _ = compute_local_shape_and_global_offset(
        meta.shape, sharding.mesh, placements)
    return DTensor.from_local(
        torch.empty(tuple(shape), dtype=meta.dtype, device="meta"),
        sharding.mesh, placements, run_check=False, shape=meta.shape,
        stride=meta.stride())


def _host_plan(cell: BuiltCell, seed: int = 0):
    """An EGNN cell's graph plan over a random host edge index of its
    shape (and its graph ids, node i in graph i // nodes-per-graph)."""
    from repro_torch.models import egnn
    batch = cell.args[1]
    n_nodes = batch["feat"].shape[0]
    n_edges = batch["edge_index"].shape[1]
    gen = torch.Generator().manual_seed(seed)
    edges = torch.randint(0, n_nodes, (2, n_edges), generator=gen,
                          dtype=torch.int32)
    gids, n_graphs = None, None
    if "graph_ids" in batch:
        n_graphs = registry.get(cell.arch).SHAPES[cell.shape]["batch"]
        gids = torch.arange(n_nodes, dtype=torch.int32) // (n_nodes
                                                            // n_graphs)
    plan = egnn.prepare(edges, n_nodes, gids, n_graphs)
    nbytes = 0
    for p in plan:
        if p is not None:
            for k, v in vars(p).items():
                if isinstance(v, torch.Tensor):
                    nbytes += _nbytes(v)
                    setattr(p, k, v.to("meta"))
    return plan, nbytes


def trace_cell(cell: BuiltCell, record_trace: bool = False) -> Counts:
    """Run ``cell.fn`` once on data-free blocks of its arguments (laid out
    by its ``in_shardings`` on their mesh, a fake CPU mesh) and return
    rank 0's ``Counts``.  A decode step's position is the cell's
    ``kv_len``."""
    from repro_torch.kernels import dispatch

    mode = CostMode(record_trace)
    extra = {}
    if registry.get(cell.arch).FAMILY == "gnn":
        # the plan's index tensors live on the device beside the
        # arguments (the same on every rank)
        extra["plan"], plan_bytes = _host_plan(cell)
        mode.counts.arg_bytes += plan_bytes
        mode._now += plan_bytes
    position = cell.meta.get("kv_len", 1)
    dispatch.reset_counters()
    args = tree.map(lambda a, s: _local(a, s, position), cell.args,
                    cell.in_shardings)
    for leaf in tree.leaves(args):
        mode.counts.arg_bytes += mode.track(getattr(leaf, "_local_tensor",
                                                    leaf))
    arg_keys = mode.live_keys()
    with sharding_rules(_mesh_of(cell), cell.rules), mode:
        out = cell.fn(*args, **extra)
    for t in tree.leaves(out):
        local = getattr(t, "_local_tensor", t)
        if not isinstance(local, torch.Tensor):
            continue
        n = local.untyped_storage().nbytes()
        mode.counts.out_bytes += n
        if id(local.untyped_storage()) in arg_keys:
            mode.counts.alias_bytes += n
    del out, args
    launched = {n: c.launches for n, c in dispatch.counters().items()
                if c.launches}
    if launched:
        raise AssertionError(f"the dry-run launched kernels: {launched}")
    return mode.counts


def _mesh_of(cell: BuiltCell):
    return tree.leaves(cell.in_shardings)[0].mesh


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str,
             save_trace: bool = False, calibrate: bool = False) -> dict:
    """Dry-run one cell on the production mesh (over a fake group made
    here) and write its record, the JAX record's keys, to ``out_dir``."""
    world = 512 if multi_pod else 256
    with fake_world(world):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        t0 = time.time()
        calib = None
        if calibrate and registry.get(arch).FAMILY == "lm":
            from repro_torch.launch.calibrate import calibrated_costs
            cell = build_cell(arch, shape, mesh)
            calib = calibrated_costs(arch, shape, mesh)
            counts = None
        else:
            cell = build_cell(arch, shape, mesh)
            counts = trace_cell(cell, record_trace=save_trace)
        t_trace = time.time() - t0
    n_dev = world
    mf = cell.meta.get("model_flops", 0.0)
    if counts is not None:
        roof, coll = rl.analyze(counts, mf, n_dev)
        mem = rl.memory_summary(counts)
    else:
        tot = calib["total"]
        roof = rl.Roofline(flops=tot["flops"], hbm_bytes=tot["bytes"],
                           coll_bytes=tot["coll"], model_flops=mf,
                           n_devices=n_dev)
        coll = {**{k: tot[k] for k in rl.COLLECTIVES}, "total": tot["coll"]}
        mem = rl.memory_summary(Counts(
            peak_bytes=tot["peak"], arg_bytes=tot["arg"],
            out_bytes=tot["out"], alias_bytes=tot["alias"]))
    record = {
        "arch": arch, "shape": shape, "kind": cell.kind,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": n_dev,
        "lower_s": round(t_trace, 2), "compile_s": 0.0,
        "memory": mem,
        "collectives": coll,
        "roofline": roof.to_dict(),
        "calibration": calib,
        "meta": cell.meta,
    }
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{arch}@{shape}@{record['mesh']}"
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(record, f, indent=1)
    if save_trace and counts is not None:
        with open(os.path.join(out_dir, tag + ".trace"), "w") as f:
            f.write("\n".join(counts.trace))
    print(f"[dryrun] {tag}: OK  "
          f"(trace {t_trace:.1f}s, dominant={roof.dominant}, "
          f"t=({roof.t_compute:.2e},{roof.t_memory:.2e},"
          f"{roof.t_collective:.2e})s, "
          f"hbm/dev={mem.get('total_hbm_bytes', 0)/2**30:.2f}GiB)")
    print("  memory:", mem)
    print("  costs: flops/dev=%.3e bytes/dev=%.3e" % (roof.flops,
                                                      roof.hbm_bytes))
    return record


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--save-trace", action="store_true",
                    help="write each cell's op list beside its record")
    ap.add_argument("--calibrate", action="store_true",
                    help="LM costs extrapolated from 1- and 2-layer traces "
                         "(launch.calibrate) instead of a full-depth trace")
    ap.add_argument("--skip-existing", action="store_true",
                    help="skip cells whose artifact JSON already exists")
    args = ap.parse_args()

    cells = (registry.all_cells() if args.all
             else [(args.arch, args.shape)])
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    for multi_pod in meshes:
        for arch, shape in cells:
            tag = f"{arch}@{shape}@{'2x16x16' if multi_pod else '16x16'}"
            if args.skip_existing and os.path.exists(
                    os.path.join(args.out, tag + ".json")):
                continue
            try:
                run_cell(arch, shape, multi_pod, args.out,
                         save_trace=args.save_trace,
                         calibrate=args.calibrate)
            except Exception as e:  # noqa: BLE001 -- reported, run goes on
                failures.append((arch, shape, multi_pod, repr(e)))
                print(f"[dryrun] {arch}@{shape} multi_pod={multi_pod} "
                      f"FAILED: {e}")
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nall dry-run cells traced successfully")


if __name__ == "__main__":
    main()
