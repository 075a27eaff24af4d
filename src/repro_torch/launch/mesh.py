"""Production mesh builders of the port.

The port of ``repro.launch.mesh``: the same shapes and axis names, as
``DeviceMesh``es.  Functions, never module-level constants, so importing
this module touches no device and no process group.  Each needs the
default process group to exist with one rank per mesh position: NCCL
ranks on cards (``device_type="cuda"``, the default), or, for the host
dry-run, a fake group of 256 or 512 ranks over ``"cpu"`` meshes
(``launch.dryrun``).
"""

from __future__ import annotations

__all__ = ["make_production_mesh", "make_elastic_mesh", "make_host_mesh"]


def _mesh(shape, names, device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a process group: call "
                           "torch.distributed.init_process_group first")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_elastic_mesh(n_devices: int | None = None, model_parallel: int = 16,
                      device_type: str = "cuda"):
    """Best mesh for an arbitrary (possibly degraded) device count -- the
    elastic-restart path: keep TP fixed at what fits a model replica, put
    everything else on data.  ``n_devices`` None is the group's size."""
    import torch.distributed as dist
    n = n_devices or dist.get_world_size()
    while n % model_parallel and model_parallel > 1:
        model_parallel //= 2
    return _mesh((n // model_parallel, model_parallel), ("data", "model"),
                 device_type)


def make_host_mesh(device_type: str = "cuda"):
    """A (1, 1) ("data", "model") mesh over a world of one."""
    return _mesh((1, 1), ("data", "model"), device_type)
