"""Worlds of CPU ranks on one host, joined by gloo.

The port's counterpart of ``repro.launch.hostdevices``, which forces N
host devices into one JAX process so the distributed tests see a mesh.
A torch mesh needs one process a rank, so ``run_ranks(fn, world, *args)``
spawns ``world`` processes, joins them in a gloo group and runs
``fn(rank, world, *args)`` in each (SPMD: every rank runs the same code).

  * The group meets through a file in a fresh temporary directory
    (``init_method="file://..."``), not a TCP port, so concurrent test
    workers never collide.
  * ``fn`` must be importable by name in a fresh interpreter (a
    module-level function); the children start by ``spawn``.
  * Rank 0's return value (numpy arrays, scalars, and dicts, lists or
    tuples of them) comes back to the caller.  An exception in any rank is
    raised in the caller with that rank's traceback; a world that has not
    finished within ``timeout`` seconds is killed and raises
    ``TimeoutError``, so a hung collective fails its test instead of
    holding the suite.

It imports torch and the standard library only.
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.multiprocessing as mp

__all__ = ["run_ranks"]


def _child(fn, rank: int, world: int, init: str, timeout: float, args,
           out) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        # the caller's deadline comes first; the group's own timeout only
        # ends ranks that outlive a caller killed without cleaning up
        dist.init_process_group(
            "gloo", init_method=init, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=2 * timeout))
        try:
            result = fn(rank, world, *args)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        out.put((rank, "ok", result if rank == 0 else None))
    except BaseException:     # handed to the caller, which raises it
        out.put((rank, "error", traceback.format_exc()))


def run_ranks(fn, world: int, *args, timeout: float = 60.0):
    """``fn(rank, world, *args)`` over ``world`` gloo ranks; rank 0's
    return value."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_child,
                             args=(fn, r, world, init, timeout, args, out),
                             daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        result, errors, done = None, [], 0
        deadline = time.monotonic() + timeout
        try:
            while done < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    if errors:
                        break
                    raise TimeoutError(f"{world} ranks did not finish "
                                       f"within {timeout} s")
                try:
                    rank, status, value = out.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [p.exitcode for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead and not errors:
                        raise RuntimeError(f"a rank exited with code "
                                           f"{dead[0]} before reporting")
                    continue
                done += 1
                if status == "error":
                    if not errors:
                        # the ranks that lose their peer report too: give
                        # them a moment, so the first cause is among them
                        deadline = min(deadline, time.monotonic() + 3)
                    errors.append(f"rank {rank}:\n{value}")
                elif rank == 0:
                    result = value
        finally:
            for p in procs:
                p.join(timeout=0 if errors else 5)
                if p.is_alive():
                    p.kill()
                    p.join()
            out.close()
        if errors:
            raise RuntimeError("\n".join(errors))
    return result
