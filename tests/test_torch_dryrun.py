"""The port's host dry-run (``repro_torch.launch.dryrun``) held to known
answers, on the CPU over fake process groups.

  * A (4096, 4096) @ (4096, 14336) product, the rows over ``data`` and the
    columns over ``model`` of a 16 x 16 mesh, counts rank 0's flops,
    2 * (M / 16) * K * (N / 16), not the global product's.
  * Gathering its result counts each all-gather's gathered bytes.
  * Live bytes: a chain of ops whose outputs are freed as it goes peaks
    at the arguments plus the two largest outputs alive together.
  * Every one of the 40 cells, at smoke depth (an LM keeps one layer of
    each group kind and at most 2 of its microbatches, a CTR model 65,536
    table rows a field; every other family is whole), runs on a fake 2 x
    4 mesh, launches no kernel, counts flops, bytes and collectives, and
    peaks at or above its arguments.
  * ``calibrated_costs`` (1- and 2-layer traces, extrapolated) equals the
    direct count of a 3-layer dense and a (2 dense, 3 MoE) decode cell:
    flops exactly; argument and accessed bytes within 1e-3, collective
    bytes within 1e-2 (small stacked leaves are replicated by size, and
    DTensor lays some of a MoE layer's activations out by what precedes
    it, so those differ a little from layer to layer).

Each fake group is made and destroyed by its test's fixture: the default
group is process-wide.
"""

import dataclasses

import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs import registry
from repro_torch.launch import calibrate, cells, dryrun
from repro_torch.launch.mesh import make_elastic_mesh, make_production_mesh
from repro_torch.launch.roofline import collective_bytes

CELLS = registry.all_cells()
# a CTR model's smoke depth: its tables' rows a field (DTensor's
# strided-shard arithmetic lists every row of a flattened vocab-sharded
# table, 39 x 2 ** 20 of them at xDeepFM's full size)
CTR_ROWS = 1 << 16


@pytest.fixture
def mesh16():
    with dryrun.fake_world(256):
        yield make_production_mesh(device_type="cpu")


@pytest.fixture
def mesh2x4():
    with dryrun.fake_world(8):
        yield make_elastic_mesh(8, 4, device_type="cpu")


def _block(shape, mesh, placements, global_shape):
    t = torch.empty(shape, device="meta")
    return DTensor.from_local(t, mesh, placements, run_check=False,
                              shape=global_shape,
                              stride=(global_shape[1], 1))


def _product(mesh):
    m, k, n = 4096, 4096, 14336
    x = _block((m // 16, k), mesh, [Shard(0), Replicate()], (m, k))
    w = _block((k, n // 16), mesh, [Replicate(), Shard(1)], (k, n))
    mode = dryrun.CostMode()
    args = mode.track(x._local_tensor) + mode.track(w._local_tensor)
    return mode, args, x, w, (m, k, n)


def test_sharded_product_counts_rank_zeros_flops(mesh16):
    mode, args, x, w, (m, k, n) = _product(mesh16)
    with mode:
        y = x @ w
    assert mode.counts.flops == 2 * (m // 16) * k * (n // 16)
    assert tuple(y._local_tensor.shape) == (m // 16, n // 16)
    assert mode.counts.collectives == []
    assert args == (m // 16 * k + k * n // 16) * 4


def test_all_gather_counts_the_gathered_result(mesh16):
    mode, args, x, w, (m, k, n) = _product(mesh16)
    with mode:
        y = x @ w
        z = y.redistribute(mesh16, [Replicate(), Replicate()])
    kinds = collective_bytes(mode.counts.collectives)
    # over "model" then over "data": the (m/16, n) rows, then (m, n)
    assert kinds["all-gather"] == (m // 16 * n + m * n) * 4
    assert kinds["total"] == kinds["all-gather"]
    assert tuple(z._local_tensor.shape) == (m, n)
    # at the peak: the arguments, y's block, the model-gathered rows and
    # the whole result
    assert mode.counts.peak_bytes == args + (m // 16 * n // 16
                                             + m // 16 * n + m * n) * 4


def test_live_bytes_follow_frees(mesh2x4):
    x = _block((64, 1024), mesh2x4, [Replicate(), Replicate()], (64, 1024))
    mode = dryrun.CostMode()
    args = mode.track(x._local_tensor)
    one = 64 * 1024 * 4
    with mode:
        a = x * 2                     # live: x, a
        b = a + 1                     # live: x, a, b  <- the peak
        del a
        c = b.sum()                   # live: x, b, c
        del b
        d = x.view(-1)                # a view: no storage
    assert args == one
    assert mode.counts.peak_bytes == 3 * one
    assert mode._now == one + 4       # x and the scalar c
    assert mode.counts.flops == 0 and d.shape == (64 * 1024,)
    assert c.shape == ()


def _smoke_cell(arch, shape, mesh, monkeypatch):
    mod = registry.get(arch)
    if arch in ("dlrm-rm2", "xdeepfm"):
        cfg = dataclasses.replace(mod.full_config(), vocab=CTR_ROWS)
        monkeypatch.setattr(mod, "full_config", lambda: cfg)
    if mod.FAMILY != "lm":
        return cells.build_cell(arch, shape, mesh)
    cfg = mod.full_config()
    kinds = cfg.layer_groups()
    cfg = dataclasses.replace(cfg, n_layers=len(kinds),
                              n_dense_layers=min(cfg.n_dense_layers, 1))
    monkeypatch.setattr(mod, "TRAIN_ACCUM_STEPS",
                        min(mod.TRAIN_ACCUM_STEPS, 2))
    return cells.build_lm_cell(arch, shape, mesh, cfg_override=cfg)


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}@{s}" for a, s in CELLS])
def test_every_cell_dry_runs_at_smoke_depth(arch, shape, mesh2x4,
                                            monkeypatch):
    cell = _smoke_cell(arch, shape, mesh2x4, monkeypatch)
    c = dryrun.trace_cell(cell)
    assert c.flops > 0 and c.bytes > 0 and c.n_ops > 0
    assert collective_bytes(c.collectives)["total"] > 0
    assert c.arg_bytes > 0 and c.peak_bytes >= c.arg_bytes
    assert c.out_bytes > 0


@pytest.mark.parametrize("arch,layers", [
    ("chatglm3-6b", dict(n_layers=3)),
    ("deepseek-v3-671b", dict(n_layers=5, n_dense_layers=2))])
def test_calibrated_costs_equal_the_direct_count(arch, layers, mesh2x4,
                                                 monkeypatch):
    mod = registry.get(arch)
    cfg = dataclasses.replace(mod.full_config(), **layers)
    monkeypatch.setattr(mod, "full_config", lambda: cfg)
    got = calibrate.calibrated_costs(arch, "decode_32k", mesh2x4)
    c = dryrun.trace_cell(cells.build_lm_cell(arch, "decode_32k", mesh2x4))
    coll = collective_bytes(c.collectives)
    tot = got["total"]
    assert tot["flops"] == pytest.approx(c.flops, rel=1e-12)
    # a stacked leaf smaller than ``param_specs``' floor is replicated, so
    # a group's argument bytes are not quite linear in its depth; DTensor
    # lays a few activations of a MoE layer out by what precedes it
    assert tot["arg"] == pytest.approx(c.arg_bytes, rel=1e-3)
    assert tot["bytes"] == pytest.approx(c.bytes, rel=1e-3)
    assert tot["coll"] == pytest.approx(coll["total"], rel=1e-2)
    assert got["layers"] == {"dense": cfg.n_dense_layers if cfg.moe
                             else cfg.n_layers,
                             "moe": cfg.n_layers - cfg.n_dense_layers
                             if cfg.moe else 0}


def test_run_cell_writes_the_jax_record_keys(tmp_path, monkeypatch):
    import json
    rec = dryrun.run_cell("sasrec", "serve_p99", False, str(tmp_path))
    assert set(rec) == {"arch", "shape", "kind", "mesh", "n_devices",
                        "lower_s", "compile_s", "memory", "collectives",
                        "roofline", "calibration", "meta"}
    assert rec["mesh"] == "16x16" and rec["n_devices"] == 256
    on_disk = json.loads((tmp_path / "sasrec@serve_p99@16x16.json")
                         .read_text())
    assert on_disk["roofline"]["flops_per_device"] > 0
    assert not torch.distributed.is_initialized()
