"""The port's roofline module (``repro_torch.launch.roofline``) against the
JAX package's ``repro.launch.roofline`` and against PERF.md's bounds.

  * ``Roofline``'s properties and ``to_dict`` equal the JAX class's on the
    same counts once the JAX ``HW`` is set to the port's H100 figures
    (its ``ici_bw`` the port's NVLink rate); the keys are the JAX keys.
  * ``collective_bytes`` keeps the JAX keys and totals per kind.
  * The cost counts moved out of ``chip_smoke.py`` give the bounds PERF.md
    quotes: EGNN's forward at its four shapes (``ogb_products`` 126.36 ms),
    the 4-layer deepseek-v3 and llama4-scout decode steps (8.476 / 5.899
    ms, bytes), STAR's train step at 64 x 512 tokens in 4 microbatches
    (548.87 ms, operations).
"""

import dataclasses

import pytest

from repro.launch import roofline as jrl
from repro_torch.configs import registry
from repro_torch.launch import roofline as rl
from repro_torch.models import transformer as tf

CASES = [dict(flops=3.2e14, hbm_bytes=1.1e12, coll_bytes=4.0e9,
              model_flops=6.0e16, n_devices=256),
         dict(flops=1.0e9, hbm_bytes=8.0e11, coll_bytes=0.0,
              model_flops=2.0e11, n_devices=256),
         dict(flops=5.0e10, hbm_bytes=1.0e8, coll_bytes=9.0e11,
              model_flops=1.0e12, n_devices=512)]


@pytest.mark.parametrize("case", CASES)
def test_roofline_formulas_equal_jax_on_the_h100_model(case, monkeypatch):
    monkeypatch.setattr(jrl, "HW", {"flops_bf16": rl.HW["flops_bf16"],
                                    "hbm_bw": rl.HW["hbm_bw"],
                                    "ici_bw": rl.HW["link_bw"]})
    got = rl.Roofline(**case).to_dict()
    want = jrl.Roofline(**case).to_dict()
    assert list(got) == list(want)
    assert got == want
    assert rl.Roofline(**case).bound_time == jrl.Roofline(**case).bound_time


def test_hardware_model_is_the_h100_data_sheet():
    assert rl.HW["flops_bf16"] == 989e12 and rl.HW["flops_f32"] == 67e12
    assert rl.HW["hbm_bw"] == 3.35e12 and rl.HW["link_bw"] == 450e9
    assert (rl.HBM_BPS, rl.F32_OPS, rl.BF16_OPS) == (3.35e12, 67e12, 989e12)


def test_collective_bytes_keys_and_totals():
    got = rl.collective_bytes([("all-gather", 10), ("all-reduce", 4),
                               ("all-gather", 6), ("all-to-all", 1)])
    want_keys = list(jrl.collective_bytes(""))
    assert list(got) == want_keys
    assert got["all-gather"] == 16 and got["all-reduce"] == 4
    assert got["reduce-scatter"] == 0 and got["total"] == 21


@pytest.mark.parametrize("shape,nodes,edges,n_out,ms", [
    ("ogb_products", 2449029, 61859140, 2449029, 126.36),
    ("molecule", 3840, 8192, 128, 0.0219),
    ("full_graph_sm", 2708, 10556, 2708, 0.0326),
    ("minibatch_lg", 232965, 164290, 232965, 0.9657)])
def test_egnn_forward_bounds_of_perf_md(shape, nodes, edges, n_out, ms):
    mod = registry.get("egnn")
    geom = mod.SHAPES[shape]
    cfg = mod.full_config(d_feat=geom["d_feat"],
                          readout="graph" if shape == "molecule" else "node")
    nbytes, ops = rl.egnn_costs(cfg, nodes, edges, n_out, geom["d_feat"])
    got, by = rl.bound(nbytes, ops, rl.F32_OPS)
    assert by == "operations"
    assert round(got, 4 if ms < 1 else 2) == ms


@pytest.mark.parametrize("arch,ms,gb", [("deepseek-v3-671b", 8.476, 28.39),
                                        ("llama4-scout-17b-16e", 5.899,
                                         19.76)])
def test_lm_decode_bounds_of_perf_md(arch, ms, gb):
    cfg = dataclasses.replace(registry.get(arch).full_config(), n_layers=4)
    params = tf.init_params(cfg, device="meta")
    bf, f32, nbytes = rl.lm_costs(cfg, params, 8, 1, 544, 8 * cfg.moe.top_k)
    got, by = rl.lm_bound(bf, f32, nbytes)
    assert by == "bytes"
    assert round(got, 3) == ms and round(nbytes / 1e9, 2) == gb


def test_star_train_bound_of_perf_md():
    mod = registry.get("star-encoder")
    cfg = mod.full_config()
    params = tf.init_params(cfg, device="meta")
    n, layer = tf.param_count(params), tf.param_count(params["group0_dense"])
    accum = mod.TRAIN_ACCUM_STEPS
    ops = rl.lm_train_ops(cfg, layer, 64 * 512, 64, 512)
    got, by = rl.bound(n * (16 * accum + 28), ops, rl.F32_OPS)
    assert by == "operations" and round(got, 2) == 548.87
