"""The port's checkpoints: the JAX package's checkpoint tests, ported, and
the format both packages read, on the CPU.

  * ``test_system.py``'s four checkpoint tests against the port: round trip
    and retention, a flipped byte detected by its CRC, async saves and
    resume through ``CheckpointManager``, and a training run killed after
    3 steps and restored that continues with the uninterrupted run's losses
    (rtol 1e-5).
  * A state written by the JAX package restores in the port, and an f32
    state written by the port restores in the JAX package, bit for bit;
    both packages write the same leaf keys, file names and CRCs for it.
  * A bf16 leaf written by the JAX package reads back in the port, while
    the JAX package's own ``restore_tree`` of it raises (numpy cannot cast
    ``|V2``): a divergence, pinned here.  A port-written bf16 leaf has the
    JAX package's bytes, dtype name and CRC.
  * An async save followed at once by an in-place optimizer step restores
    the state before the step: ``save_tree`` owns its host copy.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jmgr
from repro.configs import star_encoder as j_star
from repro.models import transformer as jtf
from repro.train import optimizer as jopt
from repro_torch import convert
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_tree, save_tree)
from repro_torch.configs import star_encoder
from repro_torch.data.lm import LMBatchSpec, TokenStream
from repro_torch.models import transformer as tf
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep
from repro_torch.train import tree

jax.config.update("jax_platform_name", "cpu")


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step}", "manifest.json")) as f:
        return json.load(f)


# --------------------------------------------- test_system.py, ported
def test_checkpoint_roundtrip_and_gc(tmp_path):
    t = {"w": torch.arange(12.0).reshape(3, 4),
         "nested": {"b": torch.ones((5,), dtype=torch.int32)},
         "scalar": torch.tensor(3)}
    for step in (1, 2, 3, 4):
        save_tree(t, str(tmp_path), step, keep=2)
    assert latest_step(str(tmp_path)) == 4
    assert not os.path.isdir(tmp_path / "step_1")     # gc'd
    out = restore_tree(t, str(tmp_path))
    assert torch.equal(out["w"], t["w"])
    assert torch.equal(out["nested"]["b"], t["nested"]["b"])
    assert out["scalar"].dtype == t["scalar"].dtype


def test_checkpoint_detects_corruption(tmp_path):
    t = {"w": torch.ones((4, 4))}
    save_tree(t, str(tmp_path), 1)
    leaf = tmp_path / "step_1" / "leaf_00000.npy"
    data = bytearray(leaf.read_bytes())
    data[-1] ^= 0xFF
    leaf.write_bytes(bytes(data))
    with pytest.raises(IOError, match="corruption"):
        restore_tree(t, str(tmp_path))


def test_checkpoint_manager_async_and_resume(tmp_path):
    mgr = CheckpointManager(str(tmp_path), interval=2, keep=2)
    t = {"p": torch.zeros((8,))}
    for step in range(1, 6):
        t = {"p": t["p"] + 1}
        mgr.maybe_save(step, t)
    mgr.wait()
    restored, step = mgr.restore_or({"p": torch.zeros((8,))})
    assert step == 4                                   # last multiple of 2
    assert torch.equal(restored["p"], torch.full((8,), 4.0))
    empty = CheckpointManager(str(tmp_path / "none"))
    fresh = {"p": torch.zeros(2)}
    assert empty.restore_or(fresh) == (fresh, 0)


def test_train_restart_resumes_identically(tmp_path):
    """Kill after step 3, restore, continue: the losses match an
    uninterrupted run (stateless data pipeline + full state checkpoint)."""
    cfg = star_encoder.smoke_config()
    opt = topt.adamw(lr=1e-3, warmup=1)
    step_fn = tstep.make_lm_train_step(cfg, opt, remat="none")
    stream = TokenStream(LMBatchSpec(global_batch=4, seq_len=16,
                                     vocab_size=cfg.vocab_size),
                         device="cpu")

    def fresh():
        gen = torch.Generator().manual_seed(0)
        params = tf.init_params(cfg, device="cpu", generator=gen)
        return {"params": params, "opt": opt.init(params)}

    state, losses_a = fresh(), []
    for i in range(6):
        state, m = step_fn(state, stream.batch(i))
        losses_a.append(float(m["loss"]))

    mgr = CheckpointManager(str(tmp_path), interval=1)
    state = fresh()
    for i in range(3):
        state, m = step_fn(state, stream.batch(i))
        mgr.maybe_save(i + 1, state)
    mgr.wait()
    state2, last = mgr.restore_or(fresh())
    assert last == 3
    losses_b = []
    for i in range(last, 6):
        state2, m = step_fn(state2, stream.batch(i))
        losses_b.append(float(m["loss"]))
    np.testing.assert_allclose(losses_a[3:], losses_b, rtol=1e-5)


# ------------------------------------------------ the shared format
def _jax_state(optimizer="adamw"):
    cfg = j_star.smoke_config()
    params = jtf.init_params(jax.random.key(0), cfg)
    opt = jopt.adamw() if optimizer == "adamw" else jopt.adafactor()
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
    params, st = opt.update(grads, opt.init(params), params)
    return {"params": params, "opt": st}


def _port_state(js):
    return {"params": convert.transformer_params_from_numpy(js["params"],
                                                            device="cpu"),
            "opt": convert.opt_state_from_numpy(js["opt"], device="cpu")}


def _assert_equal_trees(jt, tt):
    jl = jax.tree.leaves(jt)
    tl = tree.leaves(tt)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_both_packages_write_the_same_checkpoint(tmp_path, optimizer):
    js = _jax_state(optimizer)
    ts = _port_state(js)
    jmgr.save_tree(js, str(tmp_path / "jax"), 7)
    save_tree(ts, str(tmp_path / "port"), 7)
    mj, mt = _manifest(tmp_path / "jax", 7), _manifest(tmp_path / "port", 7)
    assert mj == mt
    assert "opt|.step" in mt["leaves"]
    assert mt["leaves"]["opt|.step"]["dtype"] == "int32"
    assert "params|group0_dense|attn|wq" in mt["leaves"]


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_jax_written_state_restores_in_the_port(tmp_path, optimizer):
    js = _jax_state(optimizer)
    jmgr.save_tree(js, str(tmp_path), 3)
    template = _port_state(_jax_state(optimizer))
    template = tree.map(torch.zeros_like, template)
    out = restore_tree(template, str(tmp_path))
    assert isinstance(out["opt"], topt.OptState)
    assert out["opt"].step.dtype == torch.int32
    _assert_equal_trees(js, out)
    back = convert.opt_state_to_numpy(out["opt"])
    assert back.step.dtype == np.int32 and back.step.shape == ()
    _assert_equal_trees(js["opt"], back)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_port_written_state_restores_in_jax(tmp_path, optimizer):
    js = _jax_state(optimizer)
    save_tree(_port_state(js), str(tmp_path), 3)
    template = jax.tree.map(jnp.zeros_like, js)
    out = jmgr.restore_tree(template, str(tmp_path))
    for a, b in zip(jax.tree.leaves(js), jax.tree.leaves(out)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_bf16_leaf_reads_in_the_port_not_in_jax(tmp_path):
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.standard_normal((5, 7)), jnp.bfloat16)
    jt = {"w": w, "s": jnp.asarray(2, jnp.int32)}
    jmgr.save_tree(jt, str(tmp_path / "jax"), 1)
    with pytest.raises(ValueError, match="cast"):
        jmgr.restore_tree(jt, str(tmp_path / "jax"))
    template = {"w": torch.zeros((5, 7), dtype=torch.bfloat16),
                "s": torch.tensor(0, dtype=torch.int32)}
    out = restore_tree(template, str(tmp_path / "jax"))
    assert out["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["w"].float().numpy(),
                                  np.asarray(w, np.float32))
    # the port writes the JAX package's bytes, dtype name and CRC
    save_tree(out, str(tmp_path / "port"), 1)
    mj = _manifest(tmp_path / "jax", 1)
    assert _manifest(tmp_path / "port", 1) == mj
    assert mj["leaves"]["w"]["dtype"] == "bfloat16"
    assert np.load(tmp_path / "port" / "step_1" / "leaf_00001.npy").dtype \
        == np.dtype("V2")
    back = restore_tree(template, str(tmp_path / "port"))
    assert torch.equal(back["w"], out["w"])


def test_async_save_owns_its_copy_before_an_in_place_step(tmp_path):
    cfg = star_encoder.smoke_config()
    opt = topt.adamw(lr=1e-2, warmup=1)
    step_fn = tstep.make_lm_train_step(cfg, opt, remat="none")
    stream = TokenStream(LMBatchSpec(global_batch=4, seq_len=16,
                                     vocab_size=cfg.vocab_size),
                         device="cpu")
    params = tf.init_params(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    state = {"params": params, "opt": opt.init(params)}
    state, _ = step_fn(state, stream.batch(0))
    before = tree.map(lambda t: t.clone(), state)
    mgr = CheckpointManager(str(tmp_path), interval=1)
    mgr.maybe_save(1, state)
    state, _ = step_fn(state, stream.batch(1))      # writes in place
    mgr.wait()
    assert not torch.equal(state["params"]["embed"],
                           before["params"]["embed"])
    restored, step = mgr.restore_or(tree.map(torch.zeros_like, before))
    assert step == 1
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(restored),
                                                 tree.leaves(before)))


def test_restore_follows_the_template_or_the_device(tmp_path):
    save_tree({"w": torch.arange(4.0)}, str(tmp_path), 2)
    out = restore_tree({"w": torch.zeros(4, dtype=torch.float64)},
                       str(tmp_path), step=2, device="cpu")
    assert out["w"].dtype == torch.float64 and out["w"].device.type == "cpu"
    with pytest.raises(FileNotFoundError):
        restore_tree({"w": torch.zeros(4)}, str(tmp_path / "missing"))
