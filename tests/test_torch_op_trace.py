"""The zero-copy launch contract of the port's L1 wave, traced with
``repro_torch.kernels.op_trace`` on the CPU.

The counterparts of ``tests/test_padded_layout.py``'s zero-copy tests and
``tests/test_cluster.py``'s widened insert, which hold the JAX package's
traced waves (``repro.kernels.jaxpr_util``): the probe and the fused
insert + query each call one kernel and copy nothing at the stacked
payload size outside it, also with the widened (k_c + prefetch width)
insert; a whole miss wave moves less than one payload outside its
launches.  On the CPU the kernels' plain versions run inside the
wrappers' extents, which the trace leaves out as the jaxpr walk leaves
out a ``pallas_call``'s body; the same trace taken without the extents
sees the plain versions' payload-sized work, so the guard has teeth.
"""

import numpy as np
import torch

from repro_torch.core.cache_ops import (CacheConfig, init_batched_cache,
                                        insert_query_batched, probe_batched)
from repro_torch.kernels import dispatch, op_trace


def _rows(rng, n, dim):
    x = rng.standard_normal((n, dim)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _wave_setup(s=4, capacity=100, dim=200, kc=5, mq=5):
    cfg = CacheConfig(capacity=capacity, dim=dim, max_queries=mq)
    state = init_batched_cache(cfg, s, device="cpu")
    rng = np.random.default_rng(1)
    psi = torch.as_tensor(_rows(rng, s, dim))
    ids = torch.as_tensor(rng.integers(0, 99, (s, kc)).astype(np.int32))
    emb = torch.as_tensor(_rows(rng, s * kc, dim).reshape(s, kc, dim))
    radius = torch.as_tensor(rng.uniform(0.2, 1.0, s).astype(np.float32))
    return cfg, state, psi, ids, emb, radius


def _payload(cfg, s):
    return s * cfg.phys_capacity * cfg.phys_dim          # elements


def test_traced_miss_wave_has_no_payload_copies():
    cfg, state, psi, ids, emb, radius = _wave_setup()
    payload = _payload(cfg, psi.shape[0])
    tr = op_trace.trace(probe_batched, state, psi, cfg.epsilon,
                        max_queries=cfg.max_queries)
    assert op_trace.payload_copy_ops(tr, payload) == []
    assert op_trace.kernel_call_count(tr) == 1
    assert tr.kernel_calls == {"cache_probe": 1}
    tr = op_trace.trace(insert_query_batched, state, cfg, psi, radius, emb,
                        ids, k=4)
    assert op_trace.payload_copy_ops(tr, payload) == []
    assert op_trace.kernel_call_count(tr) == 1
    assert tr.kernel_calls == {"wave_insert_query": 1}


def test_wave_moved_bytes_below_payload():
    cfg, state, psi, ids, emb, radius = _wave_setup()
    payload_bytes = _payload(cfg, psi.shape[0]) * 4
    moved = op_trace.moved_bytes(op_trace.trace(
        probe_batched, state, psi, cfg.epsilon, max_queries=cfg.max_queries))
    moved += op_trace.moved_bytes(op_trace.trace(
        insert_query_batched, state, cfg, psi, radius, emb, ids, k=4))
    assert 0 < moved < payload_bytes, (moved, payload_bytes)


def test_widened_insert_trace_is_zero_copy():
    k_c, width, dim, s = 17, 32, 48, 3
    cfg = CacheConfig(capacity=256, dim=dim)
    state = init_batched_cache(cfg, s, device="cpu")
    psi = torch.zeros((s, dim))
    ids = torch.zeros((s, k_c + width), dtype=torch.int32)
    emb = torch.zeros((s, k_c + width, dim))
    radius = torch.zeros((s,))
    payload = _payload(cfg, s)
    tr = op_trace.trace(insert_query_batched, state, cfg, psi, radius, emb,
                        ids, k=5)
    assert op_trace.payload_copy_ops(tr, payload) == []
    assert op_trace.kernel_call_count(tr) == 1
    tr = op_trace.trace(probe_batched, state, psi, cfg.epsilon,
                        max_queries=cfg.max_queries)
    assert op_trace.payload_copy_ops(tr, payload) == []
    assert op_trace.kernel_call_count(tr) == 1


def test_the_guard_sees_copies_outside_an_extent(monkeypatch):
    """Without the extents the plain versions' payload-sized writes show,
    and a payload clone outside any wrapper is flagged."""
    cfg, state, psi, ids, emb, radius = _wave_setup()
    payload = _payload(cfg, psi.shape[0])
    monkeypatch.setattr(dispatch, "in_kernel", lambda: False)
    tr = op_trace.trace(insert_query_batched, state, cfg, psi, radius, emb,
                        ids, k=4)
    assert op_trace.payload_copy_ops(tr, payload) != []
    monkeypatch.undo()
    tr = op_trace.trace(lambda st: st.doc_emb.clone(), state)
    flagged = op_trace.payload_copy_ops(tr, payload)
    assert [op.name for op in flagged] == ["clone"]
    assert op_trace.moved_bytes(tr) == payload * 4
    assert op_trace.kernel_call_count(tr) == 0
