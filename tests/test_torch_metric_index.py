"""The port's metric index against the JAX package, on the CPU.

``MetricIndex.search`` on a ``make_world`` corpus (raw embeddings, Eq. 1 in
the index) for every storage dtype and the int8-dot rule, and the plain
scans ``exact_nn`` / ``streaming_topk``: ids equal, scores within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metric_index as jmi
from repro.data.conversations import WorldConfig, make_world
from repro_torch.core import metric_index as tmi

jax.config.update("jax_platform_name", "cpu")

WORLD = WorldConfig(n_topics=4, docs_per_topic=200, n_background=400, dim=40,
                    subspace_dim=6, turns=3, n_conversations=3, seed=4)


@pytest.fixture(scope="module")
def world():
    return make_world(WORLD)


def _queries(world):
    return np.concatenate([c.queries for c in world.conversations]) \
        .astype(np.float32)


def _same(port, ref):
    np.testing.assert_array_equal(np.asarray(port.ids), np.asarray(ref.ids))
    np.testing.assert_allclose(np.asarray(port.scores), np.asarray(ref.scores),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype,int8_dot", [("fp32", False), ("bf16", False),
                                            ("int8", False), ("int8", True)])
def test_metric_index_search_matches_jax(world, dtype, int8_dot):
    emb = world.doc_emb.astype(np.float32)
    ref_ix = jmi.MetricIndex(jnp.asarray(emb), use_kernel=False, dtype=dtype,
                             int8_dot=int8_dot)
    port_ix = tmi.MetricIndex(emb, dtype=dtype, int8_dot=int8_dot,
                              device="cpu")
    assert port_ix.dim == ref_ix.dim and port_ix.n_docs == ref_ix.n_docs
    q = _queries(world)
    ref = ref_ix.search(ref_ix.transform_queries(jnp.asarray(q)), 30)
    port = port_ix.search(port_ix.transform_queries(torch.as_tensor(q)), 30)
    _same(port, ref)
    # the Eq. 1 coordinate sqrt(1 - ||phi / M||^2) of the largest-norm
    # document is the square root of a rounding residue (sqrt of one f32
    # ulp is 3.5e-4), and a bf16 payload can then round one ulp apart: the
    # stored corpora agree to that resolution
    np.testing.assert_allclose(port_ix.dequantized().numpy(),
                               np.asarray(ref_ix.dequantized())
                               [:ref_ix.n_docs],
                               atol=4e-3 if dtype == "bf16" else 1e-3)


def test_plain_scans_match_jax(world):
    emb = world.doc_emb.astype(np.float32)
    ix = tmi.MetricIndex(emb, device="cpu")
    docs = ix.dequantized()
    ids = ix.doc_ids.clone()
    ids[[2, 40, 41]] = -1
    q = ix.transform_queries(torch.as_tensor(_queries(world)))
    jd, ji, jq = (jnp.asarray(x.numpy()) for x in (docs, ids, q))
    _same(tmi.exact_nn(docs, ix.doc_ids, q, 12),
          jmi.exact_nn(jd, jnp.asarray(ix.doc_ids.numpy()), jq, 12))
    port = tmi.streaming_topk(docs, ids, q, 12, chunk=100, masked=True)
    ref = jmi.streaming_topk(jd, ji, jq, 12, chunk=100, masked=True)
    np.testing.assert_array_equal(port[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(port[0].numpy(), np.asarray(ref[0]), atol=1e-6)
    s, i = tmi.scan_topk(ix.doc_emb, ids, q, 12, scale=ix.doc_scale)
    np.testing.assert_array_equal(i.numpy(), port[1].numpy())
