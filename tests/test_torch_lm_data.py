"""The port's synthetic LM token stream against the JAX package's.

``repro_torch.data.lm.TokenStream`` copies ``repro.data.lm``'s numpy
draws: the same spec gives the same tokens and labels, step by step and
per process slice, as int32 tensors on the asked device.
"""

import numpy as np
import pytest
import torch

from repro.data import lm as jlm
from repro_torch.data import lm as tlm


@pytest.mark.parametrize("spec", [dict(global_batch=4, seq_len=16,
                                       vocab_size=256, seed=0),
                                  dict(global_batch=8, seq_len=33,
                                       vocab_size=30522, seed=5)])
@pytest.mark.parametrize("step", [0, 1, 17])
def test_batches_equal_jax(spec, step):
    j = jlm.TokenStream(jlm.LMBatchSpec(**spec))
    t = tlm.TokenStream(tlm.LMBatchSpec(**spec), device="cpu")
    want, got = j.batch(step), t.batch(step)
    for key in ("tokens", "labels"):
        assert got[key].dtype == torch.int32
        assert got[key].device.type == "cpu"
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    np.testing.assert_array_equal(t.batch_numpy(step)["tokens"],
                                  np.asarray(want["tokens"]))
    assert got["tokens"].shape == (spec["global_batch"], spec["seq_len"])
    assert (got["tokens"] >= 0).all() and \
        (got["tokens"] < spec["vocab_size"]).all()


def test_process_slices_equal_jax():
    spec = dict(global_batch=6, seq_len=12, vocab_size=512, seed=3)
    for idx in range(3):
        j = jlm.TokenStream(jlm.LMBatchSpec(**spec), process_index=idx,
                            process_count=3)
        t = tlm.TokenStream(tlm.LMBatchSpec(**spec), process_index=idx,
                            process_count=3, device="cpu")
        assert t.local_batch == j.local_batch == 2
        np.testing.assert_array_equal(t.batch(2)["labels"].numpy(),
                                      np.asarray(j.batch(2)["labels"]))
        np.testing.assert_array_equal(t.proj, j.proj)
        np.testing.assert_array_equal(t.trans_cum, j.trans_cum)


def test_batches_are_stateless():
    t = tlm.TokenStream(tlm.LMBatchSpec(2, 8, 100, seed=1), device="cpu")
    a = t.batch(4)["tokens"]
    t.batch(5)
    assert torch.equal(a, t.batch(4)["tokens"])
    assert not torch.equal(a, t.batch(5)["tokens"])
