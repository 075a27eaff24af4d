"""The port's cache ops under the LRU and ball eviction policies, against
the JAX package on the CPU: the scripted streams of
``test_torch_cache_ops.run_stream`` overflow the capacity, so every wave
past the first few evicts.  States equal at logical extents after every
step, stamps included."""

import pytest

from test_torch_cache_ops import run_stream


@pytest.mark.parametrize("eviction", ["lru", "ball"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_evicting_stream_matches_jax(dtype, eviction):
    run_stream(dtype, eviction)
