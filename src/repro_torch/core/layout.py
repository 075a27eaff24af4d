"""Physical cache-state layout for Hopper: the padded extents, in one place.

The cache's logical extents (``capacity``, ``dim``, ``max_queries`` in
``CacheConfig``) are what the serving configuration asks for.  The
``CacheState`` leaves are allocated once at padded physical extents so the
CUDA kernels read aligned rows and no launch pads the stacked state:

  * feature dim rounded to ``FEAT`` = 32 elements (769 -> 800), the kNN
    score's feature tile (``kernels/_build.py`` owns the number): every row
    then starts on a 32-byte boundary for int8, bf16 and fp32 payloads, so
    a thread can move it in 16-byte vectors, and a later ``wgmma`` K step
    of 32 bytes divides it;
  * the query-record ring rounded to ``RING`` = 8;
  * capacity rounded to the wave tile, a power of two <= 512.

Padded slots hold the empty-slot sentinels (doc id -1, scale 1.0, radius
-inf, stamp 0, zero payload) and every op masks on the logical extents.
The drop sentinel of an insert position is the physical capacity.  The JAX
package's TPU rule (``LANE`` = 128) is not used here.
"""

from __future__ import annotations

from repro_torch.kernels import _build

FEAT = _build.FEAT   # feature-axis multiple (elements)
RING = 8             # query-record ring multiple

__all__ = ["FEAT", "RING", "round_up", "next_pow2", "wave_tile",
           "phys_capacity", "phys_dim", "phys_queries"]


def round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def next_pow2(n: int) -> int:
    """The least power of two >= ``n``: 1 for any ``n`` <= 1."""
    return 1 << max(n - 1, 0).bit_length()


def wave_tile(capacity: int) -> int:
    """Capacity tile: one power of two <= 512 (the whole cache when
    smaller)."""
    pow2 = max(RING, next_pow2(capacity))
    return min(512, pow2)


def phys_capacity(capacity: int) -> int:
    """Physical doc-slot count: capacity rounded to the wave tile."""
    return round_up(capacity, wave_tile(capacity))


def phys_dim(dim: int) -> int:
    """Physical feature width: dim rounded to ``FEAT``."""
    return round_up(dim, FEAT)


def phys_queries(max_queries: int) -> int:
    """Physical query-record ring length: rounded to ``RING``."""
    return round_up(max_queries, RING)
