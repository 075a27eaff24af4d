// Block-wide exact top-k in the stable order, for the cache wave's query
// (cache_wave.cu); the kNN select (knn.cu knn_select) sorts its candidates
// with the same bitonic sort (sort_pairs), and the fused tile kernel (knn.cu
// gemm_tile_kernel) uses the same order (key_before).
//
// One block selects the k largest of n order-preserving uint32 keys
// (repro::float_key) and writes them in the stable top-k order — key
// descending, position ascending — as (key, position) pairs:
//
//   1. radix select of the k-th largest key: 4 passes of 8 bits from the
//      top, each a warp-aggregated shared-memory histogram over the keys
//      still matching the prefix and a suffix sum of its 256 bins by one
//      warp;
//   2. compaction of every key above it (in any order) plus the LOWEST
//      positions holding it, in position order (a block-wide prefix sum);
//   3. a bitonic sort of the kp = pow2(k) pairs by (key desc, position asc),
//      with (0, INT_MAX) padding that sorts last.
//
// The pair arrays hold kp entries and belong to the calling block alone:
// shared memory while kp * 8 bytes fit (the wrapper's choice), else a
// global scratch buffer — __syncthreads orders global accesses within a
// block as it does shared ones, so one code path serves both.

#pragma once

#include <climits>

#include "common.cuh"

namespace repro {

struct SelectShared {
  unsigned hist[256];
  int warp_tot[33];
  uint32_t prefix;
  int kr, ngt, neq;
};

// Exclusive block-wide prefix sum of one int per thread; *total gets the sum.
__device__ inline int block_exclusive_scan(int v, int* warp_tot, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int t0 = lane < nwarps ? warp_tot[lane] : 0;
    int t = t0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    warp_tot[lane] = t - t0;
    if (lane == 31) warp_tot[32] = t;
  }
  __syncthreads();
  const int res = warp_tot[warp] + x - v;
  *total = warp_tot[32];
  __syncthreads();
  return res;
}

__device__ __forceinline__ bool key_before(uint32_t ka, int pa, uint32_t kb, int pb) {
  return ka > kb || (ka == kb && pa < pb);
}

// Bitonic sort of kp (a power of two) pairs by (key desc, position asc),
// by the whole block; the pairs are visible to the block before and after.
__device__ inline void sort_pairs(uint32_t* key, int* pos, int kp) {
  for (int size = 2; size <= kp; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < kp / 2; t += blockDim.x) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const bool up = (i & size) == 0;
        if (key_before(key[j], pos[j], key[i], pos[i]) == up) {
          const uint32_t tk = key[i];
          key[i] = key[j];
          key[j] = tk;
          const int tp = pos[i];
          pos[i] = pos[j];
          pos[j] = tp;
        }
      }
      __syncthreads();
    }
  }
}

// The k largest of the n keys key_at(0 .. n-1) into cand_key / cand_pos
// [0, k) in the stable top-k order, by the whole block.  Needs 1 <= k <= n,
// kp the power of two >= k, n < 2^31, blockDim.x a multiple of 32 (<= 1024)
// and every thread of the block.  Ends with the pairs visible to the block.
template <typename KeyAt>
__device__ void block_topk(const KeyAt& key_at, long long n, int k, int kp,
                           uint32_t* cand_key, int* cand_pos, SelectShared& sh) {
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) {
    sh.prefix = 0u;
    sh.kr = k;
    sh.ngt = 0;
    sh.neq = 0;
  }
  // 1. radix select of the k-th largest key
  uint32_t mask = 0u;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    for (int i = tid; i < 256; i += blockDim.x) sh.hist[i] = 0u;
    __syncthreads();
    const uint32_t prefix = sh.prefix;
    for (long long base = 0; base < n; base += blockDim.x) {
      const long long i = base + tid;
      int bin = -1;
      if (i < n) {
        const uint32_t key = key_at(i);
        if ((key & mask) == prefix) bin = static_cast<int>((key >> shift) & 255u);
      }
      const unsigned peers = __match_any_sync(0xffffffffu, bin);
      if (bin >= 0 && lane == __ffs(peers) - 1) atomicAdd(&sh.hist[bin], __popc(peers));
    }
    __syncthreads();
    if (tid < 32) {
      // the bin holding the kr-th largest key, by warp 0: lane l owns bins
      // 8l .. 8l+7 and a suffix sum over the lanes gives the count above
      // them; exactly one bin has cum < kr <= cum + its count
      const unsigned kr = static_cast<unsigned>(sh.kr);
      unsigned c[8], tot = 0u;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        c[u] = sh.hist[8 * tid + u];
        tot += c[u];
      }
      unsigned above = tot;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_down_sync(0xffffffffu, above, o);
        if (tid + o < 32) above += y;
      }
      unsigned cum = above - tot;
#pragma unroll
      for (int u = 7; u >= 0; --u) {
        if (cum < kr && cum + c[u] >= kr) {
          sh.prefix = prefix | (static_cast<uint32_t>(8 * tid + u) << shift);
          sh.kr = static_cast<int>(kr - cum);
        }
        cum += c[u];
      }
    }
    mask |= 255u << shift;
    __syncthreads();
  }
  const uint32_t thr = sh.prefix;
  const int need_eq = sh.kr;       // keys equal to the threshold to keep
  const int n_gt = k - need_eq;    // keys strictly above it (all kept)

  // 2. compaction: every key above thr, then the need_eq lowest positions
  //    holding thr, in position order
  for (long long base = 0; base < n; base += 4LL * blockDim.x) {
    uint32_t key[4];
    int eqc = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long i = base + 4LL * tid + u;
      key[u] = i < n ? key_at(i) : 0u;
      if (i < n && key[u] > thr) {
        const int slot = atomicAdd(&sh.ngt, 1);
        cand_key[slot] = key[u];
        cand_pos[slot] = static_cast<int>(i);
      }
      eqc += (i < n && key[u] == thr) ? 1 : 0;
    }
    if (__syncthreads_or(eqc > 0)) {
      const int before_n = sh.neq;
      if (before_n < need_eq) {
        int total;
        int r = before_n + block_exclusive_scan(eqc, sh.warp_tot, &total);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const long long i = base + 4LL * tid + u;
          if (i < n && key[u] == thr) {
            if (r < need_eq) {
              cand_key[n_gt + r] = thr;
              cand_pos[n_gt + r] = static_cast<int>(i);
            }
            ++r;
          }
        }
        if (tid == 0) sh.neq = before_n + total;
      }
    }
  }
  __syncthreads();
  for (int r = k + tid; r < kp; r += blockDim.x) {
    cand_key[r] = 0u;
    cand_pos[r] = INT_MAX;
  }
  __syncthreads();

  // 3. bitonic sort of the kp pairs by (key desc, position asc)
  sort_pairs(cand_key, cand_pos, kp);
}

}  // namespace repro
