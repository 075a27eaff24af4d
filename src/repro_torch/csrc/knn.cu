// Exact top-k inner-product search over the corpus: score, then select.
//
// Replaces: src/repro/kernels/knn/knn.py:197 knn_fused_topk (the Pallas
// double-buffered tile scan with a (B, k) carry merged by k rounds of
// max-extract).  On a GPU at k = k_c = 1000 that merge is k serial block
// reductions per tile; here the work is split in two launches instead:
//
//   (a) knn_score  — masked f32 scores for the whole (B, N) matrix into a
//       scratch buffer.  Dequantize-first rule: payload -> f32, f32 dot,
//       times the per-document scale.  int8-dot rule: int8 x int8 summed
//       exactly in int32, then (f32(acc) * q_scale) * scale — the
//       association order of knn.py:89.  Rows with id < 0 score -inf.
//   (b) knn_select — one block per query row: an exact radix select of the
//       k-th largest order-preserving uint32 key (4 passes of 8 bits with
//       warp-aggregated shared-memory histograms), compaction of every key
//       above it plus the LOWEST positions among keys equal to it (the
//       stable top-k order), and a bitonic sort of the <= 1024 survivors by
//       (score descending, position ascending).  -inf results carry id -1.
//
// Bound: the corpus pass, N * (Dp * itemsize + 8) bytes plus the queries
// and the (B, k) answer, against 2 * B * N * Dp operations (f32 on the CUDA
// cores, or int8).  At B = 64 and fp32 the operations dominate; bf16 and
// int8 halve and quarter the bytes.  Design: (a) is a plain shared-memory
// tiled product (64 queries x 128 documents x 32 features per block, 4 x 8
// outputs per thread) so each corpus tile is read from device memory once
// for all B <= 64 queries; (b) re-reads the (B, N) f32 scratch five times,
// which a later single-pass kernel that keeps the scores on chip removes.

#include <climits>
#include <type_traits>

#include "common.cuh"

namespace {

using repro::float_key;
using repro::key_float;
using repro::to_f;

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int MAXK = 1024;

template <typename T, bool I8DOT>
__global__ void __launch_bounds__(256)
    score_kernel(const void* __restrict__ q_raw, const float* __restrict__ q_scale,
                 const T* __restrict__ docs, const int* __restrict__ ids,
                 const float* __restrict__ dscale, float* __restrict__ scores, int b,
                 long long n, int dp) {
  using Acc = typename std::conditional<I8DOT, int, float>::type;
  __shared__ Acc qs[BK][BM + 1];
  __shared__ Acc ds[BK][BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const long long n0 = static_cast<long long>(blockIdx.x) * BN;
  const int m0 = blockIdx.y * BM;
  Acc acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = Acc(0);

  for (int k0 = 0; k0 < dp; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += 256) {
      const int m = idx / BK, kk = idx % BK;
      Acc v = Acc(0);
      if (m0 + m < b) {
        const size_t off = static_cast<size_t>(m0 + m) * dp + k0 + kk;
        if constexpr (I8DOT) {
          v = static_cast<int>(static_cast<const int8_t*>(q_raw)[off]);
        } else {
          v = static_cast<const float*>(q_raw)[off];
        }
      }
      qs[kk][m] = v;
    }
    for (int idx = tid; idx < BN * BK; idx += 256) {
      const int nn = idx / BK, kk = idx % BK;
      Acc v = Acc(0);
      if (n0 + nn < n) {
        const T x = docs[static_cast<size_t>(n0 + nn) * dp + k0 + kk];
        if constexpr (I8DOT) {
          v = static_cast<int>(x);
        } else {
          v = to_f(x);
        }
      }
      ds[kk][nn] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      Acc a[4], d[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) d[j] = ds[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if constexpr (I8DOT) {
            acc[i][j] += a[i] * d[j];
          } else {
            acc[i][j] = fmaf(a[i], d[j], acc[i][j]);
          }
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= b) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long c = n0 + tx + 16 * j;
      if (c >= n) continue;
      const float sc = dscale ? dscale[c] : 1.0f;
      float s;
      if constexpr (I8DOT) {
        s = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), q_scale[m]), sc);
      } else {
        s = __fmul_rn(acc[i][j], sc);
      }
      if (ids[c] < 0) s = -INFINITY;
      scores[static_cast<size_t>(m) * n + c] = s;
    }
  }
}

// Exclusive block-wide prefix sum of one int per thread; *total gets the sum.
__device__ int block_exclusive_scan(int v, int* warp_tot, int* total) {
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

__device__ __forceinline__ bool before(uint32_t ka, int pa, uint32_t kb, int pb) {
  return ka > kb || (ka == kb && pa < pb);
}

__global__ void __launch_bounds__(1024)
    select_kernel(const float* __restrict__ scores, const int* __restrict__ ids,
                  float* __restrict__ out_vals, int* __restrict__ out_ids, long long n,
                  int k, int kp) {
  __shared__ unsigned hist[256];
  __shared__ uint32_t cand_key[MAXK];
  __shared__ int cand_pos[MAXK];
  __shared__ int warp_tot[33];
  __shared__ uint32_t s_prefix;
  __shared__ int s_kr, s_ngt, s_neq;
  const float* row = scores + static_cast<size_t>(blockIdx.x) * n;
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) {
    s_prefix = 0u;
    s_kr = k;
    s_ngt = 0;
    s_neq = 0;
  }
  // radix select of the k-th largest key, 8 bits per pass from the top
  uint32_t mask = 0u;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    for (int i = tid; i < 256; i += blockDim.x) hist[i] = 0u;
    __syncthreads();
    const uint32_t prefix = s_prefix;
    for (long long base = 0; base < n; base += blockDim.x) {
      const long long i = base + tid;
      int bin = -1;
      if (i < n) {
        const uint32_t key = float_key(row[i]);
        if ((key & mask) == prefix) bin = static_cast<int>((key >> shift) & 255u);
      }
      const unsigned peers = __match_any_sync(0xffffffffu, bin);
      if (bin >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
    }
    __syncthreads();
    if (tid == 0) {
      const unsigned kr = static_cast<unsigned>(s_kr);
      unsigned cum = 0u;
      for (int bb = 255; bb >= 0; --bb) {
        if (cum + hist[bb] >= kr) {
          s_prefix = prefix | (static_cast<uint32_t>(bb) << shift);
          s_kr = static_cast<int>(kr - cum);
          break;
        }
        cum += hist[bb];
      }
    }
    mask |= 255u << shift;
    __syncthreads();
  }
  const uint32_t thr = s_prefix;
  const int need_eq = s_kr;       // keys equal to the threshold to keep
  const int n_gt = k - need_eq;   // keys strictly above it (all kept)

  // compaction: every key above thr (any order; the sort orders them) and
  // the need_eq lowest positions holding thr, in position order
  for (long long base = 0; base < n; base += 4LL * blockDim.x) {
    uint32_t key[4];
    int eqc = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long i = base + 4LL * tid + u;
      key[u] = i < n ? float_key(row[i]) : 0u;
      if (i < n && key[u] > thr) {
        const int slot = atomicAdd(&s_ngt, 1);
        cand_key[slot] = key[u];
        cand_pos[slot] = static_cast<int>(i);
      }
      eqc += (i < n && key[u] == thr) ? 1 : 0;
    }
    if (__syncthreads_or(eqc > 0)) {
      const int before_n = s_neq;
      if (before_n < need_eq) {
        int total;
        int r = before_n + block_exclusive_scan(eqc, warp_tot, &total);
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
        if (tid == 0) s_neq = before_n + total;
      }
    }
  }
  __syncthreads();
  for (int r = k + tid; r < kp; r += blockDim.x) {
    cand_key[r] = 0u;
    cand_pos[r] = INT_MAX;
  }
  __syncthreads();

  // bitonic sort of kp survivors by (key desc, position asc)
  for (int size = 2; size <= kp; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < kp / 2; t += blockDim.x) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const bool up = (i & size) == 0;
        if (before(cand_key[j], cand_pos[j], cand_key[i], cand_pos[i]) == up) {
          const uint32_t tk = cand_key[i];
          cand_key[i] = cand_key[j];
          cand_key[j] = tk;
          const int tp = cand_pos[i];
          cand_pos[i] = cand_pos[j];
          cand_pos[j] = tp;
        }
      }
      __syncthreads();
    }
  }
  for (int r = tid; r < k; r += blockDim.x) {
    const float v = key_float(cand_key[r]);
    const size_t o = static_cast<size_t>(blockIdx.x) * k + r;
    out_vals[o] = v;
    out_ids[o] = (v == -INFINITY) ? -1 : ids[cand_pos[r]];
  }
}

template <typename T, bool I8DOT>
cudaError_t launch_score(const void* q, const void* q_scale, const void* docs,
                         const void* ids, const void* dscale, void* scores, int b,
                         long long n, int dp, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n + BN - 1) / BN),
                  static_cast<unsigned>((b + BM - 1) / BM));
  score_kernel<T, I8DOT><<<grid, 256, 0, stream>>>(
      q, static_cast<const float*>(q_scale), static_cast<const T*>(docs),
      static_cast<const int*>(ids), static_cast<const float*>(dscale),
      static_cast<float*>(scores), b, n, dp);
  return cudaGetLastError();
}

}  // namespace

extern "C" int knn_score(const void* q, const void* q_scale, const void* docs,
                         const void* ids, const void* dscale, void* scores, int b,
                         long long n, int dp, int store, int int8_dot, void* stream) {
  if (b == 0 || n == 0) return 0;
  if (dp % BK != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int8_dot) {
    if (store != repro::kI8) return static_cast<int>(cudaErrorInvalidValue);
    return launch_score<int8_t, true>(q, q_scale, docs, ids, dscale, scores, b, n, dp, st);
  }
  switch (store) {
    case repro::kF32:
      return launch_score<float, false>(q, q_scale, docs, ids, dscale, scores, b, n, dp, st);
    case repro::kBF16:
      return launch_score<__nv_bfloat16, false>(q, q_scale, docs, ids, dscale, scores, b, n,
                                                dp, st);
    case repro::kI8:
      return launch_score<int8_t, false>(q, q_scale, docs, ids, dscale, scores, b, n, dp, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int knn_select(const void* scores, const void* ids, void* out_vals, void* out_ids,
                          int b, long long n, int k, void* stream) {
  if (b == 0) return 0;
  if (k < 1 || k > MAXK || k > n) return static_cast<int>(cudaErrorInvalidValue);
  int kp = 1;
  while (kp < k) kp <<= 1;
  select_kernel<<<b, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<const int*>(ids),
      static_cast<float*>(out_vals), static_cast<int*>(out_ids), n, k, kp);
  return cudaGetLastError();
}
