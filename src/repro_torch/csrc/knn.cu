// Exact top-k inner-product search over the corpus: score, then select.
//
// Replaces: src/repro/kernels/knn/knn.py:197 knn_fused_topk (the Pallas
// double-buffered tile scan with a (B, k) carry merged by k rounds of
// max-extract) and src/repro/kernels/knn/knn.py:285 knn_tile_topk (the
// per-tile k_eff rounds of max-extract of the two-stage scheme).  On a GPU
// at k = k_c = 1000 those merges are k serial block reductions per tile;
// here the work is split in two launches instead:
//
//   (a) knn_score  — masked f32 scores for the whole (B, N) matrix into a
//       scratch buffer.  Dequantize-first rule: payload -> f32, f32 dot,
//       times the per-document scale.  int8-dot rule: int8 x int8 summed
//       exactly in int32, then (f32(acc) * q_scale) * scale — the
//       association order of knn.py:89.  Rows with id < 0 score -inf.
//   (b) knn_select — one block per query row: the stable top-k of the
//       row (select.cuh: radix select of the k-th key, compaction, bitonic
//       sort of the pow2(k) survivors by (score desc, position asc)) for
//       any k <= N; -inf results carry id -1.
//   (b') knn_tile_select — the two-stage scheme's per-tile stage: one block
//       per (tile, query row), the same stable top-k of the tile's tile_n
//       scores (positions past N read -inf), writing (tiles, B, k_eff)
//       values and corpus positions.  The wrapper merges the candidates.
//
// The survivors sit in dynamic shared memory (8 B per pair) while they fit
// and in a global scratch buffer the wrapper passes otherwise.
//
// Bound: the corpus pass, N * (Dp * itemsize + 8) bytes plus the queries
// and the answer, against 2 * B * N * Dp operations (f32 on the CUDA
// cores, or int8).  At B = 64 and fp32 the operations dominate; bf16 and
// int8 halve and quarter the bytes.  Design: (a) is a plain shared-memory
// tiled product (64 queries x 128 documents x 32 features per block, 4 x 8
// outputs per thread) so each corpus tile is read from device memory once
// for all B <= 64 queries — a single query (B = 1) pays the same block
// work; (b) re-reads the (B, N) f32 scratch five times, which a later
// single-pass kernel that keeps the scores on chip removes.

#include <climits>
#include <type_traits>

#include "common.cuh"
#include "select.cuh"

namespace {

using repro::to_f;

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BK = 32;

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

// One block per query row: the stable top-k of the row's n scores.  The
// pairs live in dynamic shared memory, or in (B, kp) global scratch when
// the wrapper passes one.
__global__ void __launch_bounds__(1024)
    select_kernel(const float* __restrict__ scores, const int* __restrict__ ids,
                  float* __restrict__ out_vals, int* __restrict__ out_ids,
                  uint32_t* pair_key, int* pair_pos, long long n, int k, int kp) {
  extern __shared__ uint32_t pairs[];
  __shared__ repro::SelectShared sh;
  const size_t r0 = blockIdx.x;
  const float* row = scores + r0 * n;
  uint32_t* ck = pair_key ? pair_key + r0 * kp : pairs;
  int* cpos = pair_key ? pair_pos + r0 * kp : reinterpret_cast<int*>(pairs + kp);
  repro::block_topk(repro::RowKeys{row, n}, n, k, kp, ck, cpos, sh);
  for (int r = threadIdx.x; r < k; r += blockDim.x) {
    const int p = cpos[r];
    const float v = row[p];
    out_vals[r0 * k + r] = v;
    out_ids[r0 * k + r] = (v == -INFINITY) ? -1 : ids[p];
  }
}

// One block per (tile, query row): the stable top-k of the tile's tile_n
// scores, positions past the corpus reading -inf.  Writes (tiles, B, k)
// values and corpus positions.
__global__ void __launch_bounds__(256)
    tile_select_kernel(const float* __restrict__ scores, float* __restrict__ out_vals,
                       int* __restrict__ out_pos, uint32_t* pair_key, int* pair_pos,
                       long long n, int tile_n, int k, int kp) {
  extern __shared__ uint32_t pairs[];
  __shared__ repro::SelectShared sh;
  const long long base = static_cast<long long>(blockIdx.x) * tile_n;
  const float* row = scores + static_cast<size_t>(blockIdx.y) * n + base;
  const long long valid = n - base < tile_n ? n - base : tile_n;
  const size_t o = static_cast<size_t>(blockIdx.x) * gridDim.y + blockIdx.y;
  uint32_t* ck = pair_key ? pair_key + o * kp : pairs;
  int* cpos = pair_key ? pair_pos + o * kp : reinterpret_cast<int*>(pairs + kp);
  repro::block_topk(repro::RowKeys{row, valid}, tile_n, k, kp, ck, cpos, sh);
  for (int r = threadIdx.x; r < k; r += blockDim.x) {
    const int p = cpos[r];
    out_vals[o * k + r] = p < valid ? row[p] : -INFINITY;
    out_pos[o * k + r] = static_cast<int>(base + p);
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
                          void* pair_key, void* pair_pos, int b, long long n, int k, int kp,
                          void* stream) {
  if (b == 0) return 0;
  if (k < 1 || k > n || kp < k || (kp & (kp - 1))) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = pair_key ? 0 : static_cast<size_t>(kp) * 8;
  cudaError_t err = repro::allow_smem(select_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  select_kernel<<<b, 1024, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<const int*>(ids),
      static_cast<float*>(out_vals), static_cast<int*>(out_ids),
      static_cast<uint32_t*>(pair_key), static_cast<int*>(pair_pos), n, k, kp);
  return cudaGetLastError();
}

extern "C" int knn_tile_select(const void* scores, void* out_vals, void* out_pos,
                               void* pair_key, void* pair_pos, int b, long long n, int tile_n,
                               int k, int kp, void* stream) {
  if (b == 0 || n == 0) return 0;
  if (k < 1 || k > tile_n || kp < k || (kp & (kp - 1)) || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (n + tile_n - 1) / tile_n;
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = pair_key ? 0 : static_cast<size_t>(kp) * 8;
  cudaError_t err = repro::allow_smem(tile_select_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(b));
  tile_select_kernel<<<grid, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<float*>(out_vals),
      static_cast<int*>(out_pos), static_cast<uint32_t*>(pair_key),
      static_cast<int*>(pair_pos), n, tile_n, k, kp);
  return cudaGetLastError();
}
