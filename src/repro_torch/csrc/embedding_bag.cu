// EmbeddingBag: a ragged gather of table rows reduced per bag by a weighted
// sum, a mean or a max -- the hot path of the recsys models' field_pool.
//
// Replaces: src/repro/kernels/embedding_bag/embedding_bag.py:50
// embedding_bag_kernel (the Pallas grid over (bags, items), one (1, D) row
// DMA per step driven by scalar-prefetched ids) together with the wrapper
// arithmetic of src/repro/kernels/embedding_bag/ops.py:30-43 (weights zeroed
// at pads, mean divided by the valid count clamped to 1, max -inf -> 0).
//
// For bag b, column c and its valid items l (idx[b, l] >= 0; w = 1 when no
// weights are given):
//   sum:  out[b, c] = sum over l, in order, of w[b, l] * f32(table[idx, c])
//   mean: the sum divided by max(#valid items, 1)
//   max:  the max of f32(table[idx, c]) over the valid items with w > 0 (the
//         Pallas kernel's rule); a non-finite result, as for an empty bag,
//         becomes 0
// An id >= V reads row V - 1, as XLA's clamped gather does: the kernel never
// reads past the table.
//
// Bound: bytes.  Each item is one row read and one multiply-add per element;
// the rows are gathered at random, so the least traffic is the output
// (bags * D * 4), the ids and every distinct row once.  Design, simple on
// purpose: a group of G threads per bag, G the smallest power of two that
// covers the row's vectors (at most a warp: 16 threads for D = 64 in f32, 1
// for the D = 1 linear term), each thread striding over D and accumulating
// in f32 registers, the (bags, D) output written once.  f32 rows move as
// 16-byte float4 loads when D % 4 == 0 and the table is 16-byte aligned;
// otherwise, and for f16 / bf16 tables (off the models' f32 path), one
// element at a time (D = 10: 40-byte rows).  All row offsets are 64-bit:
// DLRM's flattened table holds 1.7e9 elements.  No wgmma, TMA or row
// prefetch.

#include "common.cuh"

namespace {

enum Mode { kSum = 0, kMean = 1, kMax = 2 };

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float v[VEC]) {
  if constexpr (VEC == 4) {
    load4(p, v);                     // f32 only
  } else {
    v[0] = repro::to_f(*p);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(256)
bag_kernel(const T* __restrict__ table, const int* __restrict__ idx,
           const float* __restrict__ weights, float* __restrict__ out,
           long long n_bags, int bag_len, int dim, long long n_rows, int group,
           int mode) {
  const int nvec = dim / VEC;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = static_cast<int>(tid & (group - 1));
  const long long n_groups = static_cast<long long>(gridDim.x) * blockDim.x / group;
  for (long long b = tid / group; b < n_bags; b += n_groups) {
    const int* ids = idx + b * bag_len;
    const float* w = weights ? weights + b * bag_len : nullptr;
    for (int c = lane; c < nvec; c += group) {
      float acc[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = mode == kMax ? -INFINITY : 0.0f;
      int count = 0;
      for (int l = 0; l < bag_len; ++l) {
        const int i = ids[l];
        if (i < 0) continue;
        ++count;
        const float wl = w ? w[l] : 1.0f;
        if (mode == kMax && !(wl > 0.0f)) continue;
        const long long row = i < n_rows ? static_cast<long long>(i) : n_rows - 1;
        float v[VEC];
        load_vec<T, VEC>(table + row * dim + static_cast<long long>(c) * VEC, v);
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          acc[k] = mode == kMax ? fmaxf(acc[k], v[k]) : __fadd_rn(acc[k], __fmul_rn(wl, v[k]));
      }
      const float n = static_cast<float>(max(count, 1));
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        if (mode == kMean) acc[k] = acc[k] / n;
        if (mode == kMax && !isfinite(acc[k])) acc[k] = 0.0f;
      }
      float* o = out + b * dim + static_cast<long long>(c) * VEC;
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
      } else {
        o[0] = acc[0];
      }
    }
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* table, const void* idx, const void* weights, void* out,
                   long long n_bags, int bag_len, int dim, long long n_rows, int mode,
                   cudaStream_t stream) {
  const int nvec = dim / VEC;
  int group = 1;
  while (group < nvec && group < 32) group <<= 1;
  const long long blocks = (n_bags * group + 255) / 256;
  const unsigned grid = static_cast<unsigned>(blocks < (1LL << 24) ? blocks : (1LL << 24));
  bag_kernel<T, VEC><<<grid, 256, 0, stream>>>(
      static_cast<const T*>(table), static_cast<const int*>(idx),
      static_cast<const float*>(weights), static_cast<float*>(out), n_bags, bag_len, dim,
      n_rows, group, mode);
  return cudaGetLastError();
}

}  // namespace

// table (n_rows, dim) in `store` (f32, bf16 or f16), idx (n_bags, bag_len)
// int32, weights (n_bags, bag_len) f32 or null, out (n_bags, dim) f32.  `vec`
// is 4 only for an f32 table with dim % 4 == 0 aligned to 16 bytes.
extern "C" int embedding_bag(const void* table, const void* idx, const void* weights,
                             void* out, long long n_bags, int bag_len, int dim,
                             long long n_rows, int store, int vec, int mode,
                             void* stream) {
  if (n_bags == 0 || dim == 0) return 0;
  if (n_rows < 1 || bag_len < 0 || mode < kSum || mode > kMax || (vec != 1 && vec != 4) ||
      (vec == 4 && (dim % 4 != 0 || store != repro::kF32)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (store) {
    case repro::kF32:
      if (vec == 4)
        return launch<float, 4>(table, idx, weights, out, n_bags, bag_len, dim, n_rows, mode, s);
      return launch<float, 1>(table, idx, weights, out, n_bags, bag_len, dim, n_rows, mode, s);
    case repro::kBF16:
      return launch<__nv_bfloat16, 1>(table, idx, weights, out, n_bags, bag_len, dim, n_rows,
                                      mode, s);
    case repro::kF16:
      return launch<__half, 1>(table, idx, weights, out, n_bags, bag_len, dim, n_rows, mode, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
