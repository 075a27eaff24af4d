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
// reads past the table.  Row offsets are 64-bit: DLRM's flattened table
// holds 1.7e9 elements.  A bag of one item is w * row (or the row), bit for
// bit the plain version's.
//
// Bound: bytes.  Each item is one row read and one multiply-add per element;
// the rows are gathered at random, so the least traffic is the output
// (bags * D * 4), the ids and every distinct row once.  What held the first
// version back was latency, not bytes: one thread carried one id -> row
// chain, so the time followed the bag count (about 12,700 bags in flight).
//
// Design:
//   * Flat slots.  The (bags, D) output is cut into slots of V elements (a
//     vector of VB bytes of the table row: 16 where D and the table's
//     alignment allow, else 8, 4 or 2 -- float2 at D = 10, one float at
//     D = 1, 8 halves at D = 64 in f16 / bf16).  Consecutive threads own
//     consecutive slots, so a warp covers part of a wide row or several
//     narrow bags, and the output stores are fully coalesced.
//   * Many slots in flight.  A thread takes U = 4 slots a step, T apart (T
//     the grid's thread count): it loads their 4 ids, then issues the 4 row
//     loads, then reduces, so 4 id -> row chains overlap; the ids of the
//     next item (or, after a bag's last item, of the next step's first)
//     load while this item's rows are in flight, so a step never waits for
//     its ids.  Slot indices are 32-bit.  Registers are capped per width
//     (min_blocks) so 2 or 3 blocks share an SM.  The grid
//     is persistent: as many blocks as fit on the SMs at once, or fewer for
//     a small batch.
//   * Hot rows stay in L2.  Ids and weights are read once (__ldcs) and the
//     output is written with the evict-first hint (__stcs), so the
//     gigabytes of output do not flush the table rows that repeat.
//   * Items in order.  A slot runs its bag's items in order with explicit
//     round-to-nearest multiplies and adds (no fused multiply-add), the
//     plain version's arithmetic.
// No wgmma, TMA or shared memory: nothing is reused within a block.

#include <climits>
#include <cstring>

#include "common.cuh"

namespace {

enum Mode { kSum = 0, kMean = 1, kMax = 2 };

constexpr int kThreads = 256;

template <int VB> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };

template <typename T, int VB>
__device__ __forceinline__ void widen(const typename Raw<VB>::type& raw, float* f) {
  constexpr int V = VB / static_cast<int>(sizeof(T));
  T e[V];
  memcpy(e, &raw, VB);
#pragma unroll
  for (int k = 0; k < V; ++k) f[k] = repro::to_f(e[k]);
}

template <int V>
__device__ __forceinline__ void store(float* o, const float* a) {
  if constexpr (V == 1) {
    __stcs(o, a[0]);
  } else if constexpr (V == 2) {
    __stcs(reinterpret_cast<float2*>(o), make_float2(a[0], a[1]));
  } else {
#pragma unroll
    for (int k = 0; k < V; k += 4)
      __stcs(reinterpret_cast<float4*>(o + k), make_float4(a[k], a[k + 1], a[k + 2], a[k + 3]));
  }
}

struct Params {
  const void* table;
  const int* idx;
  const float* weights;
  float* out;
  long long n_rows;
  int n_bags, bag_len, dim, mode;
};

// U slots of a thread: their ids and weights at one item
template <int U>
__device__ __forceinline__ void load_ids(const Params& p, const int* bag, const bool* ok, int l,
                                         int* id, float* w) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long at = static_cast<long long>(bag[u]) * p.bag_len + l;
    id[u] = ok[u] ? __ldcs(p.idx + at) : -1;
    w[u] = (ok[u] && p.weights) ? __ldcs(p.weights + at) : 1.0f;
  }
}

constexpr int kSlots = 4;  // U

// blocks an SM must hold, by slot width V (measured on the H100): 3 at
// V = 2 (80 registers, a few bytes spilled), 2 at V = 1 (80 spilled more)
// and V = 8 (the halves' 16 bytes, which take 126), none at V = 4 (124
// registers: 2 blocks anyway)
template <typename T, int VB>
constexpr int min_blocks() {
  constexpr int V = VB / static_cast<int>(sizeof(T));
  return V == 2 ? 3 : (V == 1 || V == 8) ? 2 : 1;
}

template <typename T, int VB>
__global__ void __launch_bounds__(kThreads, (min_blocks<T, VB>())) bag_kernel(Params p) {
  constexpr int V = VB / static_cast<int>(sizeof(T));
  constexpr int U = kSlots;
  using R = typename Raw<VB>::type;
  const T* table = static_cast<const T*>(p.table);
  const int slots_per_bag = p.dim / V;
  const long long total = static_cast<long long>(p.n_bags) * slots_per_bag;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const int bstep = static_cast<int>(stride / slots_per_bag);
  const int cstep = static_cast<int>(stride % slots_per_bag);
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  // (bag, slot) of this thread's next slot, advanced by `stride` slots a
  // time without a division
  int b = static_cast<int>(first / slots_per_bag);
  int c = static_cast<int>(first % slots_per_bag);
  const int L = p.bag_len, mode = p.mode;
  // the U slots of step e: their bags, columns and whether they exist
  auto step_slots = [&](long long e, int* bag, int* col, bool* ok) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ok[u] = e + u * stride < total;
      bag[u] = b;
      col[u] = c;
      b += bstep;
      c += cstep;
      if (c >= slots_per_bag) {
        c -= slots_per_bag;
        ++b;
      }
    }
  };
  int bag[U], col[U];
  bool ok[U];
  step_slots(first, bag, col, ok);
  // the ids and weights of the item whose rows load next: item 0 of a step
  // is loaded during the step before, so no step waits for its ids
  int id[U];
  float w[U];
  if (L > 0) load_ids<U>(p, bag, ok, 0, id, w);
  for (long long e = first; e < total; e += U * stride) {
    int next_bag[U], next_col[U];
    bool next_ok[U];
    step_slots(e + U * stride, next_bag, next_col, next_ok);
    float acc[U][V];
    int count[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      count[u] = 0;
#pragma unroll
      for (int k = 0; k < V; ++k) acc[u][k] = mode == kMax ? -INFINITY : 0.0f;
    }
    for (int l = 0; l < L; ++l) {
      R raw[U];
      bool use[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        use[u] = id[u] >= 0 && (mode != kMax || w[u] > 0.0f);
        if (use[u]) {
          const long long row = id[u] < p.n_rows ? id[u] : p.n_rows - 1;
          raw[u] = __ldg(reinterpret_cast<const R*>(table + row * p.dim) + col[u]);
        }
      }
      int next_id[U];
      float next_w[U];
      if (l + 1 < L)
        load_ids<U>(p, bag, ok, l + 1, next_id, next_w);
      else
        load_ids<U>(p, next_bag, next_ok, 0, next_id, next_w);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        count[u] += id[u] >= 0;
        if (!use[u]) continue;
        float v[V];
        widen<T, VB>(raw[u], v);
#pragma unroll
        for (int k = 0; k < V; ++k)
          acc[u][k] = mode == kMax ? fmaxf(acc[u][k], v[k])
                                   : __fadd_rn(acc[u][k], __fmul_rn(w[u], v[k]));
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        id[u] = next_id[u];
        w[u] = next_w[u];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;
      const float n = static_cast<float>(max(count[u], 1));
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (mode == kMean) acc[u][k] = acc[u][k] / n;
        if (mode == kMax && !isfinite(acc[u][k])) acc[u][k] = 0.0f;
      }
      store<V>(p.out + static_cast<long long>(bag[u]) * p.dim + col[u] * V, acc[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      bag[u] = next_bag[u];
      col[u] = next_col[u];
      ok[u] = next_ok[u];
    }
  }
}

template <typename T, int VB>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int V = VB / static_cast<int>(sizeof(T));
  // the persistent grid: as many blocks as the SMs hold at once (looked up
  // once per instance)
  static const int resident = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bag_kernel<T, VB>, kThreads, 0);
    return sms * (per_sm > 0 ? per_sm : 1);
  }();
  const long long slots = static_cast<long long>(p.n_bags) * (p.dim / V);
  const long long need = (slots + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(need < resident ? need : resident);
  bag_kernel<T, VB><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_vec(const Params& p, int vb, cudaStream_t s) {
  switch (vb) {
    case 16: return launch<T, 16>(p, s);
    case 8: return launch<T, 8>(p, s);
    case 4: return launch<T, 4>(p, s);
    case 2:
      if constexpr (sizeof(T) == 2) return launch<T, 2>(p, s);
      [[fallthrough]];
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// table (n_rows, dim) in `store` (f32, bf16 or f16), idx (n_bags, bag_len)
// int32, weights (n_bags, bag_len) f32 or null, out (n_bags, dim) f32.
// Every table load is the widest of 16, 8, 4 and 2 bytes (at least one
// element) that divides a row's bytes and the table's alignment.
extern "C" int embedding_bag(const void* table, const void* idx, const void* weights,
                             void* out, long long n_bags, int bag_len, int dim,
                             long long n_rows, int store, int mode, void* stream) {
  if (n_bags == 0 || dim == 0) return 0;
  const int isz = store == repro::kF32 ? 4 : 2;
  if (n_rows < 1 || n_bags > INT_MAX || bag_len < 0 || mode < kSum || mode > kMax)
    return static_cast<int>(cudaErrorInvalidValue);
  int vec_bytes = isz;
  for (int vb = 16; vb > isz; vb /= 2) {
    if ((static_cast<long long>(dim) * isz) % vb == 0 &&
        reinterpret_cast<uintptr_t>(table) % vb == 0) {
      vec_bytes = vb;
      break;
    }
  }
  const Params p{table, static_cast<const int*>(idx), static_cast<const float*>(weights),
                 static_cast<float*>(out), n_rows, static_cast<int>(n_bags), bag_len, dim,
                 mode};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (store) {
    case repro::kF32: return launch_vec<float>(p, vec_bytes, s);
    case repro::kBF16: return launch_vec<__nv_bfloat16>(p, vec_bytes, s);
    case repro::kF16: return launch_vec<__half>(p, vec_bytes, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
