// Exact top-k inner-product search over the corpus: score, then select.
//
// Replaces: src/repro/kernels/knn/knn.py:197 knn_fused_topk (the Pallas
// double-buffered tile scan with a (B, k) carry merged by k rounds of
// max-extract) and src/repro/kernels/knn/knn.py:285 knn_tile_topk (the
// per-tile k_eff rounds of max-extract of the two-stage scheme).  On a GPU
// at k = k_c = 1000 those merges are k serial block reductions per tile;
// here the fused search is split in two ops instead, and the tile stage is
// one kernel that scores and selects each tile on chip:
//
//   (a) knn_score — masked f32 scores for the whole (B, N) matrix into a
//       scratch buffer.  Dequantize-first rule: payload -> f32, f32 dot (FMA
//       on the CUDA cores: no TF32), times the per-document scale.
//       int8-dot rule: int8 x int8 summed exactly in int32, then
//       (f32(acc) * q_scale) * scale, the association order of knn.py:89.
//       Rows with id < 0 score -inf.  Two paths behind one entry, the
//       wrapper choosing from B:
//       * batched (the wave's B = 64): bound by the f32 operations,
//         2 * B * N * Dp at 67 TFLOP/s (13.5 ms at N = 8.8M, Dp = 800).  A
//         persistent grid of two 128-thread blocks per SM walks 64-query x
//         256-document tiles, so the corpus is read once for all <= 64
//         queries.  Operands pass through a 2-stage ring of 32-feature
//         slices in dynamic shared memory (92 KB a block), f32 filled by
//         16-byte cp.async (bf16 / int8 loaded into registers one stage
//         ahead and widened to f32 as they are stored), so the next slice
//         loads while this one multiplies and the other block of the SM
//         covers the wait.  The multiply issues FFMA at close to 90% of its
//         instructions; shared-memory reads held it back, so each lane owns
//         8 x 16 outputs (24 float4 reads per 512 FMA, each read one
//         broadcast wavefront per warp).
//       * single query (B <= GEMV_MAX_B; every miss of one session): bound by the
//         bytes, N * Dp * itemsize (8.5 ms for the f32 corpus).  The queries
//         sit in shared memory; a warp streams one document row at a time
//         with 16-byte loads (8 in flight per lane), a shuffle reduction
//         makes each score, and the grid fills every SM.
//   (b) knn_select — the stable top-k of each (B, N) row, any k <= N: a
//       radix select that spreads every row over all SMs (AIR top-k: Zhang
//       et al., SC '23).  Bound: one read of the (B, N) scratch, 4 B * B *
//       N.  Digits of 8, 12 and 12 bits from the top of the key.  A first
//       pass counts the first digit (counted in the score kernels it cost
//       them more than this pass takes).  Each filter pass runs on a
//       (chunks, B) grid of >= 4 x SMs blocks, whatever B is, works out the
//       k-th key's digit from the pass's histogram, appends keys above it
//       to the row's candidates and keys at it to a buffer (building the
//       next digit's histogram), and the later passes read only that
//       buffer.  The candidates end as every key above the k-th key plus
//       every position holding it, and one block per row sorts them by (key
//       desc, position asc) and keeps k: the lowest positions of a tie win
//       whatever order the atomics ran in.  A tie run at rank k too long for
//       the candidates (all-equal rows, runs of -inf, k = N) is finished by
//       a position-ordered compaction of the row; a digit too full for the
//       buffer makes the next pass read the scores again.  A memset and 5
//       device kernels at every B.
//   (c) knn_tile_topk — the two-stage scheme's tile stage: the stable top
//       k_eff of every tile_n tile of the masked scores, as knn.py:285
//       computes it, with no (B, N) scratch: each tile is scored and
//       selected on chip and only (B, tiles, k_eff) values and positions
//       are written.  Bound: the f32 operations, as the score (13.5 ms at
//       B = 64 over the 8.8M-document corpus; the bytes alone, the corpus
//       read and the candidates written, 9.8 ms).  The TPU kernel held a
//       whole tile's (B, tile_n) scores in VMEM; a Hopper block holds 64 x
//       256 of them, so the GEMM's main loop (gemm_units) gets a new
//       epilogue in its dead ring: a warp sorts each row's 256 keys in
//       registers (no block barrier per row), and a tile wider than 256
//       spans a thread-block cluster whose runs are merged by rank through
//       distributed shared memory (gemm_tile_kernel).  Every B takes it (a
//       single-query scan pays the 64-query tile's operations, as knn_score's
//       GEMM would).  Tiles up to FUSED_MAX_TILE documents, of any width;
//       the wrapper answers a wider tile through (a) and (b).
//
//   The wrapper merges the candidates of (c) with (b).
//
// Every buffer (histograms, counters, candidates, filter buffers) comes from
// the wrapper; the kernels allocate nothing.  The numbers the wrapper shares
// (REPRO_*) come from kernels/_build.py, which owns each of them.

#include <climits>
#include <type_traits>

#include <cooperative_groups.h>

#include "common.cuh"
#include "select.cuh"

namespace cg = cooperative_groups;

namespace {

using repro::float_key;
using repro::key_float;

constexpr int H0 = 256;  // bins of the first radix digit (the key's top byte)

// ----------------------------------------------------------------- helpers
__device__ __forceinline__ unsigned word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// Element j of a 16-byte chunk of T payloads, widened.
template <typename T>
__device__ __forceinline__ float elem(const uint4& r, int j);
template <>
__device__ __forceinline__ float elem<float>(const uint4& r, int j) {
  return __uint_as_float(word(r, j));
}
template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& r, int j) {
  const unsigned w = word(r, j >> 1);
  return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
}
__device__ __forceinline__ int ielem(const uint4& r, int j) {
  return static_cast<int>(static_cast<int8_t>((word(r, j >> 2) >> (8 * (j & 3))) & 0xffu));
}
template <>
__device__ __forceinline__ float elem<int8_t>(const uint4& r, int j) {
  return static_cast<float>(ielem(r, j));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One count per lane into a shared histogram, the lanes of a warp that share
// a bin added by one atomic.  Every lane of the warp must call it.
__device__ __forceinline__ void count_bin(unsigned* h, bool ok, unsigned bin) {
  const unsigned peers = __match_any_sync(0xffffffffu, ok ? bin : 0xffffffffu);
  if (ok && static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&h[bin], __popc(peers));
}

// The score of query m from its accumulator and the document's scale sc.
template <bool I8DOT, typename Acc>
__device__ __forceinline__ float scaled_score(Acc a, const float* q_scale, int m, float sc) {
  if constexpr (I8DOT) {
    return __fmul_rn(__fmul_rn(__int2float_rn(a), q_scale[m]), sc);
  } else {
    return __fmul_rn(a, sc);
  }
}

// The score of one (query, document) pair from its accumulator.
template <bool I8DOT, typename Acc>
__device__ __forceinline__ float finish_score(Acc a, const float* q_scale, const int* ids,
                                              const float* dscale, int m, long long c) {
  const float sc = dscale ? dscale[c] : 1.0f;
  const float s = scaled_score<I8DOT>(a, q_scale, m, sc);
  return ids[c] < 0 ? -INFINITY : s;
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

// ------------------------------------------------ batched score: the GEMM
#ifndef REPRO_QUERY_TILE
#error "REPRO_QUERY_TILE is set by kernels/_build.py"
#endif
#ifndef REPRO_FEAT
#error "REPRO_FEAT is set by kernels/_build.py"
#endif
constexpr int GM = REPRO_QUERY_TILE;  // queries per tile
constexpr int GN = 256;               // documents per tile
constexpr int GK = REPRO_FEAT;        // features per ring stage
static_assert(GM == 64, "gemm_qrow spreads a tile's queries over 2 warps x 4 lanes x 8 rows");
static_assert(GK % 16 == 0, "a ring stage row is whole 16-byte chunks of int8");
constexpr int GLD = GK + 4;    // shared row stride in words: float4 reads of
                               // 8 consecutive rows hit 8 distinct bank quads
constexpr int GSTAGES = 2;     // 92 KB of ring: two blocks per SM
constexpr int GTHREADS = 128;  // 4 warps of 32 x 128 outputs, 8 x 16 a lane
constexpr int TJ = 16;         // documents per lane
constexpr int STAGE_WORDS = (GM + GN) * GLD;
constexpr size_t GRING_BYTES = static_cast<size_t>(GSTAGES) * STAGE_WORDS * 4;

// Moves a (ROWS, GK) slice of a row-major (rows, ld) payload into a ring
// stage of Acc words at row stride GLD, rows past the end as zeros.  An f32
// payload goes by cp.async in issue(); any other is loaded into registers in
// issue() and widened and stored in store(), so its loads overlap the
// multiply of the stage before.
template <typename T, typename Acc, int ROWS>
struct TileLoader {
  static constexpr bool kAsync = std::is_same<T, float>::value;
  static constexpr int E = 16 / static_cast<int>(sizeof(T));
  static constexpr int CPR = GK / E;
  static constexpr int CHUNKS = ROWS * CPR;
  static constexpr int PER = (CHUNKS + GTHREADS - 1) / GTHREADS;
  uint4 reg[PER];

  __device__ __forceinline__ void issue(const T* src, long long row0, long long rows, int ld,
                                        int k0, Acc* dst) {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int c = threadIdx.x + u * GTHREADS;
      if (c < CHUNKS) {
        const int r = c / CPR, kc = c % CPR;
        const bool ok = row0 + r < rows;
        const T* g = src + (ok ? (row0 + r) * static_cast<long long>(ld) + k0 + kc * E : 0);
        if constexpr (kAsync) {
          cp_async16(dst + r * GLD + kc * E, g, ok);
        } else {
          reg[u] = ok ? __ldg(reinterpret_cast<const uint4*>(g)) : make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
  }

  __device__ __forceinline__ void store(Acc* dst) {
    if constexpr (!kAsync) {
      using V4 = typename std::conditional<std::is_same<Acc, float>::value, float4, int4>::type;
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int c = threadIdx.x + u * GTHREADS;
        if (c < CHUNKS) {
          const int r = c / CPR, kc = c % CPR;
          V4* d = reinterpret_cast<V4*>(dst + r * GLD + kc * E);
#pragma unroll
          for (int j = 0; j < E; j += 4) {
            if constexpr (std::is_same<Acc, int>::value) {
              d[j / 4] = V4{ielem(reg[u], j), ielem(reg[u], j + 1), ielem(reg[u], j + 2),
                            ielem(reg[u], j + 3)};
            } else {
              d[j / 4] = V4{elem<T>(reg[u], j), elem<T>(reg[u], j + 1), elem<T>(reg[u], j + 2),
                            elem<T>(reg[u], j + 3)};
            }
          }
        }
      }
    }
  }
};

template <typename V4>
__device__ __forceinline__ auto lane_of(const V4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ float mac(float a, float d, float c) { return fmaf(a, d, c); }
__device__ __forceinline__ int mac(int a, int d, int c) { return c + a * d; }

// The lane's place in a 64 x 256 unit: warp (wr, wc) owns rows wr * 32 + lr
// + 4 i and documents wc * 128 + lc + 8 j (i < 8, j < 16) of the unit: the 8
// lanes of a row group read 8 consecutive document rows, the 4 row groups
// the same ones, so every float4 shared read of a warp is one broadcast
// wavefront.
__device__ __forceinline__ int gemm_qrow() {
  return ((threadIdx.x >> 5) & 1) * 32 + ((threadIdx.x & 31) >> 3);
}
__device__ __forceinline__ int gemm_dcol() {
  return (threadIdx.x >> 6) * 128 + (threadIdx.x & 7);
}

// The GEMM's main loop, shared by the score kernel and the tile kernel.  The
// block walks `mine` (64-query, 256-document) units, unit j at query row m0
// and document n0 as place(j, m0, n0) sets them, through the 2-stage ring in
// `smem`; epi(acc, m0, n0) runs after a unit's last K slice, while the
// ring's other stage may already be loading the next unit's first slice.
template <typename T, bool I8DOT, typename Place, typename Epi>
__device__ __forceinline__ void gemm_units(const void* __restrict__ q_raw,
                                           const T* __restrict__ docs, int b, long long n,
                                           int dp, long long mine, unsigned char* smem,
                                           Place place, Epi epi) {
  using Acc = typename std::conditional<I8DOT, int, float>::type;
  using Q = typename std::conditional<I8DOT, int8_t, float>::type;
  using V4 = typename std::conditional<I8DOT, int4, float4>::type;
  Acc* ring = reinterpret_cast<Acc*>(smem);
  const int qrow = gemm_qrow(), dcol = gemm_dcol();
  const int kt_n = dp / GK;
  const long long steps = mine * kt_n;
  TileLoader<Q, Acc, GM> ql;
  TileLoader<T, Acc, GN> dl;
  // a position in the block's sequence of (unit, K slice) steps; the unit's
  // origin is worked out once per unit, not per step
  struct Cursor {
    long long j;  // the block's unit ordinal
    int kt, slot, m0;
    long long n0;
  };
  auto advance = [&](Cursor& c) {
    if (++c.slot == GSTAGES) c.slot = 0;
    if (++c.kt == kt_n) {
      c.kt = 0;
      if (++c.j < mine) place(c.j, c.m0, c.n0);
    }
  };
  auto issue = [&](const Cursor& c) {
    Acc* s = ring + c.slot * STAGE_WORDS;
    ql.issue(static_cast<const Q*>(q_raw), c.m0, b, dp, c.kt * GK, s);
    dl.issue(docs, c.n0, n, dp, c.kt * GK, s + GM * GLD);
  };
  auto store = [&](int slot) {
    Acc* s = ring + slot * STAGE_WORDS;
    ql.store(s);
    dl.store(s + GM * GLD);
  };
  Cursor in{0, 0, 0, 0, 0}, out{0, 0, 0, 0, 0};
  place(0, in.m0, in.n0);
  place(0, out.m0, out.n0);

#pragma unroll
  for (int s = 0; s < GSTAGES - 1; ++s) {
    if (s < steps) {
      issue(in);
      store(in.slot);
      advance(in);
    }
    cp_async_commit();
  }
  Acc acc[8][TJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TJ; ++j) acc[i][j] = Acc(0);

  for (long long g = 0; g < steps; ++g) {
    cp_async_wait<GSTAGES - 2>();
    __syncthreads();  // stage g landed; every thread is done with stage g - 1
    const bool more = g + GSTAGES - 1 < steps;
    const int next_slot = in.slot;  // the slot of stage g - 1
    if (more) {
      issue(in);
      advance(in);
    }
    cp_async_commit();
    const Acc* qs = ring + out.slot * STAGE_WORDS;
    const Acc* ds = qs + GM * GLD;
#pragma unroll
    for (int kk = 0; kk < GK; kk += 4) {
      V4 d[TJ];
#pragma unroll
      for (int j = 0; j < TJ; ++j) d[j] = *reinterpret_cast<const V4*>(ds + (dcol + 8 * j) * GLD + kk);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const V4 a = *reinterpret_cast<const V4*>(qs + (qrow + 4 * i) * GLD + kk);
        // one k at a time over the 8 documents: 8 independent FMAs in a
        // row, each output still summed in k order
#pragma unroll
        for (int kq = 0; kq < 4; ++kq)
#pragma unroll
          for (int j = 0; j < TJ; ++j)
            acc[i][j] = mac(lane_of(a, kq), lane_of(d[j], kq), acc[i][j]);
      }
    }
    if (more) store(next_slot);
    if (out.kt == kt_n - 1) {  // epilogue of the unit
      epi(acc, out.m0, out.n0);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TJ; ++j) acc[i][j] = Acc(0);
    }
    advance(out);
  }
  cp_async_wait<0>();
}

template <typename T, bool I8DOT>
__global__ void __launch_bounds__(GTHREADS, 2)
    gemm_score_kernel(const void* __restrict__ q_raw, const float* __restrict__ q_scale,
                      const T* __restrict__ docs, const int* __restrict__ ids,
                      const float* __restrict__ dscale, float* __restrict__ scores, int b,
                      long long n, int dp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int qrow = gemm_qrow(), dcol = gemm_dcol();
  const long long dtiles = (n + GN - 1) / GN;
  const long long tiles = dtiles * ((b + GM - 1) / GM);
  // the block's units: blockIdx.x, + gridDim.x, ...
  const long long mine = (tiles - 1 - blockIdx.x) / gridDim.x + 1;
  gemm_units<T, I8DOT>(
      q_raw, docs, b, n, dp, mine, smem,
      [&](long long j, int& m0, long long& n0) {
        const long long t = blockIdx.x + j * gridDim.x;
        m0 = static_cast<int>(t / dtiles) * GM;
        n0 = (t % dtiles) * GN;
      },
      [&](auto& acc, int m0, long long n0) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int m = m0 + qrow + 4 * i;
#pragma unroll
          for (int j = 0; j < TJ; ++j) {
            const long long c = n0 + dcol + 8 * j;
            if (m < b && c < n)
              scores[static_cast<size_t>(m) * n + c] =
                  finish_score<I8DOT>(acc[i][j], q_scale, ids, dscale, m, c);
          }
        }
      });
}

template <typename T, bool I8DOT>
cudaError_t launch_gemm(const void* q, const void* q_scale, const void* docs, const void* ids,
                        const void* dscale, void* scores, int b, long long n, int dp,
                        cudaStream_t stream) {
  auto kern = gemm_score_kernel<T, I8DOT>;
  const size_t smem = GRING_BYTES;
  cudaError_t err = repro::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, GTHREADS, smem);
  if (err != cudaSuccess) return err;
  const long long tiles = ((n + GN - 1) / GN) * ((b + GM - 1) / GM);
  const long long slots = static_cast<long long>(sm_count()) * (occ > 0 ? occ : 1);
  const unsigned grid = static_cast<unsigned>(tiles < slots ? tiles : slots);
  kern<<<grid, GTHREADS, smem, stream>>>(
      q, static_cast<const float*>(q_scale), static_cast<const T*>(docs),
      static_cast<const int*>(ids), static_cast<const float*>(dscale),
      static_cast<float*>(scores), b, n, dp);
  return cudaGetLastError();
}

// ------------------------------------------- single-query score: the GEMV
#ifndef REPRO_SCORE_GEMV_MAX_B
#error "REPRO_SCORE_GEMV_MAX_B is set by kernels/_build.py"
#endif
constexpr int GEMV_MAX_B = REPRO_SCORE_GEMV_MAX_B;  // the widest query block of the GEMV path
static_assert(GEMV_MAX_B > 4 && GEMV_MAX_B <= 32,
              "launch_score's last block follows 4 queries; a lane keeps one query's sum");
constexpr int VTHREADS = 256;
constexpr int VUNROLL = 8;      // 16-byte loads in flight per lane

// The BQ query rows (rows past b as zeros) into shared memory, by a block of
// VTHREADS.
template <typename T, bool I8DOT, int BQ>
__global__ void __launch_bounds__(VTHREADS)
    gemv_score_kernel(const void* __restrict__ q_raw, const float* __restrict__ q_scale,
                      const T* __restrict__ docs, const int* __restrict__ ids,
                      const float* __restrict__ dscale, float* __restrict__ scores, int b,
                      long long n, int dp) {
  using Acc = typename std::conditional<I8DOT, int, float>::type;
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  const int qrow16 = dp * (I8DOT ? 1 : 4) / 16;  // 16-byte words per query row
  uint4* qs = reinterpret_cast<uint4*>(smem);
  const int tid = threadIdx.x, lane = tid & 31;
  const uint4* qg = static_cast<const uint4*>(q_raw);
  for (int i = tid; i < BQ * qrow16; i += VTHREADS)
    qs[i] = i / qrow16 < b ? qg[i] : make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  const int nchunk = dp / E;
  const long long warps = static_cast<long long>(gridDim.x) * (VTHREADS / 32);
  for (long long d = static_cast<long long>(blockIdx.x) * (VTHREADS / 32) + (tid >> 5); d < n;
       d += warps) {
    const uint4* row = reinterpret_cast<const uint4*>(docs + d * dp);
    Acc acc[BQ];
#pragma unroll
    for (int q = 0; q < BQ; ++q) acc[q] = Acc(0);
    for (int base = 0; base < nchunk; base += 32 * VUNROLL) {
      uint4 v[VUNROLL];
#pragma unroll
      for (int u = 0; u < VUNROLL; ++u) {
        const int c = base + lane + 32 * u;
        v[u] = c < nchunk ? __ldg(row + c) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < VUNROLL; ++u) {
        const int c = base + lane + 32 * u;
        if (c >= nchunk) continue;
#pragma unroll
        for (int q = 0; q < BQ; ++q) {
          if constexpr (I8DOT) {
            const int4 a = reinterpret_cast<const int4*>(smem)[q * qrow16 + c];
            acc[q] = __dp4a(static_cast<int>(v[u].x), a.x, acc[q]);
            acc[q] = __dp4a(static_cast<int>(v[u].y), a.y, acc[q]);
            acc[q] = __dp4a(static_cast<int>(v[u].z), a.z, acc[q]);
            acc[q] = __dp4a(static_cast<int>(v[u].w), a.w, acc[q]);
          } else {
            const float4* a = reinterpret_cast<const float4*>(smem) + (q * dp + c * E) / 4;
#pragma unroll
            for (int j = 0; j < E; j += 4) {
              const float4 x = a[j / 4];
              acc[q] = fmaf(elem<T>(v[u], j), x.x, acc[q]);
              acc[q] = fmaf(elem<T>(v[u], j + 1), x.y, acc[q]);
              acc[q] = fmaf(elem<T>(v[u], j + 2), x.z, acc[q]);
              acc[q] = fmaf(elem<T>(v[u], j + 3), x.w, acc[q]);
            }
          }
        }
      }
    }
    Acc mine = Acc(0);
#pragma unroll
    for (int q = 0; q < BQ; ++q) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], o);
      if (lane == q) mine = acc[q];
    }
    if (lane < b && lane < BQ)
      scores[static_cast<size_t>(lane) * n + d] =
          finish_score<I8DOT>(mine, q_scale, ids, dscale, lane, d);
  }
}

template <typename T, bool I8DOT, int BQ>
cudaError_t launch_gemv(const void* q, const void* q_scale, const void* docs, const void* ids,
                        const void* dscale, void* scores, int b, long long n, int dp,
                        cudaStream_t stream) {
  auto kern = gemv_score_kernel<T, I8DOT, BQ>;
  const size_t smem = static_cast<size_t>(BQ) * dp * (I8DOT ? 1 : 4);
  cudaError_t err = repro::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, VTHREADS, smem);
  if (err != cudaSuccess) return err;
  const long long need = (n + VTHREADS / 32 - 1) / (VTHREADS / 32);
  const long long slots = static_cast<long long>(sm_count()) * (occ > 0 ? occ : 1);
  const unsigned grid = static_cast<unsigned>(need < slots ? need : slots);
  kern<<<grid, VTHREADS, smem, stream>>>(
      q, static_cast<const float*>(q_scale), static_cast<const T*>(docs),
      static_cast<const int*>(ids), static_cast<const float*>(dscale),
      static_cast<float*>(scores), b, n, dp);
  return cudaGetLastError();
}

template <typename T, bool I8DOT>
cudaError_t launch_score(const void* q, const void* q_scale, const void* docs, const void* ids,
                         const void* dscale, void* scores, int b, long long n, int dp, int gemv,
                         cudaStream_t st) {
  if (!gemv) return launch_gemm<T, I8DOT>(q, q_scale, docs, ids, dscale, scores, b, n, dp, st);
  if (b <= 1) return launch_gemv<T, I8DOT, 1>(q, q_scale, docs, ids, dscale, scores, b, n, dp, st);
  if (b <= 2) return launch_gemv<T, I8DOT, 2>(q, q_scale, docs, ids, dscale, scores, b, n, dp, st);
  if (b <= 4) return launch_gemv<T, I8DOT, 4>(q, q_scale, docs, ids, dscale, scores, b, n, dp, st);
  return launch_gemv<T, I8DOT, GEMV_MAX_B>(q, q_scale, docs, ids, dscale, scores, b, n, dp, st);
}

// --------------------------------------------------- the all-SM radix select
constexpr int STHREADS = 512;
constexpr int SUNROLL = 8;   // loads in flight per thread in a filter pass
constexpr int H12 = 4096;    // bins of the second and third digits
// workspace row (uint32): histograms of digits 2 and 3, the counters
// (candidates, buffer 0, buffer 1), each pass's state (prefix, k-th rank
// left, keys in the chosen bin) and the histogram of digit 1; zeroed by
// knn_select
constexpr int WS_HIST1 = 0, WS_HIST2 = H12, WS_CNT = 2 * H12, WS_STATE = 2 * H12 + 4;
constexpr int WS_HIST0 = 2 * H12 + 16;
constexpr int WS_ROW = WS_HIST0 + H0;
#ifndef REPRO_SELECT_WS
#error "REPRO_SELECT_WS is set by kernels/_build.py"
#endif
static_assert(WS_ROW == REPRO_SELECT_WS, "the wrapper sizes a workspace row as SELECT_WS");

// The bin holding the kr-th largest key of histogram h (nb bins): *bin, and
// *above the keys in the bins over it.  Every thread of the block.
__device__ void find_bin(const unsigned* h, int nb, int kr, int* warp_tot, int* bin, int* above) {
  const int per = (nb + blockDim.x - 1) / blockDim.x;
  const int top = nb - 1 - static_cast<int>(threadIdx.x) * per;  // descending group
  int sum = 0;
  for (int j = 0; j < per; ++j)
    if (top - j >= 0) sum += static_cast<int>(h[top - j]);
  int total;
  const int before = repro::block_exclusive_scan(sum, warp_tot, &total);
  if (before < kr && kr <= before + sum) {
    int cum = before;
    for (int j = 0; j < per && top - j >= 0; ++j) {
      const int c = static_cast<int>(h[top - j]);
      if (cum + c >= kr) {
        *bin = top - j;
        *above = cum;
        break;
      }
      cum += c;
    }
  }
  __syncthreads();
}

// Append (key, pos) for the lanes that want it, one atomic per warp.  Every
// lane of the warp must call it.
__device__ __forceinline__ void warp_append(bool want, uint32_t key, int pos, uint32_t* ok,
                                            int* op, unsigned* ctr) {
  const unsigned m = __ballot_sync(0xffffffffu, want);
  if (!m) return;
  const int lane = threadIdx.x & 31, leader = __ffs(m) - 1;
  unsigned base = 0u;
  if (lane == leader) base = atomicAdd(ctr, static_cast<unsigned>(__popc(m)));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (want) {
    const unsigned slot = base + __popc(m & ((1u << lane) - 1u));
    ok[slot] = key;
    op[slot] = pos;
  }
}

// The first digit's histogram of each row.  Grid (chunks, rows).  Each lane
// counts into a column of its own (bank = lane), so the few bins that hold
// most scores cost no conflicts.
__global__ void __launch_bounds__(STHREADS)
    hist_kernel(const float* __restrict__ scores, unsigned* __restrict__ ws, long long n) {
  __shared__ unsigned h[H0 * 32];
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < H0 * 32; i += STHREADS) h[i] = 0u;
  __syncthreads();
  const float* row = scores + static_cast<size_t>(blockIdx.y) * n;
  const long long per = (n + gridDim.x - 1) / gridDim.x;
  const long long lo = blockIdx.x * per, hi = lo + per < n ? lo + per : n;
  for (long long base = lo; base < hi; base += static_cast<long long>(STHREADS) * SUNROLL) {
    float v[SUNROLL];
#pragma unroll
    for (int u = 0; u < SUNROLL; ++u) {
      const long long i = base + threadIdx.x + static_cast<long long>(u) * STHREADS;
      v[u] = i < hi ? row[i] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < SUNROLL; ++u)
      atomicAdd(&h[(float_key(v[u]) >> 24) * 32 + lane],
                base + threadIdx.x + static_cast<long long>(u) * STHREADS < hi ? 1u : 0u);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < H0; i += STHREADS) {
    unsigned c = 0u;
    for (int l = 0; l < 32; ++l) c += h[i * 32 + (l + i) % 32];
    if (c) atomicAdd(&ws[static_cast<size_t>(blockIdx.y) * WS_ROW + WS_HIST0 + i], c);
  }
}

// One radix pass over a row's keys, grid (chunks, rows).  Pass 0 reads the
// scores; passes 1 and 2 read the previous pass's buffer, or the scores again
// (keys matching the prefix) when that bin outgrew the buffer.
template <int PASS>
__global__ void __launch_bounds__(STHREADS)
    filter_kernel(const float* __restrict__ scores, unsigned* __restrict__ ws,
                  uint32_t* __restrict__ cand_key, int* __restrict__ cand_pos,
                  uint32_t* __restrict__ buf_key, int* __restrict__ buf_pos, long long n, int k,
                  int cap, long long bufcap) {
  constexpr int SHIFT = PASS == 0 ? 24 : PASS == 1 ? 12 : 0;
  constexpr int NB = PASS == 0 ? H0 : H12;
  constexpr unsigned FIXED = PASS == 0 ? 0u : PASS == 1 ? 0xff000000u : 0xfffff000u;
  __shared__ unsigned nhist[PASS < 2 ? H12 : 1];
  __shared__ int warp_tot[33];
  __shared__ int sh_bin, sh_above;
  const int tid = threadIdx.x;
  const size_t row = blockIdx.y, rows = gridDim.y;
  unsigned* w = ws + row * WS_ROW;
  const unsigned* h = w + (PASS == 0 ? WS_HIST0 : PASS == 1 ? WS_HIST1 : WS_HIST2);
  unsigned prefix = 0u;
  int kr = k;
  long long in_count = n;
  if (PASS > 0) {
    prefix = w[WS_STATE + 3 * (PASS - 1)];
    kr = static_cast<int>(w[WS_STATE + 3 * (PASS - 1) + 1]);
    in_count = w[WS_STATE + 3 * (PASS - 1) + 2];
  }
  const bool from_buf = PASS > 0 && in_count <= bufcap;
  if (PASS < 2)
    for (int i = tid; i < H12; i += STHREADS) nhist[i] = 0u;
  find_bin(h, NB, kr, warp_tot, &sh_bin, &sh_above);
  const unsigned bin = static_cast<unsigned>(sh_bin);
  const int kr_next = kr - sh_above;
  const unsigned in_bin = h[bin];
  if (blockIdx.x == 0 && tid == 0) {
    w[WS_STATE + 3 * PASS] = prefix | (bin << SHIFT);
    w[WS_STATE + 3 * PASS + 1] = static_cast<unsigned>(kr_next);
    w[WS_STATE + 3 * PASS + 2] = in_bin;
  }
  // keys at the k-th digit: into the buffer (passes 0, 1) or, at the last
  // digit, among the candidates — each only when all of them fit
  const bool keep_eq = PASS < 2 ? in_bin <= bufcap
                                : static_cast<long long>(k - kr_next) + in_bin <= cap;
  uint32_t* ck = cand_key + row * cap;
  int* cpos = cand_pos + row * cap;
  const size_t bout = ((PASS & 1) * rows + row) * bufcap;
  const size_t bin_off = (((PASS - 1) & 1) * rows + row) * bufcap;
  const float* srow = scores + row * n;
  const long long total = from_buf ? in_count : n;
  const long long per = (total + gridDim.x - 1) / gridDim.x;
  const long long lo = blockIdx.x * per, hi = lo + per < total ? lo + per : total;
  for (long long base = lo; base < hi; base += static_cast<long long>(STHREADS) * SUNROLL) {
    uint32_t key[SUNROLL];
    int pos[SUNROLL];
#pragma unroll
    for (int u = 0; u < SUNROLL; ++u) {
      const long long i = base + tid + static_cast<long long>(u) * STHREADS;
      key[u] = 0u;
      pos[u] = 0;
      if (i < hi) {
        if (from_buf) {
          key[u] = buf_key[bin_off + i];
          pos[u] = buf_pos[bin_off + i];
        } else {
          key[u] = float_key(srow[i]);
          pos[u] = static_cast<int>(i);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < SUNROLL; ++u) {
      const long long i = base + tid + static_cast<long long>(u) * STHREADS;
      const bool match = i < hi && (key[u] & FIXED) == prefix;
      const unsigned dig = (key[u] >> SHIFT) & (NB - 1);
      const bool eq = match && dig == bin;
      warp_append((match && dig > bin) || (PASS == 2 && eq && keep_eq), key[u], pos[u], ck, cpos,
                  &w[WS_CNT]);
      if constexpr (PASS < 2) {
        warp_append(eq && keep_eq, key[u], pos[u], buf_key + bout, buf_pos + bout,
                    &w[WS_CNT + 1 + PASS]);
        if (__any_sync(0xffffffffu, eq))
          count_bin(nhist, eq, (key[u] >> (SHIFT - 12)) & (H12 - 1));
      }
    }
  }
  if constexpr (PASS < 2) {
    __syncthreads();
    unsigned* hn = w + (PASS == 0 ? WS_HIST1 : WS_HIST2);
    for (int i = tid; i < H12; i += STHREADS)
      if (nhist[i]) atomicAdd(&hn[i], nhist[i]);
  }
}

// One block per row: the candidates sorted by (key desc, position asc), the
// first k written out.  When the tie run at the k-th key did not fit among
// the candidates, its lowest positions are first compacted from the row in
// position order.
__global__ void __launch_bounds__(1024)
    finish_kernel(const float* __restrict__ scores, const int* __restrict__ ids,
                  const unsigned* __restrict__ ws, uint32_t* cand_key, int* cand_pos,
                  float* __restrict__ out_vals, int* __restrict__ out_ids, long long n, int k,
                  int cap, int sort_global) {
  extern __shared__ uint32_t pairs[];
  __shared__ repro::SelectShared sh;
  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;
  const unsigned* w = ws + row * WS_ROW;
  const uint32_t thr = w[WS_STATE + 6];
  const int need_eq = static_cast<int>(w[WS_STATE + 7]);
  const long long in_bin = w[WS_STATE + 8];
  const int n_gt = k - need_eq;
  const float* srow = scores + row * n;
  uint32_t* ck = cand_key + row * cap;
  int* cpos = cand_pos + row * cap;
  const bool all = n_gt + in_bin <= cap;
  const int c = all ? static_cast<int>(n_gt + in_bin) : k;
  if (!all) {
    if (tid == 0) sh.neq = 0;
    __syncthreads();
    for (long long base = 0; base < n; base += 4LL * blockDim.x) {
      int eqc = 0;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long i = base + 4LL * tid + u;
        eqc += (i < n && float_key(srow[i]) == thr) ? 1 : 0;
      }
      if (__syncthreads_or(eqc > 0)) {
        const int before_n = sh.neq;
        if (before_n >= need_eq) break;
        int tot;
        int r = before_n + repro::block_exclusive_scan(eqc, sh.warp_tot, &tot);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const long long i = base + 4LL * tid + u;
          if (i < n && float_key(srow[i]) == thr) {
            if (r < need_eq) {
              ck[n_gt + r] = thr;
              cpos[n_gt + r] = static_cast<int>(i);
            }
            ++r;
          }
        }
        if (tid == 0) sh.neq = before_n + tot;
      }
    }
    __syncthreads();
  }
  int p2 = 1;
  while (p2 < c) p2 <<= 1;
  uint32_t* sk = sort_global ? ck : pairs;
  int* sp = sort_global ? cpos : reinterpret_cast<int*>(pairs + cap);
  for (int r = tid; r < p2; r += blockDim.x) {
    if (r < c) {
      if (!sort_global) {
        sk[r] = ck[r];
        sp[r] = cpos[r];
      }
    } else {
      sk[r] = 0u;
      sp[r] = INT_MAX;
    }
  }
  __syncthreads();
  repro::sort_pairs(sk, sp, p2);
  for (int r = tid; r < k; r += blockDim.x) {
    const int p = sp[r];
    const float v = srow[p];
    out_vals[row * k + r] = v;
    out_ids[row * k + r] = (v == -INFINITY) ? -1 : ids[p];
  }
}

// ----------------------------------------- the fused tile stage: score and select
// knn_tile_topk: the stable top k_eff of every tile_n tile of the masked
// scores, written as (B, tiles, k_eff) values and corpus positions; no (B,
// N) score leaves the chip.
// The widest tile the fused kernel takes.
#ifndef REPRO_FUSED_MAX_TILE
#error "REPRO_FUSED_MAX_TILE is set by kernels/_build.py"
#endif
constexpr int FUSED_MAX_TILE = REPRO_FUSED_MAX_TILE;
static_assert(FUSED_MAX_TILE <= 16 * GN, "a cluster holds at most 16 blocks (non-portable size)");
constexpr int KLD = GN + 8;  // key row stride in words: the epilogue's stores of 4 rows x 8
                             // consecutive columns hit 32 distinct banks
constexpr size_t TILE_EPI_BYTES =
    static_cast<size_t>(GM) * KLD * 4 + GM * GN + (GTHREADS / 32) * GN * 4;
static_assert(TILE_EPI_BYTES <= GRING_BYTES, "the tile epilogue must fit the dead ring");

// A warp's 256 (key, slot) pairs, lane l holding elements 8l .. 8l+7, sorted
// into runs of 2^lseg (<= 256) elements, each run in the stable top-k order
// (key descending, slot ascending; slots are distinct).  A bitonic network:
// strides under 8 compare within a lane's registers, wider ones swap
// through shuffles; runs that are not the last level alternate direction.
__device__ __forceinline__ void warp_sort256(uint32_t (&k)[8], int (&p)[8], int lseg) {
  const int lane = threadIdx.x & 31;
  const int seg = 1 << lseg;
#pragma unroll
  for (int size = 2; size <= GN; size <<= 1) {
    if (size > seg) break;
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 8) {
        const int ls = stride >> 3;
        const bool lower = (lane & ls) == 0;
        const bool desc = size == seg || ((8 * lane) & size) == 0;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const uint32_t ok = __shfl_xor_sync(0xffffffffu, k[e], ls);
          const int op = __shfl_xor_sync(0xffffffffu, p[e], ls);
          const bool other_first = repro::key_before(ok, op, k[e], p[e]);
          if (other_first == (lower == desc)) {
            k[e] = ok;
            p[e] = op;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (e & stride) continue;
          const int f = e | stride;
          const bool desc = size == seg || ((8 * lane + e) & size) == 0;
          if (repro::key_before(k[f], p[f], k[e], p[e]) == desc) {
            const uint32_t tk = k[e];
            k[e] = k[f];
            k[f] = tk;
            const int tp = p[e];
            p[e] = p[f];
            p[f] = tp;
          }
        }
      }
    }
  }
}

// How many keys of a descending run of GN come before `key`: those above
// it, and those equal to it too when `ge` (the run holds lower positions).
__device__ __forceinline__ int count_before(const uint32_t* run, uint32_t key, bool ge) {
  int pos = 0;
#pragma unroll
  for (int step = GN / 2; step > 0; step >>= 1) {
    const uint32_t x = run[pos + step - 1];
    if (x > key || (ge && x == key)) pos += step;
  }
  const uint32_t x = run[GN - 1];
  if (pos == GN - 1 && (x > key || (ge && x == key))) pos = GN;
  return pos;
}

// The GEMM's main loop (gemm_units), one 64-query x 256-document unit
// a block, then a new epilogue in the dead ring.  Bound: the f32 operations,
// 2 B N Dp at 67 TFLOP/s, as knn_score; what the select adds is issue slots
// beside the FFMA of the SM's other block.  The unit's masked keys go to
// shared memory; a warp sorts each query row's 256 (key, slot) pairs in
// registers (warp_sort256), so no row takes a block-wide barrier.
//   * tile_n <= 256: the block holds 256 / seg whole tiles (seg the power of
//     two >= tile_n), each tile's columns at its own run of seg slots; the
//     slots past tile_n read key 0, below every score's key, and sort last.
//     Each run is a tile's answer.
//   * tile_n > 256: a tile spans a cluster of ceil(tile_n / 256) blocks along
//     the documents (2 at the fp32 tile of 512, 16 at 4096).  Each block
//     sorts its own run per row; after cluster.sync() an element's rank in
//     the tile is its rank in its own run plus, for every other block's run
//     (copied through distributed shared memory to the warp), the keys
//     before it (binary search): equal keys of a lower block come first, as
//     their positions are lower.  Ranks under k_eff are written out.
// Rows past b are neither sorted nor written; positions past n read -inf.
template <typename T, bool I8DOT>
__global__ void __launch_bounds__(GTHREADS, 2)
    gemm_tile_kernel(const void* __restrict__ q_raw, const float* __restrict__ q_scale,
                     const T* __restrict__ docs, const int* __restrict__ ids,
                     const float* __restrict__ dscale, float* __restrict__ out_vals,
                     int* __restrict__ out_pos, int b, long long n, int dp, int tile_n,
                     int lseg, int clus, int k_eff, long long tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int seg = 1 << lseg;
  const int per_blk = clus > 1 ? 1 : GN / seg;  // whole tiles a block holds
  const int rank = clus > 1 ? static_cast<int>(blockIdx.x % clus) : 0;
  const long long tile0 =
      clus > 1 ? blockIdx.x / clus : static_cast<long long>(blockIdx.x) * per_blk;
  const long long n0 = tile0 * tile_n + static_cast<long long>(rank) * GN;
  const int m0 = blockIdx.y * GM;
  // the unit's columns that belong to a tile (the rest were computed and
  // are dropped)
  const int vcols = clus > 1 ? min(GN, tile_n - rank * GN) : per_blk * tile_n;
  gemm_units<T, I8DOT>(
      q_raw, docs, b, n, dp, 1, smem,
      [&](long long, int& m, long long& c) {
        m = m0;
        c = n0;
      },
      [&](auto& acc, int, long long) {
        cp_async_wait<0>();
        __syncthreads();  // every warp is done with the ring
        uint32_t* K = reinterpret_cast<uint32_t*>(smem);       // (GM, KLD) keys
        uint8_t* P = smem + static_cast<size_t>(GM) * KLD * 4;  // (GM, GN) slots
        uint32_t* W = reinterpret_cast<uint32_t*>(P + GM * GN);  // a run per warp
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
        const int qrow = gemm_qrow(), dcol = gemm_dcol();
#pragma unroll
        for (int j = 0; j < TJ; ++j) {
          const int cc = dcol + 8 * j;
          if (cc >= vcols) continue;
          int slot = cc;
          if (clus == 1) {
            const int t = cc / tile_n;
            slot = t * seg + (cc - t * tile_n);
          }
          // the column's id and scale read once for its 8 rows
          const long long g = n0 + cc;
          const bool live = g < n && ids[g] >= 0;
          const float sc = live && dscale ? dscale[g] : 1.0f;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int m = qrow + 4 * i;
            float s = -INFINITY;
            if (live && m0 + m < b) s = scaled_score<I8DOT>(acc[i][j], q_scale, m0 + m, sc);
            K[m * KLD + slot] = float_key(s);
          }
        }
        __syncthreads();
        for (int r = warp; r < GM && m0 + r < b; r += GTHREADS / 32) {
          uint32_t k[8];
          int p[8];
          const uint4* src = reinterpret_cast<const uint4*>(K + r * KLD + 8 * lane);
          const uint4 x0 = src[0], x1 = src[1];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            k[e] = word(x0, e);
            k[e + 4] = word(x1, e);
          }
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            p[e] = 8 * lane + e;
            const bool real = clus > 1 ? p[e] < vcols : (p[e] & (seg - 1)) < tile_n;
            if (!real) k[e] = 0u;
          }
          warp_sort256(k, p, lseg);
          uint4* dst = reinterpret_cast<uint4*>(K + r * KLD + 8 * lane);
          dst[0] = make_uint4(k[0], k[1], k[2], k[3]);
          dst[1] = make_uint4(k[4], k[5], k[6], k[7]);
          uint2 ps;
          ps.x = static_cast<unsigned>(p[0] | (p[1] << 8) | (p[2] << 16) | (p[3] << 24));
          ps.y = static_cast<unsigned>(p[4] | (p[5] << 8) | (p[6] << 16) | (p[7] << 24));
          reinterpret_cast<uint2*>(P + r * GN)[lane] = ps;
          __syncwarp();
          if (clus > 1) continue;
          // one block holds whole tiles: each run is a tile's answer
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int i = lane + 32 * e;
            const int t = i >> lseg, rk = i & (seg - 1);
            const long long tile = tile0 + t;
            if (rk < k_eff && tile < tiles) {
              const size_t o = (static_cast<size_t>(m0 + r) * tiles + tile) * k_eff + rk;
              out_vals[o] = key_float(K[r * KLD + i]);
              out_pos[o] = static_cast<int>(tile * tile_n + (P[r * GN + i] - t * seg));
            }
          }
        }
        if (clus == 1) return;
        cg::cluster_group cluster = cg::this_cluster();
        cluster.sync();  // every block's runs are sorted
        // the warp's jobs: (row, other block) in order, each copying that
        // block's run of the row to the warp's buffer while the next job's
        // run is already loading from distributed shared memory
        uint32_t* w = W + warp * GN;
        const int others = clus - 1;
        const int live_rows = min(GM, b - m0);
        const int jobs = (live_rows > warp ? (live_rows - warp + 3) / 4 : 0) * others;
        uint4 a0 = make_uint4(0u, 0u, 0u, 0u), a1 = a0;
        auto fetch = [&](int job) {
          const int r = warp + 4 * (job / others), t = job % others;
          const uint4* rk = reinterpret_cast<const uint4*>(
              cluster.map_shared_rank(K, static_cast<unsigned>(t + (t >= rank))) + r * KLD);
          a0 = rk[2 * lane];
          a1 = rk[2 * lane + 1];
        };
        if (jobs > 0) fetch(0);
        uint32_t mk[8];
        int cnt[8];
        for (int job = 0; job < jobs; ++job) {
          const int r = warp + 4 * (job / others), t = job % others;
          if (t == 0) {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              mk[e] = K[r * KLD + lane + 32 * e];
              cnt[e] = 0;
            }
          }
          __syncwarp();
          reinterpret_cast<uint4*>(w)[2 * lane] = a0;
          reinterpret_cast<uint4*>(w)[2 * lane + 1] = a1;
          __syncwarp();
          if (job + 1 < jobs) fetch(job + 1);
          const bool lower = t < rank;  // the other block holds lower positions
#pragma unroll
          for (int e = 0; e < 8; ++e) cnt[e] += count_before(w, mk[e], lower);
          if (t < others - 1) continue;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int i = lane + 32 * e, f = i + cnt[e];
            if (f < k_eff && mk[e] != 0u) {
              const size_t o = (static_cast<size_t>(m0 + r) * tiles + tile0) * k_eff + f;
              out_vals[o] = key_float(mk[e]);
              out_pos[o] = static_cast<int>(n0 + P[r * GN + i]);
            }
          }
        }
        cluster.sync();  // no block leaves while another reads its runs
      });
}

template <typename T, bool I8DOT>
cudaError_t launch_tile(const void* q, const void* q_scale, const void* docs, const void* ids,
                        const void* dscale, void* vals, void* pos, int b, long long n, int dp,
                        int tile_n, int k_eff, cudaStream_t st) {
  const long long tiles = (n + tile_n - 1) / tile_n;
  auto kern = gemm_tile_kernel<T, I8DOT>;
  const size_t smem = GRING_BYTES;
  cudaError_t err = repro::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  int lseg = 0;
  while ((1 << lseg) < tile_n && lseg < 8) ++lseg;
  const int clus = tile_n > GN ? (tile_n + GN - 1) / GN : 1;
  const unsigned qtiles = static_cast<unsigned>((b + GM - 1) / GM);
  const float* qs = static_cast<const float*>(q_scale);
  const T* d = static_cast<const T*>(docs);
  const int* id = static_cast<const int*>(ids);
  const float* ds = static_cast<const float*>(dscale);
  float* v = static_cast<float*>(vals);
  int* p = static_cast<int*>(pos);
  if (clus == 1) {
    const long long per_blk = GN >> lseg;
    const dim3 grid(static_cast<unsigned>((tiles + per_blk - 1) / per_blk), qtiles);
    kern<<<grid, GTHREADS, smem, st>>>(q, qs, d, id, ds, v, p, b, n, dp, tile_n, lseg, 1, k_eff,
                                       tiles);
    return cudaGetLastError();
  }
  if (clus > 8) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles * clus), qtiles);
  cfg.blockDim = dim3(GTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(clus);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, q, qs, d, id, ds, v, p, b, n, dp, tile_n, lseg, clus,
                           k_eff, tiles);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// gemv != 0 takes the single-query path (b <= GEMV_MAX_B).
extern "C" int knn_score(const void* q, const void* q_scale, const void* docs,
                         const void* ids, const void* dscale, void* scores, int b, long long n,
                         int dp, int store, int int8_dot, int gemv, void* stream) {
  if (b == 0 || n == 0) return 0;
  if (dp % GK != 0 || (gemv && b > GEMV_MAX_B)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int8_dot) {
    if (store != repro::kI8) return static_cast<int>(cudaErrorInvalidValue);
    return launch_score<int8_t, true>(q, q_scale, docs, ids, dscale, scores, b, n, dp, gemv, st);
  }
  switch (store) {
    case repro::kF32:
      return launch_score<float, false>(q, q_scale, docs, ids, dscale, scores, b, n, dp, gemv,
                                        st);
    case repro::kBF16:
      return launch_score<__nv_bfloat16, false>(q, q_scale, docs, ids, dscale, scores, b, n, dp,
                                                gemv, st);
    case repro::kI8:
      return launch_score<int8_t, false>(q, q_scale, docs, ids, dscale, scores, b, n, dp, gemv,
                                         st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The fused tile stage: (b, tiles, k_eff) values and positions of the stable
// top k_eff of every tile_n tile (tile_n <= FUSED_MAX_TILE).
extern "C" int knn_tile_topk(const void* q, const void* q_scale, const void* docs,
                             const void* ids, const void* dscale, void* out_vals, void* out_pos,
                             int b, long long n, int dp, int store, int int8_dot, int tile_n,
                             int k_eff, void* stream) {
  if (b == 0 || n == 0) return 0;
  if (dp % GK != 0 || b > repro::kMaxRows || tile_n < 1 ||
      tile_n > FUSED_MAX_TILE || k_eff < 1 || k_eff > tile_n ||
      n + tile_n >= static_cast<long long>(INT_MAX))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int8_dot) {
    if (store != repro::kI8) return static_cast<int>(cudaErrorInvalidValue);
    return launch_tile<int8_t, true>(q, q_scale, docs, ids, dscale, out_vals, out_pos, b, n, dp,
                                     tile_n, k_eff, st);
  }
  switch (store) {
    case repro::kF32:
      return launch_tile<float, false>(q, q_scale, docs, ids, dscale, out_vals, out_pos, b, n,
                                       dp, tile_n, k_eff, st);
    case repro::kBF16:
      return launch_tile<__nv_bfloat16, false>(q, q_scale, docs, ids, dscale, out_vals, out_pos,
                                               b, n, dp, tile_n, k_eff, st);
    case repro::kI8:
      return launch_tile<int8_t, false>(q, q_scale, docs, ids, dscale, out_vals, out_pos, b, n,
                                        dp, tile_n, k_eff, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Stable top-k of (b, n) scores.  scratch (uint32): the workspace (b,
// WS_ROW), zeroed here, then the candidates (2, b, cap: keys, positions),
// cap a power of two >= 2k, and the filter buffers (4, b, bufcap: keys of
// buffers 0 and 1, then their positions).  Issues 5 device kernels after
// one memset.
extern "C" int knn_select(const void* scores, const void* ids, void* scratch,
                          void* out_vals, void* out_ids, int b, long long n, int k, int cap,
                          long long bufcap, int sort_global, void* stream) {
  if (b == 0) return 0;
  if (k < 1 || k > n || n >= INT_MAX || cap < 2 * static_cast<long long>(k) ||
      (cap & (cap - 1)) || b > repro::kMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scores);
  const size_t rows = static_cast<size_t>(b);
  unsigned* w = static_cast<unsigned*>(scratch);
  uint32_t* ck = w + rows * WS_ROW;
  int* cp = reinterpret_cast<int*>(ck + rows * cap);
  uint32_t* bk = reinterpret_cast<uint32_t*>(cp + rows * cap);
  int* bp = reinterpret_cast<int*>(bk + 2 * rows * bufcap);
  cudaError_t err = cudaMemsetAsync(w, 0, rows * WS_ROW * 4, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one wave of blocks over all rows: chunks per row from the residency
  int occ_h = 0, occ_f = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ_h, hist_kernel, STHREADS, 0);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ_f, filter_kernel<0>, STHREADS, 0);
  const int occ = occ_h < occ_f ? occ_h : occ_f;
  long long chunks = static_cast<long long>(sm_count()) * (occ > 0 ? occ : 1) / b;
  const long long most = (n + 2047) / 2048;
  if (chunks > most) chunks = most;
  if (chunks < 1) chunks = 1;
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(b));
  hist_kernel<<<grid, STHREADS, 0, st>>>(s, w, n);
  filter_kernel<0><<<grid, STHREADS, 0, st>>>(s, w, ck, cp, bk, bp, n, k, cap, bufcap);
  filter_kernel<1><<<grid, STHREADS, 0, st>>>(s, w, ck, cp, bk, bp, n, k, cap, bufcap);
  filter_kernel<2><<<grid, STHREADS, 0, st>>>(s, w, ck, cp, bk, bp, n, k, cap, bufcap);
  const size_t smem = sort_global ? 0 : static_cast<size_t>(cap) * 8;
  err = repro::allow_smem(finish_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  finish_kernel<<<b, 1024, smem, st>>>(s, static_cast<const int*>(ids), w, ck, cp,
                                       static_cast<float*>(out_vals), static_cast<int*>(out_ids),
                                       n, k, cap, sort_global);
  return cudaGetLastError();
}
