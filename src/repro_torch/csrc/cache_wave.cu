// Fused per-wave cache op over the stacked session caches: insert scatter,
// then the post-insert top-k query, one counted launch for the whole wave.
//
// Replaces: src/repro/kernels/cache_wave/ops.py:143 _launch with the body
// src/repro/kernels/cache_wave/cache_wave.py:56 make_wave_kernel, in its
// three modes (template flags INS and QRY):
//   wave_insert_query   (ops.py:255)  INS + QRY — the last launch of a
//                                      miss wave;
//   wave_query_topk     (ops.py:163)  QRY       — a wave with no misses;
//   wave_insert_scatter (ops.py:234)  INS       — insert without a query.
//
// The state is updated IN PLACE.  The payload doc_emb may be the whole
// stacked (S_total, Cp, Dp) state: wave row s reads and writes payload row
// rows[s] (row s when rows is null), so a wave copies no payload.  Every
// other leaf, input and output is indexed by the wave row.
//
// Bound: bytes.  The query scans S * Cp * Dp * itemsize of payload; the
// insert moves each kept row twice (read, write); the dot is 2 operations
// per payload element, far below the card's rate.  So the design is about
// keeping the whole card streaming: the TPU kernel's sequential grid of
// one step per session became, in PR 11, one block per session, which at
// S = 1 streams the whole cache through a single SM.  Here the grid is
// (chunks, S): block (c, s) owns the slots [c * chunk, (c + 1) * chunk) of
// row s, and the wrapper sizes the chunk so that S * chunks fills about two
// blocks per SM in one wave (S = 1, Cp = 12288: 256 blocks of 48 slots).
//
// Per block:
//   1. insert (INS): every thread reads one of the row's k_c positions at a
//      time, and the positions that land in the block's own slots are
//      listed in shared memory; one warp per listed row copies it in
//      16-byte vectors (then id, scale and LRU stamp = step).  A position
//      >= Cp is the drop sentinel and lands nowhere.  Chunk 0 writes the
//      (psi, r_a, scale) record at ring slot qslot when rec is set.  No
//      block reads a slot that another block writes, so the insert needs no
//      barrier across blocks: __syncthreads shows the block its own rows.
//   2. scan (QRY): one warp per slot, each lane with up to 8 coalesced
//      16-byte loads in flight and psi as f32 in shared memory; the key
//      (the f32 dot times the slot scale, BIG_NEG for an empty slot) goes
//      to the row's line of a (S, Cp) f32 key scratch.
//   3. merge (QRY): every block fences its keys and takes a ticket; the
//      last block of the row to finish reads the row's Cp keys back from
//      L2 (into shared memory while Cp <= STAGE_SLOTS) and selects the top
//      k with select.cuh block_topk, for any k <= Cp.  The order is (key
//      descending, slot ascending), so finite scores come first with ties
//      to the lower slot and empty slots follow in ascending order — the
//      order of the stable top-k and of the TPU kernel's BIG_NEG / INIT /
//      KNOCK bands.  The survivors sit in dynamic shared memory while they
//      fit, else in a global scratch the wrapper passes.  One device kernel
//      and a memset of the S tickets: one counted launch.
//
// Padded wave rows (a bucket larger than the wave repeats its first
// session) must have no insert positions and rec unset: they read the
// payload that their session's own row may be writing in the same launch,
// and their answers are the caller's to throw away.

#include "common.cuh"
#include "select.cuh"

namespace {

#ifndef REPRO_WAVE_CHUNK_ALIGN
#error "REPRO_WAVE_CHUNK_ALIGN is set by kernels/_build.py"
#endif
#ifndef REPRO_WAVE_BLOCKS_PER_SM
#error "REPRO_WAVE_BLOCKS_PER_SM is set by kernels/_build.py"
#endif
constexpr int WARPS = REPRO_WAVE_CHUNK_ALIGN;  // the wrapper's chunks are whole multiples
constexpr int THREADS = 32 * WARPS;
constexpr int BLOCKS_PER_SM = REPRO_WAVE_BLOCKS_PER_SM;  // the wrapper sizes its grid by it
static_assert(THREADS <= 1024, "a block holds at most 1024 threads");
constexpr int IN_FLIGHT = 8;          // 16-byte loads in flight per lane
constexpr int STAGE_SLOTS = 16384;    // merge keys staged in shared memory
constexpr float BIG_NEG = -1.0e38f;
constexpr int kMaxDevices = 64;

struct WaveArgs {
  void* doc_emb;
  const int* rows;
  int* doc_ids;
  int* doc_stamp;
  float* doc_scale;
  void* q_emb;
  float* q_radius;
  float* q_scale;
  const void* new_emb;
  const float* new_scale;
  const int* new_ids;
  const int* pos;
  const void* psi_q;
  const float* psi_scale;
  const float* radius;
  const int* rec;
  const int* qslot;
  const int* step;
  const float* psi;
  float* out_vals;
  int* out_ids;
  int* out_slots;
  float* keys;
  unsigned* tickets;
  uint32_t* pair_key;
  int* pair_pos;
  int cp, dp, kc, qp, k, kp, chunk;
  int work;      // bytes of dynamic shared memory before the pairs
  int stage;     // merge keys staged in shared memory
};

// Dot of one 16-byte payload vector with psi (f32, shared memory) at the
// vector's first element.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static float dot(uint4 x, const float* p, float acc) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    acc = fmaf(__uint_as_float(x.x), q.x, acc);
    acc = fmaf(__uint_as_float(x.y), q.y, acc);
    acc = fmaf(__uint_as_float(x.z), q.z, acc);
    return fmaf(__uint_as_float(x.w), q.w, acc);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static float dot(uint4 x, const float* p, float acc) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 q = *reinterpret_cast<const float4*>(p + 4 * h);
      // a bf16 is the top half of the f32 with the same value
      acc = fmaf(__uint_as_float(w[2 * h] << 16), q.x, acc);
      acc = fmaf(__uint_as_float(w[2 * h] & 0xffff0000u), q.y, acc);
      acc = fmaf(__uint_as_float(w[2 * h + 1] << 16), q.z, acc);
      acc = fmaf(__uint_as_float(w[2 * h + 1] & 0xffff0000u), q.w, acc);
    }
    return acc;
  }
};

template <>
struct Vec<int8_t> {
  static constexpr int N = 16;
  __device__ static float dot(uint4 x, const float* p, float acc) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 q = *reinterpret_cast<const float4*>(p + 4 * i);
      const float qb[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int v = static_cast<int>(w[i] << (24 - 8 * b)) >> 24;  // sign-extended byte b
        acc = fmaf(static_cast<float>(v), qb[b], acc);
      }
    }
    return acc;
  }
};

// Keys of the merge: staged in shared memory, or read from L2.
struct StagedKeys {
  const uint32_t* key;
  __device__ __forceinline__ uint32_t operator()(long long i) const { return key[i]; }
};

struct ScratchKeys {
  const float* row;
  __device__ __forceinline__ uint32_t operator()(long long i) const {
    return repro::float_key(__ldcg(row + i));
  }
};

// Copy one payload row, up to IN_FLIGHT 16-byte loads in flight per
// thread; dp * sizeof(T) is a multiple of 32 bytes.
template <typename T>
__device__ __forceinline__ void copy_row(T* __restrict__ dst, const T* __restrict__ src, int dp,
                                         int first, int step) {
  const int nvec = dp * static_cast<int>(sizeof(T)) / 16;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int v0 = first; v0 < nvec; v0 += step * IN_FLIGHT) {
    uint4 x[IN_FLIGHT];
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u) {
      const int v = v0 + step * u;
      if (v < nvec) x[u] = s[v];
    }
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u) {
      const int v = v0 + step * u;
      if (v < nvec) d[v] = x[u];
    }
  }
}

template <typename T, bool INS, bool QRY>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) wave_kernel(WaveArgs a) {
  const int s = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * a.chunk;
  const int c1 = min(a.cp, c0 + a.chunk);
  const long long prow = a.rows ? a.rows[s] : s;
  T* demb = static_cast<T*>(a.doc_emb) + prow * a.cp * a.dp;
  const size_t so = static_cast<size_t>(s) * a.cp;
  int* dids = a.doc_ids + so;
  float* dscale = a.doc_scale + so;

  if constexpr (INS) {
    __shared__ int mine_j[THREADS], mine_p[THREADS];
    __shared__ int n_mine;
    int* dstamp = a.doc_stamp + so;
    const T* nemb = static_cast<const T*>(a.new_emb) + static_cast<size_t>(s) * a.kc * a.dp;
    const size_t jo = static_cast<size_t>(s) * a.kc;
    const int stamp = a.step[s];
    for (int base = 0; base < a.kc; base += THREADS) {
      if (tid == 0) n_mine = 0;
      __syncthreads();
      const int j = base + tid;
      if (j < a.kc) {
        const int p = a.pos[jo + j];
        if (p >= c0 && p < c1) {       // the drop sentinel (>= Cp) never is
          const int m = atomicAdd(&n_mine, 1);
          mine_j[m] = j;
          mine_p[m] = p;
        }
      }
      __syncthreads();
      for (int m = warp; m < n_mine; m += WARPS) {
        const int jj = mine_j[m], p = mine_p[m];
        copy_row(demb + static_cast<size_t>(p) * a.dp, nemb + static_cast<size_t>(jj) * a.dp,
                 a.dp, lane, 32);
        if (lane == 0) {
          dids[p] = a.new_ids[jo + jj];
          dscale[p] = a.new_scale[jo + jj];
          dstamp[p] = stamp;
        }
      }
      __syncthreads();
    }
    if (blockIdx.x == 0 && a.rec[s]) {
      const size_t ro = static_cast<size_t>(s) * a.qp + a.qslot[s];
      copy_row(static_cast<T*>(a.q_emb) + ro * a.dp,
               static_cast<const T*>(a.psi_q) + static_cast<size_t>(s) * a.dp, a.dp, tid,
               THREADS);
      if (tid == 0) {
        a.q_radius[ro] = a.radius[s];
        a.q_scale[ro] = a.psi_scale[s];
      }
    }
    __syncthreads();
  }

  if constexpr (QRY) {
    extern __shared__ __align__(16) unsigned char dyn[];  // psi or staged keys, then pairs
    __shared__ repro::SelectShared sel;
    __shared__ int last;
    float* psi_s = reinterpret_cast<float*>(dyn);
    const float* psi = a.psi + static_cast<size_t>(s) * a.dp;
    for (int i = tid; i < a.dp; i += THREADS) psi_s[i] = psi[i];
    __syncthreads();

    // 2. scan: one warp per slot of the chunk
    using V = Vec<T>;
    const int nvec = a.dp / V::N;
    float* keys = a.keys + so;
    for (int slot = c0 + warp; slot < c1; slot += WARPS) {
      const uint4* row = reinterpret_cast<const uint4*>(demb + static_cast<size_t>(slot) * a.dp);
      int id = 0;
      float sc = 0.0f;
      if (lane == 0) {
        id = dids[slot];
        sc = dscale[slot];
      }
      float acc = 0.0f;
      for (int v0 = lane; v0 < nvec; v0 += 32 * IN_FLIGHT) {
        uint4 x[IN_FLIGHT];
#pragma unroll
        for (int u = 0; u < IN_FLIGHT; ++u) {
          const int v = v0 + 32 * u;
          x[u] = v < nvec ? row[v] : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < IN_FLIGHT; ++u) {
          const int v = v0 + 32 * u;
          if (v < nvec) acc = V::dot(x[u], psi_s + v * V::N, acc);
        }
      }
      acc = repro::warp_sum(acc);
      if (lane == 0) keys[slot] = id < 0 ? BIG_NEG : __fmul_rn(acc, sc);
    }

    // 3. merge, by the row's last block to finish: the barrier orders the
    //    block's key stores before thread 0's fence and ticket (the pattern
    //    of a cooperative grid sync), and the last block's fence orders its
    //    reads after every other block's
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      last = atomicAdd(a.tickets + s, 1u) == gridDim.x - 1;
      if (last) __threadfence();
    }
    __syncthreads();
    if (!last) return;
    uint32_t* ck = a.pair_key ? a.pair_key + static_cast<size_t>(s) * a.kp
                              : reinterpret_cast<uint32_t*>(dyn + a.work);
    int* cpos = a.pair_key ? a.pair_pos + static_cast<size_t>(s) * a.kp
                           : reinterpret_cast<int*>(ck + a.kp);
    if (a.stage) {
      // psi is done with; the keys come back from L2 four at a time, up to
      // IN_FLIGHT loads a thread in flight (Cp is a multiple of 4)
      uint4* staged = reinterpret_cast<uint4*>(dyn);
      const float4* k4 = reinterpret_cast<const float4*>(keys);
      const int n4 = a.cp / 4;
      for (int i0 = tid; i0 < n4; i0 += THREADS * IN_FLIGHT) {
        float4 x[IN_FLIGHT];
#pragma unroll
        for (int u = 0; u < IN_FLIGHT; ++u) {
          const int i = i0 + THREADS * u;
          if (i < n4) x[u] = __ldcg(k4 + i);
        }
#pragma unroll
        for (int u = 0; u < IN_FLIGHT; ++u) {
          const int i = i0 + THREADS * u;
          if (i < n4)
            staged[i] = make_uint4(repro::float_key(x[u].x), repro::float_key(x[u].y),
                                   repro::float_key(x[u].z), repro::float_key(x[u].w));
        }
      }
      __syncthreads();
      repro::block_topk(StagedKeys{reinterpret_cast<const uint32_t*>(staged)}, a.cp, a.k, a.kp,
                        ck, cpos, sel);
    } else {
      repro::block_topk(ScratchKeys{keys}, a.cp, a.k, a.kp, ck, cpos, sel);
    }
    const size_t oo = static_cast<size_t>(s) * a.k;
    for (int r = tid; r < a.k; r += THREADS) {
      const int slot = cpos[r];
      const float key = __ldcg(keys + slot);
      const bool live = key > BIG_NEG;
      a.out_vals[oo + r] = live ? key : -INFINITY;
      a.out_ids[oo + r] = live ? __ldcg(dids + slot) : -1;
      a.out_slots[oo + r] = slot;
    }
  }
}

template <typename T, bool INS, bool QRY>
cudaError_t launch(WaveArgs& a, int s, cudaStream_t stream) {
  size_t smem = 0;
  if (QRY) {
    a.stage = a.cp <= STAGE_SLOTS;
    size_t work = static_cast<size_t>(a.dp) * sizeof(float);
    if (a.stage && static_cast<size_t>(a.cp) * 4 > work) work = static_cast<size_t>(a.cp) * 4;
    work = (work + 15) & ~static_cast<size_t>(15);
    a.work = static_cast<int>(work);
    smem = work + (a.pair_key ? 0 : static_cast<size_t>(a.kp) * 8);
    const cudaError_t err =
        cudaMemsetAsync(a.tickets, 0, static_cast<size_t>(s) * sizeof(unsigned), stream);
    if (err != cudaSuccess) return err;
  }
  // the shared-memory limit already raised on each device
  static size_t granted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || smem > granted[dev]) {
    err = repro::allow_smem(wave_kernel<T, INS, QRY>, smem);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) granted[dev] = smem;
  }
  const dim3 grid((a.cp + a.chunk - 1) / a.chunk, s);
  wave_kernel<T, INS, QRY><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mode(int mode, WaveArgs& a, int s, cudaStream_t stream) {
  switch (mode) {
    case 0: return launch<T, true, true>(a, s, stream);
    case 1: return launch<T, false, true>(a, s, stream);
    case 2: return launch<T, true, false>(a, s, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// mode: 0 insert + query, 1 query only, 2 insert only.  keys holds S * Cp
// f32 keys followed by the S tickets; rows may be null (payload row = wave
// row).
extern "C" int cache_wave(int mode, int store, void* doc_emb, const void* rows, void* doc_ids,
                          void* doc_stamp, void* doc_scale, void* q_emb, void* q_radius,
                          void* q_scale, const void* new_emb, const void* new_scale,
                          const void* new_ids, const void* pos, const void* psi_q,
                          const void* psi_scale, const void* radius, const void* rec,
                          const void* qslot, const void* step, const void* psi, void* out_vals,
                          void* out_ids, void* out_slots, void* keys, void* pair_key,
                          void* pair_pos, int s, int cp, int dp, int kc, int qp, int k, int kp,
                          int chunk, void* stream) {
  if (s == 0) return 0;
  if (s > repro::kMaxRows || chunk < 1 || cp % 4) return static_cast<int>(cudaErrorInvalidValue);
  if (mode != 2 && (k < 1 || k > cp || kp < k || (kp & (kp - 1)) || keys == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  WaveArgs a;
  a.doc_emb = doc_emb;
  a.rows = static_cast<const int*>(rows);
  a.doc_ids = static_cast<int*>(doc_ids);
  a.doc_stamp = static_cast<int*>(doc_stamp);
  a.doc_scale = static_cast<float*>(doc_scale);
  a.q_emb = q_emb;
  a.q_radius = static_cast<float*>(q_radius);
  a.q_scale = static_cast<float*>(q_scale);
  a.new_emb = new_emb;
  a.new_scale = static_cast<const float*>(new_scale);
  a.new_ids = static_cast<const int*>(new_ids);
  a.pos = static_cast<const int*>(pos);
  a.psi_q = psi_q;
  a.psi_scale = static_cast<const float*>(psi_scale);
  a.radius = static_cast<const float*>(radius);
  a.rec = static_cast<const int*>(rec);
  a.qslot = static_cast<const int*>(qslot);
  a.step = static_cast<const int*>(step);
  a.psi = static_cast<const float*>(psi);
  a.out_vals = static_cast<float*>(out_vals);
  a.out_ids = static_cast<int*>(out_ids);
  a.out_slots = static_cast<int*>(out_slots);
  a.keys = static_cast<float*>(keys);
  a.tickets = keys ? reinterpret_cast<unsigned*>(a.keys + static_cast<size_t>(s) * cp) : nullptr;
  a.pair_key = static_cast<uint32_t*>(pair_key);
  a.pair_pos = static_cast<int*>(pair_pos);
  a.cp = cp;
  a.dp = dp;
  a.kc = kc;
  a.qp = qp;
  a.k = k;
  a.kp = kp;
  a.chunk = chunk;
  a.work = 0;
  a.stage = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (store) {
    case repro::kF32: return launch_mode<float>(mode, a, s, st);
    case repro::kBF16: return launch_mode<__nv_bfloat16>(mode, a, s, st);
    case repro::kI8: return launch_mode<int8_t>(mode, a, s, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
