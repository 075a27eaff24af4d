// Fused per-wave cache op over the stacked session caches: insert scatter,
// then the post-insert top-k query, one launch for the whole wave.
//
// Replaces: src/repro/kernels/cache_wave/ops.py:143 _launch with the body
// src/repro/kernels/cache_wave/cache_wave.py:56 make_wave_kernel, in its
// three modes (template flags INS and QRY):
//   wave_insert_query   (ops.py:255)  INS + QRY — the last launch of a
//                                      miss wave;
//   wave_query_topk     (ops.py:163)  QRY       — a wave with no misses;
//   wave_insert_scatter (ops.py:234)  INS       — insert without a query.
//
// The state is updated IN PLACE.  Per session (one block each):
//   1. scatter the kept k_c rows (payload, id, scale, LRU stamp = step) at
//      the positions the wrapper computed; a position >= the physical
//      capacity is the drop sentinel and is skipped.  The TPU kernel's
//      one-hot matmul scatter was a workaround; rows are copied directly,
//      one warp per row in 16-byte vectors;
//   2. write the (psi, r_a, scale) record at ring slot qslot when rec is
//      set;
//   3. __syncthreads, then score every slot — one warp per slot takes the
//      f32 dot with psi, times the slot scale; empty slots get the key
//      BIG_NEG — into the session's row of a (S, Cp) f32 key scratch, and
//      select the top k of it with select.cuh (radix select, compaction,
//      bitonic sort) for any k <= Cp.  The order is (key descending, slot
//      ascending), so finite scores come first with ties to the lower slot
//      and empty slots follow in ascending order — the order of the stable
//      top-k and of the TPU kernel's BIG_NEG / INIT / KNOCK bands.  The
//      survivors sit in dynamic shared memory while they fit, else in a
//      global scratch the wrapper passes.
//
// Bound: bytes.  S * Cp * Dp * itemsize read by the query scan and
// S * k_c * Dp * itemsize written by the scatter (plus the small id, scale
// and stamp columns); the dot is 2 operations per payload element.  The
// design streams every cache row once with coalesced warp loads; one block
// per session keeps the scan and its selection on one SM without any
// cross-block merge.

#include "common.cuh"
#include "select.cuh"

namespace {

using repro::to_f;

constexpr int THREADS = 512;
constexpr float BIG_NEG = -1.0e38f;

struct WaveArgs {
  void* doc_emb;
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
  uint32_t* pair_key;
  int* pair_pos;
  int cp, dp, kc, qp, k, kp;
};

// Copy one payload row; dp * sizeof(T) is a multiple of 32 bytes.
template <typename T>
__device__ __forceinline__ void copy_row(T* dst, const T* src, int dp, int first, int step) {
  const int nvec = dp * static_cast<int>(sizeof(T)) / 16;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int v = first; v < nvec; v += step) d[v] = s[v];
}

template <typename T, bool INS, bool QRY>
__global__ void __launch_bounds__(THREADS) wave_kernel(WaveArgs a) {
  const int s = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  T* demb = static_cast<T*>(a.doc_emb) + static_cast<size_t>(s) * a.cp * a.dp;
  int* dids = a.doc_ids + static_cast<size_t>(s) * a.cp;
  float* dscale = a.doc_scale + static_cast<size_t>(s) * a.cp;

  if constexpr (INS) {
    int* dstamp = a.doc_stamp + static_cast<size_t>(s) * a.cp;
    const T* nemb = static_cast<const T*>(a.new_emb) + static_cast<size_t>(s) * a.kc * a.dp;
    const size_t jo = static_cast<size_t>(s) * a.kc;
    const int stamp = a.step[s];
    for (int j = warp; j < a.kc; j += nwarps) {
      const int p = a.pos[jo + j];
      if (p < 0 || p >= a.cp) continue;            // drop sentinel
      copy_row(demb + static_cast<size_t>(p) * a.dp, nemb + static_cast<size_t>(j) * a.dp,
               a.dp, lane, 32);
      if (lane == 0) {
        dids[p] = a.new_ids[jo + j];
        dscale[p] = a.new_scale[jo + j];
        dstamp[p] = stamp;
      }
    }
    if (a.rec[s]) {
      const int qs = a.qslot[s];
      const size_t ro = static_cast<size_t>(s) * a.qp + qs;
      copy_row(static_cast<T*>(a.q_emb) + ro * a.dp,
               static_cast<const T*>(a.psi_q) + static_cast<size_t>(s) * a.dp, a.dp, tid,
               blockDim.x);
      if (tid == 0) {
        a.q_radius[ro] = a.radius[s];
        a.q_scale[ro] = a.psi_scale[s];
      }
    }
    __syncthreads();
  }

  if constexpr (QRY) {
    extern __shared__ float dyn[];          // psi, then the pairs if local
    __shared__ repro::SelectShared sel;
    float* psi_s = dyn;
    const float* psi = a.psi + static_cast<size_t>(s) * a.dp;
    for (int i = tid; i < a.dp; i += blockDim.x) psi_s[i] = psi[i];
    __syncthreads();
    // every slot's key into this session's row of the key scratch
    float* keys = a.keys + static_cast<size_t>(s) * a.cp;
    for (int slot = warp; slot < a.cp; slot += nwarps) {
      const T* row = demb + static_cast<size_t>(slot) * a.dp;
      float acc = 0.0f;
      for (int i = lane; i < a.dp; i += 32) acc = fmaf(to_f(row[i]), psi_s[i], acc);
      acc = repro::warp_sum(acc);
      if (lane == 0) keys[slot] = dids[slot] < 0 ? BIG_NEG : __fmul_rn(acc, dscale[slot]);
    }
    __syncthreads();
    uint32_t* ck = a.pair_key ? a.pair_key + static_cast<size_t>(s) * a.kp
                              : reinterpret_cast<uint32_t*>(dyn + a.dp);
    int* cpos = a.pair_key ? a.pair_pos + static_cast<size_t>(s) * a.kp
                           : reinterpret_cast<int*>(ck + a.kp);
    repro::block_topk(repro::RowKeys{keys, a.cp}, a.cp, a.k, a.kp, ck, cpos, sel);
    const size_t oo = static_cast<size_t>(s) * a.k;
    for (int r = tid; r < a.k; r += blockDim.x) {
      const int slot = cpos[r];
      const float key = keys[slot];
      const bool live = key > BIG_NEG;
      a.out_vals[oo + r] = live ? key : -INFINITY;
      a.out_ids[oo + r] = live ? dids[slot] : -1;
      a.out_slots[oo + r] = slot;
    }
  }
}

template <typename T, bool INS, bool QRY>
cudaError_t launch(const WaveArgs& a, int s, cudaStream_t stream) {
  const size_t smem =
      QRY ? static_cast<size_t>(a.dp) * sizeof(float) + (a.pair_key ? 0 : static_cast<size_t>(a.kp) * 8)
          : 0;
  cudaError_t err = repro::allow_smem(wave_kernel<T, INS, QRY>, smem);
  if (err != cudaSuccess) return err;
  wave_kernel<T, INS, QRY><<<s, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mode(int mode, const WaveArgs& a, int s, cudaStream_t stream) {
  switch (mode) {
    case 0: return launch<T, true, true>(a, s, stream);
    case 1: return launch<T, false, true>(a, s, stream);
    case 2: return launch<T, true, false>(a, s, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// mode: 0 insert + query, 1 query only, 2 insert only.
extern "C" int cache_wave(int mode, int store, void* doc_emb, void* doc_ids, void* doc_stamp,
                          void* doc_scale, void* q_emb, void* q_radius, void* q_scale,
                          const void* new_emb, const void* new_scale, const void* new_ids,
                          const void* pos, const void* psi_q, const void* psi_scale,
                          const void* radius, const void* rec, const void* qslot,
                          const void* step, const void* psi, void* out_vals, void* out_ids,
                          void* out_slots, void* keys, void* pair_key, void* pair_pos, int s,
                          int cp, int dp, int kc, int qp, int k, int kp, void* stream) {
  if (s == 0) return 0;
  if (mode != 2 && (k < 1 || k > cp || kp < k || (kp & (kp - 1)) || keys == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  WaveArgs a;
  a.doc_emb = doc_emb;
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
  a.pair_key = static_cast<uint32_t*>(pair_key);
  a.pair_pos = static_cast<int*>(pair_pos);
  a.cp = cp;
  a.dp = dp;
  a.kc = kc;
  a.qp = qp;
  a.k = k;
  a.kp = kp;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (store) {
    case repro::kF32: return launch_mode<float>(mode, a, s, st);
    case repro::kBF16: return launch_mode<__nv_bfloat16>(mode, a, s, st);
    case repro::kI8: return launch_mode<int8_t>(mode, a, s, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
