// LowQuality probe (paper Eq. 3/4) with its decision: the batched probe of
// a serving wave and the single-session probe of Algorithm 1, one kernel
// body and one C entry.
//
// Replaces: src/repro/kernels/cache_probe/cache_probe.py:81
// probe_rhat_batched (the Pallas grid over sessions, one (Qmax, D) x (D,)
// matvec per step) and src/repro/kernels/cache_probe/cache_probe.py:49
// probe_rhat (the same matvec for one session, a single grid step),
// together with the decision the JAX wrappers take after them
// (src/repro/kernels/cache_probe/ops.py:58-68 and :121-130).
//
// For session s and record r:
//   score = (q_emb[s, r, :] . psi[s, :]) * scale[s, r]      (f32 dot)
//   r_hat = radius[s, r] - sqrt(max(2 - 2 * score, 0))      (NaN stays NaN)
// In decision mode (the wrappers cache_probe / cache_probe_batched) a
// record is live iff r < min(n_queries[s], max_queries), and a dead one has
// r_hat = -inf, so only live records are read; then, per session,
//   best    = the first maximal r_hat (torch.argmax / jnp.argmax: a NaN is
//             the maximum, equal values keep the lower index)
//   best_r  = r_hat[best]
//   hit     = n_queries > 0 and best_r >= epsilon   (in f32)
//   nearest = best, or -1 when n_queries == 0.
// In r_hat mode (probe_rhat / probe_rhat_batched, the functions held against
// the JAX kernels) the kernel writes r_hat of every slot and decides
// nothing; the caller has folded validity into radius as -inf.
//
// Bound: bytes.  One pass over the record payload, S * Qmax * Dp * itemsize
// bytes, at 2 operations per element: far below the card's
// compute-to-bandwidth ratio.  At one session (Qmax = 64, Dp = 800, f32:
// 205 KB) the time is latency and launch, not bandwidth.
//
// Design: one block of 512 threads per session, so the argmax is a block
// reduction and needs no second kernel or ticket across blocks (one block
// keeps a 64-record ring's loads in flight: 16 warps, 4 records a warp, a
// 16-byte vector a lane per record and step).  The session's psi is staged
// in shared memory (zero past its length, so the caller need not pad it);
// each warp dots its records with 16-byte loads when a row is 16-byte
// aligned (else one element at a time), reduces by shuffles, and keeps its
// best (r_hat, index); the 16 warps' bests meet in shared memory (no live
// record: index 0, r_hat -inf, as argmax over an all -inf row).  A
// missing scale reads as 1 (x * 1 is exact) and n_queries comes as a
// device pointer or, when that is null, as a scalar: the wrappers pass
// their inputs as they are.  The epilogue uses explicit round-to-nearest
// multiplies and subtracts (no fused multiply-add), the operation order of
// the plain version.

#include <climits>

#include "common.cuh"

namespace {

using repro::to_f;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRecs = 4;  // records a warp dots at once

struct Args {
  const void* q_emb;        // (S, qmax, dp) in the storage type
  const float* psi;         // (S, psi_len) f32
  const float* radius;      // (S, qmax)
  const float* scale;       // (S, qmax) or null (ones)
  const int* n_queries;     // (S,) or null: then n_queries_scalar
  float* r_hat;             // (S, qmax): r_hat mode
  bool* hit;                // (S,), null in r_hat mode
  float* best_r;            // (S,)
  int* nearest;             // (S,)
  int qmax, dp, psi_len, n_queries_scalar, max_queries;
  float epsilon;
};

// true when (v, i) comes before (bv, bi) in torch.argmax's order
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn || bn) return vn && (!bn || i < bi);
  return v > bv || (v == bv && i < bi);
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* f) {
  if constexpr (sizeof(T) == 4) {
    f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
  } else if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 x = __bfloat1622float2(h[k]);
      f[2 * k] = x.x;
      f[2 * k + 1] = x.y;
    }
  } else {
    const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int k = 0; k < 16; ++k) f[k] = static_cast<float>(b[k]);
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads) probe_kernel(Args a) {
  extern __shared__ float psi_s[];
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
  const int s = blockIdx.x;
  const int qmax = a.qmax, dp = a.dp;
  const float* psi_row = a.psi + static_cast<size_t>(s) * a.psi_len;
  for (int i = threadIdx.x; i < dp; i += kThreads)
    psi_s[i] = i < a.psi_len ? psi_row[i] : 0.0f;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool decide = a.hit != nullptr;
  const int nq = !decide ? 0 : a.n_queries ? a.n_queries[s] : a.n_queries_scalar;
  // the records to read: the live ones, or every slot in r_hat mode
  const int end = decide ? min(max(nq, 0), min(a.max_queries, qmax)) : qmax;
  const T* base = static_cast<const T*>(a.q_emb) + static_cast<size_t>(s) * qmax * dp;
  float best_v = -INFINITY;
  int best_i = INT_MAX;
  for (int r0 = warp * kRecs; r0 < end; r0 += kWarps * kRecs) {
    float acc[kRecs];
    const T* row[kRecs];
#pragma unroll
    for (int t = 0; t < kRecs; ++t) {
      acc[t] = 0.0f;
      row[t] = base + static_cast<size_t>(min(r0 + t, end - 1)) * dp;
    }
    if constexpr (VEC) {
      constexpr int E = 16 / sizeof(T);
      const int nv = dp / E;
#pragma unroll 2
      for (int j = lane; j < nv; j += 32) {
        uint4 u[kRecs];
#pragma unroll
        for (int t = 0; t < kRecs; ++t) u[t] = __ldg(reinterpret_cast<const uint4*>(row[t]) + j);
        const float* p = psi_s + j * E;
#pragma unroll
        for (int t = 0; t < kRecs; ++t) {
          float f[E];
          unpack<T>(u[t], f);
#pragma unroll
          for (int k = 0; k < E; ++k) acc[t] = fmaf(f[k], p[k], acc[t]);
        }
      }
    } else {
      for (int i = lane; i < dp; i += 32) {
#pragma unroll
        for (int t = 0; t < kRecs; ++t) acc[t] = fmaf(to_f(row[t][i]), psi_s[i], acc[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < kRecs; ++t) {
      const int r = r0 + t;
      const float dot = repro::warp_sum(acc[t]);
      if (r >= end) continue;
      const size_t o = static_cast<size_t>(s) * qmax + r;
      const float sc = __fmul_rn(dot, a.scale ? a.scale[o] : 1.0f);
      const float x = __fsub_rn(2.0f, __fmul_rn(2.0f, sc));
      const float v = __fsub_rn(a.radius[o], sqrtf(x < 0.0f ? 0.0f : x));
      if (!decide) {
        if (lane == 0) a.r_hat[o] = v;
        continue;
      }
      if (better(v, r, best_v, best_i)) {
        best_v = v;
        best_i = r;
      }
    }
  }
  if (!decide) return;
  if (lane == 0) {
    warp_v[warp] = best_v;
    warp_i[warp] = best_i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) {
      if (better(warp_v[w], warp_i[w], best_v, best_i)) {
        best_v = warp_v[w];
        best_i = warp_i[w];
      }
    }
    if (best_i == INT_MAX) best_i = 0;
    const bool has_q = nq > 0;
    a.best_r[s] = best_v;
    a.nearest[s] = has_q ? best_i : -1;
    a.hit[s] = has_q && best_v >= a.epsilon;
  }
}

template <typename T>
cudaError_t launch(const Args& a, int s, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(a.dp) * sizeof(float);
  const bool vec = (static_cast<size_t>(a.dp) * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.q_emb) % 16 == 0;
  cudaError_t err = vec ? repro::allow_smem(probe_kernel<T, true>, smem)
                        : repro::allow_smem(probe_kernel<T, false>, smem);
  if (err != cudaSuccess) return err;
  if (vec)
    probe_kernel<T, true><<<s, kThreads, smem, stream>>>(a);
  else
    probe_kernel<T, false><<<s, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// One probe launch over S sessions.  q_emb (S, qmax, dp) in `store` (f32,
// bf16 or int8); psi (S, psi_len) f32, psi_len <= dp; radius and scale (S,
// qmax) f32, scale null for ones.  With hit null: r_hat mode, writes r_hat
// (S, qmax).  Else decision mode: writes hit (S,) bool, best_r (S,) f32 and
// nearest (S,) int32, the record count from n_queries (S,) int32, or
// n_queries_scalar when that is null.
extern "C" int cache_probe(const void* q_emb, const void* psi, const void* radius,
                           const void* scale, const void* n_queries, void* r_hat, void* hit,
                           void* best_r, void* nearest, int s, int qmax, int dp, int psi_len,
                           int n_queries_scalar, int max_queries, float epsilon, int store,
                           void* stream) {
  if (s == 0) return 0;
  if (s < 0 || qmax < 1 || dp < 1 || psi_len < 0 || psi_len > dp ||
      (hit == nullptr) == (r_hat == nullptr) ||
      (hit != nullptr && (best_r == nullptr || nearest == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q_emb, static_cast<const float*>(psi), static_cast<const float*>(radius),
               static_cast<const float*>(scale), static_cast<const int*>(n_queries),
               static_cast<float*>(r_hat), static_cast<bool*>(hit),
               static_cast<float*>(best_r), static_cast<int*>(nearest),
               qmax, dp, psi_len, n_queries_scalar, max_queries, epsilon};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (store) {
    case repro::kF32: return launch<float>(a, s, st);
    case repro::kBF16: return launch<__nv_bfloat16>(a, s, st);
    case repro::kI8: return launch<int8_t>(a, s, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
