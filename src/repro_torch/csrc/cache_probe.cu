// LowQuality probe (paper Eq. 3/4): the batched probe of a serving wave and
// the single-session probe of Algorithm 1, one kernel body.
//
// Replaces: src/repro/kernels/cache_probe/cache_probe.py:81
// probe_rhat_batched (the Pallas grid over sessions, one (Qmax, D) x (D,)
// matvec per step) and src/repro/kernels/cache_probe/cache_probe.py:49
// probe_rhat (the same matvec for one session, a single grid step).
//
// For session s and record r:
//   score = (q_emb[s, r, :] . psi[s, :]) * scale[s, r]      (f32 dot)
//   r_hat = radius[s, r] - sqrt(max(2 - 2 * score, 0))
// The wrapper has already folded ring validity into radius as -inf, and
// takes the argmax and the hit test itself.
//
// Bound: bytes.  The work is one pass over the record payload,
// S * Qmax * Dp * itemsize bytes, at 2 operations per byte-element, far
// below the card's compute-to-bandwidth ratio.  Design: grid (record
// chunks, sessions); each block stages its session's psi in shared memory
// and gives one warp per record, so each record row streams as coalesced
// 32-element warp loads; the dot reduces by warp shuffles and lane 0
// writes r_hat.  The batched entry runs one block per session (64 SMs at a
// 64-session wave); the single-session entry spreads one session's records
// over blocks of 8 warps so a 64-record ring works on 8 SMs instead of one.
// The epilogue uses explicit round-to-nearest multiplies and subtracts (no
// fused multiply-add), the operation order of the plain version.

#include "common.cuh"

namespace {

using repro::to_f;

template <typename T>
__global__ void probe_kernel(const T* __restrict__ q_emb, const float* __restrict__ psi,
                             const float* __restrict__ radius,
                             const float* __restrict__ scale, float* __restrict__ out,
                             int qmax, int dp) {
  extern __shared__ float psi_s[];
  const int s = blockIdx.y;
  const float* psi_row = psi + static_cast<size_t>(s) * dp;
  for (int i = threadIdx.x; i < dp; i += blockDim.x) psi_s[i] = psi_row[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int r = blockIdx.x * nwarps + warp; r < qmax; r += gridDim.x * nwarps) {
    const size_t o = static_cast<size_t>(s) * qmax + r;
    const T* row = q_emb + o * dp;
    float acc = 0.0f;
    for (int i = lane; i < dp; i += 32) acc = fmaf(to_f(row[i]), psi_s[i], acc);
    acc = repro::warp_sum(acc);
    if (lane == 0) {
      const float sc = __fmul_rn(acc, scale[o]);
      const float d = sqrtf(fmaxf(__fsub_rn(2.0f, __fmul_rn(2.0f, sc)), 0.0f));
      out[o] = __fsub_rn(radius[o], d);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q_emb, const void* psi, const void* radius,
                   const void* scale, void* out, int s, int qmax, int dp, int chunks,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(dp) * sizeof(float);
  cudaError_t err = repro::allow_smem(probe_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  probe_kernel<T><<<dim3(chunks, s), 256, smem, stream>>>(
      static_cast<const T*>(q_emb), static_cast<const float*>(psi),
      static_cast<const float*>(radius), static_cast<const float*>(scale),
      static_cast<float*>(out), qmax, dp);
  return cudaGetLastError();
}

template <typename... A>
int dispatch(int store, A... args) {
  switch (store) {
    case repro::kF32: return launch<float>(args...);
    case repro::kBF16: return launch<__nv_bfloat16>(args...);
    case repro::kI8: return launch<int8_t>(args...);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int probe_rhat_batched(const void* q_emb, const void* psi, const void* radius,
                                  const void* scale, void* out, int s, int qmax, int dp,
                                  int store, void* stream) {
  if (s == 0 || qmax == 0) return 0;
  if (s > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(store, q_emb, psi, radius, scale, out, s, qmax, dp, 1,
                  static_cast<cudaStream_t>(stream));
}

extern "C" int probe_rhat(const void* q_emb, const void* psi, const void* radius,
                          const void* scale, void* out, int qmax, int dp, int store,
                          void* stream) {
  if (qmax == 0) return 0;
  const int chunks = (qmax + 7) / 8;     // 8 warps of 256 threads per block
  return dispatch(store, q_emb, psi, radius, scale, out, 1, qmax, dp, chunks,
                  static_cast<cudaStream_t>(stream));
}
