// Batched LowQuality probe (paper Eq. 3/4): one launch per serving wave.
//
// Replaces: src/repro/kernels/cache_probe/cache_probe.py:81 probe_rhat_batched
// (the Pallas grid over sessions, one (Qmax, D) x (D,) matvec per step).
//
// For session s and record r:
//   score = (q_emb[s, r, :] . psi[s, :]) * scale[s, r]      (f32 dot)
//   r_hat = radius[s, r] - sqrt(max(2 - 2 * score, 0))
// The wrapper has already folded ring validity into radius as -inf, and
// takes the argmax and the hit test itself.
//
// Bound: bytes.  The work is one pass over the record payload,
// S * Qmax * Dp * itemsize bytes, at 2 operations per byte-element, far
// below the card's compute-to-bandwidth ratio.  Design: one block per
// session, psi staged once in shared memory, one warp per record so each
// record row streams as coalesced 32-element warp loads; the dot reduces
// by warp shuffles and lane 0 writes r_hat.  The epilogue uses explicit
// round-to-nearest multiplies and subtracts (no fused multiply-add), the
// operation order of the plain version.

#include "common.cuh"

namespace {

using repro::to_f;

template <typename T>
__global__ void probe_kernel(const T* __restrict__ q_emb, const float* __restrict__ psi,
                             const float* __restrict__ radius,
                             const float* __restrict__ scale, float* __restrict__ out,
                             int qmax, int dp) {
  extern __shared__ float psi_s[];
  const int s = blockIdx.x;
  const float* psi_row = psi + static_cast<size_t>(s) * dp;
  for (int i = threadIdx.x; i < dp; i += blockDim.x) psi_s[i] = psi_row[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < qmax; r += nwarps) {
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
                   const void* scale, void* out, int s, int qmax, int dp,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(dp) * sizeof(float);
  cudaError_t err = repro::allow_smem(probe_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  probe_kernel<T><<<s, 256, smem, stream>>>(
      static_cast<const T*>(q_emb), static_cast<const float*>(psi),
      static_cast<const float*>(radius), static_cast<const float*>(scale),
      static_cast<float*>(out), qmax, dp);
  return cudaGetLastError();
}

}  // namespace

extern "C" int probe_rhat_batched(const void* q_emb, const void* psi, const void* radius,
                                  const void* scale, void* out, int s, int qmax, int dp,
                                  int store, void* stream) {
  if (s == 0 || qmax == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (store) {
    case repro::kF32: return launch<float>(q_emb, psi, radius, scale, out, s, qmax, dp, st);
    case repro::kBF16:
      return launch<__nv_bfloat16>(q_emb, psi, radius, scale, out, s, qmax, dp, st);
    case repro::kI8: return launch<int8_t>(q_emb, psi, radius, scale, out, s, qmax, dp, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
