// Shared device helpers of the port's CUDA kernels.
#pragma once

#include <cmath>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// Storage codes passed from Python (kernels/_build.py STORE).
#ifndef REPRO_STORE_FLOAT32
#error "REPRO_STORE_FLOAT32 is set by kernels/_build.py"
#endif
#ifndef REPRO_STORE_BFLOAT16
#error "REPRO_STORE_BFLOAT16 is set by kernels/_build.py"
#endif
#ifndef REPRO_STORE_INT8
#error "REPRO_STORE_INT8 is set by kernels/_build.py"
#endif
#ifndef REPRO_STORE_FLOAT16
#error "REPRO_STORE_FLOAT16 is set by kernels/_build.py"
#endif
enum Store {
  kF32 = REPRO_STORE_FLOAT32,
  kBF16 = REPRO_STORE_BFLOAT16,
  kI8 = REPRO_STORE_INT8,
  kF16 = REPRO_STORE_FLOAT16
};

// The most rows a select, tile or wave grid takes (its gridDim.y).
#ifndef REPRO_MAX_ROWS
#error "REPRO_MAX_ROWS is set by kernels/_build.py"
#endif
constexpr int kMaxRows = REPRO_MAX_ROWS;
static_assert(kMaxRows <= 65535, "CUDA's gridDim.y is at most 65535");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Order-preserving uint32 key of a float: a > b as floats <=> key(a) > key(b).
// -0.0 is folded onto +0.0 first, so equal floats always share one key.
__device__ __forceinline__ uint32_t float_key(float f) {
  if (f == 0.0f) f = 0.0f;
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(uint32_t k) {
  const uint32_t u = (k & 0x80000000u) ? (k & 0x7fffffffu) : ~k;
  return __uint_as_float(u);
}

// Raise the dynamic shared-memory limit of a kernel when it needs more than
// the default 48 KB.
template <typename K>
__host__ inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro
