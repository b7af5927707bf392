// Shared helpers of the esn_tpu_torch CUDA kernels.
//
// Each kernel file exports plain `extern "C"` launch functions that take
// raw device pointers and a cudaStream_t passed as void*, launch on that
// stream, and return cudaGetLastError() as an int. No file includes
// PyTorch's headers; the Python wrappers (esn_tpu_torch/ops/kernels/)
// check shapes, dtypes and contiguity before they call in.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace esn {

// shared memory on an H100: the most one block may take (dynamic), and
// the most each of two blocks may take to share an SM (228 KB, less 1 KB
// reserved per block)
constexpr int kMaxSmem = 232448;
constexpr int kSmemTwoBlocks = 115712;

// dtype codes passed from Python: 0 = float32, 1 = bfloat16
enum DType : int { kF32 = 0, kBF16 = 1 };

// activation codes: 0 = none, 1 = relu, 2 = relu6
__device__ __forceinline__ float act(float v, int kind) {
  if (kind == 1) return fmaxf(v, 0.f);
  if (kind == 2) return fminf(fmaxf(v, 0.f), 6.f);
  return v;
}

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
// round to nearest even, as torch's float -> bfloat16 cast
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Asynchronous 16-byte copy from device to shared memory (both addresses
// 16-byte aligned); with `fill` false nothing is read and the 16 bytes are
// zeroed. Complete after cp_async_wait_all() and a barrier.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool fill = true) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(fill ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace esn
