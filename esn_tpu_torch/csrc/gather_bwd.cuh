// Shared pieces of the two fixed-order backward kernels,
// resize_bilinear_bwd.cu (K5) and adaptive_pool_bwd.cu (K6).
//
// Both compute an input gradient in gather form: each element of the
// input gradient sums the output-gradient terms that read its element in
// an order fixed by the shapes, in f32 (f64 for an f64 tensor), and is
// stored once. No float atomics, so two launches on the same inputs give
// the same bits. Both take NCHW or NHWC (channels_last) memory; the
// gradient they write has the memory format of the gradient they read.
//
// Both see a tensor as lines of pixels: in NHWC a pixel holds the c
// values of its channels, one image is a plane; in NCHW a pixel holds one
// value, one (image, channel) is a plane. Element (plane p, row y, column
// x, value v) of a plane of rows x cols pixels of `vals` values lies at
// ((p rows + y) cols + x) vals + v either way.
#pragma once

#include "common.cuh"

namespace esn {

// dtype code beside kF32 and kBF16 (common.cuh)
constexpr int kF64 = 2;

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<double> { using type = double; };

__device__ __forceinline__ float load_acc(const float* p) { return *p; }
__device__ __forceinline__ float load_acc(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ double load_acc(const double* p) { return *p; }
__device__ __forceinline__ void store_acc(float* p, float v) { *p = v; }
// round to nearest even, as torch's float -> bfloat16 cast
__device__ __forceinline__ void store_acc(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_acc(double* p, double v) { *p = v; }

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// the offset of pixel (p, y, x), value 0, of planes of rows x cols pixels
// of `vals` values
__device__ __forceinline__ int64_t pixel_offset(int p, int y, int x, int rows, int cols,
                                                int vals) {
  return (((int64_t)p * rows + y) * cols + x) * vals;
}

// Let a kernel take `bytes` of dynamic shared memory (above 48 KB it must
// ask); once per kernel and size.
template <typename K>
inline int allow_smem(K kernel, int bytes, int& allowed) {
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024 && bytes > allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    allowed = bytes;
  }
  return 0;
}

}  // namespace esn
