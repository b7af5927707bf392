// Shared pieces of the two fixed-order backward kernels,
// resize_bilinear_bwd.cu and adaptive_pool_bwd.cu.
//
// Both compute an input gradient in gather form: one thread per element of
// the input gradient, which sums the output-gradient terms that read its
// element in an order fixed by the loops, in f32 (f64 for an f64 tensor),
// and stores once. No float atomics, so two launches on the same inputs
// give the same bits. Both take NCHW or NHWC (channels_last) memory; the
// gradient they write has the memory format of the gradient they read.
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

// the offset of element (b, ch, y, x) of an (n, c, h, w) tensor, NCHW or
// (cl) NHWC in memory
__device__ __forceinline__ int64_t offset(int b, int ch, int y, int x, int c, int h,
                                          int w, bool cl) {
  return cl ? (((int64_t)b * h + y) * w + x) * c + ch
            : (((int64_t)b * c + ch) * h + y) * w + x;
}

// (b, ch, y, x) of the element at `idx` in memory order
struct Element {
  int b, ch, y, x;
};
__device__ __forceinline__ Element unravel(int64_t idx, int c, int h, int w, bool cl) {
  Element e;
  if (cl) {
    e.ch = (int)(idx % c);
    idx /= c;
    e.x = (int)(idx % w);
    idx /= w;
    e.y = (int)(idx % h);
    e.b = (int)(idx / h);
  } else {
    e.x = (int)(idx % w);
    idx /= w;
    e.y = (int)(idx % h);
    idx /= h;
    e.ch = (int)(idx % c);
    e.b = (int)(idx / c);
  }
  return e;
}

constexpr int kGatherThreads = 256;

// blocks of a grid-stride loop over `total` elements: at most 32 a
// streaming multiprocessor of an H100 (132 of them)
inline int gather_blocks(int64_t total) {
  const int64_t blocks = (total + kGatherThreads - 1) / kGatherThreads;
  return (int)(blocks < 132 * 32 ? blocks : 132 * 32);
}

}  // namespace esn
