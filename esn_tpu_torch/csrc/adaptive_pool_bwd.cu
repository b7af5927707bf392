// Backward of the adaptive average pool, in a fixed order (K6).
//
// Replaces no TPU kernel. The reference differentiates its adaptive pool
// (esn_tpu/ops/pooling.py, the bins' edges at :122) through XLA, which
// sums in a fixed order; the port's forward is F.adaptive_avg_pool2d
// (PPM's only pool, models/blocks.py), and torch's CUDA backward of it
// (atomic_adaptive_average_gradinput) adds each bin's share into the
// input with float atomics in no fixed order, so two equal steps on the
// card differ in the last bits. This kernel is that backward with one
// order.
//
// The map is torch's: bin a of n over a length L spans [floor(a L / n),
// ceil((a + 1) L / n)) (the reference's edges), and each bin hands each of
// its elements g / kh / kw, the two divisions in the accumulation type as
// torch's backward takes them. Each input element sums those terms over
// the bins that hold it, rows of bins outer and columns inner, in f32
// (f64 for an f64 tensor), and rounds once.
//
// What bounds it on an H100: it reads g once and writes gx once; PPM's
// bins are at most 6 x 6, so gx is nearly all of it (Fast-SCNN's 1/32 map
// at config 5: (8, 128, 32, 64) f32, 8.4 MB, ~2.5 us at 3.35 TB/s), and
// the arithmetic (a division pair and an add a term) is small. So bytes;
// at these sizes a launch's own cost is larger than either.
//
// Design: one thread per input element in memory order (coalesced store,
// NCHW or NHWC), the bins that hold its row found from the floor of the
// inverse map and walked down to the first that holds it; no shared
// memory.
#include "gather_bwd.cuh"

namespace {

__device__ __forceinline__ int bin_start(int a, int len, int n) {
  return (int)(((int64_t)a * len) / n);
}
__device__ __forceinline__ int bin_end(int a, int len, int n) {
  return (int)(((int64_t)(a + 1) * len + n - 1) / n);
}
// the first bin of n over len that holds index i
__device__ __forceinline__ int first_bin(int i, int len, int n) {
  int a = (int)(((int64_t)i * n) / len);
  while (a > 0 && bin_end(a - 1, len, n) > i) --a;
  return a;
}

template <typename T>
__global__ void __launch_bounds__(esn::kGatherThreads)
adaptive_pool_bwd_kernel(const T* __restrict__ g, T* __restrict__ gx, int n, int c, int h,
                         int w, int oh, int ow, bool cl) {
  using A = typename esn::AccOf<T>::type;
  const int64_t total = (int64_t)n * c * h * w;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const esn::Element e = esn::unravel(idx, c, h, w, cl);
    const int b0 = first_bin(e.x, w, ow);
    A acc = 0;
    for (int a = first_bin(e.y, h, oh); a < oh && bin_start(a, h, oh) <= e.y; ++a) {
      const int kh = bin_end(a, h, oh) - bin_start(a, h, oh);
      for (int b = b0; b < ow && bin_start(b, w, ow) <= e.x; ++b) {
        const int kw = bin_end(b, w, ow) - bin_start(b, w, ow);
        acc += esn::load_acc(g + esn::offset(e.b, e.ch, a, b, c, oh, ow, cl)) / (A)kh / (A)kw;
      }
    }
    esn::store_acc(gx + idx, acc);
  }
}

template <typename T>
int launch(const T* g, T* gx, int n, int c, int h, int w, int oh, int ow, bool cl,
           cudaStream_t st) {
  const int64_t total = (int64_t)n * c * h * w;
  adaptive_pool_bwd_kernel<T><<<esn::gather_blocks(total), esn::kGatherThreads, 0, st>>>(
      g, gx, n, c, h, w, oh, ow, cl);
  return cudaGetLastError();
}

}  // namespace

// g (n, c, oh, ow) and gx (n, c, h, w), both NCHW or both NHWC
// (channels_last != 0), of dtype `dtype` (0 f32, 1 bf16, 2 f64).
extern "C" int esn_adaptive_pool_bwd(const void* g, void* gx, int dtype, int n, int c, int h,
                                     int w, int oh, int ow, int channels_last, void* stream) {
  if (n < 1 || c < 1 || h < 1 || w < 1 || oh < 1 || ow < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool cl = channels_last != 0;
  if (dtype == esn::kF32)
    return launch(static_cast<const float*>(g), static_cast<float*>(gx), n, c, h, w, oh, ow, cl,
                  st);
  if (dtype == esn::kBF16)
    return launch(static_cast<const __nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(gx), n, c,
                  h, w, oh, ow, cl, st);
  if (dtype == esn::kF64)
    return launch(static_cast<const double*>(g), static_cast<double*>(gx), n, c, h, w, oh, ow,
                  cl, st);
  return cudaErrorInvalidValue;
}
