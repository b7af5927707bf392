// Backward of the half-pixel bilinear resize, in a fixed order (K5).
//
// Replaces no TPU kernel. The reference differentiates
// jax.image.resize(..., antialias=False) (esn_tpu/ops/resize.py) through
// XLA, whose transpose sums in a fixed order; the port's forward is
// F.interpolate(mode="bilinear", align_corners=False, antialias=False),
// and torch's CUDA backward of it (upsample_bilinear2d_backward_out_cuda)
// adds every output gradient into its four input taps with float atomics
// in no fixed order, so two equal training steps on the card differ in
// the last bits and a resumed run drifts from the straight one. This
// kernel is that backward with one order: the transpose of the forward's
// map, gx = A_h^T g A_w, each input element summing, in f32 (f64 for an
// f64 tensor), the output-gradient terms that read it, and rounding once
// to the tensor's dtype.
//
// The map is torch's forward, arithmetic for arithmetic
// (area_pixel_compute_scale / _source_index, upsample_bilinear2d): along
// an axis of n_in -> n_out the scale is 1 / scale_factor on the ratio
// route, else n_in / n_out, in the accumulation type (the wrapper computes
// it on the host and passes it as a double); output index d reads source
// src = max(0, scale * (d + 0.5) - 0.5), rounded once (the card's fused
// multiply-add, as torch's kernel is compiled), taps i0 = (int)src and
// i1 = i0 + (i0 < n_in - 1), weights l1 = src - i0 and l0 = 1 - l1. Other
// weights would make this the transpose of another map.
//
// What bounds it on an H100: it reads g once and writes gx once (at
// Fast-SCNN's fusion x4, config 5: g (8, 128, 128, 256) f32 134 MB and gx
// 8 MB, ~43 us at 3.35 TB/s); the arithmetic, ~8 flops an output element,
// is far below the card's f32 rate. So bytes.
//
// Design: the simple gather. One thread per input element (memory order,
// so the store is coalesced, NCHW or NHWC alike); the output rows that
// read its row form one run of d, found from an estimate of the inverse
// map corrected against the exact taps, and likewise the columns. For each
// such row it sums the row's column terms, then adds the row's weight
// times that sum. Every output gradient is read by the (up to) four
// threads of its taps, from L1/L2 after the first; no shared memory. Its
// second round (a tiled form reading each g element once from shared
// memory) waits for a benchmark cell.
#include "gather_bwd.cuh"

namespace {

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// One axis of the resize, n_in -> n_out at `scale`, in accumulation type A.
template <typename A>
struct Axis {
  int n_in, n_out;
  A scale;

  // torch's source taps of output index d
  __device__ __forceinline__ void taps(int d, int& i0, int& i1, A& l0, A& l1) const {
    A src = fma_rn(scale, (A)d + (A)0.5, (A)-0.5);
    src = src < (A)0 ? (A)0 : src;
    i0 = (int)src;
    i1 = i0 + (i0 < n_in - 1 ? 1 : 0);
    l1 = src - (A)i0;
    l0 = (A)1 - l1;
  }
  __device__ __forceinline__ int first_tap(int d) const {
    int i0, i1;
    A l0, l1;
    taps(d, i0, i1, l0, l1);
    return i0;
  }
  // the first output index whose first tap is >= t (n_out if none): the
  // inverse of the map estimated, then moved to the exact answer
  __device__ int first_at(int t) const {
    if (t <= 0) return 0;
    A est = ((A)t + (A)0.5) / scale - (A)0.5;
    est = est < (A)0 ? (A)0 : est > (A)n_out ? (A)n_out : est;
    int d = (int)est;
    while (d > 0 && first_tap(d - 1) >= t) --d;
    while (d < n_out && first_tap(d) < t) ++d;
    return d;
  }
  // the weight with which output index d reads input index i (the sum of
  // both taps where they coincide at the edge)
  __device__ __forceinline__ A weight(int d, int i, int& i0) const {
    int i1;
    A l0, l1;
    taps(d, i0, i1, l0, l1);
    return (i0 == i ? l0 : (A)0) + (i1 == i ? l1 : (A)0);
  }
};

template <typename T>
__global__ void __launch_bounds__(esn::kGatherThreads)
resize_bilinear_bwd_kernel(const T* __restrict__ g, T* __restrict__ gx, int n, int c,
                           Axis<typename esn::AccOf<T>::type> ah,
                           Axis<typename esn::AccOf<T>::type> aw, bool cl) {
  using A = typename esn::AccOf<T>::type;
  const int h = ah.n_in, w = aw.n_in, ho = ah.n_out, wo = aw.n_out;
  const int64_t total = (int64_t)n * c * h * w;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const esn::Element e = esn::unravel(idx, c, h, w, cl);
    // output rows and columns whose taps can reach row e.y / column e.x
    const int d0 = ah.first_at(e.y - 1), c0 = aw.first_at(e.x - 1);
    A acc = 0;
    for (int d = d0; d < ho; ++d) {
      int i0;
      const A wh = ah.weight(d, e.y, i0);
      if (i0 > e.y) break;
      A row = 0;
      for (int q = c0; q < wo; ++q) {
        int j0;
        const A ww = aw.weight(q, e.x, j0);
        if (j0 > e.x) break;
        row += ww * esn::load_acc(g + esn::offset(e.b, e.ch, d, q, c, ho, wo, cl));
      }
      acc += wh * row;
    }
    esn::store_acc(gx + idx, acc);
  }
}

template <typename T>
int launch(const T* g, T* gx, int n, int c, int h, int w, int ho, int wo, const double* scales,
           bool cl, cudaStream_t st) {
  using A = typename esn::AccOf<T>::type;
  const Axis<A> ah{h, ho, (A)scales[0]}, aw{w, wo, (A)scales[1]};
  const int64_t total = (int64_t)n * c * h * w;
  resize_bilinear_bwd_kernel<T><<<esn::gather_blocks(total), esn::kGatherThreads, 0, st>>>(
      g, gx, n, c, ah, aw, cl);
  return cudaGetLastError();
}

}  // namespace

// g (n, c, ho, wo) and gx (n, c, h, w), both NCHW or both NHWC
// (channels_last != 0), of dtype `dtype` (0 f32, 1 bf16, 2 f64); scales:
// two host doubles, the H and W scales of torch's forward (1 / scale
// factor, or in / out), already rounded to the accumulation type.
extern "C" int esn_resize_bilinear_bwd(const void* g, void* gx, int dtype, int n, int c,
                                       int h, int w, int ho, int wo, const double* scales,
                                       int channels_last, void* stream) {
  if (n < 1 || c < 1 || h < 1 || w < 1 || ho < 1 || wo < 1 || !scales ||
      !(scales[0] > 0) || !(scales[1] > 0))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool cl = channels_last != 0;
  if (dtype == esn::kF32)
    return launch(static_cast<const float*>(g), static_cast<float*>(gx), n, c, h, w, ho, wo,
                  scales, cl, st);
  if (dtype == esn::kBF16)
    return launch(static_cast<const __nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(gx), n, c,
                  h, w, ho, wo, scales, cl, st);
  if (dtype == esn::kF64)
    return launch(static_cast<const double*>(g), static_cast<double*>(gx), n, c, h, w, ho, wo,
                  scales, cl, st);
  return cudaErrorInvalidValue;
}
