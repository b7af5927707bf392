// Subpixel class argmax: the fused prediction head of a model whose last
// layer is a stride-2 transposed conv (K7).
//
// Replaces no Pallas kernel. It is the counterpart of
// esn_tpu/ops/classify.py `subpixel_argmax` (line 130), which XLA computed
// on the TPU: for NHWC features x (N, H, W, I), bf16 or f32, and the
// transposed conv's weight (I, O, kh, kw) and bias, it writes the int32
// class map (N, 2H, 2W) directly. Each entry is the first-max argmax over
// the O classes of its phase logit: an f32 sum over the phase's taps and
// the I channels, plus the bias in f32. The full-resolution logits never
// exist, and the depth-to-space is the store address.
//
// Phases: output pixel (2q + rh, 2p + rw) sums x[q + dy, p + dx] . w[uh, uw]
// over the taps of phase (rh, rw) (ops/convolution.py `_subpixel_axis`, in
// torch's unflipped convention). The host gives each phase its own tap
// list, so k3s2p1op1's phases run 1, 2, 2 and 4 taps and k2s2p0's one
// each; a tap past the input's edge (x[H] or x[W] for op = 1) reads zero
// and is skipped.
//
// What bounds it on an H100: at ENet's predict (x (8,512,1024,16) bf16 ->
// (8,1024,2048) int32) it reads 134 MB and writes 67 MB, 0.06 ms at
// 3.35 TB/s; its 11.5 G multiply-adds (9 taps x 16 x 19 a low-res pixel)
// take ~0.34 ms as f32 FMAs outside the tensor cores. So this design is
// bound by its FMAs: ~0.023 ms at the tensor cores' bf16 rate is the
// bound a second design (mma.sync over a tile of pixels) would aim at.
//
// Design (simple first): the weights (kh*kw*I*OMAX f32, classes padded
// to OMAX with zeros) and the bias go to shared memory once per block;
// each thread takes two neighbouring low-res pixels of a row, keeps
// 2 x OMAX f32 accumulators in registers for one phase at a time, reads
// each tap's channels with 16-byte loads (element by element where I
// does not fill whole vectors, e.g. ESPNet's I = 19, or x is not 16-byte
// aligned), reads each weight row as float4 broadcasts shared by both
// pixels, and runs the compare chain (a strict `>`: ties go to the first
// class). The four classes of an output row pair go out as two 8-byte
// stores. The grid strides over the pixel pairs.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPhases = 4;   // stride 2 on both axes
constexpr int kMaxTaps = 16; // taps of one phase (k <= 8 per axis)

// the shape and the phases' tap tables: tap t of phase ph reads x at
// (q + dy, p + dx) with weight slot uh * kw + uw
struct Geo {
  int n, h, w, ci, co;
  int ntaps[kPhases];
  int dy[kPhases][kMaxTaps], dx[kPhases][kMaxTaps], slot[kPhases][kMaxTaps];
};

// a[o] += f * w[o] for both pixels, OMAX classes, w a shared row
template <int OMAX>
__device__ __forceinline__ void fma_row(float f0, float f1, const float* wr, float* a0,
                                        float* a1) {
#pragma unroll
  for (int o4 = 0; o4 < OMAX / 4; ++o4) {
    const float4 wv = reinterpret_cast<const float4*>(wr)[o4];
    a0[4 * o4 + 0] = fmaf(f0, wv.x, a0[4 * o4 + 0]);
    a0[4 * o4 + 1] = fmaf(f0, wv.y, a0[4 * o4 + 1]);
    a0[4 * o4 + 2] = fmaf(f0, wv.z, a0[4 * o4 + 2]);
    a0[4 * o4 + 3] = fmaf(f0, wv.w, a0[4 * o4 + 3]);
    a1[4 * o4 + 0] = fmaf(f1, wv.x, a1[4 * o4 + 0]);
    a1[4 * o4 + 1] = fmaf(f1, wv.y, a1[4 * o4 + 1]);
    a1[4 * o4 + 2] = fmaf(f1, wv.z, a1[4 * o4 + 2]);
    a1[4 * o4 + 3] = fmaf(f1, wv.w, a1[4 * o4 + 3]);
  }
}

// one tap: the I channels of the two pixels (rows r0, r1; zero where
// not v0, v1) against the tap's weights wt (I rows of OMAX)
template <typename T, int OMAX, bool VEC>
__device__ __forceinline__ void accumulate(const T* r0, const T* r1, bool v0, bool v1,
                                           const float* wt, int ci, float* a0, float* a1) {
  if constexpr (VEC) {
    constexpr int V = 16 / sizeof(T);
    for (int c = 0; c < ci; c += V) {
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      const uint4 u0 = v0 ? *reinterpret_cast<const uint4*>(r0 + c) : zero;
      const uint4 u1 = v1 ? *reinterpret_cast<const uint4*>(r1 + c) : zero;
      float f0[8], f1[8];
      esn::unpack(u0, f0, T());
      esn::unpack(u1, f1, T());
#pragma unroll
      for (int k = 0; k < V; ++k) fma_row<OMAX>(f0[k], f1[k], wt + (c + k) * OMAX, a0, a1);
    }
  } else {
    for (int c = 0; c < ci; ++c) {
      const float f0 = v0 ? esn::to_f32(r0[c]) : 0.f;
      const float f1 = v1 ? esn::to_f32(r1[c]) : 0.f;
      fma_row<OMAX>(f0, f1, wt + c * OMAX, a0, a1);
    }
  }
}

// first-max argmax over classes o < co of a[o] + bias[o] (selects, not
// branches)
template <int OMAX>
__device__ __forceinline__ int argmax(const float* a, const float* bs, int co) {
  float best = a[0] + bs[0];
  int idx = 0;
#pragma unroll
  for (int o = 1; o < OMAX; ++o) {
    const float v = a[o] + bs[o];
    const bool take = o < co && v > best;
    best = take ? v : best;
    idx = take ? o : idx;
  }
  return idx;
}

// two blocks an SM (<= 128 registers a thread) up to 20 classes; 32
// classes' accumulators take one block's room
template <typename T, int OMAX, bool VEC>
__global__ void __launch_bounds__(kThreads, OMAX > 20 ? 1 : 2)
subpixel_argmax_kernel(const T* __restrict__ x, const float* __restrict__ wp,
                       const float* __restrict__ bias, int* __restrict__ out, Geo g,
                       int nslots) {
  extern __shared__ __align__(16) float ws[];  // nslots*ci rows of OMAX, then the bias
  const int nw = nslots * g.ci * OMAX;
  for (int i = threadIdx.x; i < nw + OMAX; i += kThreads) ws[i] = i < nw ? wp[i] : bias[i - nw];
  __syncthreads();
  const float* bs = ws + nw;
  const int npairs = (g.w + 1) / 2;
  const int64_t items = (int64_t)g.n * g.h * npairs;
  const int64_t W2 = 2 * (int64_t)g.w;
  for (int64_t item = (int64_t)blockIdx.x * kThreads + threadIdx.x; item < items;
       item += (int64_t)gridDim.x * kThreads) {
    const int j = (int)(item % npairs);
    const int64_t rest = item / npairs;
    const int q = (int)(rest % g.h), b = (int)(rest / g.h);
    const int p0 = 2 * j;
    const bool two = p0 + 1 < g.w;  // the pair's second pixel exists
    const T* xb = x + (int64_t)b * g.h * g.w * g.ci;
    int* orow = out + ((int64_t)b * 2 * g.h + 2 * q) * W2 + 2 * p0;
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      int cls[2][2];  // [pixel][rw]
#pragma unroll
      for (int rw = 0; rw < 2; ++rw) {
        const int ph = rh * 2 + rw;
        float a0[OMAX], a1[OMAX];
#pragma unroll
        for (int o = 0; o < OMAX; ++o) a0[o] = a1[o] = 0.f;
        for (int t = 0; t < g.ntaps[ph]; ++t) {
          const int qy = q + g.dy[ph][t];
          if (qy < 0 || qy >= g.h) continue;
          const int px0 = p0 + g.dx[ph][t];
          const bool v0 = px0 >= 0 && px0 < g.w, v1 = px0 + 1 >= 0 && px0 + 1 < g.w;
          const T* r0 = xb + ((int64_t)qy * g.w + px0) * g.ci;
          accumulate<T, OMAX, VEC>(r0, r0 + g.ci, v0, v1, ws + g.slot[ph][t] * g.ci * OMAX,
                                   g.ci, a0, a1);
        }
        cls[0][rw] = argmax<OMAX>(a0, bs, g.co);
        cls[1][rw] = argmax<OMAX>(a1, bs, g.co);
      }
      int* o = orow + rh * W2;
      *reinterpret_cast<int2*>(o) = make_int2(cls[0][0], cls[0][1]);
      if (two) *reinterpret_cast<int2*>(o + 2) = make_int2(cls[1][0], cls[1][1]);
    }
  }
}

// classes padded to the accumulators' count (the wrapper pads the same)
inline int pad_classes(int co) { return co <= 12 ? 12 : co <= 20 ? 20 : co <= 32 ? 32 : 0; }

template <typename T, int OMAX, bool VEC>
int launch(const T* x, const float* w, const float* b, int* out, const Geo& g, int nslots,
           cudaStream_t st) {
  const size_t bytes = ((size_t)nslots * g.ci + 1) * OMAX * sizeof(float);
  if (bytes > (size_t)esn::kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = subpixel_argmax_kernel<T, OMAX, VEC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int64_t items = (int64_t)g.n * g.h * ((g.w + 1) / 2);
  const int64_t need = (items + kThreads - 1) / kThreads;
  const int blocks = (int)(need < 8 * (int64_t)sms ? need : 8 * (int64_t)sms);
  kernel<<<blocks, kThreads, bytes, st>>>(x, w, b, out, g, nslots);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const T* x, const float* w, const float* b, int* out, const Geo& g, int co_pad,
             int nslots, bool vec, cudaStream_t st) {
  switch (co_pad * 2 + (vec ? 1 : 0)) {
    case 24: return launch<T, 12, false>(x, w, b, out, g, nslots, st);
    case 25: return launch<T, 12, true>(x, w, b, out, g, nslots, st);
    case 40: return launch<T, 20, false>(x, w, b, out, g, nslots, st);
    case 41: return launch<T, 20, true>(x, w, b, out, g, nslots, st);
    case 64: return launch<T, 32, false>(x, w, b, out, g, nslots, st);
    case 65: return launch<T, 32, true>(x, w, b, out, g, nslots, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x (n, h, w, ci) of dtype `dtype` contiguous; w (nslots, ci, co_pad) f32,
// slot uh * kw + uw, classes from co on zero; b (co_pad) f32; out
// (n, 2h, 2w) int32. desc (int32, host): n, h, w, ci, co, co_pad, nslots,
// the four phases' tap counts, then per phase kMaxTaps (dy, dx, slot)
// triples.
extern "C" int esn_subpixel_argmax(const void* x, const void* w, const void* b, void* out,
                                   int dtype, const int* desc, void* stream) {
  Geo g{};
  g.n = desc[0], g.h = desc[1], g.w = desc[2], g.ci = desc[3], g.co = desc[4];
  const int co_pad = desc[5], nslots = desc[6];
  if (g.n < 1 || g.h < 1 || g.w < 1 || g.ci < 1 || g.co < 1 || nslots < 1 ||
      co_pad != pad_classes(g.co))
    return cudaErrorInvalidValue;
  const int* taps = desc + 7 + kPhases;
  for (int ph = 0; ph < kPhases; ++ph) {
    g.ntaps[ph] = desc[7 + ph];
    if (g.ntaps[ph] < 1 || g.ntaps[ph] > kMaxTaps) return cudaErrorInvalidValue;
    for (int t = 0; t < kMaxTaps; ++t) {
      const int* tap = taps + 3 * (ph * kMaxTaps + t);
      g.dy[ph][t] = tap[0], g.dx[ph][t] = tap[1], g.slot[ph][t] = tap[2];
      if (t < g.ntaps[ph] && (tap[2] < 0 || tap[2] >= nslots)) return cudaErrorInvalidValue;
    }
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  const float *wf = static_cast<const float*>(w), *bf = static_cast<const float*>(b);
  if (dtype == esn::kF32) {
    const bool vec = g.ci % 4 == 0 && esn::aligned16(x);
    return dispatch(static_cast<const float*>(x), wf, bf, o, g, co_pad, nslots, vec, st);
  }
  if (dtype == esn::kBF16) {
    const bool vec = g.ci % 8 == 0 && esn::aligned16(x);
    return dispatch(static_cast<const __nv_bfloat16*>(x), wf, bf, o, g, co_pad, nslots, vec,
                    st);
  }
  return cudaErrorInvalidValue;
}
