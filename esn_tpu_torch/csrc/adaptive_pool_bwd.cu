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
// its elements v = g / kh / kw, the two divisions in the accumulation type
// as torch's backward takes them. Each input element sums the v of the
// bins that hold it, rows of bins outer and columns inner, each ascending,
// in f32 (f64 for an f64 tensor), from 0, and rounds once. That order is
// a function of the element's bins alone: no tile or grid size enters it.
//
// What bounds it on an H100: it reads g once and writes gx once; PPM's
// bins are at most 6 x 6, so gx is nearly all of it (Fast-SCNN's 1/32 map
// at config 5: (8, 128, 32, 64) f32, 8.4 MB, ~2.5 us at 3.35 TB/s), and
// the arithmetic (an add a term) is small. So bytes, and at these sizes
// a launch's own few microseconds; a loop of such launches from Python
// runs at the wrapper's host time a call, which is larger.
//
// Design: a block owns one image's input row y, a band of xb columns and
// cb channels. Its threads first divide each bin value it needs once into
// shared memory, v[a][b][ch] for the bins a that hold y and the bins b
// that hold the band's columns (PPM: at most 2 x 6 x 128 f32, 6 KB). The
// bins that hold each row and column (first bin, count) and each bin's
// size come from per-axis tables of 32-bit ints, built on the host and
// kept on the card per shape (pool_tables in
// ops/kernels/adaptive_pool_bwd.py); no bin edge is computed here. Then
// each thread sums its elements from shared memory and stores: in
// channels_last a vector of 16 bytes of one pixel's channels (4 f32, 8
// bf16, 2 f64) where the channels allow it, in NCHW one element, the
// columns of a row on consecutive threads. Index math is 32-bit inside a
// block, from a 64-bit base.
#include "gather_bwd.cuh"

namespace {

// The plan, ints from the host in this order (pool_plan).
struct Plan {
  int xb;    // input columns a block
  int cb;    // channels a block
  int vec;   // channels a thread (16 bytes of them), or 1
  int nbb;   // the most bins of columns a block holds
  int smem;  // dynamic shared memory, bytes
};
constexpr int kPlanInts = 5;
constexpr int kThreads = 256;

// 16 bytes of a thread's sums, rounded to T
__device__ __forceinline__ void store16(float* p, const float* a) {
  *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* a) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(esn::pack_bf16(a[0], a[1]), esn::pack_bf16(a[2], a[3]),
                 esn::pack_bf16(a[4], a[5]), esn::pack_bf16(a[6], a[7]));
}
__device__ __forceinline__ void store16(double* p, const double* a) {
  *reinterpret_cast<double2*>(p) = make_double2(a[0], a[1]);
}

// tables of an axis of `len` over n bins: first[len], count[len], size[n]
struct Bins {
  const int* t;
  int len;
  __device__ __forceinline__ int first(int i) const { return __ldg(t + i); }
  __device__ __forceinline__ int count(int i) const { return __ldg(t + len + i); }
  __device__ __forceinline__ int size(int a) const { return __ldg(t + 2 * len + a); }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
pool_bwd_kernel(const T* __restrict__ g, T* __restrict__ gx, Bins bh, Bins bw, int c, int oh,
                int ow, bool cl, Plan pl, int nxb, int ncb) {
  using A = typename esn::AccOf<T>::type;
  constexpr int kVec = 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  A* v = reinterpret_cast<A*>(smem);
  const int tid = threadIdx.x;
  const int h = bh.len, w = bw.len;
  int bid = blockIdx.x;
  const int kc = bid % ncb;
  bid /= ncb;
  const int kx = bid % nxb;
  bid /= nxb;
  const int y = bid % h, n = bid / h;
  const int xa = kx * pl.xb, xe = min(w, xa + pl.xb), nx = xe - xa;
  const int c0 = kc * pl.cb, nc = min(c, c0 + pl.cb) - c0;
  const int a0 = bh.first(y), na = bh.count(y);
  const int b0 = bw.first(xa), nb = bw.first(xe - 1) + bw.count(xe - 1) - b0;

  // v[a][b][ch]: each bin value this block reads, divided once
  const int64_t g0 = cl ? esn::pixel_offset(n, a0, b0, oh, ow, c) + c0
                        : esn::pixel_offset(n * c + c0, a0, b0, oh, ow, 1);
  for (int k = tid; k < na * nb * nc; k += kThreads) {
    const int ch = k % nc, r = k / nc, b = r % nb, a = r / nb;
    const int64_t at = cl ? g0 + ((int64_t)a * ow + b) * c + ch
                          : g0 + ((int64_t)ch * oh + a) * ow + b;
    v[k] = esn::load_acc(g + at) / (A)bh.size(a0 + a) / (A)bw.size(b0 + b);
  }
  __syncthreads();

  if (cl) {
    const int64_t out0 = esn::pixel_offset(n, y, xa, h, w, c) + c0;
    if (pl.vec == kVec) {
      const int per = nc / kVec;
      for (int it = tid; it < nx * per; it += kThreads) {
        const int xl = it / per, ch = (it - xl * per) * kVec;
        const int fb = bw.first(xa + xl) - b0, cnt = bw.count(xa + xl);
        A acc[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[e] = (A)0;
        for (int a = 0; a < na; ++a)
          for (int b = fb; b < fb + cnt; ++b) {
            const A* src = v + (a * nb + b) * nc + ch;
#pragma unroll
            for (int e = 0; e < kVec; ++e) acc[e] += src[e];
          }
        store16(gx + out0 + xl * c + ch, acc);
      }
    } else {
      for (int it = tid; it < nx * nc; it += kThreads) {
        const int xl = it / nc, ch = it - xl * nc;
        const int fb = bw.first(xa + xl) - b0, cnt = bw.count(xa + xl);
        A acc = (A)0;
        for (int a = 0; a < na; ++a)
          for (int b = fb; b < fb + cnt; ++b) acc += v[(a * nb + b) * nc + ch];
        esn::store_acc(gx + out0 + xl * c + ch, acc);
      }
    }
  } else {
    const int64_t out0 = esn::pixel_offset(n * c + c0, y, xa, h, w, 1);
    const int64_t plane = (int64_t)h * w;
    for (int it = tid; it < nc * nx; it += kThreads) {
      const int ch = it / nx, xl = it - ch * nx;
      const int fb = bw.first(xa + xl) - b0, cnt = bw.count(xa + xl);
      A acc = (A)0;
      for (int a = 0; a < na; ++a)
        for (int b = fb; b < fb + cnt; ++b) acc += v[(a * nb + b) * nc + ch];
      esn::store_acc(gx + out0 + ch * plane + xl, acc);
    }
  }
}

template <typename T>
int launch(const T* g, T* gx, int n, int c, int h, int w, int oh, int ow, const int* th,
           const int* tw, const Plan& pl, bool cl, cudaStream_t st) {
  constexpr int kVec = 16 / (int)sizeof(T);
  if (pl.xb < 1 || pl.cb < 1 || pl.nbb < 1 || (pl.vec != 1 && pl.vec != kVec) ||
      (pl.vec == kVec && (!cl || pl.cb % kVec || c % kVec || !esn::aligned16(gx))))
    return cudaErrorInvalidValue;
  const int nxb = (w + pl.xb - 1) / pl.xb, ncb = (c + pl.cb - 1) / pl.cb;
  const int64_t blocks = (int64_t)n * h * nxb * ncb;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  static int allowed = 0;
  if (const int err = esn::allow_smem(pool_bwd_kernel<T>, pl.smem, allowed)) return err;
  pool_bwd_kernel<T><<<(unsigned)blocks, kThreads, pl.smem, st>>>(
      g, gx, Bins{th, h}, Bins{tw, w}, c, oh, ow, cl, pl, nxb, ncb);
  return cudaGetLastError();
}

}  // namespace

// g (n, c, oh, ow) and gx (n, c, h, w), both NCHW or both NHWC; desc:
// int64s (the wrapper's _desc): dtype (0 f32, 1 bf16, 2 f64), n, c, h, w,
// oh, ow, channels_last, the device tables of H and of W (int32: the first
// bin and the count of bins that hold each index, then each bin's size),
// then kPlanInts plan ints (pool_plan).
extern "C" int esn_adaptive_pool_bwd(const void* g, void* gx, const int64_t* desc,
                                     void* stream) {
  if (!desc) return cudaErrorInvalidValue;
  const int dtype = (int)desc[0], n = (int)desc[1], c = (int)desc[2], h = (int)desc[3],
            w = (int)desc[4], oh = (int)desc[5], ow = (int)desc[6];
  const bool cl = desc[7] != 0;
  const int* bins_h = reinterpret_cast<const int*>(desc[8]);
  const int* bins_w = reinterpret_cast<const int*>(desc[9]);
  if (n < 1 || c < 1 || h < 1 || w < 1 || oh < 1 || ow < 1 || !bins_h || !bins_w)
    return cudaErrorInvalidValue;
  Plan pl;
  int* fields = &pl.xb;
  for (int i = 0; i < kPlanInts; ++i) fields[i] = (int)desc[10 + i];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == esn::kF32)
    return launch(static_cast<const float*>(g), static_cast<float*>(gx), n, c, h, w, oh, ow,
                  bins_h, bins_w, pl, cl, st);
  if (dtype == esn::kBF16)
    return launch(static_cast<const __nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(gx), n, c,
                  h, w, oh, ow, bins_h, bins_w, pl, cl, st);
  if (dtype == esn::kF64)
    return launch(static_cast<const double*>(g), static_cast<double*>(gx), n, c, h, w, oh, ow,
                  bins_h, bins_w, pl, cl, st);
  return cudaErrorInvalidValue;
}
