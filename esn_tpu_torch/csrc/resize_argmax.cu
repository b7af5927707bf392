// Fused bilinear x r upsample + class argmax (the prediction tail).
//
// Replaces the TPU kernel esn_tpu/ops/pallas/resize_argmax.py
// (`resize_argmax`, Pallas kernel `_kernel`): for low-res logits y of shape
// (B, h, w, C), NHWC, bf16 or f32, it writes the int32 map (B, r*h, r*w) of
// the first-max argmax over classes of the f32 half-pixel bilinear upsample
// (torch align_corners=False, edge taps clamped). Full-resolution logits
// never exist, and the map is written in place (no depth-to-space step).
//
// Arithmetic: full-res pixel (r*i+p, r*j+q) lerps each of its two tap rows
// along x, `lo + g*(hi-lo)` over its two tap columns (weight g of phase q),
// then the two results along y (weight f of phase p), in f32, with the
// host's tap tables (common.cuh: Phases). The Pallas kernel blends y first;
// the two orders are an f32 re-association of the same separable
// interpolation, which its docstring allows (near-tie pixels may differ).
// The compare over classes is a strict `>`, so ties go to the first class.
//
// What bounds it on an H100: at Fast-SCNN's batch 8 (y (8,128,256,19), r =
// 8) it writes 67 MB of int32 and reads 10 MB of bf16 logits, 23 us at
// 3.35 TB/s; its 0.32 G (pixel, class) steps of one FMA and a compare and
// select take ~4 instructions each, ~45 us at one instruction a lane a
// clock. So the arithmetic, not HBM, is what it can be held to.
//
// Design (the band walk of common.cuh, shared with resize_ce.cu): one
// 256-thread block per (image, band of kBand low-res rows, tile of wb ~
// 256/r low-res columns); the band's logits and the clamp halo go to shared
// memory once with 16-byte cp.async, in y's own dtype. Each thread owns one
// full-res column: per tap row it lerps the column's logits along x once
// into registers (C <= kRegClasses; above, each logit is lerped from shared
// memory), then walks down the column two full-res rows at a time, one FMA
// a class for the y-blend and a compare chain, and stores int32 coalesced
// across the warp. No division by r and no 64-bit div/mod per pixel. The
// first design (one thread per output pixel, four scalar global loads a
// class, the x-blend redone for every row) ran at ~20x the bytes' bound.
#include "common.cuh"

namespace {

using esn::kBand;
constexpr int kThreads = esn::kBandThreads;
constexpr int kMaxFactor = 8;
// classes kept in registers (C <= 20 pays for 20); more are read from
// shared memory
constexpr int kRegClasses = 20;

// first-max argmax over classes of two pixels of the column (y-weights fa,
// fb): two compare chains in flight
template <typename Col>
__device__ __forceinline__ void argmax_pair(const Col& col, float fa, float fb, int& aa, int& ab) {
  const int n = Col::kCMax > 0 ? Col::kCMax : col.c;
  float ba = col.logit(0, fa), bb = col.logit(0, fb);
  aa = ab = 0;
#pragma unroll(Col::kN)
  for (int k = 1; k < n; ++k) {
    const float va = col.logit(k, fa), vb = col.logit(k, fb);
    if (va > ba) ba = va, aa = k;
    if (vb > bb) bb = vb, ab = k;
  }
}

template <typename T, int CMAX>
__global__ void __launch_bounds__(kThreads, 3)
resize_argmax_kernel(const T* __restrict__ y, int* __restrict__ out, int h, int w, int c,
                     int r, int wb, esn::Phases ph) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  T* ys = reinterpret_cast<T*>(smem_bytes);
  __shared__ int shift[kBand + 2];
  const int tid = threadIdx.x;
  const int nband = (h + kBand - 1) / kBand, ncol = (w + wb - 1) / wb;
  const int ct = blockIdx.x % ncol;
  const int band = (blockIdx.x / ncol) % nband;
  const int b = blockIdx.x / (ncol * nband);
  const int i0 = band * kBand, j0 = ct * wb;
  const int rows = min(kBand, h - i0), cols = min(wb, w - j0);
  const int stride = esn::band_stride<T>(wb, c);
  esn::stage_band(ys, shift, y, b, h, w, c, i0, j0, wb, stride, esn::aligned16(y), tid);
  esn::cp_async_commit();
  esn::cp_async_wait_all();
  __syncthreads();

  const int jj = tid / r, px = tid - jj * r;  // this thread's full-res column
  if (jj >= cols) return;                     // no barrier follows
  const int64_t W = (int64_t)w * r;
  int* ocol = out + ((int64_t)b * h * r + (int64_t)i0 * r) * W + (int64_t)j0 * r + tid;
  esn::BandColumn<T, CMAX> col;
  col.s = ys;
  col.shift = shift;
  col.stride = stride;
  col.off = (jj + ph.upper_next[px]) * c;
  col.c = c;
  col.fx = ph.frac[px];
  esn::walk_column(col, rows, r, ph, [&](int Y, float fa, float fb, bool two) {
    int aa, ab;
    argmax_pair(col, fa, fb, aa, ab);
    // both stores unconditional (a branch would serialise the two pixels'
    // chains): without a second row, row Y gets its own class again
    ocol[Y * W] = aa;
    ocol[(Y + (two ? 1 : 0)) * W] = two ? ab : aa;
  });
}

template <typename T>
int launch(const T* y, int* out, int n, int h, int w, int c, int r, cudaStream_t st) {
  const int wb = esn::band_cols<T>(w, c, r);
  const size_t bytes = esn::band_bytes<T>(wb, c);
  if (bytes > (size_t)esn::kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = c <= kRegClasses ? resize_argmax_kernel<T, kRegClasses>
                                 : resize_argmax_kernel<T, 0>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int blocks = n * ((h + kBand - 1) / kBand) * ((w + wb - 1) / wb);
  kernel<<<blocks, kThreads, bytes, st>>>(y, out, h, w, c, r, wb, esn::make_phases(r));
  return cudaGetLastError();
}

}  // namespace

// y (n, h, w, c) of dtype `dtype` contiguous; out (n, r*h, r*w) int32.
// Requires 1 <= r <= 8 and a band of c classes that fits in shared memory.
extern "C" int esn_resize_argmax(const void* y, void* out, int dtype, int n,
                                 int h, int w, int c, int r, void* stream) {
  if (r < 1 || r > kMaxFactor || c < 1 || n < 1 || h < 1 || w < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  if (dtype == esn::kF32)
    return launch(static_cast<const float*>(y), o, n, h, w, c, r, st);
  if (dtype == esn::kBF16)
    return launch(static_cast<const __nv_bfloat16*>(y), o, n, h, w, c, r, st);
  return cudaErrorInvalidValue;
}
