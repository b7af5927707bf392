// Fused bilinear x r upsample + class argmax (the prediction tail).
//
// Replaces the TPU kernel esn_tpu/ops/pallas/resize_argmax.py
// (`resize_argmax`, Pallas kernel `_kernel`): for low-res logits y of shape
// (B, h, w, C), NHWC, it writes the int32 map (B, r*h, r*w) of the
// first-max argmax over classes of the f32 half-pixel bilinear upsample
// (torch align_corners=False, edge taps clamped). Full-resolution logits
// never exist.
//
// Arithmetic, matched to the Pallas kernel: output row r*i+p takes the
// 2-tap vertical blend `lo + f*(hi-lo)` of rows (i-1, i) when
// d = (p+0.5)/r - 0.5 < 0 (f = 1+d) and of rows (i, i+1) otherwise
// (f = d), rows clamped to [0, h); the horizontal blend is the same
// formula over columns, applied to the vertical results. The compare over
// classes is a strict `>`, so ties go to the first class.
//
// What bounds it on an H100: the int32 writes. At Fast-SCNN's batch 8
// (r = 8, 1024 x 2048 output) it writes 67 MB and reads 10 MB of bf16
// logits, ~20 us at full bandwidth. Design: one thread per output pixel;
// neighbouring threads hold neighbouring output columns, so the writes
// coalesce and the r threads that share a source column read the same
// logits (served by L1). A pixel's C logits are contiguous in NHWC.
#include "common.cuh"

namespace {

using esn::to_f32;

constexpr int kThreads = 256;
constexpr int kMaxFactor = 8;

// per sub-pixel phase: does the upper tap sit at +1 (else at 0, with the
// lower tap at -1), and the f32 weight on the upper tap
struct Phases {
  int upper_next[kMaxFactor];
  float frac[kMaxFactor];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
resize_argmax_kernel(const T* __restrict__ y, int* __restrict__ out, int n,
                     int h, int w, int c, int r, Phases ph) {
  const int64_t W = (int64_t)w * r, H = (int64_t)h * r;
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (int64_t)n * H * W) return;
  const int X = (int)(idx % W);
  const int64_t t = idx / W;
  const int Y = (int)(t % H);
  const int b = (int)(t / H);

  const int i = Y / r, p = Y - i * r;
  const int row_lo = ph.upper_next[p] ? i : max(i - 1, 0);
  const int row_hi = ph.upper_next[p] ? min(i + 1, h - 1) : i;
  const float f = ph.frac[p];
  const int j = X / r, q = X - j * r;
  const int col_a = ph.upper_next[q] ? j : max(j - 1, 0);
  const int col_b = ph.upper_next[q] ? min(j + 1, w - 1) : j;
  const float g = ph.frac[q];

  const T* img = y + (int64_t)b * h * w * c;
  const T* lo_a = img + ((int64_t)row_lo * w + col_a) * c;
  const T* hi_a = img + ((int64_t)row_hi * w + col_a) * c;
  const T* lo_b = img + ((int64_t)row_lo * w + col_b) * c;
  const T* hi_b = img + ((int64_t)row_hi * w + col_b) * c;

  float best = 0.f;
  int arg = 0;
  for (int k = 0; k < c; ++k) {
    const float la = to_f32(lo_a[k]), ha = to_f32(hi_a[k]);
    const float lb = to_f32(lo_b[k]), hb = to_f32(hi_b[k]);
    const float va = fmaf(f, ha - la, la);
    const float vb = fmaf(f, hb - lb, lb);
    const float v = fmaf(g, vb - va, va);
    if (k == 0 || v > best) {
      best = v;
      arg = k;
    }
  }
  out[idx] = arg;
}

}  // namespace

// y (n, h, w, c) of dtype `dtype` contiguous; out (n, r*h, r*w) int32.
// Requires 1 <= r <= 8.
extern "C" int esn_resize_argmax(const void* y, void* out, int dtype, int n,
                                 int h, int w, int c, int r, void* stream) {
  if (r < 1 || r > kMaxFactor || c < 1) return cudaErrorInvalidValue;
  Phases ph{};
  for (int p = 0; p < r; ++p) {
    // same double-precision formula as the Pallas kernel's _fracs, rounded
    // once to f32
    const double d = (p + 0.5) / r - 0.5;
    ph.upper_next[p] = d >= 0;
    ph.frac[p] = (float)(d < 0 ? 1.0 + d : d);
  }
  const int64_t total = (int64_t)n * h * r * w * r;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == esn::kF32)
    resize_argmax_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(y), static_cast<int*>(out), n, h, w, c, r, ph);
  else if (dtype == esn::kBF16)
    resize_argmax_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(y), static_cast<int*>(out), n, h, w, c, r, ph);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
