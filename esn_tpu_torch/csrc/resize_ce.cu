// Fused bilinear x r upsample + class-weighted cross-entropy sums, forward
// and backward (the training loss tail).
//
// Replaces the TPU kernels of esn_tpu/ops/pallas/resize_ce.py
// (`resize_ce_sums`: forward `_fwd_kernel`, backward `_bwd_kernel`). For
// low-res logits z (B, h, w, C) f32 NHWC and labels (B, h*r, w*r) int32:
//   forward   S = sum_i w_i * nll_i,  N = sum_i w_i   over full-res pixels i
//             (w_i = class_weights[y_i] where y_i is valid, else 0; nll with
//             label smoothing eps: (1-eps)*(lse - z_y) + eps*(lse - mean_c z))
//   backward  dz = gS * U^T (w * (softmax - (1-eps)*onehot - eps/C))
// where U is the half-pixel bilinear x r upsample with edge taps clamped
// (torch align_corners=False; the Pallas kernel's _fracs/_expand_matrix).
// Neither pass writes a (B, H, W, C) tensor: full-res logits and their
// cotangent never exist.
//
// Taps: full-res row Y = r*i + p blends rows (lo, hi) = (i-1, i) when
// d = (p+0.5)/r - 0.5 < 0 (weight f = 1+d on hi) and (i, i+1) otherwise
// (f = d), clamped to [0, h); columns the same. f and 1-f are computed in
// double on the host and rounded once to f32, as in K1 (resize_argmax.cu).
//
// What bounds it on an H100, at Fast-SCNN's batch 8 (z (8,128,256,19),
// r = 8): the forward must read 67 MB of int32 labels and 20 MB of logits
// (26 us at 3.35 TB/s), and takes 16.7M pixels x 19 classes of exp
// (0.32 G exp, ~0.1 ms of the SFUs) plus the interpolation FMAs and the
// tap loads from L1. So it is bound by arithmetic and L1, not by HBM.
//
// Forward design: one thread per full-res pixel in a grid-stride loop
// (neighbouring threads on neighbouring columns: label reads coalesce,
// the r threads that share a source column read the same logits from
// L1). One pass over classes with an online logsumexp (one exp per class).
// Each block reduces its threads' sums in double into a per-block slot of
// a scratch buffer; a second one-block kernel sums the slots in a fixed
// order. The grid depends only on the shape, so two runs give
// bit-identical S and N; there are no float atomics.
//
// Backward design (a): one thread per low-res pixel (b, i, j) gathers
// from the full-res pixels that tap it (rows and columns within one
// low-res cell of it, at most 2r x 2r with a nonzero weight), recomputing
// each pixel's logsumexp, and accumulates its C gradients in registers
// (classes in chunks of CMAX). Each dz element has one writer, so the
// result is deterministic and needs no slabs, atomics or clamp fold: the
// clamped taps simply carry both weights to the edge row. Cost: each
// full-res pixel is visited by the 4 low-res pixels that tap it, with two
// passes over classes, about 8x the forward's class evaluations.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFactor = 16;
constexpr int kMaxFwdBlocks = 4096;

// per sub-pixel phase: is the upper tap at +1 (else at 0, the lower at -1),
// and the f32 weights on the upper and the lower tap
struct Phases {
  int upper_next[kMaxFactor];
  float frac[kMaxFactor];
  float frac_lo[kMaxFactor];
};

struct Tap {
  int lo, hi;
  float f, f_lo;
};

__device__ __forceinline__ Tap tap(int Y, int r, int h, const Phases& ph) {
  const int i = Y / r, p = Y - i * r;
  Tap t;
  t.lo = ph.upper_next[p] ? i : max(i - 1, 0);
  t.hi = ph.upper_next[p] ? min(i + 1, h - 1) : i;
  t.f = ph.frac[p];
  t.f_lo = ph.frac_lo[p];
  return t;
}

// the weight that tap t puts on low-res index i
__device__ __forceinline__ float tap_weight(const Tap& t, int i) {
  return (t.lo == i ? t.f_lo : 0.f) + (t.hi == i ? t.f : 0.f);
}

// the four source pixels of one full-res pixel and its two blend weights
struct Pixel {
  const float *lo_a, *hi_a, *lo_b, *hi_b;
  float f, g;
  __device__ __forceinline__ float logit(int k) const {
    const float va = fmaf(f, hi_a[k] - lo_a[k], lo_a[k]);
    const float vb = fmaf(f, hi_b[k] - lo_b[k], lo_b[k]);
    return fmaf(g, vb - va, va);
  }
};

__device__ __forceinline__ Pixel pixel(const float* img, int w, int c,
                                       const Tap& ty, const Tap& tx) {
  Pixel px;
  px.lo_a = img + ((int64_t)ty.lo * w + tx.lo) * c;
  px.hi_a = img + ((int64_t)ty.hi * w + tx.lo) * c;
  px.lo_b = img + ((int64_t)ty.lo * w + tx.hi) * c;
  px.hi_b = img + ((int64_t)ty.hi * w + tx.hi) * c;
  px.f = ty.f;
  px.g = tx.f;
  return px;
}

// online logsumexp over classes; also the true-class logit and the sum
__device__ __forceinline__ float logsumexp(const Pixel& px, int c, int y,
                                           float* true_logit, float* sum) {
  float m = -INFINITY, s = 0.f, vt = 0.f, vs = 0.f;
  for (int k = 0; k < c; ++k) {
    const float v = px.logit(k);
    if (v > m) {
      s = s * expf(m - v) + 1.f;
      m = v;
    } else {
      s += expf(v - m);
    }
    vt = k == y ? v : vt;
    vs += v;
  }
  if (true_logit) *true_logit = vt;
  if (sum) *sum = vs;
  return m + logf(s);
}

__device__ __forceinline__ bool valid_label(int y, int c, int ignore) {
  return y != ignore && y >= 0 && y < c;
}

// sum over the block in double, in a fixed order; the result in thread 0
__device__ __forceinline__ double block_sum(double v, double* smem) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  v = 0.0;
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? smem[lane] : 0.0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

int fwd_blocks(int n, int h, int w, int r) {
  const int64_t total = (int64_t)n * h * r * w * r;
  const int64_t want = (total + kThreads - 1) / kThreads;
  return (int)(want < kMaxFwdBlocks ? want : kMaxFwdBlocks);
}

__global__ void __launch_bounds__(kThreads)
resize_ce_fwd_kernel(const float* __restrict__ z, const int* __restrict__ lab,
                     const float* __restrict__ cw, double* __restrict__ partial,
                     int n, int h, int w, int c, int r, int ignore, float eps,
                     Phases ph) {
  __shared__ double smem[kThreads / 32];
  const int64_t W = (int64_t)w * r, H = (int64_t)h * r;
  const int64_t total = (int64_t)n * H * W;
  double acc_s = 0.0, acc_n = 0.0;
  for (int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
       idx < total; idx += (int64_t)gridDim.x * kThreads) {
    const int y = lab[idx];
    if (!valid_label(y, c, ignore)) continue;
    const int X = (int)(idx % W);
    const int64_t t = idx / W;
    const int Y = (int)(t % H);
    const int b = (int)(t / H);
    const Pixel px = pixel(z + (int64_t)b * h * w * c, w, c, tap(Y, r, h, ph),
                           tap(X, r, w, ph));
    float vt, vs;
    const float lse = logsumexp(px, c, y, &vt, &vs);
    float nll = lse - vt;
    if (eps > 0.f) nll = (1.f - eps) * nll + eps * (lse - vs / c);
    const float wpix = cw[y];
    acc_s += (double)(wpix * nll);
    acc_n += (double)wpix;
  }
  acc_s = block_sum(acc_s, smem);
  acc_n = block_sum(acc_n, smem);
  if (threadIdx.x == 0) {
    partial[2 * blockIdx.x] = acc_s;
    partial[2 * blockIdx.x + 1] = acc_n;
  }
}

__global__ void __launch_bounds__(kThreads)
resize_ce_finish_kernel(const double* __restrict__ partial, int blocks,
                        float* __restrict__ s_out, float* __restrict__ n_out) {
  __shared__ double smem[kThreads / 32];
  double s = 0.0, n = 0.0;
  for (int i = threadIdx.x; i < blocks; i += kThreads) {
    s += partial[2 * i];
    n += partial[2 * i + 1];
  }
  s = block_sum(s, smem);
  n = block_sum(n, smem);
  if (threadIdx.x == 0) {
    *s_out = (float)s;
    *n_out = (float)n;
  }
}

template <int CMAX>
__global__ void __launch_bounds__(kThreads)
resize_ce_bwd_kernel(const float* __restrict__ z, const int* __restrict__ lab,
                     const float* __restrict__ cw,
                     const float* __restrict__ g_s, float* __restrict__ dz,
                     int n, int h, int w, int c, int r, int ignore, float eps,
                     Phases ph) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (int64_t)n * h * w) return;
  const int j = (int)(idx % w);
  const int64_t t = idx / w;
  const int i = (int)(t % h);
  const int b = (int)(t / h);
  const int H = h * r, W = w * r;
  const float* img = z + (int64_t)b * h * w * c;
  const int* limg = lab + (int64_t)b * H * W;
  const float gs = *g_s, eps_c = eps / c, hot = 1.f - eps;
  // full-res rows and columns whose taps can reach low-res (i, j)
  const int Y0 = max((i - 1) * r, 0), Y1 = min((i + 2) * r, H);
  const int X0 = max((j - 1) * r, 0), X1 = min((j + 2) * r, W);
  for (int k0 = 0; k0 < c; k0 += CMAX) {
    float acc[CMAX];
#pragma unroll
    for (int kk = 0; kk < CMAX; ++kk) acc[kk] = 0.f;
    for (int Y = Y0; Y < Y1; ++Y) {
      const Tap ty = tap(Y, r, h, ph);
      const float wy = tap_weight(ty, i);
      if (wy == 0.f) continue;
      for (int X = X0; X < X1; ++X) {
        const Tap tx = tap(X, r, w, ph);
        const float wx = tap_weight(tx, j);
        if (wx == 0.f) continue;
        const int y = limg[(int64_t)Y * W + X];
        if (!valid_label(y, c, ignore)) continue;
        const Pixel px = pixel(img, w, c, ty, tx);
        const float lse = logsumexp(px, c, y, nullptr, nullptr);
        const float coef = gs * cw[y] * (wy * wx);
#pragma unroll
        for (int kk = 0; kk < CMAX; ++kk) {
          const int k = k0 + kk;
          if (k < c) {
            const float p = expf(px.logit(k) - lse);
            acc[kk] = fmaf(coef, p - (k == y ? hot : 0.f) - eps_c, acc[kk]);
          }
        }
      }
    }
    float* out = dz + idx * c + k0;
#pragma unroll
    for (int kk = 0; kk < CMAX; ++kk)
      if (k0 + kk < c) out[kk] = acc[kk];
  }
}

Phases make_phases(int r) {
  Phases ph{};
  for (int p = 0; p < r; ++p) {
    // the Pallas kernel's _fracs in double, each weight rounded once to f32
    const double d = (p + 0.5) / r - 0.5;
    const double f = d < 0 ? 1.0 + d : d;
    ph.upper_next[p] = d >= 0;
    ph.frac[p] = (float)f;
    ph.frac_lo[p] = (float)(1.0 - f);
  }
  return ph;
}

}  // namespace

// Number of forward blocks (and of (S, N) partial pairs the scratch buffer
// must hold) for this shape.
extern "C" int esn_resize_ce_fwd_blocks(int n, int h, int w, int r) {
  return fwd_blocks(n, h, w, r);
}

// z (n, h, w, c) f32 contiguous; lab (n, h*r, w*r) int32; cw (c,) f32;
// partial: 2 * esn_resize_ce_fwd_blocks(...) doubles of scratch; s_out,
// n_out: one f32 each. Requires 2 <= r <= 16.
extern "C" int esn_resize_ce_fwd(const void* z, const void* lab, const void* cw,
                                 void* partial, void* s_out, void* n_out,
                                 int n, int h, int w, int c, int r, int ignore,
                                 float eps, void* stream) {
  if (r < 2 || r > kMaxFactor || c < 1 || n < 1 || h < 1 || w < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = fwd_blocks(n, h, w, r);
  resize_ce_fwd_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const float*>(z), static_cast<const int*>(lab),
      static_cast<const float*>(cw), static_cast<double*>(partial), n, h, w, c,
      r, ignore, eps, make_phases(r));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  resize_ce_finish_kernel<<<1, kThreads, 0, st>>>(
      static_cast<const double*>(partial), blocks, static_cast<float*>(s_out),
      static_cast<float*>(n_out));
  return cudaGetLastError();
}

// As esn_resize_ce_fwd, plus g_s: one f32 on the device (the cotangent of
// S), and dz (n, h, w, c) f32, every element written.
extern "C" int esn_resize_ce_bwd(const void* z, const void* lab, const void* cw,
                                 const void* g_s, void* dz, int n, int h, int w,
                                 int c, int r, int ignore, float eps,
                                 void* stream) {
  if (r < 2 || r > kMaxFactor || c < 1 || n < 1 || h < 1 || w < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t total = (int64_t)n * h * w;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  const Phases ph = make_phases(r);
  const float* zf = static_cast<const float*>(z);
  const int* lb = static_cast<const int*>(lab);
  const float* cwf = static_cast<const float*>(cw);
  const float* gs = static_cast<const float*>(g_s);
  float* out = static_cast<float*>(dz);
  if (c <= 8)
    resize_ce_bwd_kernel<8><<<blocks, kThreads, 0, st>>>(
        zf, lb, cwf, gs, out, n, h, w, c, r, ignore, eps, ph);
  else if (c <= 16)
    resize_ce_bwd_kernel<16><<<blocks, kThreads, 0, st>>>(
        zf, lb, cwf, gs, out, n, h, w, c, r, ignore, eps, ph);
  else if (c <= 24)
    resize_ce_bwd_kernel<24><<<blocks, kThreads, 0, st>>>(
        zf, lb, cwf, gs, out, n, h, w, c, r, ignore, eps, ph);
  else
    resize_ce_bwd_kernel<32><<<blocks, kThreads, 0, st>>>(
        zf, lb, cwf, gs, out, n, h, w, c, r, ignore, eps, ph);
  return cudaGetLastError();
}
