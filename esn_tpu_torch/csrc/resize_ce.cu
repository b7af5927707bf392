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
// double on the host and rounded once to f32 (common.cuh: Phases), as in
// K1 (resize_argmax.cu). Both passes lerp x first, then y, so they see the
// same logits.
//
// What bounds it on an H100, at Fast-SCNN's batch 8 (z (8,128,256,19),
// r = 8): the forward must read 67 MB of int32 labels and 20 MB of logits
// (26 us at 3.35 TB/s), and takes 16.7M pixels x 19 classes of exp: 0.32 G
// exp, ~0.08 ms at the SFUs' 16 a clock an SM, above the 27 us that
// chip_smoke.py's bound gives by counting an exp as one f32 operation. The
// backward moves 67 MB of labels, 20 MB of z and 20 MB of dz (107 MB, 32
// us) for ~2.7 GFLOP (upsample, softmax, gradient and its transposed
// upsample, 9 per valid (pixel, class), as chip_smoke.py counts them: 41
// us at the f32 peak), so its bound is ~0.04 ms, set by the arithmetic
// about as much as by HBM.
//
// Both passes tile as the band walk of common.cuh: one block of 256
// threads per (image, band of kBand low-res rows, tile of wb low-res
// columns, wb ~ 256/r so that a thread owns one full-res column); the
// logits of low-res rows i0-1 .. i0+kBand and columns j0-1 .. j0+wb
// (clamped to the image, which is the upsample's edge clamp) go to shared
// memory once with 16-byte cp.async copies (stage_band).
//
// Forward design: each thread lerps its column's logits along x once per
// tap row, then walks down its column two full-res rows at a time (two
// pixels' chains in flight), with its labels coalesced across the threads.
// Per tap row it also takes M, the largest logit of either tap row over
// the classes: no pixel blended from the two rows has a larger one, so M
// stands in for the pixel's max in lse = M + ln 2 * log2(sum_k 2^((z_k -
// M) log2 e)) and the max pass goes. It keeps (xa_k - M) log2 e and d_k
// log2 e in registers (up to kRegClasses classes; above, each logit is
// lerped from shared memory), so a (pixel, class) costs one FMA, one
// ex2.approx on the SFU and one add, with no branch. Where a class spreads
// by more than kMaxSpread between the two rows, M could sit so far above a
// pixel's max that its exps underflow: those tap rows take each pixel's
// own max first. The true-class logit is lerped again from shared memory
// (the backward's bits), the class mean comes from the tap rows' sums.
// ex2.approx and lg2.approx are ~2 ulp, far inside the sums' 1e-5
// relative tolerance against the plain version. Each thread sums its
// pixels in f32, the block its threads in double, in a fixed order, into a
// per-block slot of a scratch buffer; a second one-block kernel sums the
// slots in a fixed order. The tiling depends only on the shape: two runs
// give bit-identical S and N; there are no float atomics. The first design
// (one thread per full-res pixel, a 64-bit div/mod each, four scalar
// global loads a class and a branchy online logsumexp with expf/logf) ran
// at ~26x its bound.
//
// Backward design (band, as the TPU kernel's _bwd_kernel), after staging:
//   2. each thread walks down its own full-res column of the band, taking
//      each pixel once: its label (coalesced across the threads, the next
//      row's load in flight), its C logits lerped along y between the
//      column's logits in its two tap rows (lerped along x once per tap
//      row, kept in registers for up to 20 classes), max, one exp per
//      class, and g_k = gS w_y (p_k - (1-eps)[k=y] - eps/C), added with
//      the row's two tap weights into the column's sums for those two
//      low-res rows. No barrier between full-res rows;
//   3. when the tap rows move on, the upper one is complete: the columns'
//      sums for it go to shared memory and one thread per (padded low-res
//      column, class) contracts them along W, summing its 2r source
//      columns in column order with weights from a host table, into that
//      row of a (kBand+2) x (wb+2) x C slab: kBand+2 contractions a band,
//      every value with one writer;
//   4. the slab goes to scratch; a second kernel adds each dz element's
//      (up to 3 x 3) slab entries in a fixed order, edge rows and columns
//      of the clamp folding back onto rows 0, h-1 and columns 0, w-1.
// Each full-res pixel's softmax is evaluated once, the tap tables are the
// host's (no division by r in the loops), there are no float atomics and
// the tiling depends only on the shape: two launches give bit-identical
// dz. Capped at 128 registers, two blocks (16 warps) share an SM; the
// pixels' dependent chain (label, logits, max, exp, sum) is latency-bound
// at that occupancy, ~19x over the bound at Fast-SCNN's shape
// (esn_tpu_torch/tools/kernel_phases.py times the phases). The first
// design (one thread per low-res pixel gathering its 2r x 2r full-res
// pixels) evaluated every (pixel, class) 8 times and ran at ~180x.
#include "common.cuh"

namespace {

using esn::kBand;
using esn::kMaxFactor;
using esn::Phases;
constexpr int kThreads = esn::kBandThreads;

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

// Classes up to which a thread keeps its column's state in registers:
// Cityscapes' 19, CamVid's 11; more take shared memory.
constexpr int kRegClasses = 20;

constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// 2^x and log2(x) on the SFU (ex2.approx.ftz, lg2.approx.ftz: ~2 ulp)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The forward's tiling: wb low-res columns a block (common.cuh: band_cols).
struct FwdPlan {
  int wb, nband, ncol;
  size_t bytes;
  FwdPlan(int h, int w, int c, int r)
      : wb(esn::band_cols<float>(w, c, r)),
        nband((h + kBand - 1) / kBand),
        ncol((w + wb - 1) / wb),
        bytes(esn::band_bytes<float>(wb, c)) {}
};

// Largest spread, in natural-log units, of one class's logits between the
// two tap rows for which the tap rows' largest logit M may stand in for a
// pixel's max: the pixel's largest logit then lies within it of M, so the
// largest term of its sum of exp(z - M) is at least e^-64, far above where
// ex2.approx.ftz flushes to 0 (2^-126 = e^-87.3).
constexpr float kMaxSpread = 64.f;

// A thread's column for the forward: BandColumn's staged logits and, per
// tap row t, M (no pixel blended from rows t and t+1 has a larger logit),
// whether some class spreads more than kMaxSpread between the two rows
// (then each pixel takes its own max), the sums of xa and d over classes
// (for the class mean), and with CMAX > 0 the logits scaled for exp2, a_k
// = (xa_k - M) log2 e and b_k = d_k log2 e, in registers for CMAX classes
// (a = -inf, b = 0 past c: 2^-inf = 0).
template <int CMAX>
struct CeColumn : esn::BandColumn<float, 0> {
  static constexpr int kCMax = CMAX;
  static constexpr int kN = CMAX > 0 ? CMAX : 1;
  float a[kN], b[kN];
  float m, sum_xa, sum_d;
  bool wide;

  __device__ __forceinline__ void load(int row) {
    t = row;
    const int n = CMAX > 0 ? CMAX : c;
    float mx = -INFINITY, spread = 0.f, s0 = 0.f, s1 = 0.f;
#pragma unroll(kN)
    for (int k = 0; k < n; ++k) {  // selects, not branches
      const bool in = k < c;
      const float x0 = xlerp(t, in ? k : 0), dk = xlerp(t + 1, in ? k : 0) - x0;
      mx = in ? fmaxf(mx, fmaxf(x0, x0 + dk)) : mx;
      spread = in ? fmaxf(spread, fabsf(dk)) : spread;
      s0 += in ? x0 : 0.f;
      s1 += in ? dk : 0.f;
      if constexpr (CMAX > 0) a[k] = in ? x0 : -INFINITY, b[k] = in ? dk : 0.f;
    }
    m = mx, sum_xa = s0, sum_d = s1;
    wide = !(spread <= kMaxSpread);
    if constexpr (CMAX > 0) {
#pragma unroll
      for (int k = 0; k < CMAX; ++k) a[k] = (a[k] - m) * kLog2e, b[k] *= kLog2e;
    }
  }
  // (z_k - M) log2 e of class k at y-weight f
  __device__ __forceinline__ float scaled(int k, float f) const {
    if constexpr (CMAX > 0) {
      return fmaf(f, b[k], a[k]);
    } else {
      return (logit_smem(k, f) - m) * kLog2e;
    }
  }
};

// log2 of sum_k 2^(scaled_k) for two pixels (y-weights fa, fb), two sums
// each, the four interleaved: per class one FMA, one ex2 and one add. With
// kWide each pixel first takes its own max, which its sum then leaves out.
template <bool kWide, typename Col>
__device__ __forceinline__ void log2_sums(const Col& col, float fa, float fb, float& la,
                                          float& lb) {
  const int n = Col::kCMax > 0 ? Col::kCMax : col.c;
  float oa = 0.f, ob = 0.f;
  if constexpr (kWide) {
    oa = ob = -INFINITY;
#pragma unroll(Col::kN)
    for (int k = 0; k < n; ++k) {
      oa = fmaxf(oa, col.scaled(k, fa));
      ob = fmaxf(ob, col.scaled(k, fb));
    }
  }
  float sa[2] = {0.f, 0.f}, sb[2] = {0.f, 0.f};
#pragma unroll(Col::kN)
  for (int k = 0; k < n; ++k) {
    if constexpr (kWide) {
      sa[k & 1] += ex2(col.scaled(k, fa) - oa);
      sb[k & 1] += ex2(col.scaled(k, fb) - ob);
    } else {
      sa[k & 1] += ex2(col.scaled(k, fa));
      sb[k & 1] += ex2(col.scaled(k, fb));
    }
  }
  la = oa + lg2(sa[0] + sa[1]);
  lb = ob + lg2(sb[0] + sb[1]);
}

// nll of two pixels of the column (y-weights fa, fb; labels ka, kb, each in
// [0, c)): lse = M + ln 2 * log2(sum_k 2^((z_k - M) log2 e)), nll = lse -
// z_y with z_y lerped again from shared memory (the same bits as the
// backward's), and with eps > 0 (1-eps) nll + eps (lse - mean_k z_k).
template <typename Col>
__device__ __forceinline__ void nll_pair(const Col& col, float fa, float fb, int ka, int kb,
                                         float eps, float& na, float& nb) {
  float la, lb;
  if (col.wide)
    log2_sums<true>(col, fa, fb, la, lb);
  else
    log2_sums<false>(col, fa, fb, la, lb);
  const float lsa = kLn2 * la, lsb = kLn2 * lb;
  na = (col.m - col.logit_smem(ka, fa)) + lsa;
  nb = (col.m - col.logit_smem(kb, fb)) + lsb;
  if (eps > 0.f) {  // lse - mean = (M - mean) + ln 2 log2(sum)
    const float ma = fmaf(fa, col.sum_d, col.sum_xa) / col.c;
    const float mb = fmaf(fb, col.sum_d, col.sum_xa) / col.c;
    na = (1.f - eps) * na + eps * ((col.m - ma) + lsa);
    nb = (1.f - eps) * nb + eps * ((col.m - mb) + lsb);
  }
}

template <int CMAX>
__global__ void __launch_bounds__(kThreads, 3)
resize_ce_fwd_kernel(const float* __restrict__ z, const int* __restrict__ lab,
                     const float* __restrict__ cw, double* __restrict__ partial, int h, int w,
                     int c, int r, int ignore, float eps, int wb, Phases ph) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int zshift[kBand + 2];
  __shared__ double red[kThreads / 32];
  const int tid = threadIdx.x;
  const int nband = (h + kBand - 1) / kBand, ncol = (w + wb - 1) / wb;
  const int ct = blockIdx.x % ncol;
  const int band = (blockIdx.x / ncol) % nband;
  const int b = blockIdx.x / (ncol * nband);
  const int i0 = band * kBand, j0 = ct * wb;
  const int rows = min(kBand, h - i0), cols = min(wb, w - j0);
  const int zstride = esn::band_stride<float>(wb, c);
  esn::stage_band(smem, zshift, z, b, h, w, c, i0, j0, wb, zstride, esn::aligned16(z), tid);
  esn::cp_async_commit();
  esn::cp_async_wait_all();
  __syncthreads();

  const int jj = tid / r, px = tid - jj * r;  // this thread's full-res column
  float acc_s = 0.f, acc_n = 0.f;
  if (jj < cols) {
    const int64_t W = (int64_t)w * r;
    const int* lcol = lab + ((int64_t)b * h * r + (int64_t)i0 * r) * W + (int64_t)j0 * r + tid;
    CeColumn<CMAX> col;
    col.s = smem;
    col.shift = zshift;
    col.stride = zstride;
    col.off = (jj + ph.upper_next[px]) * c;
    col.c = c;
    col.fx = ph.frac[px];
    esn::walk_column(col, rows, r, ph, [&](int Y, float fa, float fb, bool two) {
      const int ya = __ldg(lcol + Y * W);
      const int yb = two ? __ldg(lcol + (Y + 1) * W) : ignore;
      const bool va = valid_label(ya, c, ignore), vb = valid_label(yb, c, ignore);
      float na, nb;
      nll_pair(col, fa, fb, va ? ya : 0, vb ? yb : 0, eps, na, nb);
      const float wa = va ? __ldg(cw + ya) : 0.f, wb_ = vb ? __ldg(cw + yb) : 0.f;
      acc_s += (va ? wa * na : 0.f) + (vb ? wb_ * nb : 0.f);
      acc_n += wa + wb_;
    });
  }
  const double s = block_sum(acc_s, red);
  const double n = block_sum(acc_n, red);
  if (tid == 0) {
    partial[2 * blockIdx.x] = s;
    partial[2 * blockIdx.x + 1] = n;
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

// shared-memory plan of the backward, in floats: staged logits (kBand+2
// rows of zrow, each row shifted so that it shares the 16-byte phase of
// its source), the slab, one row of r*wb pixels (odd stride against bank
// conflicts) that holds each thread's logits while it takes its pixel and
// the columns' sums for the W-contraction, and with more than kRegClasses
// classes each thread's column state (4 rows of c)
struct BwdPlan {
  int wb, zrow, cs, nband, ncol;
  int zs, slab, g, st, floats;
  __host__ __device__ BwdPlan(int h, int w, int c, int r, int wb_) {
    wb = wb_;
    zrow = esn::band_stride<float>(wb, c);
    cs = c | 1;
    nband = (h + kBand - 1) / kBand;
    ncol = (w + wb - 1) / wb;
    zs = 0;
    slab = zs + (kBand + 2) * zrow;
    g = slab + (kBand + 2) * (wb + 2) * c;
    st = g + r * wb * cs;
    floats = st + (c <= kRegClasses ? 0 : 4 * r * wb * cs);
  }
  __host__ __device__ int slab_floats(int c) const { return (kBand + 2) * (wb + 2) * c; }
  __host__ __device__ size_t bytes() const { return (size_t)floats * sizeof(float); }
};

// wb = 256/r low-res columns (a thread per full-res column), fewer where
// w is narrower or shared memory would hold fewer than two blocks
int bwd_cols(int h, int w, int c, int r) {
  int wb = kThreads / r < w ? kThreads / r : w;
  while (wb > 1 && BwdPlan(h, w, c, r, wb).bytes() > (size_t)esn::kSmemTwoBlocks) wb = (wb + 1) / 2;
  return wb;
}

// One full-res pixel of a thread's column: its logits v_k, lerped along y
// (weight fy) between xa and xb (the column's logits lerped along x in
// its two tap rows), max, one exp per class, g_k = gS w_y (p_k -
// (1-eps)[k=y] - eps/C), added with the row weights into lo (upper tap
// row, weight wlo) and hi (lower, fy). __expf: p only enters dz, whose
// tolerance (1e-4 relative) is far above its ~2 ulp. v (c floats of
// shared memory) holds the logits. With N > 0 the other arrays are
// registers (c <= N, loops unrolled) and the max and the sum run as 4
// interleaved chains (classes k mod 4, joined in a fixed order).
template <int N>
__device__ __forceinline__ void pixel_grad(const float* xa, const float* xb, float* lo,
                                           float* hi, float* v, int c, int y, float fy,
                                           float wlo, float coef, float hot, float eps_c) {
  float m, sum;
  if constexpr (N > 0) {
    float m4[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY}, s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (k < c) {
        v[k] = fmaf(fy, xb[k] - xa[k], xa[k]);
        m4[k & 3] = fmaxf(m4[k & 3], v[k]);
      }
    m = fmaxf(fmaxf(m4[0], m4[1]), fmaxf(m4[2], m4[3]));
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (k < c) {
        v[k] = __expf(v[k] - m);
        s4[k & 3] += v[k];
      }
    sum = (s4[0] + s4[1]) + (s4[2] + s4[3]);
  } else {
    m = -INFINITY, sum = 0.f;
    for (int k = 0; k < c; ++k) {
      v[k] = fmaf(fy, xb[k] - xa[k], xa[k]);
      m = fmaxf(m, v[k]);
    }
    for (int k = 0; k < c; ++k) {
      v[k] = __expf(v[k] - m);
      sum += v[k];
    }
  }
  const float ci = coef / sum, off = -coef * eps_c, off_y = off - coef * hot;
  constexpr int kN = N > 0 ? N : 1;
  const int n = N > 0 ? N : c;
#pragma unroll(kN)
  for (int k = 0; k < n; ++k)
    if (k < c) {
      const float g = fmaf(v[k], ci, k == y ? off_y : off);
      lo[k] = fmaf(wlo, g, lo[k]);
      hi[k] = fmaf(fy, g, hi[k]);
    }
}

// at most 128 registers a thread: two blocks on an SM (the register
// path's column state takes 80)
template <int CMAX>
__global__ void __launch_bounds__(kThreads, 2)
resize_ce_bwd_kernel(const float* __restrict__ z, const int* __restrict__ lab,
                     const float* __restrict__ cw, const float* __restrict__ g_s,
                     float* __restrict__ slabs, int h, int w, int c, int r, int ignore,
                     float eps, int wb, Phases ph) {
  extern __shared__ __align__(16) float smem[];
  const BwdPlan p(h, w, c, r, wb);
  float* zs = smem + p.zs;
  float* slab = smem + p.slab;
  float* gbuf = smem + p.g;
  __shared__ int shift[kBand + 2];
  const int tid = threadIdx.x;
  const int ct = blockIdx.x % p.ncol;
  const int band = (blockIdx.x / p.ncol) % p.nband;
  const int b = blockIdx.x / (p.ncol * p.nband);
  const int i0 = band * kBand, j0 = ct * wb;
  const int rows = min(kBand, h - i0), cols = min(wb, w - j0);

  // 1. logits of rows i0-1 .. i0+kBand, columns j0-1 .. j0+wb, clamped
  esn::stage_band(zs, shift, z, b, h, w, c, i0, j0, wb, p.zrow, esn::aligned16(z), tid);
  for (int i = tid; i < p.slab_floats(c); i += kThreads) slab[i] = 0.f;
  esn::cp_async_commit();
  esn::cp_async_wait_all();
  __syncthreads();

  // 2.-3. the band's full-res rows, each thread down its own column
  const int W = w * r;
  const float gs = *g_s, eps_c = eps / c, hot = 1.f - eps;
  const int jj = tid / r, px = tid - jj * r;   // this thread's full-res column
  const bool active = jj < cols;
  const int ulo = jj + ph.upper_next[px];
  const float fx = ph.frac[px];
  const int* lcol = lab + ((int64_t)b * h * r + (int64_t)i0 * r) * W + (int64_t)j0 * r + tid;
  const int nrows = rows * r, wp = wb + 2, npair = (cols + 2) * c;
  // the column's state: xa, xb its logits lerped along x in slab rows t and
  // t+1 (the tap rows of the current full-res rows), lo, hi its gradient
  // summed with the row weights into those two slab rows
  constexpr int kN = CMAX > 0 ? CMAX : 1;
  const int sn = CMAX > 0 ? CMAX : p.cs;  // stride of the four state arrays
  float reg[4 * kN];
  float* xa = CMAX > 0 ? reg : smem + p.st + tid * 4 * p.cs;
  float *xb = xa + sn, *lo = xb + sn, *hi = lo + sn;
  float* v = gbuf + tid * p.cs;
  const int n = CMAX > 0 ? CMAX : c;
  auto xlerp = [&](float* dst, int t) {
    const float* zr = zs + t * p.zrow + shift[t] + ulo * c;
#pragma unroll(kN)
    for (int k = 0; k < n; ++k)
      if (k < c) dst[k] = fmaf(fx, zr[c + k] - zr[k], zr[k]);
  };
  // slab row t of the tile: every column's sums (from the caller's src)
  // contracted along W, each (low-res column, class) by one thread over
  // its 2r source columns in column order
  auto flush = [&](const float* src, int t) {
    if (active) {
#pragma unroll(kN)
      for (int k = 0; k < n; ++k)
        if (k < c) v[k] = src[k];
    }
    __syncthreads();
    for (int q = tid; q < npair; q += kThreads) {
      const int u = q / c, k = q - u * c;
      const int x0 = (u - 2) * r + ph.h0;
      const int m0 = max(0, -x0), m1 = min(2 * r, r * cols - x0);
      const float* gx = gbuf + x0 * p.cs + k;
      float acc = 0.f;
      for (int mm = m0; mm < m1; ++mm) acc = fmaf(ph.wcol[mm], gx[mm * p.cs], acc);
      slab[(t * wp + u) * c + k] = acc;
    }
    __syncthreads();
  };
  int t = ph.upper_next[0];
  if (active) {
    xlerp(xa, t);
    xlerp(xb, t + 1);
#pragma unroll(kN)
    for (int k = 0; k < n; ++k) lo[k] = hi[k] = 0.f;
  }
  int y_next = active ? __ldg(lcol) : ignore;
  for (int Y = 0, yy = 0, py = 0; Y < nrows; ++Y) {
    const int tl = yy + ph.upper_next[py];
    if (tl != t) {  // slab row t is complete (the same Y for every thread)
      flush(lo, t);
      if (active) {
#pragma unroll(kN)
        for (int k = 0; k < n; ++k) {
          lo[k] = hi[k];
          hi[k] = 0.f;
          xa[k] = xb[k];
        }
        xlerp(xb, tl + 1);
      }
      t = tl;
    }
    const int y = y_next;
    if (active && Y + 1 < nrows) y_next = __ldg(lcol + (int64_t)(Y + 1) * W);
    if (active && valid_label(y, c, ignore))
      pixel_grad<CMAX>(xa, xb, lo, hi, v, c, y, ph.frac[py], ph.frac_lo[py], gs * cw[y], hot,
                       eps_c);
    if (++py == r) py = 0, ++yy;
  }
  flush(lo, t);
  flush(hi, t + 1);

  // 4. the slab to scratch
  float* out = slabs + (int64_t)blockIdx.x * p.slab_floats(c);
  for (int i = tid; i < p.slab_floats(c); i += kThreads) out[i] = slab[i];
}

// dz (n, h, w, c): each element the sum of its slab entries, in a fixed
// order: rows (band q, slab row t) and columns (tile, slab column u) that
// hold original row i / column j, its halo copies in the neighbouring
// band or tile, and the clamp rows -1, h and columns -1, w at the edges.
__global__ void __launch_bounds__(kThreads)
resize_ce_fold_kernel(const float* __restrict__ slabs, float* __restrict__ dz, int n, int h,
                      int w, int c, int r, int wb) {
  const BwdPlan p(h, w, c, r, wb);
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (int64_t)n * h * w * c) return;
  const int k = (int)(idx % c);
  int64_t t = idx / c;
  const int j = (int)(t % w);
  t /= w;
  const int i = (int)(t % h);
  const int b = (int)(t / h);
  int rq[4], rt[4], cq[4], cu[4], nr = 0, nc = 0;
  const int q = i / kBand, ti = i - q * kBand + 1;
  if (ti == 1 && q > 0) { rq[nr] = q - 1; rt[nr++] = kBand + 1; }
  if (i == 0) { rq[nr] = 0; rt[nr++] = 0; }
  rq[nr] = q; rt[nr++] = ti;
  if (i == h - 1) { rq[nr] = q; rt[nr++] = h - q * kBand + 1; }
  if (ti == kBand && q + 1 < p.nband) { rq[nr] = q + 1; rt[nr++] = 0; }
  const int e = j / wb, uj = j - e * wb + 1;
  if (uj == 1 && e > 0) { cq[nc] = e - 1; cu[nc++] = wb + 1; }
  if (j == 0) { cq[nc] = 0; cu[nc++] = 0; }
  cq[nc] = e; cu[nc++] = uj;
  if (j == w - 1) { cq[nc] = e; cu[nc++] = w - e * wb + 1; }
  if (uj == wb && e + 1 < p.ncol) { cq[nc] = e + 1; cu[nc++] = 0; }
  const int sf = p.slab_floats(c), wp = wb + 2;
  float acc = 0.f;
  for (int a = 0; a < nr; ++a)
    for (int bb = 0; bb < nc; ++bb) {
      const int64_t blk = ((int64_t)b * p.nband + rq[a]) * p.ncol + cq[bb];
      acc += slabs[blk * sf + ((int64_t)rt[a] * wp + cu[bb]) * c + k];
    }
  dz[idx] = acc;
}

}  // namespace

// Doubles of scratch the forward needs for this shape (an (S, N) pair per
// block), or -1 if its band does not fit in shared memory.
extern "C" long long esn_resize_ce_fwd_scratch(int n, int h, int w, int c, int r) {
  if (r < 2 || r > kMaxFactor || c < 1 || n < 1 || h < 1 || w < 1) return -1;
  const FwdPlan p(h, w, c, r);
  if (p.bytes > (size_t)esn::kMaxSmem) return -1;
  return 2LL * n * p.nband * p.ncol;
}

// z (n, h, w, c) f32 contiguous; lab (n, h*r, w*r) int32; cw (c,) f32;
// partial: esn_resize_ce_fwd_scratch(...) doubles of scratch; s_out,
// n_out: one f32 each. Requires 2 <= r <= 16.
extern "C" int esn_resize_ce_fwd(const void* z, const void* lab, const void* cw,
                                 void* partial, void* s_out, void* n_out,
                                 int n, int h, int w, int c, int r, int ignore,
                                 float eps, void* stream) {
  if (esn_resize_ce_fwd_scratch(n, h, w, c, r) < 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FwdPlan p(h, w, c, r);
  auto kernel = c <= kRegClasses ? resize_ce_fwd_kernel<kRegClasses> : resize_ce_fwd_kernel<0>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.bytes);
  if (err != cudaSuccess) return err;
  const int blocks = n * p.nband * p.ncol;
  kernel<<<blocks, kThreads, p.bytes, st>>>(
      static_cast<const float*>(z), static_cast<const int*>(lab), static_cast<const float*>(cw),
      static_cast<double*>(partial), h, w, c, r, ignore, eps, p.wb, esn::make_phases(r));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  resize_ce_finish_kernel<<<1, kThreads, 0, st>>>(
      static_cast<const double*>(partial), blocks, static_cast<float*>(s_out),
      static_cast<float*>(n_out));
  return cudaGetLastError();
}

// Floats of scratch the backward needs for this shape (its slabs), or -1
// if no tiling fits in shared memory.
extern "C" long long esn_resize_ce_bwd_scratch(int n, int h, int w, int c, int r) {
  if (r < 2 || r > kMaxFactor || c < 1 || n < 1 || h < 1 || w < 1) return -1;
  const BwdPlan p(h, w, c, r, bwd_cols(h, w, c, r));
  if (p.bytes() > (size_t)esn::kMaxSmem) return -1;
  return (long long)n * p.nband * p.ncol * p.slab_floats(c);
}

// As esn_resize_ce_fwd, plus g_s: one f32 on the device (the cotangent of
// S), scratch: esn_resize_ce_bwd_scratch(...) floats, and dz (n, h, w, c)
// f32, every element written.
extern "C" int esn_resize_ce_bwd(const void* z, const void* lab, const void* cw,
                                 const void* g_s, void* scratch, void* dz, int n,
                                 int h, int w, int c, int r, int ignore, float eps,
                                 void* stream) {
  if (esn_resize_ce_bwd_scratch(n, h, w, c, r) < 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int wb = bwd_cols(h, w, c, r);
  const BwdPlan p(h, w, c, r, wb);
  auto kernel = c <= kRegClasses ? resize_ce_bwd_kernel<kRegClasses> : resize_ce_bwd_kernel<0>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.bytes());
  if (err != cudaSuccess) return err;
  float* slabs = static_cast<float*>(scratch);
  kernel<<<n * p.nband * p.ncol, kThreads, p.bytes(), st>>>(
      static_cast<const float*>(z), static_cast<const int*>(lab),
      static_cast<const float*>(cw), static_cast<const float*>(g_s), slabs, h, w, c, r,
      ignore, eps, wb, esn::make_phases(r));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t total = (int64_t)n * h * w * c;
  resize_ce_fold_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      slabs, static_cast<float*>(dz), n, h, w, c, r, wb);
  return cudaGetLastError();
}
