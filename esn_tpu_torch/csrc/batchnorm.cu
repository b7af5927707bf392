// BatchNorm on the card (K8): the training moments, the apply (training
// and eval) and the backward, each in a fixed order.
//
// Replaces no TPU kernel: XLA fused the reference's BatchNorm
// (esn_tpu/nn/layers.py, BatchNorm.folded_apply) into its neighbours on
// the TPU. In eager PyTorch the same math ran as a chain of broadcast
// passes, f32 copies of the activation and autograd's backward of them,
// the largest share of the card's time in every cell of the benchmark.
//
// The math is the reference's. Training: per channel, the sums of
// u = x - centre and of u^2 (centre: the running mean the module centres
// on), d = sum(u)/n, mean = centre + d, var = max(sum(u^2)/n - d^2, 0), the
// running statistics moved by the momentum toward mean and var * n'/(n'-1);
// then y = x * scale + offset with scale = rsqrt(var + eps) * weight and
// offset = bias - mean * scale, from the batch's statistics in training and
// the running ones in eval, computed in f32 (f64 for f64) as the composite
// rounds it and rounded once to x's dtype. Backward, with xh = (x - mean) * rstd: dbias = sum(dy),
// dweight = sum(dy * xh), dx = scale * (dy - sum(dy)/n - xh * sum(dy*xh)/n)
// (in eval dx = scale * dy).
//
// What bounds it on an H100: bytes. Per element the forward's moments read
// x once, the apply reads x and writes y, the backward's sums read dy and
// x, and its dx pass reads both and writes dx: 6 bytes an element a bf16
// training forward, 10 a backward, 4 an eval apply, at 3.35 TB/s. The
// arithmetic is a few operations an element.
//
// Design. x is seen as (a, c, b): channels_last (NHWC) is (N*H*W, C, 1), a
// "rows" layout; NCHW is (N, C, H*W), a "planes" layout. Every thread
// moves 16 bytes a load where it can.
// - Rows: the tensor is cut into tiles of L = lcm(C, V) elements (V per
//   16 bytes), so L is a whole number of rows and lane k of vector slot j
//   of any tile is channel (j V + k) mod C: a thread keeps one slot, its
//   channels' centres or coefficients in registers, and walks the tiles.
//   C needs no power-of-two factor (CGNet's 35 and 131 channels: L = 280
//   and 1048 bf16). A ragged last tile goes element by element.
// - Planes: one block walks one (image, channel) plane, or a chunk of it;
//   16-byte loads where H*W is a whole number of them, else one element.
// - The reductions are two-stage and use no float atomics: each block of
//   the first launch writes its partial sums (a fixed walk, registers,
//   then a fixed tree in shared memory), and a finishing launch sums the
//   partials of each channel in a fixed order and does the per-channel
//   arithmetic. So a step repeats bit for bit. The plan (tiles, blocks)
//   comes from the shapes alone (ops/kernels/batchnorm.py, bn_plan).
// - The sums are f64 whatever x's dtype: each term (u, u^2, dy, dy u, with
//   u = x - centre in x's accumulation type) is exact in f64, and an f64
//   sum of them hardly depends on its order, so the statistics come out
//   the same whatever the tiling, and whichever ranks of a data-parallel
//   group hold which images (a two-rank step then matches one process to
//   ~1e-6 where f32 sums left ~1e-3: BN over a few values amplifies a
//   last-bit change of its statistics). An f64 add a term costs no time
//   beside the bytes.
// Two launches give the moments and the statistics, one the apply; two the
// backward's sums and one dx. Under a data-parallel or spatial group the
// wrapper all-reduces the finished sums between a sums-only finish and a
// second finish that takes the world's sums as its one partial row.
#include "gather_bwd.cuh"

namespace {

using esn::AccOf;
using esn::unpack;

// a rows block's most threads; two such blocks share an SM (64 registers
// a thread), so that enough 16-byte loads are in flight to fill HBM
constexpr int kMaxThreads = 512;
constexpr int kPlaneThreads = 256;
// the finishing block: 16 channels (their two sums: 32 columns) x 32 rows
// of partials summed side by side
constexpr int kFinishChannels = 16;
constexpr int kFinishRows = 32;

// what the finishing launch makes of the two sums of a channel
enum Finish : int { kSums = 0, kStats = 1, kGrad = 2 };

__device__ __forceinline__ void unpack(const uint4& v, double* f, double) {
  f[0] = __hiloint2double((int)v.y, (int)v.x);
  f[1] = __hiloint2double((int)v.w, (int)v.z);
}
__device__ __forceinline__ uint4 pack(const float* f, float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float* f, __nv_bfloat16) {
  return make_uint4(esn::pack_bf16(f[0], f[1]), esn::pack_bf16(f[2], f[3]),
                    esn::pack_bf16(f[4], f[5]), esn::pack_bf16(f[6], f[7]));
}
__device__ __forceinline__ uint4 pack(const double* f, double) {
  return make_uint4((unsigned)__double2loint(f[0]), (unsigned)__double2hiint(f[0]),
                    (unsigned)__double2loint(f[1]), (unsigned)__double2hiint(f[1]));
}

__device__ __forceinline__ float inv_sqrt(float v) { return 1.f / sqrtf(v); }
__device__ __forceinline__ double inv_sqrt(double v) { return 1.0 / sqrt(v); }

// V elements of p (V > 1: 16 bytes, aligned) as the accumulation type
template <typename T, int V>
__device__ __forceinline__ void load(const T* p, typename AccOf<T>::type* f) {
  if constexpr (V == 1) {
    f[0] = esn::load_acc(p);
  } else {
    unpack(*reinterpret_cast<const uint4*>(p), f, T{});
  }
}
template <typename T, int V>
__device__ __forceinline__ void store(T* p, const typename AccOf<T>::type* f) {
  if constexpr (V == 1) {
    esn::store_acc(p, f[0]);
  } else {
    *reinterpret_cast<uint4*>(p) = pack(f, T{});
  }
}

// The two running sums of one lane: (u, u^2) for the moments, (dy, dy u)
// for the backward, u = x - centre.
template <bool GRAD, typename A>
__device__ __forceinline__ void accumulate(double& sa, double& sb, A xv, A gv, A centre) {
  const double u = (double)(xv - centre);
  if constexpr (GRAD) {
    sa += (double)gv;
    sb = __fma_rn((double)gv, u, sb);
  } else {
    sa += u;
    sb = __fma_rn(u, u, sb);
  }
}

// Per-channel y = x * scale + offset from (mean, var, weight, bias): the
// module's affine, f32 (f64 for f64), each operation rounded as torch's
// composite rounds it (no contraction into a fused multiply-add), so that
// in eval an f32 (f64) y is the composite's to the bit.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename A>
__device__ __forceinline__ void affine(int ch, const A* mean, const A* var, const A* weight,
                                       const A* bias, A eps, A& scale, A& offset) {
  const A rstd = inv_sqrt(add_rn(var[ch], eps));
  scale = weight ? mul_rn(rstd, weight[ch]) : rstd;
  offset = add_rn(bias ? bias[ch] : (A)0, -mul_rn(mean[ch], scale));
}

// x * scale, rounded, + offset, rounded: the composite's two roundings in
// the accumulation type; the caller rounds once more to x's dtype
template <typename A>
__device__ __forceinline__ A scale_add(A x, A scale, A offset) {
  return add_rn(mul_rn(x, scale), offset);
}

// Per-channel dx = k_dy * dy + k_u * (x - mean) + k_0 (sums: the world's
// sum(dy), sum(dy xh); none in eval, where the statistics are constants).
template <typename A>
struct DxCoef {
  A k_dy, k_u, k_0, mean;
  __device__ __forceinline__ DxCoef(int ch, int c, const A* mean_, const A* var, const A* weight,
                                    const double* sums, double n, A eps) {
    const A rstd = inv_sqrt(var[ch] + eps);
    k_dy = weight ? rstd * weight[ch] : rstd;
    mean = mean_[ch];
    k_u = sums ? -k_dy * rstd * (A)(sums[c + ch] / n) : (A)0;
    k_0 = sums ? -k_dy * (A)(sums[ch] / n) : (A)0;
  }
  __device__ __forceinline__ A dx(A g, A xv) const {
    return esn::fma_rn(k_dy, g, esn::fma_rn(k_u, xv - mean, k_0));
  }
};

// ---------------------------------------------------------------- reduction
// The block's partial sums of every channel, rows layout: thread (slot j,
// tile s) holds V lanes of each of the two sums. Summed over the block's
// tiles by a fixed tree in shared memory, then over the L / C rows of a
// tile, and written as part[block][0..c) and part[block][c..2c).
template <int V>
__device__ __forceinline__ void rows_partials(double* buf, const double* sa, const double* sb,
                                              int c, int slots, int tiles,
                                              double* __restrict__ part) {
  const int l = slots * V, nt = slots * tiles;
  const int j = threadIdx.x % slots, s = threadIdx.x / slots;
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int k = 0; k < V; ++k) buf[s * l + j * V + k] = pass ? sb[k] : sa[k];
    __syncthreads();
    for (int rr = tiles; rr > 1;) {
      const int half = (rr + 1) / 2;
      for (int i = threadIdx.x; i < (rr - half) * l; i += nt) buf[i] += buf[i + half * l];
      __syncthreads();
      rr = half;
    }
    for (int ch = threadIdx.x; ch < c; ch += nt) {
      double v = buf[ch];
      for (int q = ch + c; q < l; q += c) v += buf[q];
      part[(int64_t)blockIdx.x * 2 * c + pass * c + ch] = v;
    }
    __syncthreads();
  }
}

template <typename T, bool GRAD>
__device__ __forceinline__ void rows_reduce(const T* __restrict__ x, const T* __restrict__ dy,
                                            const typename AccOf<T>::type* __restrict__ centre,
                                            double* __restrict__ part, int64_t e, int c, int slots,
                                            int tiles) {
  using A = typename AccOf<T>::type;
  constexpr int V = 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int l = slots * V;
  const int j = threadIdx.x % slots, s = threadIdx.x / slots;
  A cen[V];
  double sa[V], sb[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    cen[k] = centre[(j * V + k) % c];
    sa[k] = sb[k] = 0.0;
  }
  const int64_t full = e / l, step = (int64_t)gridDim.x * tiles;
  int64_t t = (int64_t)blockIdx.x * tiles + s;
  const int64_t off = (int64_t)j * V;
  for (; t + step < full; t += 2 * step) {
    A x0[V], x1[V], g0[V], g1[V];
    load<T, V>(x + t * l + off, x0);
    load<T, V>(x + (t + step) * l + off, x1);
    if constexpr (GRAD) {
      load<T, V>(dy + t * l + off, g0);
      load<T, V>(dy + (t + step) * l + off, g1);
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      accumulate<GRAD>(sa[k], sb[k], x0[k], GRAD ? g0[k] : (A)0, cen[k]);
      accumulate<GRAD>(sa[k], sb[k], x1[k], GRAD ? g1[k] : (A)0, cen[k]);
    }
  }
  if (t < full) {
    A x0[V], g0[V];
    load<T, V>(x + t * l + off, x0);
    if constexpr (GRAD) load<T, V>(dy + t * l + off, g0);
#pragma unroll
    for (int k = 0; k < V; ++k)
      accumulate<GRAD>(sa[k], sb[k], x0[k], GRAD ? g0[k] : (A)0, cen[k]);
    t += step;
  }
  if (t == full) {  // the ragged last tile, in the one thread whose walk reaches it
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int64_t i = full * l + off + k;
      if (i < e)
        accumulate<GRAD>(sa[k], sb[k], esn::load_acc(x + i), GRAD ? esn::load_acc(dy + i) : (A)0,
                         cen[k]);
    }
  }
  rows_partials<V>(reinterpret_cast<double*>(smem), sa, sb, c, slots, tiles, part);
}

// Planes layout: block (plane p = image * c + ch, chunk) sums its chunk of
// the plane; part[image * chunks + chunk][ch] and [c + ch].
template <typename T, bool GRAD, int V>
__device__ __forceinline__ void planes_reduce(const T* __restrict__ x, const T* __restrict__ dy,
                                              const typename AccOf<T>::type* __restrict__ centre,
                                              double* __restrict__ part, int c, int64_t b) {
  using A = typename AccOf<T>::type;
  __shared__ double warps[2][kPlaneThreads / 32];
  const int64_t p = blockIdx.x;
  const int ch = (int)(p % c);
  const A cen = centre[ch];
  const T* xp = x + p * b;
  const T* gp = GRAD ? dy + p * b : nullptr;
  const int64_t nv = b / V, step = (int64_t)gridDim.y * kPlaneThreads;
  double sa = 0.0, sb = 0.0;
  int64_t w = (int64_t)blockIdx.y * kPlaneThreads + threadIdx.x;
  for (; w + step < nv; w += 2 * step) {
    A x0[V], x1[V], g0[V], g1[V];
    load<T, V>(xp + w * V, x0);
    load<T, V>(xp + (w + step) * V, x1);
    if constexpr (GRAD) {
      load<T, V>(gp + w * V, g0);
      load<T, V>(gp + (w + step) * V, g1);
    }
#pragma unroll
    for (int k = 0; k < V; ++k) accumulate<GRAD>(sa, sb, x0[k], GRAD ? g0[k] : (A)0, cen);
#pragma unroll
    for (int k = 0; k < V; ++k) accumulate<GRAD>(sa, sb, x1[k], GRAD ? g1[k] : (A)0, cen);
  }
  if (w < nv) {
    A x0[V], g0[V];
    load<T, V>(xp + w * V, x0);
    if constexpr (GRAD) load<T, V>(gp + w * V, g0);
#pragma unroll
    for (int k = 0; k < V; ++k) accumulate<GRAD>(sa, sb, x0[k], GRAD ? g0[k] : (A)0, cen);
  }
  for (int o = 16; o > 0; o >>= 1) {
    sa += __shfl_down_sync(0xffffffffu, sa, o);
    sb += __shfl_down_sync(0xffffffffu, sb, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    warps[0][warp] = sa;
    warps[1][warp] = sb;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double ta = warps[0][0], tb = warps[1][0];
    for (int i = 1; i < kPlaneThreads / 32; ++i) {
      ta += warps[0][i];
      tb += warps[1][i];
    }
    const int64_t row = (p / c) * gridDim.y + blockIdx.y;
    part[row * 2 * c + ch] = ta;
    part[row * 2 * c + c + ch] = tb;
  }
}

// The moments' first stage: the partial sums of x - centre and its square.
template <typename T, bool ROWS, int V>
__global__ void __launch_bounds__(kMaxThreads, 2)
bn_moments_kernel(const T* __restrict__ x, const typename AccOf<T>::type* __restrict__ centre,
                  double* __restrict__ part, int64_t e, int c, int64_t b, int slots,
                  int tiles) {
  if constexpr (ROWS)
    rows_reduce<T, false>(x, nullptr, centre, part, e, c, slots, tiles);
  else
    planes_reduce<T, false, V>(x, nullptr, centre, part, c, b);
}

// The backward's first stage: the partial sums of dy and dy (x - mean).
template <typename T, bool ROWS, int V>
__global__ void __launch_bounds__(kMaxThreads, 2)
bn_grad_kernel(const T* __restrict__ x, const T* __restrict__ dy,
               const typename AccOf<T>::type* __restrict__ mean,
               double* __restrict__ part, int64_t e, int c, int64_t b, int slots, int tiles) {
  if constexpr (ROWS)
    rows_reduce<T, true>(x, dy, mean, part, e, c, slots, tiles);
  else
    planes_reduce<T, true, V>(x, dy, mean, part, c, b);
}

// The second stage: each channel's two f64 sums over `parts` rows of
// partials, row after row in 32 interleaved runs added in order, then what
// `mode` asks: the sums (`sums`, 2c); the batch statistics (mean, biased
// var in `stats`, 2c, computed in f64 and rounded once; the running
// statistics moved when `update`); or the backward's sum dy and sum dy xh
// (`sums`).
template <typename A>
__global__ void __launch_bounds__(kFinishChannels * 2 * kFinishRows)
bn_finish_kernel(const double* __restrict__ part, int parts, int c, int mode, const A* centre,
                 const A* __restrict__ var, double* __restrict__ sums, A* __restrict__ stats,
                 A* running_mean, A* running_var, double n, double momentum, double unbias, A eps,
                 int update) {
  // centre may be running_mean itself: each channel's thread reads it first
  __shared__ double red[kFinishRows][2 * kFinishChannels + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ch = blockIdx.x * kFinishChannels + (tx % kFinishChannels);
  const int col = (tx < kFinishChannels ? 0 : c) + ch;
  double v = 0.0;
  if (ch < c) {
#pragma unroll 4
    for (int p = ty; p < parts; p += kFinishRows) v += part[(int64_t)p * 2 * c + col];
  }
  red[ty][tx] = v;
  __syncthreads();
  if (ty != 0) return;
  double t = red[0][tx];
  for (int r = 1; r < kFinishRows; ++r) t += red[r][tx];
  red[0][tx] = t;
  __syncwarp();
  if (tx >= kFinishChannels || ch >= c) return;
  const double sa = red[0][tx], sb = red[0][tx + kFinishChannels];
  if (mode == kSums) {
    sums[ch] = sa;
    sums[c + ch] = sb;
  } else if (mode == kStats) {
    const double cen = (double)centre[ch];
    const double d = sa / n, m2 = sb / n;
    const double mean = cen + d;
    const double dev = m2 - d * d;
    const double vb = dev < 0.0 ? 0.0 : dev;  // a NaN stays NaN, as torch's clamp
    stats[ch] = (A)mean;
    stats[c + ch] = (A)vb;
    if (update) {
      running_mean[ch] = (A)((1.0 - momentum) * cen + momentum * mean);
      running_var[ch] =
          (A)((1.0 - momentum) * (double)running_var[ch] + momentum * (vb * unbias));
    }
  } else {
    sums[ch] = sa;
    sums[c + ch] = sb * (double)inv_sqrt(var[ch] + eps);
  }
}

// -------------------------------------------------------------- elementwise
// y = x * scale + offset, rounded once. Rows: a thread keeps its slot's V
// channels' coefficients; planes: a block's plane is one channel.
template <typename T, bool ROWS, int V>
__global__ void __launch_bounds__(kMaxThreads, 2)
bn_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                const typename AccOf<T>::type* __restrict__ mean,
                const typename AccOf<T>::type* __restrict__ var,
                const typename AccOf<T>::type* __restrict__ weight,
                const typename AccOf<T>::type* __restrict__ bias, typename AccOf<T>::type eps,
                int64_t e, int c, int64_t b, int slots, int tiles) {
  using A = typename AccOf<T>::type;
  if constexpr (ROWS) {
    const int l = slots * V;
    const int j = threadIdx.x % slots, s = threadIdx.x / slots;
    A sc[V], of[V];
#pragma unroll
    for (int k = 0; k < V; ++k) affine((j * V + k) % c, mean, var, weight, bias, eps, sc[k], of[k]);
    const int64_t full = e / l, step = (int64_t)gridDim.x * tiles, off = (int64_t)j * V;
    int64_t t = (int64_t)blockIdx.x * tiles + s;
    for (; t + step < full; t += 2 * step) {
      A x0[V], x1[V];
      load<T, V>(x + t * l + off, x0);
      load<T, V>(x + (t + step) * l + off, x1);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        x0[k] = scale_add(x0[k], sc[k], of[k]);
        x1[k] = scale_add(x1[k], sc[k], of[k]);
      }
      store<T, V>(y + t * l + off, x0);
      store<T, V>(y + (t + step) * l + off, x1);
    }
    if (t < full) {
      A x0[V];
      load<T, V>(x + t * l + off, x0);
#pragma unroll
      for (int k = 0; k < V; ++k) x0[k] = scale_add(x0[k], sc[k], of[k]);
      store<T, V>(y + t * l + off, x0);
      t += step;
    }
    if (t == full) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int64_t i = full * l + off + k;
        if (i < e) esn::store_acc(y + i, scale_add(esn::load_acc(x + i), sc[k], of[k]));
      }
    }
  } else {
    const int64_t p = blockIdx.x;
    A sc, of;
    affine((int)(p % c), mean, var, weight, bias, eps, sc, of);
    const T* xp = x + p * b;
    T* yp = y + p * b;
    const int64_t nv = b / V, step = (int64_t)gridDim.y * kPlaneThreads;
    for (int64_t w = (int64_t)blockIdx.y * kPlaneThreads + threadIdx.x; w < nv; w += step) {
      A v[V];
      load<T, V>(xp + w * V, v);
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = scale_add(v[k], sc, of);
      store<T, V>(yp + w * V, v);
    }
  }
}

// dx = k_dy dy + k_u (x - mean) + k_0, rounded once.
template <typename T, bool ROWS, int V>
__global__ void __launch_bounds__(kMaxThreads, 2)
bn_dx_kernel(const T* __restrict__ dy, const T* __restrict__ x, T* __restrict__ dx,
             const typename AccOf<T>::type* __restrict__ mean,
             const typename AccOf<T>::type* __restrict__ var,
             const typename AccOf<T>::type* __restrict__ weight,
             const double* __restrict__ sums, double n, typename AccOf<T>::type eps, int64_t e,
             int c, int64_t b, int slots, int tiles) {
  using A = typename AccOf<T>::type;
  if constexpr (ROWS) {
    const int l = slots * V;
    const int j = threadIdx.x % slots, s = threadIdx.x / slots;
    // a slot's coefficients, one channel a lane
    A kd[V], ku[V], k0[V], mu[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const DxCoef<A> co((j * V + k) % c, c, mean, var, weight, sums, n, eps);
      kd[k] = co.k_dy;
      ku[k] = co.k_u;
      k0[k] = co.k_0;
      mu[k] = co.mean;
    }
    auto f = [&](int k, A g, A xv) {
      return esn::fma_rn(kd[k], g, esn::fma_rn(ku[k], xv - mu[k], k0[k]));
    };
    const int64_t full = e / l, step = (int64_t)gridDim.x * tiles, off = (int64_t)j * V;
    int64_t t = (int64_t)blockIdx.x * tiles + s;
    for (; t + step < full; t += 2 * step) {
      A g0[V], g1[V], x0[V], x1[V];
      load<T, V>(dy + t * l + off, g0);
      load<T, V>(dy + (t + step) * l + off, g1);
      load<T, V>(x + t * l + off, x0);
      load<T, V>(x + (t + step) * l + off, x1);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        g0[k] = f(k, g0[k], x0[k]);
        g1[k] = f(k, g1[k], x1[k]);
      }
      store<T, V>(dx + t * l + off, g0);
      store<T, V>(dx + (t + step) * l + off, g1);
    }
    if (t < full) {
      A g0[V], x0[V];
      load<T, V>(dy + t * l + off, g0);
      load<T, V>(x + t * l + off, x0);
#pragma unroll
      for (int k = 0; k < V; ++k) g0[k] = f(k, g0[k], x0[k]);
      store<T, V>(dx + t * l + off, g0);
      t += step;
    }
    if (t == full) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int64_t i = full * l + off + k;
        if (i < e) esn::store_acc(dx + i, f(k, esn::load_acc(dy + i), esn::load_acc(x + i)));
      }
    }
  } else {
    const int64_t p = blockIdx.x;
    const DxCoef<A> co((int)(p % c), c, mean, var, weight, sums, n, eps);
    const T* gp = dy + p * b;
    const T* xp = x + p * b;
    T* op = dx + p * b;
    const int64_t nv = b / V, step = (int64_t)gridDim.y * kPlaneThreads;
    for (int64_t w = (int64_t)blockIdx.y * kPlaneThreads + threadIdx.x; w < nv; w += step) {
      A g[V], v[V];
      load<T, V>(gp + w * V, g);
      load<T, V>(xp + w * V, v);
#pragma unroll
      for (int k = 0; k < V; ++k) g[k] = co.dx(g[k], v[k]);
      store<T, V>(op + w * V, g);
    }
  }
}

// ------------------------------------------------------------------ launch
// The plan, from the wrapper (bn_plan): vec (V, or 1 for planes that are
// not whole 16-byte vectors), slots and tiles (rows: the block is slots x
// tiles threads; planes: 0), reduce_grid and apply_grid (rows: blocks;
// planes: chunks a plane).
struct Shape {
  int64_t a, b;
  int c, vec, slots, tiles, reduce_grid, apply_grid;
  bool rows() const { return slots > 0; }
  int64_t elements() const { return a * c * b; }
  int64_t planes() const { return a * c; }
  // rows of partial sums the reduction writes
  int64_t parts() const { return rows() ? reduce_grid : a * reduce_grid; }
};

template <typename T>
bool valid(const Shape& s, const void* p0, const void* p1, const void* p2) {
  constexpr int V = 16 / (int)sizeof(T);
  if (s.a < 0 || s.b < 0 || s.c < 1 || s.reduce_grid < 1 || s.apply_grid < 1) return false;
  if (s.rows()) {
    if (s.b != 1 || s.vec != V || s.tiles < 1 || (int64_t)s.slots * s.tiles > kMaxThreads ||
        ((int64_t)s.slots * V) % s.c)
      return false;
  } else {
    if (s.slots != 0 || (s.vec != 1 && s.vec != V) || (s.vec == V && s.b % V) ||
        s.reduce_grid > 65535 || s.apply_grid > 65535 || s.planes() > INT32_MAX)
      return false;
  }
  // 16-byte loads and stores need 16-byte aligned bases
  if (s.vec > 1 && ((p0 && !esn::aligned16(p0)) || (p1 && !esn::aligned16(p1)) ||
                    (p2 && !esn::aligned16(p2))))
    return false;
  return true;
}

template <typename T>
size_t rows_smem(const Shape& s) {
  return (size_t)s.slots * s.tiles * (16 / sizeof(T)) * sizeof(double);
}

template <typename T, bool GRAD, bool ROWS, int V>
void reduce_kernel(dim3 grid, unsigned threads, size_t smem, cudaStream_t st, const T* x,
                   const T* dy, const typename AccOf<T>::type* centre, double* part,
                   const Shape& s) {
  if constexpr (GRAD)
    bn_grad_kernel<T, ROWS, V><<<grid, threads, smem, st>>>(x, dy, centre, part, s.elements(),
                                                            s.c, s.b, s.slots, s.tiles);
  else
    bn_moments_kernel<T, ROWS, V><<<grid, threads, smem, st>>>(x, centre, part, s.elements(),
                                                               s.c, s.b, s.slots, s.tiles);
}

template <typename T, bool GRAD>
int launch_reduce(const T* x, const T* dy, const typename AccOf<T>::type* centre, double* part,
                  const Shape& s, cudaStream_t st) {
  constexpr int V = 16 / (int)sizeof(T);
  if (s.parts() == 0) return 0;
  if (s.rows())
    reduce_kernel<T, GRAD, true, V>(dim3(s.reduce_grid), s.slots * s.tiles, rows_smem<T>(s), st,
                                    x, dy, centre, part, s);
  else if (s.vec == V)
    reduce_kernel<T, GRAD, false, V>(dim3((unsigned)s.planes(), s.reduce_grid), kPlaneThreads,
                                     0, st, x, dy, centre, part, s);
  else
    reduce_kernel<T, GRAD, false, 1>(dim3((unsigned)s.planes(), s.reduce_grid), kPlaneThreads,
                                     0, st, x, dy, centre, part, s);
  return (int)cudaGetLastError();
}

// the finish's scalars
struct Scalars {
  double n, momentum, unbias, eps;
};

// `out`: the statistics (A) in kStats, the sums (f64) otherwise
template <typename A>
int launch_finish(const double* part, int64_t parts, int c, int mode, const A* centre,
                  const A* var, void* out, A* running_mean, A* running_var, const Scalars& k,
                  int update, cudaStream_t st) {
  if (parts > INT32_MAX) return (int)cudaErrorInvalidValue;
  const bool stats = mode == kStats;
  const dim3 block(2 * kFinishChannels, kFinishRows);
  const unsigned grid = (unsigned)((c + kFinishChannels - 1) / kFinishChannels);
  bn_finish_kernel<A><<<grid, block, 0, st>>>(
      part, (int)parts, c, mode, centre, var, stats ? nullptr : static_cast<double*>(out),
      stats ? static_cast<A*>(out) : nullptr, running_mean, running_var, k.n, k.momentum,
      k.unbias, (A)k.eps, update);
  return (int)cudaGetLastError();
}

template <typename T>
int sums(const void* x, const void* dy, const void* centre, const void* var, void* part, void* out,
         void* running_mean, void* running_var, const Shape& s, int mode, const Scalars& k,
         int update, cudaStream_t st) {
  using A = typename AccOf<T>::type;
  // an empty tensor (an empty spatial shard) has no data pointer: its sums are 0
  const bool grad = mode == kGrad, some = s.elements() > 0;
  if (!valid<T>(s, x, dy, nullptr) || (some && (!x || (grad && !dy))) || !centre || !part ||
      !out || (grad && !var) || (mode == kStats && update && (!running_mean || !running_var)))
    return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const A* ct = static_cast<const A*>(centre);
  double* pt = static_cast<double*>(part);
  const int err = grad ? launch_reduce<T, true>(xt, static_cast<const T*>(dy), ct, pt, s, st)
                       : launch_reduce<T, false>(xt, nullptr, ct, pt, s, st);
  if (err) return err;
  return launch_finish<A>(pt, s.parts(), s.c, mode, ct, static_cast<const A*>(var), out,
                          static_cast<A*>(running_mean), static_cast<A*>(running_var), k, update,
                          st);
}

template <typename T>
int apply(const void* x, void* y, const void* mean, const void* var, const void* weight,
          const void* bias, double eps, const Shape& s, cudaStream_t st) {
  using A = typename AccOf<T>::type;
  constexpr int V = 16 / (int)sizeof(T);
  if (!valid<T>(s, x, y, nullptr) || !x || !y || !mean || !var) return cudaErrorInvalidValue;
  if (s.elements() == 0) return 0;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const A *m = static_cast<const A*>(mean), *v = static_cast<const A*>(var);
  const A *w = static_cast<const A*>(weight), *bi = static_cast<const A*>(bias);
  if (s.rows()) {
    bn_apply_kernel<T, true, V><<<s.apply_grid, s.slots * s.tiles, 0, st>>>(
        xt, yt, m, v, w, bi, (A)eps, s.elements(), s.c, s.b, s.slots, s.tiles);
  } else {
    const dim3 grid((unsigned)s.planes(), (unsigned)s.apply_grid);
    if (s.vec == V)
      bn_apply_kernel<T, false, V><<<grid, kPlaneThreads, 0, st>>>(
          xt, yt, m, v, w, bi, (A)eps, s.elements(), s.c, s.b, 0, 0);
    else
      bn_apply_kernel<T, false, 1><<<grid, kPlaneThreads, 0, st>>>(
          xt, yt, m, v, w, bi, (A)eps, s.elements(), s.c, s.b, 0, 0);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dx(const void* dy, const void* x, void* out, const void* mean, const void* var,
       const void* weight, const void* sums_, double n, double eps, const Shape& s,
       cudaStream_t st) {
  using A = typename AccOf<T>::type;
  constexpr int V = 16 / (int)sizeof(T);
  if (!valid<T>(s, dy, x, out) || !dy || !x || !out || !mean || !var) return cudaErrorInvalidValue;
  if (s.elements() == 0) return 0;
  const T *gt = static_cast<const T*>(dy), *xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  const A *m = static_cast<const A*>(mean), *v = static_cast<const A*>(var);
  const A* w = static_cast<const A*>(weight);
  const double* su = static_cast<const double*>(sums_);
  if (s.rows()) {
    bn_dx_kernel<T, true, V><<<s.apply_grid, s.slots * s.tiles, 0, st>>>(
        gt, xt, ot, m, v, w, su, n, (A)eps, s.elements(), s.c, s.b, s.slots, s.tiles);
  } else {
    const dim3 grid((unsigned)s.planes(), (unsigned)s.apply_grid);
    if (s.vec == V)
      bn_dx_kernel<T, false, V><<<grid, kPlaneThreads, 0, st>>>(
          gt, xt, ot, m, v, w, su, n, (A)eps, s.elements(), s.c, s.b, 0, 0);
    else
      bn_dx_kernel<T, false, 1><<<grid, kPlaneThreads, 0, st>>>(
          gt, xt, ot, m, v, w, su, n, (A)eps, s.elements(), s.c, s.b, 0, 0);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry takes x as (a, c, b) (rows: b = 1) and the plan's ints,
// pointers to the card's memory (per-channel vectors in the accumulation
// type: f32, f64 for f64), and returns a CUDA error code. dtype: 0 f32,
// 1 bf16, 2 f64.

// The two sums of every channel: the moments of x about `centre` or, in
// kGrad, the backward's sums of dy and dy (x - centre) (`var` then gives
// rstd); `mode` (kSums, kStats, kGrad) says what the finishing launch
// writes to `out` (2c: f64 sums, or the statistics in kStats). `part`
// holds the plan's partial rows (2c f64 each).
extern "C" int esn_bn_sums(const void* x, const void* dy, const void* centre, const void* var,
                           void* part, void* out, void* running_mean, void* running_var,
                           int dtype, int64_t a, int c, int64_t b, int vec, int slots, int tiles,
                           int reduce_grid, int apply_grid, int mode, double n, double momentum,
                           double unbias, double eps, int update, void* stream) {
  const Shape s{a, b, c, vec, slots, tiles, reduce_grid, apply_grid};
  const Scalars k{n, momentum, unbias, eps};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == esn::kF32)
    return sums<float>(x, dy, centre, var, part, out, running_mean, running_var, s, mode, k,
                       update, st);
  if (dtype == esn::kBF16)
    return sums<__nv_bfloat16>(x, dy, centre, var, part, out, running_mean, running_var, s,
                               mode, k, update, st);
  if (dtype == esn::kF64)
    return sums<double>(x, dy, centre, var, part, out, running_mean, running_var, s, mode, k,
                        update, st);
  return cudaErrorInvalidValue;
}

// The finishing launch alone, over `parts` rows of f64 sums (under a
// group: the world's sums as one row). acc: 0 f32, 2 f64, the type of
// centre, var, the statistics and the running statistics.
extern "C" int esn_bn_finish(const void* part, int64_t parts, int c, int mode, const void* centre,
                             const void* var, void* out, void* running_mean, void* running_var,
                             int acc, double n, double momentum, double unbias, double eps,
                             int update, void* stream) {
  const Scalars k{n, momentum, unbias, eps};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* pt = static_cast<const double*>(part);
  if (!part || !out || c < 1 || parts < 0 || (mode == kStats && !centre) ||
      (mode == kGrad && !var) || (mode == kStats && update && (!running_mean || !running_var)))
    return cudaErrorInvalidValue;
  if (acc == esn::kF32)
    return launch_finish<float>(pt, parts, c, mode, static_cast<const float*>(centre),
                                static_cast<const float*>(var), out,
                                static_cast<float*>(running_mean),
                                static_cast<float*>(running_var), k, update, st);
  if (acc == esn::kF64)
    return launch_finish<double>(pt, parts, c, mode, static_cast<const double*>(centre),
                                 static_cast<const double*>(var), out,
                                 static_cast<double*>(running_mean),
                                 static_cast<double*>(running_var), k, update, st);
  return cudaErrorInvalidValue;
}

// y = x * scale + offset from (mean, var, weight, bias); weight and bias
// may be null (affine=False).
extern "C" int esn_bn_apply(const void* x, void* y, const void* mean, const void* var,
                            const void* weight, const void* bias, double eps, int dtype,
                            int64_t a, int c, int64_t b, int vec, int slots, int tiles,
                            int reduce_grid, int apply_grid, void* stream) {
  const Shape s{a, b, c, vec, slots, tiles, reduce_grid, apply_grid};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == esn::kF32) return apply<float>(x, y, mean, var, weight, bias, eps, s, st);
  if (dtype == esn::kBF16) return apply<__nv_bfloat16>(x, y, mean, var, weight, bias, eps, s, st);
  if (dtype == esn::kF64) return apply<double>(x, y, mean, var, weight, bias, eps, s, st);
  return cudaErrorInvalidValue;
}

// dx from dy and x; `sums` (the world's f64 sum dy, sum dy xh, 2c) null in
// eval.
extern "C" int esn_bn_dx(const void* dy, const void* x, void* out, const void* mean,
                         const void* var, const void* weight, const void* sums_, double n,
                         double eps, int dtype, int64_t a, int c, int64_t b, int vec, int slots,
                         int tiles, int reduce_grid, int apply_grid, void* stream) {
  const Shape s{a, b, c, vec, slots, tiles, reduce_grid, apply_grid};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == esn::kF32) return dx<float>(dy, x, out, mean, var, weight, sums_, n, eps, s, st);
  if (dtype == esn::kBF16)
    return dx<__nv_bfloat16>(dy, x, out, mean, var, weight, sums_, n, eps, s, st);
  if (dtype == esn::kF64) return dx<double>(dy, x, out, mean, var, weight, sums_, n, eps, s, st);
  return cudaErrorInvalidValue;
}
