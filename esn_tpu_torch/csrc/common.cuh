// Shared helpers of the esn_tpu_torch CUDA kernels.
//
// Each kernel file exports plain `extern "C"` launch functions that take
// raw device pointers and a cudaStream_t passed as void*, launch on that
// stream, and return cudaGetLastError() as an int. No file includes
// PyTorch's headers; the Python wrappers (esn_tpu_torch/ops/kernels/)
// check shapes, dtypes and contiguity before they call in.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace esn {

// shared memory on an H100: the most one block may take (dynamic), and
// the most each of two blocks may take to share an SM (228 KB, less 1 KB
// reserved per block)
constexpr int kMaxSmem = 232448;
constexpr int kSmemTwoBlocks = 115712;

// dtype codes passed from Python: 0 = float32, 1 = bfloat16
enum DType : int { kF32 = 0, kBF16 = 1 };

// activation codes: 0 = none, 1 = relu, 2 = relu6
__device__ __forceinline__ float act(float v, int kind) {
  if (kind == 1) return fmaxf(v, 0.f);
  if (kind == 2) return fminf(fmaxf(v, 0.f), 6.f);
  return v;
}

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
// round to nearest even, as torch's float -> bfloat16 cast
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 16 bytes of x as f32: 4 floats, or 8 bfloat16 (a bfloat16 is the high
// half of its f32; element 0 is the low half of the first word)
__device__ __forceinline__ void unpack(const uint4& v, float* f, float) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, float* f, __nv_bfloat16) {
  const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const unsigned*>(&v);
}

// Asynchronous 16-byte copy from device to shared memory (both addresses
// 16-byte aligned); with `fill` false nothing is read and the 16 bytes are
// zeroed. Complete after cp_async_wait_all() and a barrier.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool fill = true) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(fill ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Tensor-core pieces of the bf16 products (dsconv.cu, cgblock.cu):
// ldmatrix loads four (two) 8x8 b16 matrices from shared memory, each lane
// giving one 16-byte row address, into the fragment layout of mma.sync
// m16n8k16, which adds A (16x16, row-major) x B (16x8, given as [n][k]
// rows) to its f32 accumulators.
__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* ptr) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x2(unsigned* r, const void* ptr) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s)
               : "memory");
}
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// The band walk of the resize kernels (resize_argmax.cu, resize_ce.cu): one
// block of kBandThreads threads per (image, band of kBand low-res rows, tile
// of wb low-res columns), a thread per full-res column; the band's logits
// plus the clamp halo staged once in shared memory.

constexpr int kBand = 8;
constexpr int kBandThreads = 256;
constexpr int kMaxFactor = 16;

// Taps of the half-pixel bilinear x r upsample (torch align_corners=False,
// edge taps clamped), per sub-pixel phase p < r: full-res row r*i + p
// blends low-res rows (i-1, i) when d = (p+0.5)/r - 0.5 < 0 (weight 1+d on
// i) and (i, i+1) otherwise (weight d on i+1); columns the same.
// upper_next[p]: the upper tap is i+1; frac, frac_lo: the f32 weights on
// the upper and the lower tap. h0: the first phase whose upper tap is i+1.
// wcol (resize_ce's backward): the weights of the 2r full-res columns
// (u-2)*r + h0 + m, m < 2r, that tap low-res column u (as their upper tap
// for m < r, their lower one after).
struct Phases {
  int upper_next[kMaxFactor];
  float frac[kMaxFactor];
  float frac_lo[kMaxFactor];
  int h0;
  float wcol[2 * kMaxFactor];
};

// the Pallas kernels' _fracs in double, each weight rounded once to f32
inline Phases make_phases(int r) {
  Phases ph{};
  for (int p = 0; p < r; ++p) {
    const double d = (p + 0.5) / r - 0.5;
    const double f = d < 0 ? 1.0 + d : d;
    ph.upper_next[p] = d >= 0;
    ph.frac[p] = (float)f;
    ph.frac_lo[p] = (float)(1.0 - f);
  }
  ph.h0 = 0;
  while (ph.h0 < r && !ph.upper_next[ph.h0]) ++ph.h0;
  for (int m = 0; m < 2 * r; ++m) {
    const int p = (ph.h0 + m) % r;
    ph.wcol[m] = m < r ? ph.frac[p] : ph.frac_lo[p];
  }
  return ph;
}

// Elements of one staged band row: wb + 2 columns of c, plus room to shift
// the row to its source's 16-byte phase, in whole 16-byte vectors.
template <typename T>
__host__ __device__ inline int band_stride(int wb, int c) {
  constexpr int V = 16 / sizeof(T);
  return ((wb + 2) * c + 2 * (V - 1)) / V * V;
}

template <typename T>
__host__ __device__ inline size_t band_bytes(int wb, int c) {
  return (size_t)(kBand + 2) * band_stride<T>(wb, c) * sizeof(T);
}

// Low-res columns a band block takes: kBandThreads / r (a thread per
// full-res column), fewer where w is narrower or the staged band would
// leave room for fewer than two blocks on an SM.
template <typename T>
inline int band_cols(int w, int c, int r) {
  int wb = kBandThreads / r < w ? kBandThreads / r : w;
  while (wb > 1 && band_bytes<T>(wb, c) > (size_t)kSmemTwoBlocks) wb = (wb + 1) / 2;
  return wb;
}

// One row segment, elements [g0, g1) of x, to shared memory s at d0 (d0 and
// g0 in the same 16-byte phase when `vec`): 16-byte cp.async copies for the
// whole vectors, element by element for the ragged ends (or all of it
// without `vec`).
template <typename T>
__device__ __forceinline__ void stage_segment(T* s, const T* x, int64_t g0, int64_t g1, int d0,
                                              bool vec, int tid) {
  constexpr int V = 16 / sizeof(T);
  int64_t v0 = g1, v1 = g1;  // the 16-byte body [v0, v1)
  if (vec) {
    v0 = (g0 + V - 1) / V * V;
    v1 = g1 / V * V;
    if (v0 > v1) v0 = v1 = g1;
  }
  for (int64_t i = v0 + V * (int64_t)tid; i < v1; i += V * kBandThreads)
    cp_async16(s + d0 + (i - g0), x + i);
  const int head = (int)(v0 - g0), tail = (int)(g1 - v1);
  for (int i = tid; i < head + tail; i += kBandThreads) {
    const int64_t gi = i < head ? g0 + i : v1 + (i - head);
    s[d0 + (gi - g0)] = x[gi];
  }
}

// The band's logits: rows i0-1 .. i0+kBand and columns j0-1 .. j0+wb of
// image b of x (n, h, w, c) NHWC, clamped to the image (the upsample's edge
// clamp), to s: row t at s + t*stride + shift[t], column u (source column
// j0-1+u) at + u*c. shift[t] puts each element in its source's 16-byte
// phase (0 without `vec`: x not 16-byte aligned), so the body of a row goes
// by 16-byte cp.async. The caller commits, waits and syncs before it reads
// s or shift.
template <typename T>
__device__ void stage_band(T* s, int* shift, const T* __restrict__ x, int b, int h, int w,
                           int c, int i0, int j0, int wb, int stride, bool vec, int tid) {
  constexpr int V = 16 / sizeof(T);
  const int u_lo = j0 == 0 ? 1 : 0;            // first column inside the image
  const int u_hi = min(wb + 1, w - j0);        // last one
  for (int t = 0; t < kBand + 2; ++t) {
    const int src = min(max(i0 - 1 + t, 0), h - 1);
    const int64_t row = ((int64_t)b * h + src) * w * c;
    const int64_t g0 = row + (int64_t)(j0 - 1 + u_lo) * c;
    const int sh = vec ? (int)(((g0 - (int64_t)u_lo * c) % V + V) % V) : 0;
    if (tid == 0) shift[t] = sh;
    const int d = t * stride + sh;
    stage_segment(s, x, g0, row + (int64_t)(j0 + u_hi) * c, d + u_lo * c, vec, tid);
    // clamped columns: u = 0 at the left edge, u > u_hi past the right one
    const int nclamp = (u_lo + (wb + 1 - u_hi)) * c;
    for (int i = tid; i < nclamp; i += kBandThreads) {
      const int q = i / c, k = i - q * c;
      const bool left = q < u_lo;
      const int u = left ? 0 : u_hi + 1 + (q - u_lo);
      s[d + u * c + k] = x[row + (int64_t)(left ? 0 : w - 1) * c + k];
    }
  }
}

// A thread's full-res column in a staged band: its logits lerped along x
// (weight fx between staged columns u and u+1, u*c = off) in tap rows t and
// t+1, and their blend along y. With CMAX > 0, load(t) keeps xa (row t) and
// d (row t+1 less row t) in registers for CMAX classes, those from c on
// padded with xa = -inf, d = 0: a logit of -inf, which never wins a strict
// max and whose exp is 0. With CMAX = 0 nothing is kept and each logit is
// lerped from shared memory when asked. Both give the same bits.
template <typename T, int CMAX>
struct BandColumn {
  static constexpr int kCMax = CMAX;
  static constexpr int kN = CMAX > 0 ? CMAX : 1;
  const T* s;
  const int* shift;
  int stride, off, c, t;
  float fx;
  float xa[kN], d[kN];

  __device__ __forceinline__ float xlerp(int row, int k) const {
    const T* zr = s + row * stride + shift[row] + off;
    const float a = to_f32(zr[k]);
    return fmaf(fx, to_f32(zr[c + k]) - a, a);
  }
  __device__ __forceinline__ void load(int row) {
    t = row;
    if constexpr (CMAX > 0) {
#pragma unroll
      for (int k = 0; k < CMAX; ++k) {  // selects, not branches
        const bool in = k < c;
        const float x0 = xlerp(t, in ? k : 0), x1 = xlerp(t + 1, in ? k : 0);
        xa[k] = in ? x0 : -INFINITY;
        d[k] = in ? x1 - x0 : 0.f;
      }
    }
  }
  // class k at y-weight f (k a constant of an unrolled loop when CMAX > 0)
  __device__ __forceinline__ float logit(int k, float f) const {
    if constexpr (CMAX > 0) {
      return fmaf(f, d[k], xa[k]);
    } else {
      return logit_smem(k, f);
    }
  }
  // the same for any k, from shared memory
  __device__ __forceinline__ float logit_smem(int k, float f) const {
    const float a = xlerp(t, k);
    return fmaf(f, xlerp(t + 1, k) - a, a);
  }
};

// Walks a thread's column down the band's rows*r full-res rows: for each
// tap row t (staged rows t and t+1 blend), col.load(t), then pair(Y, fa,
// fb, two) for full-res rows Y and Y+1, two at a time, with their y-weights
// (two: row Y+1 blends the same tap rows; else the second is a dummy). The
// rows of tap row t are [(t-1)*r + h0, t*r + h0) within [0, rows*r); the
// phases advance without a division.
template <class Col, class Pair>
__device__ __forceinline__ void walk_column(Col& col, int rows, int r, const Phases& ph,
                                            Pair&& pair) {
  const int nrows = rows * r;
  for (int t = 0; t <= rows; ++t) {
    const int ya = max(0, (t - 1) * r + ph.h0), yb = min(nrows, t * r + ph.h0);
    if (ya >= yb) continue;
    col.load(t);
    int p = ya == 0 ? 0 : ph.h0;
    for (int Y = ya; Y < yb; Y += 2) {
      const int p1 = p + 1 == r ? 0 : p + 1;
      pair(Y, ph.frac[p], ph.frac[p1], Y + 1 < yb);
      p = p1 + 1 == r ? 0 : p1 + 1;
    }
  }
}

}  // namespace esn
