// Fused CGNet context-guided block, eval mode, up to the global gate (NHWC).
//
// Replaces the TPU kernel esn_tpu/ops/pallas/cgblock.py (`fused_cgblock_pre`
// -> `_cgblock_pre_pallas`, Pallas kernel `_kernel`). For x (N, H, W, C) and
// half = C/2:
//
//   y   = PReLU(a1 * (x @ w1) + b1, p1)            (N,H,W,half), x's dtype
//   j   = PReLU(a2 * cat(dw3x3(y), dw3x3_dil_d(y)) + b2, p2)   (N,H,W,C)
//   sum = the f32 j summed over (H, W), per (n, c)
//
// w1 is rounded to x's dtype and the reduce product sums in f32; y is
// rounded to x's dtype before the taps; the two depthwise sums are f32 and
// are not rounded before the join affine; j is stored in x's dtype and its
// f32 value (before that rounding) goes into the sum, as in the TPU kernel.
// Both depthwise convs are SAME-padded with zeros: the padding is of y, so
// y is 0 outside the image (not PReLU(b1), which a zero-padded x gives).
//
// CGNet's stage3 at batch 8, x (8,128,256,128) bf16, moves 67 MB in and
// 67 MB out (40 us at 3.35 TB/s); its 1x1 reduce is 2.1 G multiply-adds,
// 2.5x that with the halo recomputed below, in f32 FMAs (no tensor cores):
// ~0.16 ms at the card's f32 peak. One block fits on an SM at that shape
// (~156 KB of shared memory), so nothing hides the latency of staging x:
// it is loaded 16 bytes at a time, several loads in flight per thread.
// The unfused chain writes y, both context maps and the f32 join to device
// memory; here none of them leaves shared memory.
//
// Design. One block of 256 threads per (image, tile of th x tw output
// pixels):
//   1. stage w1 (rounded to x's dtype, held as f32, rows padded to a
//      multiple of 4 channels), the taps, affines and slopes in shared
//      memory;
//   2. y over the tile plus a halo of d pixels on each side, in chunks of
//      halo pixels: the chunk of x goes to shared memory as f32 (16-byte
//      loads where C allows, see stage_x), each thread computes 4 pixels
//      x 4 reduce channels with float4 reads, and the affine + PReLU
//      result is stored in x's dtype into the y tile, 0 where the pixel
//      lies outside the image;
//   3. both 3x3 stencils per (pixel, channel) from the y tile, the join
//      affine and PReLU, j stored; each thread sums the f32 j of its
//      channel over its pixels;
//   4. those sums are added over threads in a fixed order into one partial
//      per (image, tile, channel); a second kernel adds the partials per
//      (image, channel) in tile order, in double.
// No float atomics, and the tiling depends only on the shape: two launches
// give bit-identical j and sums. The host picks the tile (8 x 32, smaller
// where shared memory runs out) and raises the dynamic shared-memory limit
// past 48 KB. Tensor cores (mma/wgmma), TMA and overlapping the staging
// of one chunk with the reduce of the last are later work.
#include "common.cuh"

namespace {

using esn::from_f32;
using esn::kMaxSmem;
using esn::to_f32;

constexpr int kThreads = 256;
constexpr int kTileH = 8, kTileW = 32;

__host__ __device__ inline int round4(int v) { return (v + 3) / 4 * 4; }

struct CgArgs {
  const void* x;
  const float* w1;   // (C, half)
  const float* a1;   // (half,)
  const float* b1;
  const float* p1;
  const float* dwl;  // (3, 3, half)
  const float* dws;
  const float* a2;   // (C,)
  const float* b2;
  const float* p2;
  void* j;
  float* partial;    // (n, tiles, C)
  int n, h, w, c, d, th, tw;
  int vec;           // x's pixels are whole 16-byte vectors (see stage_x)
};

// shared-memory plan, in the order of the buffers (floats, then y)
struct Plan {
  int half, kp, cp, ncg, npg, pc, lanes, groups;
  int w1s, xs, taps, vec, red, floats;  // float offsets / total
  int ht, wt;
  size_t bytes;
};

__host__ __device__ inline Plan plan(int c, int d, int th, int tw, int itemsize) {
  Plan p;
  p.half = c / 2;
  p.kp = round4(p.half);
  p.cp = round4(c);
  p.ncg = p.kp / 4;                                    // 4-channel groups of y
  p.npg = p.ncg < kThreads ? kThreads / p.ncg : 1;     // 4-pixel groups a chunk
  p.pc = 4 * p.npg;                                    // halo pixels a chunk
  p.lanes = p.half < kThreads ? p.half : kThreads;     // stencil channels
  p.groups = kThreads / p.lanes;                       // stencil pixel groups
  p.w1s = 0;
  p.xs = p.w1s + p.cp * p.kp;
  p.taps = p.xs + p.pc * p.cp;
  p.vec = p.taps + round4(18 * p.half);
  p.red = p.vec + round4(3 * p.half + 3 * c);
  p.floats = p.red + round4(2 * p.groups * p.lanes);
  p.ht = th + 2 * d;
  p.wt = tw + 2 * d;
  p.bytes = (size_t)p.floats * sizeof(float) + (size_t)p.ht * p.wt * p.half * itemsize;
  return p;
}

struct Tile {
  int th, tw;
};

Tile pick_tile(int h, int w, int c, int d, int itemsize) {
  Tile t{h < kTileH ? h : kTileH, w < kTileW ? w : kTileW};
  while (plan(c, d, t.th, t.tw, itemsize).bytes > (size_t)kMaxSmem && (t.th > 1 || t.tw > 1)) {
    if (t.th > 1)
      t.th = (t.th + 1) / 2;
    else
      t.tw = (t.tw + 1) / 2;
  }
  return t;
}

__device__ __forceinline__ float prelu(float v, float a) { return v >= 0.f ? v : a * v; }

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

// Chunk of halo pixels [q0, q0 + pc) of x into xs (pc x cp f32), 0 outside
// the image and past the halo. With a.vec (c * sizeof(T) a multiple of 16,
// x 16-byte aligned, so cp == c) each thread starts kLoads 16-byte loads
// before it stores any, so they are in flight together; otherwise one
// element at a time.
template <typename T>
__device__ __forceinline__ void stage_x(const CgArgs& a, const Plan& p, float* xs, int img,
                                        int r0, int c0, int q0, int tid) {
  const T* x = static_cast<const T*>(a.x);
  const int nhalo = p.ht * p.wt;
  if (!a.vec) {
    for (int i = tid; i < p.pc * p.cp; i += kThreads) {
      const int qi = i / p.cp, ci = i - qi * p.cp;
      const int q = q0 + qi;
      float v = 0.f;
      if (q < nhalo && ci < a.c) {
        const int gr = r0 + q / p.wt, gc = c0 + q % p.wt;
        if (gr >= 0 && gr < a.h && gc >= 0 && gc < a.w)
          v = to_f32(x[(((int64_t)img * a.h + gr) * a.w + gc) * a.c + ci]);
      }
      xs[i] = v;
    }
    return;
  }
  constexpr int kVec = 16 / sizeof(T);  // elements of x per load
  constexpr int kLoads = 4;
  const int per_pixel = a.c / kVec;
  const int nvec = p.pc * per_pixel;
  for (int i0 = tid; i0 < nvec; i0 += kLoads * kThreads) {
    uint4 v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      const int i = i0 + u * kThreads;
      const int qi = i / per_pixel, q = q0 + qi;
      if (i < nvec && q < nhalo) {
        const int gr = r0 + q / p.wt, gc = c0 + q % p.wt;
        if (gr >= 0 && gr < a.h && gc >= 0 && gc < a.w)
          v[u] = __ldg(reinterpret_cast<const uint4*>(
                           x + (((int64_t)img * a.h + gr) * a.w + gc) * a.c) +
                       (i - qi * per_pixel));
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = i0 + u * kThreads;
      if (i >= nvec) break;
      float f[kVec];
      unpack(v[u], f, T());
      float4* dst = reinterpret_cast<float4*>(xs + i * kVec);  // cp == c
#pragma unroll
      for (int e = 0; e < kVec / 4; ++e)
        dst[e] = make_float4(f[4 * e], f[4 * e + 1], f[4 * e + 2], f[4 * e + 3]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) cgblock_kernel(CgArgs a) {
  extern __shared__ __align__(16) float smem[];
  const Plan p = plan(a.c, a.d, a.th, a.tw, sizeof(T));
  const int c = a.c, half = p.half, d = a.d, tw = a.tw;
  float* w1s = smem + p.w1s;  // cp x kp
  float* xs = smem + p.xs;    // pc x cp
  float* tl = smem + p.taps;  // 9 x half, then the surround's 9 x half
  float* ts = tl + 9 * half;
  float* a1 = smem + p.vec;
  float* b1 = a1 + half;
  float* p1 = b1 + half;
  float* a2 = p1 + half;
  float* b2 = a2 + c;
  float* p2 = b2 + c;
  float* red = smem + p.red;                      // 2 x groups x lanes
  T* ys = reinterpret_cast<T*>(smem + p.floats);  // ht x wt x half

  const int img = blockIdx.z;
  const int oh0 = blockIdx.y * a.th, ow0 = blockIdx.x * tw;
  const int r0 = oh0 - d, c0 = ow0 - d;
  const int tid = threadIdx.x;

  // 1. parameters
  for (int i = tid; i < p.cp * p.kp; i += kThreads) {
    const int ci = i / p.kp, k = i - ci * p.kp;
    float v = 0.f;
    if (ci < c && k < half) v = to_f32(from_f32<T>(a.w1[ci * half + k]));
    w1s[i] = v;
  }
  for (int i = tid; i < 9 * half; i += kThreads) {
    tl[i] = a.dwl[i];
    ts[i] = a.dws[i];
  }
  for (int i = tid; i < half; i += kThreads) {
    a1[i] = a.a1[i];
    b1[i] = a.b1[i];
    p1[i] = a.p1[i];
  }
  for (int i = tid; i < c; i += kThreads) {
    a2[i] = a.a2[i];
    b2[i] = a.b2[i];
    p2[i] = a.p2[i];
  }

  // 2. y over the halo tile, chunk by chunk
  const int nhalo = p.ht * p.wt;
  for (int q0 = 0; q0 < nhalo; q0 += p.pc) {
    __syncthreads();  // the parameters are staged / the last chunk is read
    stage_x<T>(a, p, xs, img, r0, c0, q0, tid);
    __syncthreads();
    for (int item = tid; item < p.ncg * p.npg; item += kThreads) {
      const int k0 = (item % p.ncg) * 4, qi0 = (item / p.ncg) * 4;
      float acc[4][4] = {};
      const float* xr = xs + qi0 * p.cp;
      for (int ci = 0; ci < p.cp; ci += 4) {
        float4 xv[4], wv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[q] = *reinterpret_cast<const float4*>(xr + q * p.cp + ci);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          wv[e] = *reinterpret_cast<const float4*>(w1s + (ci + e) * p.kp + k0);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float xq[4] = {xv[q].x, xv[q].y, xv[q].z, xv[q].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[q][0] = fmaf(xq[e], wv[e].x, acc[q][0]);
            acc[q][1] = fmaf(xq[e], wv[e].y, acc[q][1]);
            acc[q][2] = fmaf(xq[e], wv[e].z, acc[q][2]);
            acc[q][3] = fmaf(xq[e], wv[e].w, acc[q][3]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int qq = q0 + qi0 + q;
        if (qq >= nhalo) break;
        const int gr = r0 + qq / p.wt, gc = c0 + qq % p.wt;
        const bool inside = gr >= 0 && gr < a.h && gc >= 0 && gc < a.w;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = k0 + e;
          if (k >= half) break;
          const float v = inside ? prelu(acc[q][e] * a1[k] + b1[k], p1[k]) : 0.f;
          ys[qq * half + k] = from_f32<T>(v);
        }
      }
    }
  }
  __syncthreads();

  // 3. stencils, join affine + PReLU, j, per-thread channel sums
  T* j = static_cast<T*>(a.j);
  const int kk = tid % p.lanes, g = tid / p.lanes;
  const bool active = g < p.groups;
  const int npix = a.th * tw;
  const int tiles = gridDim.x * gridDim.y;
  float* part = a.partial + ((int64_t)img * tiles + blockIdx.y * gridDim.x + blockIdx.x) * c;
  for (int kc = 0; kc < half; kc += p.lanes) {
    const int k = kc + kk;
    float sl = 0.f, ss = 0.f;
    if (active && k < half) {
      float wl[9], wsr[9];
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        wl[t] = tl[t * half + k];
        wsr[t] = ts[t * half + k];
      }
      const float al = a2[k], bl = b2[k], pl = p2[k];
      const float as = a2[half + k], bs = b2[half + k], ps = p2[half + k];
      for (int px = g; px < npix; px += p.groups) {
        const int py = px / tw, pxx = px - py * tw;
        const int oh = oh0 + py, ow = ow0 + pxx;
        if (oh >= a.h || ow >= a.w) continue;
        const T* yc = ys + ((py + d) * p.wt + (pxx + d)) * half + k;
        float accl = 0.f, accs = 0.f;
#pragma unroll
        for (int u = 0; u < 3; ++u)
#pragma unroll
          for (int v = 0; v < 3; ++v) {
            accl = fmaf(to_f32(yc[((u - 1) * p.wt + (v - 1)) * half]), wl[u * 3 + v], accl);
            accs = fmaf(to_f32(yc[((u - 1) * d * p.wt + (v - 1) * d) * half]), wsr[u * 3 + v], accs);
          }
        const float jl = prelu(accl * al + bl, pl), js = prelu(accs * as + bs, ps);
        T* o = j + (((int64_t)img * a.h + oh) * a.w + ow) * c;
        o[k] = from_f32<T>(jl);
        o[half + k] = from_f32<T>(js);
        sl += jl;
        ss += js;
      }
    }
    // 4. per-channel sums over the pixel groups, in group order
    if (active) {
      red[g * p.lanes + kk] = sl;
      red[(p.groups + g) * p.lanes + kk] = ss;
    }
    __syncthreads();
    if (tid < p.lanes && kc + tid < half) {
      float tsl = 0.f, tss = 0.f;
      for (int gg = 0; gg < p.groups; ++gg) {
        tsl += red[gg * p.lanes + tid];
        tss += red[(p.groups + gg) * p.lanes + tid];
      }
      part[kc + tid] = tsl;
      part[half + kc + tid] = tss;
    }
    __syncthreads();
  }
}

// sums[img, ch] = sum over tiles of partial[img, tile, ch], in tile order
__global__ void cgblock_sum_kernel(const float* partial, float* sums, int n, int tiles, int c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * c) return;
  const int img = i / c, ch = i - img * c;
  const float* src = partial + (int64_t)img * tiles * c + ch;
  double s = 0.0;
  for (int t = 0; t < tiles; ++t) s += src[(int64_t)t * c];
  sums[i] = (float)s;
}

int tiles_of(const Tile& t, int h, int w) {
  return ((h + t.th - 1) / t.th) * ((w + t.tw - 1) / t.tw);
}

template <typename T>
cudaError_t launch(CgArgs a, float* sums, cudaStream_t stream) {
  const Tile t = pick_tile(a.h, a.w, a.c, a.d, sizeof(T));
  a.th = t.th;
  a.tw = t.tw;
  const size_t smem = plan(a.c, a.d, t.th, t.tw, sizeof(T)).bytes;
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(cgblock_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.w + t.tw - 1) / t.tw, (a.h + t.th - 1) / t.th, a.n);
  cgblock_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total = a.n * a.c;
  cgblock_sum_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      a.partial, sums, a.n, tiles_of(t, a.h, a.w), a.c);
  return cudaGetLastError();
}

int itemsize_of(int dtype) {
  if (dtype == esn::kF32) return 4;
  if (dtype == esn::kBF16) return 2;
  return 0;
}

}  // namespace

// Tiles per image of the launch for this shape (the partial buffer holds
// n x tiles x c f32); -1 for a dtype it does not take or a shape whose
// smallest tile does not fit in shared memory.
extern "C" int esn_cgblock_pre_tiles(int dtype, int h, int w, int c, int d) {
  const int isz = itemsize_of(dtype);
  if (isz == 0 || h < 1 || w < 1 || c < 2 || c % 2 != 0 || d < 1) return -1;
  const Tile t = pick_tile(h, w, c, d, isz);
  if (plan(c, d, t.th, t.tw, isz).bytes > (size_t)kMaxSmem) return -1;
  return tiles_of(t, h, w);
}

// Shapes: x and j (n, h, w, c) of dtype `dtype`, contiguous; w1 (c, c/2),
// a1/b1/p1 (c/2,), dwl/dws (3, 3, c/2), a2/b2/p2 (c,), all f32; partial
// n x esn_cgblock_pre_tiles(...) x c f32 scratch; sums (n, c) f32.
extern "C" int esn_cgblock_pre(const void* x, const void* w1, const void* a1, const void* b1,
                               const void* p1, const void* dwl, const void* dws,
                               const void* a2, const void* b2, const void* p2, void* j,
                               void* partial, void* sums, int dtype, int n, int h, int w,
                               int c, int d, void* stream) {
  if (esn_cgblock_pre_tiles(dtype, h, w, c, d) < 0 || n < 1) return cudaErrorInvalidValue;
  const CgArgs a{x,
                 static_cast<const float*>(w1),
                 static_cast<const float*>(a1),
                 static_cast<const float*>(b1),
                 static_cast<const float*>(p1),
                 static_cast<const float*>(dwl),
                 static_cast<const float*>(dws),
                 static_cast<const float*>(a2),
                 static_cast<const float*>(b2),
                 static_cast<const float*>(p2),
                 j,
                 static_cast<float*>(partial),
                 n, h, w, c, d, 0, 0,
                 (c * itemsize_of(dtype)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* s = static_cast<float*>(sums);
  if (dtype == esn::kF32) return launch<float>(a, s, st);
  return launch<__nv_bfloat16>(a, s, st);
}
