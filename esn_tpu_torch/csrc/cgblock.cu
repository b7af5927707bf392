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
// What bounds it on an H100: bytes, by the count. CGNet's stage3 at batch
// 8, x (8,128,256,128) bf16, reads 67 MB and writes 67 MB (0.040 ms at
// 3.35 TB/s); its 1x1 reduce is 2.1 G multiply-adds (~0.005 ms on the
// tensor cores) and the stencils 0.6 G (~0.02 ms of f32 FMAs). The unfused
// chain writes y, both context maps and the f32 join to device memory;
// here none of them leaves shared memory, and the kernel's job is to keep
// the loads, the product and the stores of different pixels in flight at
// once. The first designs ran one 8-warp block an SM in strict sequence
// (load a chunk of x through registers, widen it to f32, multiply in f32
// FMAs, and only then the stencils, one bf16 a thread), recomputing y on
// a halo 2.5x the tile: 0.743 ms at stage3. This one takes ~0.18 ms there
// (NVIDIA H100 80GB HBM3, 700.00 W), and what bounds it now is instruction
// throughput at 16 warps an SM: the stencils are ~800 instructions per (pixel
// pair, 8 channels), a quarter of them unpacking bf16, and knocking them
// out saves 0.08 ms, the reduce 0.06 ms, the stores 0.01 ms and the loads
// of x 0.004 ms (tools/kernel_phases.py).
//
// Design. Persistent blocks of 256 threads, two on an SM wherever their
// shared memory fits (every CGNet shape in bf16), each walking over units
// in a fixed order. A unit is (image, segment of `seg` output rows, strip
// of `tw` output columns); the block walks down the strip `rows` y rows a
// step and keeps y in a ring of rows + 2d rows of shared memory, so the
// vertical halo is computed once a segment (not once a tile) and only the
// 2d columns beside the strip are recomputed:
//   0. once a block: w1 (bf16: rounded to bf16 in the [half][C] layout
//      that ldmatrix reads as the B operand, K padded to 16 with zeros;
//      f32: as given), the taps, affines and slopes, in shared memory;
//   1. the step's x rows (strip + 2d columns) go to shared memory in x's
//      own dtype by 16-byte cp.async, zero-filled outside the image. With
//      two buffers the next step's rows are in flight while this step
//      multiplies and runs its stencils; with one (where two do not fit
//      beside a second block) they are started as soon as the product has
//      read the buffer and fly during the stencils. A channel count or an
//      x that is not 16-byte whole takes an element-by-element path;
//   2. the reduce. bf16: tensor cores, mma.sync m16n8k16 bf16 -> f32, a
//      warp 16 pixels x up to 64 reduced channels an item (narrower
//      items, which would spread a step's items more evenly over the
//      warps, measured slower); the affine + PReLU
//      epilogue writes y as bf16 from the accumulator fragments into the
//      ring, 0 for pixels outside the image. f32: FMAs (TF32 would break
//      the f32 tolerance), a thread 4 pixels x 4 channels;
//   3. the stencils for the output rows whose 2d rows below are now in
//      the ring: a thread takes 16 bytes of channels (8 bf16, 4 f32) of
//      two neighbouring pixels, reads y by 16-byte vectors, applies the
//      join affine + PReLU and stores each half of j by 16 bytes. It keeps
//      the f32 sums of its channels over the whole unit in registers;
//   4. at the end of a unit those sums are added over threads in a fixed
//      order into one partial per (image, unit, channel); a second kernel
//      adds the partials per (image, channel) in unit order, in double.
// No float atomics, and the units depend only on the shape, not on which
// block takes which: two launches, or launches with other grids, give
// bit-identical j and sums. esn_tpu_torch/tools/kernel_phases.py times the
// phases and the plans.
#include "common.cuh"

#include <initializer_list>
#include <type_traits>

namespace {

using esn::from_f32;
using esn::kMaxSmem;
using esn::kSmemTwoBlocks;
using esn::pack_bf16;
using esn::unpack;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTileW = 32;
// blocks the planner wants units for (two on each of an H100's 132 SMs);
// the launch asks the card how many are resident
constexpr int kPlanBlocks = 264;

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// a plan forced by esn_cgblock_pre_tune (0: the planner's choice)
int g_tune[4] = {0, 0, 0, 0};

// the plan of a launch: the units, and the shared-memory layout (byte
// offsets) for element size `es`
struct Plan {
  int tw, rows, seg, nbuf;  // strip width, y rows a step, output rows a unit, x buffers
  int strips, segs;         // units an image = strips * segs
  int half, ve;             // reduced channels; elements in 16 bytes
  int wt, nr, chunk;        // strip + halo columns; ring rows; pixels a step
  int mp;                   // chunk padded to the product's M (bf16 16, f32 4)
  int kp, ldx;              // K padded, row stride of x (and of bf16 w1^T)
  int np;                   // bf16: rows of w1^T (half padded to 16); f32: half padded to 4
  int yc, ldy;              // channels of a ring pixel, its stride
  int groups, lanes;        // 16-byte channel groups; threads a group
  int o_w1, o_x, xbytes, o_taps, o_aff, o_y, bytes;
};

__host__ inline Plan make_plan(int es, int h, int w, int c, int d, int tw, int rows, int seg,
                               int nbuf) {
  Plan p;
  p.tw = tw, p.rows = rows, p.seg = seg, p.nbuf = nbuf;
  p.strips = (w + tw - 1) / tw;
  p.segs = (h + seg - 1) / seg;
  p.half = c / 2;
  p.ve = 16 / es;
  p.wt = tw + 2 * d;
  p.nr = rows + 2 * d;
  p.chunk = rows * p.wt;
  const bool bf = es == 2;
  p.mp = round_up(p.chunk, bf ? 16 : 4);
  p.kp = round_up(c, bf ? 16 : 4);
  p.ldx = bf ? p.kp + 8 : p.kp;
  p.np = round_up(p.half, bf ? 16 : 4);
  p.yc = p.np;
  p.groups = (p.half + p.ve - 1) / p.ve;
  p.lanes = kThreads / p.groups;
  // A ring pixel's stride in bytes: 16 past its channels, which spreads
  // the product's accumulator stores over the banks. With 2 or 4 channel
  // groups, the 8 threads that share a 16-byte load phase in the stencils
  // read 4 or 2 pixel pairs: the stride that lays those pairs side by side
  // in the 128 bytes of banks instead (2 * stride = 32 or 64 mod 128).
  int stride = p.yc * es + 16;
  if (p.groups == 2 || p.groups == 4)
    stride = (p.yc * es + 63) / 64 * 64 + p.groups * 8;
  p.ldy = stride / es;
  int o = 0;
  p.o_w1 = o, o += round_up(bf ? p.np * p.ldx * 2 : p.kp * p.np * 4, 16);
  p.xbytes = round_up(p.mp * p.ldx * es, 16);
  p.o_x = o, o += nbuf * p.xbytes;
  p.o_taps = o, o += 18 * p.yc * 4;
  p.o_aff = o, o += 9 * p.yc * 4;
  // the ring; at a unit's end it holds the threads' channel sums
  const int ring = p.nr * p.wt * p.ldy * es, red = p.lanes * 2 * p.groups * p.ve * 4;
  p.o_y = o, o += round_up(ring > red ? ring : red, 16);
  p.bytes = o;
  return p;
}

// Strips of up to 32 columns (even: a thread takes two pixels); the most
// rows a step (8, 4, 2, 1) and two x buffers before one, first among the
// plans that leave room for two blocks on an SM, then among those that
// fit at all, then with narrower strips. Segments as tall as still give
// every resident block a unit (halving from 256 rows down to 8).
Plan pick_plan(int es, int n, int h, int w, int c, int d) {
  int tw0 = w + (w & 1) < kMaxTileW ? w + (w & 1) : kMaxTileW;
  if (g_tune[0] > 0) tw0 = g_tune[0] + (g_tune[0] & 1);
  Plan best = make_plan(es, h, w, c, d, 2, 1, 8, 1);
  bool found = false;
  for (int tw = tw0; tw >= 2 && !found; tw = tw > 2 ? round_up(tw / 2, 2) : 0)
    for (int limit : {kSmemTwoBlocks, kMaxSmem}) {
      for (int rows = 8; rows >= 1 && !found; rows /= 2)
        for (int nbuf = 2; nbuf >= 1 && !found; --nbuf) {
          if ((g_tune[1] > 0 && rows != g_tune[1]) || (g_tune[2] > 0 && nbuf != g_tune[2]))
            continue;
          best = make_plan(es, h, w, c, d, tw, rows, 8, nbuf);
          found = best.bytes <= limit;
        }
      if (found) break;
    }
  int seg = 256;
  while (seg > 8 && (seg / 2 >= h || (int64_t)n * best.strips * ((h + seg - 1) / seg) <
                                          kPlanBlocks * 9 / 10))
    seg /= 2;
  if (g_tune[3] > 0) seg = g_tune[3];
  return make_plan(es, h, w, c, d, best.tw, best.rows, seg, best.nbuf);
}

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
  float* partial;    // (n, units an image, C)
  int n, h, w, c, d;
  int xvec, jvec;    // x's pixels / j's halves are whole aligned 16-byte vectors
};

struct Unit {
  int img, s0, ow0, urows;  // image, first output row and column, y rows (outputs + 2d)
};

__device__ __forceinline__ Unit unit_at(const CgArgs& a, const Plan& p, int t) {
  Unit u;
  u.ow0 = (t % p.strips) * p.tw;
  t /= p.strips;
  u.s0 = (t % p.segs) * p.seg;
  u.img = t / p.segs;
  u.urows = min(p.seg, a.h - u.s0) + 2 * a.d;
  return u;
}

__device__ __forceinline__ float prelu(float v, float a) { return v >= 0.f ? v : a * v; }

// 1. The x rows of step `step` of unit `u` (y rows [step*rows, +rows) of
// the unit, strip + halo columns) into xs ([chunk][ldx] in x's dtype), 0
// outside the image and past the unit's last row.
template <typename T>
__device__ __forceinline__ void stage_x(const CgArgs& a, const Plan& p, T* xs, const Unit& u,
                                        int step, int tid) {
  const T* x = static_cast<const T*>(a.x);
  const int r0 = u.s0 - a.d + step * p.rows, c0 = u.ow0 - a.d;
  const int rmax = u.s0 - a.d + u.urows;  // the unit's rows end here
  const int64_t img = (int64_t)u.img * a.h;
  if (a.xvec) {
    // thread's vector v of pixel q (row, col of the chunk), advanced by
    // kThreads vectors a turn without a division
    const int nv = a.c / p.ve, dq = kThreads / nv, dv = kThreads % nv;
    int q = tid / nv, v = tid - q * nv;
    int row = q / p.wt, col = q - row * p.wt;
    while (q < p.chunk) {
      const int gr = r0 + row, gc = c0 + col;
      const bool in = gr >= 0 && gr < a.h && gr < rmax && gc >= 0 && gc < a.w;
      const T* src = in ? x + ((img + gr) * a.w + gc) * a.c + v * p.ve : x;
      esn::cp_async16(xs + q * p.ldx + v * p.ve, src, in);
      const int carry = v + dv >= nv;
      v += dv - (carry ? nv : 0);
      q += dq + carry;
      col += dq + carry;
      while (col >= p.wt) col -= p.wt, ++row;
    }
  } else {
    const int total = p.chunk * p.kp;
    for (int i = tid; i < total; i += kThreads) {
      const int q = i / p.kp, ci = i - q * p.kp;
      const int row = q / p.wt, gr = r0 + row, gc = c0 + (q - row * p.wt);
      T v = from_f32<T>(0.f);
      if (ci < a.c && gr >= 0 && gr < a.h && gr < rmax && gc >= 0 && gc < a.w)
        v = x[((img + gr) * a.w + gc) * a.c + ci];
      xs[q * p.ldx + ci] = v;
    }
  }
  esn::cp_async_commit();
}

// y of chunk pixel q of step `step` into the ring: where it goes, and
// whether it lies inside the image (else y is 0: the padding is of y)
struct YPixel {
  int offset;  // elements from the ring's start
  bool inside;
};

__device__ __forceinline__ YPixel y_pixel(const CgArgs& a, const Plan& p, const Unit& u,
                                          int step, int q) {
  const int row = q / p.wt, col = q - row * p.wt;
  const int ur = step * p.rows + row;  // y row of the unit
  const int gr = u.s0 - a.d + ur, gc = u.ow0 - a.d + col;
  YPixel y;
  y.offset = ((ur % p.nr) * p.wt + col) * p.ldy;
  y.inside = ur < u.urows && gr >= 0 && gr < a.h && gc >= 0 && gc < a.w;
  return y;
}

// acc += A (16 pixels x kp, rows at a_row) x B (NT tiles of 8 channels x
// kp, rows at b_row), NT even: no branch in the loop, so the next k's
// fragments load while this k's products run
template <int NT>
__device__ __forceinline__ void product(float (*acc)[4], const __nv_bfloat16* a_row,
                                        const __nv_bfloat16* b_row, int kp, int ldx) {
#pragma unroll 2
  for (int k0 = 0; k0 < kp; k0 += 16) {
    unsigned af[4];
    esn::ldmatrix_x4(af, a_row + k0);
#pragma unroll
    for (int i = 0; i < NT; i += 2) {
      unsigned bf[4];
      esn::ldmatrix_x4(bf, b_row + 8 * i * ldx + k0);
      esn::mma_bf16(acc[i], af, bf[0], bf[1]);
      esn::mma_bf16(acc[i + 1], af, bf[2], bf[3]);
    }
  }
}

// 2. bf16: xs (mp x kp) @ w1^T (np x kp, [n][k]) on tensor cores; a warp
// takes 16 pixels x up to 8 tiles of 8 reduced channels an item, each tile
// an independent accumulator chain
__device__ __forceinline__ void reduce_bf16(const CgArgs& a, const Plan& p, const Unit& u,
                                            int step, const __nv_bfloat16* xs,
                                            const __nv_bfloat16* w1t, const float* aff,
                                            __nv_bfloat16* ys, int tid) {
  const float *a1 = aff, *b1 = aff + p.yc, *p1 = aff + 2 * p.yc;
  const int lane = tid & 31;
  // ldmatrix row addresses: A rows m0 + lane%16 at k + 8*(lane/16); B (two
  // n-tiles of 8) rows n0 + lane%8 + 8*(lane/16) at k + 8*((lane/8)%2)
  const int a_off = (lane & 15) * p.ldx + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * p.ldx + ((lane >> 3) & 1) * 8;
  const int nchunks = (p.np + 63) / 64, items = (p.mp / 16) * nchunks;
  for (int item = tid >> 5; item < items; item += kWarps) {
    const int m0 = (item / nchunks) * 16, n0 = (item % nchunks) * 64;
    // the two pixels of this lane's accumulator rows: m0 + lane/4 (+8)
    YPixel yp[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int q = m0 + (lane >> 2) + 8 * hr;
      yp[hr] = y_pixel(a, p, u, step, q < p.chunk ? q : 0);
      if (q >= p.chunk) yp[hr].offset = -1;
    }
    const __nv_bfloat16* a_row = xs + m0 * p.ldx + a_off;
    const __nv_bfloat16* b_row = w1t + n0 * p.ldx + b_off;
    const int nt = min(8, (p.np - n0) / 8);  // even: np is a multiple of 16
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    if (nt == 8)
      product<8>(acc, a_row, b_row, p.kp, p.ldx);
    else if (nt == 6)
      product<6>(acc, a_row, b_row, p.kp, p.ldx);
    else if (nt == 4)
      product<4>(acc, a_row, b_row, p.kp, p.ldx);
    else
      product<2>(acc, a_row, b_row, p.kp, p.ldx);
    // acc[i]: rows m0 + lane/4 (+8), columns n0 + 8i + 2*(lane%4) (+1)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i >= nt) break;
      const int ch = n0 + 8 * i + 2 * (lane & 3);
      const float2 sa = *reinterpret_cast<const float2*>(a1 + ch);
      const float2 sb = *reinterpret_cast<const float2*>(b1 + ch);
      const float2 sp = *reinterpret_cast<const float2*>(p1 + ch);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        if (yp[hr].offset < 0) continue;
        float v0 = 0.f, v1 = 0.f;
        if (yp[hr].inside) {
          v0 = prelu(acc[i][2 * hr] * sa.x + sb.x, sp.x);
          v1 = prelu(acc[i][2 * hr + 1] * sa.y + sb.y, sp.y);
        }
        *reinterpret_cast<unsigned*>(ys + yp[hr].offset + ch) = pack_bf16(v0, v1);
      }
    }
  }
}

// 2. f32: xs (mp x kp) @ w1 (kp x np) in FMAs, 4 pixels x 4 channels a
// work item
__device__ __forceinline__ void reduce_f32(const CgArgs& a, const Plan& p, const Unit& u,
                                           int step, const float* xs, const float* w1s,
                                           const float* aff, float* ys, int tid) {
  const float *a1 = aff, *b1 = aff + p.yc, *p1 = aff + 2 * p.yc;
  const int ncg = p.np / 4;
  for (int item = tid; item < ncg * (p.mp / 4); item += kThreads) {
    const int k0 = (item % ncg) * 4, q0 = (item / ncg) * 4;
    float acc[4][4] = {};
    const float* xr = xs + q0 * p.ldx;
    for (int ci = 0; ci < p.kp; ci += 4) {
      float4 xv[4], wv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) xv[q] = *reinterpret_cast<const float4*>(xr + q * p.ldx + ci);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        wv[e] = *reinterpret_cast<const float4*>(w1s + (ci + e) * p.np + k0);
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
      if (q0 + q >= p.chunk) break;
      const YPixel yp = y_pixel(a, p, u, step, q0 + q);
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = yp.inside ? prelu(acc[q][e] * a1[k0 + e] + b1[k0 + e], p1[k0 + e]) : 0.f;
      *reinterpret_cast<float4*>(ys + yp.offset + k0) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// 16 bytes of j: 8 bfloat16 or 4 floats
__device__ __forceinline__ uint4 pack_j(const float* v, __nv_bfloat16) {
  return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                    pack_bf16(v[6], v[7]));
}
__device__ __forceinline__ uint4 pack_j(const float* v, float) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}

// 3. Output rows [o0, o1) of the unit (row o reads y rows o .. o + 2d of
// the unit from the ring): both stencils, the join affine + PReLU, j. A
// thread keeps one group of 16 bytes of channels and takes two
// neighbouring pixels an item; sl, ss: its running f32 sums of j (local,
// surround) over the unit.
template <typename T>
__device__ __forceinline__ void stencils(const CgArgs& a, const Plan& p, const Unit& u, int o0,
                                         int o1, const T* ys, const float* taps,
                                         const float* aff, float* sl, float* ss, int tid) {
  constexpr int kVe = 16 / sizeof(T);
  const int cg = tid % p.groups, lane = tid / p.groups;
  if (lane >= p.lanes) return;
  const int c0 = cg * kVe, d = a.d, pairs = p.tw / 2;
  const float* tl = taps + c0;              // [9][yc]
  const float* ts = taps + 9 * p.yc + c0;
  T* j = static_cast<T*>(a.j);
  // the thread's items: output row o, pixel pair `pair`, advanced by
  // p.lanes items a turn without a division
  const int d_o = p.lanes / pairs, d_pair = p.lanes % pairs;
  int o = o0 + lane / pairs, pair = lane % pairs;
  for (; o < o1; o += d_o + (pair >= pairs), pair -= pair >= pairs ? pairs : 0) {
    const int col = pair * 2, ow = u.ow0 + col;
    pair += d_pair;
    if (ow >= a.w) continue;
    const int om = o % p.nr;  // ring row of y row o; o + k, k <= 2d < nr, wraps once
    float accl[2][kVe], accs[2][kVe];
#pragma unroll
    for (int e = 0; e < kVe; ++e) accl[0][e] = accl[1][e] = accs[0][e] = accs[1][e] = 0.f;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      // local: y rows o + d - 1 + r, ring columns col + d - 1 .. col + d + 2
      const int rl = om + d - 1 + r, rs = om + r * d;
      const T* yl = ys + ((rl - (rl >= p.nr ? p.nr : 0)) * p.wt + col + d - 1) * p.ldy + c0;
      float yv[4][kVe];
#pragma unroll
      for (int v = 0; v < 4; ++v)
        unpack(*reinterpret_cast<const uint4*>(yl + v * p.ldy), yv[v], T());
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        float wv[kVe];
#pragma unroll
        for (int e = 0; e < kVe; e += 4) {
          const float4 t4 = *reinterpret_cast<const float4*>(tl + (r * 3 + v) * p.yc + e);
          wv[e] = t4.x, wv[e + 1] = t4.y, wv[e + 2] = t4.z, wv[e + 3] = t4.w;
        }
#pragma unroll
        for (int e = 0; e < kVe; ++e) {
          accl[0][e] = fmaf(yv[v][e], wv[e], accl[0][e]);
          accl[1][e] = fmaf(yv[v + 1][e], wv[e], accl[1][e]);
        }
      }
      // surround: y rows o + r*d, ring columns col + v*d (+1)
      const T* yr = ys + ((rs - (rs >= p.nr ? p.nr : 0)) * p.wt + col) * p.ldy + c0;
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        float y0[kVe], y1[kVe], wv[kVe];
        unpack(*reinterpret_cast<const uint4*>(yr + (v * d) * p.ldy), y0, T());
        unpack(*reinterpret_cast<const uint4*>(yr + (v * d + 1) * p.ldy), y1, T());
#pragma unroll
        for (int e = 0; e < kVe; e += 4) {
          const float4 t4 = *reinterpret_cast<const float4*>(ts + (r * 3 + v) * p.yc + e);
          wv[e] = t4.x, wv[e + 1] = t4.y, wv[e + 2] = t4.z, wv[e + 3] = t4.w;
        }
#pragma unroll
        for (int e = 0; e < kVe; ++e) {
          accs[0][e] = fmaf(y0[e], wv[e], accs[0][e]);
          accs[1][e] = fmaf(y1[e], wv[e], accs[1][e]);
        }
      }
    }
    // join affine + PReLU: [a2, b2, p2] x [local, surround], each yc wide
    const float* jn = aff + 3 * p.yc + c0;
    T* out = j + (((int64_t)u.img * a.h + u.s0 + o) * a.w + ow) * a.c + c0;
#pragma unroll
    for (int px = 0; px < 2; ++px) {
      if (ow + px >= a.w) break;
      float jl[kVe], js[kVe];
#pragma unroll
      for (int e = 0; e < kVe; ++e) {
        jl[e] = prelu(accl[px][e] * jn[e] + jn[2 * p.yc + e], jn[4 * p.yc + e]);
        js[e] = prelu(accs[px][e] * jn[p.yc + e] + jn[3 * p.yc + e], jn[5 * p.yc + e]);
        sl[e] += jl[e];
        ss[e] += js[e];
      }
      T* o_px = out + (int64_t)px * a.c;
      if (a.jvec) {  // both halves of the concat, 16 bytes each
        *reinterpret_cast<uint4*>(o_px) = pack_j(jl, T());
        *reinterpret_cast<uint4*>(o_px + p.half) = pack_j(js, T());
      } else {
#pragma unroll
        for (int e = 0; e < kVe; ++e)
          if (c0 + e < p.half) {
            o_px[e] = from_f32<T>(jl[e]);
            o_px[p.half + e] = from_f32<T>(js[e]);
          }
      }
    }
  }
}

// kMinBlocks 2 caps the registers at 128 so that two blocks fit on an SM
// (where their shared memory does)
template <typename T, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks) cgblock_kernel(CgArgs a, Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kBf16 = !std::is_same<T, float>::value;
  constexpr int kVe = 16 / sizeof(T);
  const int tid = threadIdx.x;
  const int units = a.n * p.segs * p.strips;
  int t = blockIdx.x;
  if (t >= units) return;
  T* xbuf = reinterpret_cast<T*>(smem + p.o_x);
  const int xelems = p.xbytes / (int)sizeof(T);
  float* taps = reinterpret_cast<float*>(smem + p.o_taps);
  float* aff = reinterpret_cast<float*>(smem + p.o_aff);
  T* ys = reinterpret_cast<T*>(smem + p.o_y);

  // the x buffers' padding (rows past the chunk, channels past C) is read
  // by the product: zeros, once
  for (int i = tid; i < p.nbuf * p.xbytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(xbuf)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  Unit u = unit_at(a, p, t);
  stage_x<T>(a, p, xbuf, u, 0, tid);

  // 0. parameters, once a block; channels past half are zeros
  if constexpr (kBf16) {
    __nv_bfloat16* w1t = reinterpret_cast<__nv_bfloat16*>(smem + p.o_w1);  // [np][ldx]
    for (int i = tid; i < a.c * p.half; i += kThreads) {  // coalesced reads of w1
      const int ci = i / p.half, k = i - ci * p.half;
      w1t[k * p.ldx + ci] = __float2bfloat16_rn(a.w1[i]);
    }
    for (int i = tid; i < p.np * p.ldx; i += kThreads) {  // the padding
      const int k = i / p.ldx, ci = i - k * p.ldx;
      if (k >= p.half || ci >= a.c) w1t[i] = __float2bfloat16_rn(0.f);
    }
  } else {
    float* w1s = reinterpret_cast<float*>(smem + p.o_w1);  // [kp][np]
    for (int i = tid; i < p.kp * p.np; i += kThreads) {
      const int ci = i / p.np, k = i - ci * p.np;
      w1s[i] = ci < a.c && k < p.half ? a.w1[ci * p.half + k] : 0.f;
    }
  }
  for (int i = tid; i < 9 * p.yc; i += kThreads) {
    const int tap = i / p.yc, k = i - tap * p.yc;
    taps[i] = k < p.half ? a.dwl[tap * p.half + k] : 0.f;
    taps[9 * p.yc + i] = k < p.half ? a.dws[tap * p.half + k] : 0.f;
  }
  for (int k = tid; k < p.yc; k += kThreads) {
    const bool in = k < p.half;
    aff[k] = in ? a.a1[k] : 0.f;
    aff[p.yc + k] = in ? a.b1[k] : 0.f;
    aff[2 * p.yc + k] = in ? a.p1[k] : 0.f;
    aff[3 * p.yc + k] = in ? a.a2[k] : 0.f;
    aff[4 * p.yc + k] = in ? a.a2[p.half + k] : 0.f;
    aff[5 * p.yc + k] = in ? a.b2[k] : 0.f;
    aff[6 * p.yc + k] = in ? a.b2[p.half + k] : 0.f;
    aff[7 * p.yc + k] = in ? a.p2[k] : 0.f;
    aff[8 * p.yc + k] = in ? a.p2[p.half + k] : 0.f;
  }

  int buf = 0;
  for (; t < units; t += gridDim.x) {
    u = unit_at(a, p, t);
    const int nsteps = (u.urows + p.rows - 1) / p.rows;
    float sl[kVe], ss[kVe];
#pragma unroll
    for (int e = 0; e < kVe; ++e) sl[e] = ss[e] = 0.f;
    for (int step = 0; step < nsteps; ++step) {
      esn::cp_async_wait_all();
      __syncthreads();  // this step's x has landed; the ring rows it overwrites are read
      // what to stage next: this unit's next step, or the next unit's first
      const bool last = step + 1 == nsteps;
      const bool more = !last || t + gridDim.x < units;
      const Unit nu = last && more ? unit_at(a, p, t + gridDim.x) : u;
      const int nstep = last ? 0 : step + 1;
      T* xs = xbuf + buf * xelems;
      if (p.nbuf == 2 && more) stage_x<T>(a, p, xbuf + (buf ^ 1) * xelems, nu, nstep, tid);
      if constexpr (kBf16)
        reduce_bf16(a, p, u, step, xs, reinterpret_cast<const __nv_bfloat16*>(smem + p.o_w1),
                    aff, ys, tid);
      else
        reduce_f32(a, p, u, step, xs, reinterpret_cast<const float*>(smem + p.o_w1), aff, ys,
                   tid);
      __syncthreads();  // y rows are in the ring; xs is free
      if (p.nbuf == 1 && more) stage_x<T>(a, p, xbuf, nu, nstep, tid);
      const int done = min((step + 1) * p.rows, u.urows);  // y rows computed so far
      const int o0 = max(step * p.rows - 2 * a.d, 0), o1 = done - 2 * a.d;
      if (o1 > o0) stencils<T>(a, p, u, o0, o1, ys, taps, aff, sl, ss, tid);
      if (p.nbuf == 2) buf ^= 1;
    }
    // 4. the unit's channel sums: over the threads of a channel group in
    // lane order (the ring is free by now)
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem + p.o_y);  // [lanes][2][groups * ve]
    const int gw = p.groups * kVe, cg = tid % p.groups, lane = tid / p.groups;
    if (lane < p.lanes) {
#pragma unroll
      for (int e = 0; e < kVe; ++e) {
        red[lane * 2 * gw + cg * kVe + e] = sl[e];
        red[(lane * 2 + 1) * gw + cg * kVe + e] = ss[e];
      }
    }
    __syncthreads();
    float* part = a.partial + (int64_t)t * a.c;
    for (int i = tid; i < 2 * gw; i += kThreads) {
      const int hs = i / gw, k = i - hs * gw;
      if (k >= p.half) continue;
      float s = 0.f;
      for (int l = 0; l < p.lanes; ++l) s += red[l * 2 * gw + i];
      part[hs * p.half + k] = s;
    }
    // the next step's first barrier comes before the ring is written again
  }
}

// sums[img, ch] = sum over units of partial[img, unit, ch], in unit order
__global__ void cgblock_sum_kernel(const float* partial, float* sums, int n, int tiles, int c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * c) return;
  const int img = i / c, ch = i - img * c;
  const float* src = partial + (int64_t)img * tiles * c + ch;
  double s = 0.0;
  for (int t = 0; t < tiles; ++t) s += src[(int64_t)t * c];
  sums[i] = (float)s;
}

template <typename T, int kMinBlocks>
cudaError_t launch_as(const CgArgs& a, const Plan& p, float* sums, int max_blocks,
                      cudaStream_t stream) {
  const auto kernel = cgblock_kernel<T, kMinBlocks>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.bytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                           p.bytes)) != cudaSuccess)
    return err;
  const int64_t units = (int64_t)a.n * p.segs * p.strips;
  int64_t grid = (int64_t)(per_sm > 1 ? per_sm : 1) * sms;
  if (max_blocks > 0 && max_blocks < grid) grid = max_blocks;
  if (units < grid) grid = units;
  kernel<<<(int)grid, kThreads, p.bytes, stream>>>(a, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int total = a.n * a.c;
  cgblock_sum_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      a.partial, sums, a.n, p.segs * p.strips, a.c);
  return cudaGetLastError();
}

int itemsize_of(int dtype) {
  if (dtype == esn::kF32) return 4;
  if (dtype == esn::kBF16) return 2;
  return 0;
}

bool takes(int isz, int h, int w, int c, int d) {
  return isz != 0 && h >= 1 && w >= 1 && c >= 2 && c % 2 == 0 && d >= 1;
}

}  // namespace

// Units per image of the launch for this shape (the partial buffer holds
// n x units x c f32); -1 for a dtype it does not take or a shape whose
// smallest plan does not fit in shared memory.
extern "C" int esn_cgblock_pre_tiles(int dtype, int n, int h, int w, int c, int d) {
  const int isz = itemsize_of(dtype);
  if (!takes(isz, h, w, c, d) || n < 1) return -1;
  const Plan p = pick_plan(isz, n, h, w, c, d);
  if (p.bytes > kMaxSmem || (int64_t)n * p.segs * p.strips > INT32_MAX) return -1;
  return p.segs * p.strips;
}

// For timing other plans than the planner's (tools/kernel_phases.py):
// strip width, y rows a step, x buffers and output rows a unit of every
// later launch, 0 for the planner's choice of that one.
extern "C" void esn_cgblock_pre_tune(int tw, int rows, int nbuf, int seg) {
  g_tune[0] = tw, g_tune[1] = rows, g_tune[2] = nbuf, g_tune[3] = seg;
}

// Shapes: x and j (n, h, w, c) of dtype `dtype`, contiguous; w1 (c, c/2),
// a1/b1/p1 (c/2,), dwl/dws (3, 3, c/2), a2/b2/p2 (c,), all f32; partial
// n x esn_cgblock_pre_tiles(...) x c f32 scratch; sums (n, c) f32.
// max_blocks > 0 caps the grid of persistent blocks (the result does not
// depend on it).
extern "C" int esn_cgblock_pre(const void* x, const void* w1, const void* a1, const void* b1,
                               const void* p1, const void* dwl, const void* dws,
                               const void* a2, const void* b2, const void* p2, void* j,
                               void* partial, void* sums, int dtype, int n, int h, int w,
                               int c, int d, int max_blocks, void* stream) {
  if (esn_cgblock_pre_tiles(dtype, n, h, w, c, d) < 0) return cudaErrorInvalidValue;
  const int isz = itemsize_of(dtype);
  const Plan p = pick_plan(isz, n, h, w, c, d);
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
                 n, h, w, c, d,
                 (c * isz) % 16 == 0 && esn::aligned16(x),
                 (p.half * isz) % 16 == 0 && esn::aligned16(j)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* s = static_cast<float*>(sums);
  const bool two = p.bytes <= kSmemTwoBlocks;
  if (dtype == esn::kF32)
    return two ? launch_as<float, 2>(a, p, s, max_blocks, st)
               : launch_as<float, 1>(a, p, s, max_blocks, st);
  return two ? launch_as<__nv_bfloat16, 2>(a, p, s, max_blocks, st)
             : launch_as<__nv_bfloat16, 1>(a, p, s, max_blocks, st);
}
