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
// each; a tap past the input's edge (x[H] or x[W] for op = 1) reads zero.
//
// What bounds it on an H100: at ENet's predict (x (8,512,1024,16) bf16 ->
// (8,1024,2048) int32) it reads 134 MB and writes 67 MB, 0.060 ms at
// 3.35 TB/s; its 11.5 G multiply-adds (9 taps x 16 x 19 a low-res pixel)
// are 0.023 ms at the tensor cores' bf16 rate, and 0.34 ms as f32 FMAs.
//
// bf16 design (the second; the first ran f32 FMAs on the bf16 values at
// 13x its bytes bound, 76% of its time in the FMAs). Persistent blocks of
// 256 threads walk tiles of TH x 16 low-res pixels (TH = 16, fewer where
// shared memory runs out) of one image:
//   0. once per block: the weights, rounded to bf16 by the wrapper and
//      packed [slot][n][k] (K padded to a multiple of 16 with zeros, rows
//      ldk = K + 8 apart, classes padded to 8, 12, 20 or 32, then a zero
//      slot), the f32 bias and the phase pairs' offset tables, to shared
//      memory;
//   1. the tile's x with the taps' halo (the rows and columns dy, dx range
//      over), K channels a pixel, ldk apart (an odd count of 16-byte
//      units, so ldmatrix's eight row addresses hit distinct banks), by
//      16-byte cp.async, zero-filled outside the image and from I to K;
//      double-buffered where shared memory allows, so the next tile's
//      loads overlap this one's products. Channel counts or an x that are
//      not 16-byte whole take 8 element loads and one 16-byte store a
//      unit into the same layout;
//   2. per warp, per 16 pixels of a tile row (two rows a warp at TH = 16,
//      sharing each B fragment) and per phase pair (rh, 0), (rh, 1): one
//      mma.sync m16n8k16 product, bf16 x bf16 into f32, over the offsets
//      either phase reads x K/16 steps, A and B by ldmatrix. n-tile j holds
//      classes 4j .. 4j + 3 of each phase: its B rows are ldmatrix row
//      addresses into the two phases' slots (the zero slot where a phase
//      reads nothing at the offset). The first product adds to the bias;
//      the bf16 products are exact in f32;
//   3. the argmax in the accumulators' layout: lane (g, t) holds pixels g
//      and g + 8 of phase t/2, half its classes, the lane t^1 the other
//      half (padded classes -inf through the bias): the pair's largest
//      value by one xor shuffle, then the least class holding it by
//      another, so ties go to the first class;
//   4. each lane then holds one of the 32 classes (16 pixels x 2 phases)
//      of a full-resolution row, and the row segment leaves as one store
//      of the warp, 128 contiguous bytes.
// Each pixel is summed by one warp in a fixed order whatever the grid,
// so two launches, and any grid size, give the same bits.
//
// f32 design (the first, kept: the tensor cores have no f32 operand, and
// TF32 would round x and w): the weights (kh*kw*I*OMAX f32, classes padded
// to OMAX with zeros) and the bias go to shared memory once per block;
// each thread takes two neighbouring low-res pixels of a row, keeps
// 2 x OMAX f32 accumulators in registers for one phase at a time, reads
// each tap's channels with 16-byte loads (element by element where I
// does not fill whole vectors or x is not 16-byte aligned), reads each
// weight row as float4 broadcasts shared by both pixels, and runs the
// compare chain (a strict `>`: ties go to the first class). The four
// classes of an output row pair go out as two 8-byte stores. The grid
// strides over the pixel pairs.
#include "common.cuh"

#include <type_traits>

namespace {

using esn::cp_async16;
using esn::ldmatrix_x2;
using esn::ldmatrix_x4;
using esn::mma_bf16;

// d = a b + c for one m16n8k16 tile whose four accumulators' columns
// carry c (c[0] at even columns, c[1] at odd ones, both rows)
__device__ __forceinline__ void mma_bf16_c(float* d, const unsigned* a, unsigned b0,
                                           unsigned b1, const float* c) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%11,%10,%11};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(c[0]), "f"(c[1]));
}

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPhases = 4;   // stride 2 on both axes
constexpr int kMaxTaps = 16; // taps of one phase (k <= 8 per axis)
constexpr int kTileW = 16;   // low-res columns a tile: the product's M

constexpr int kMaxPairs = 2 * kMaxTaps;  // offsets of one phase pair

// the shape and the phases' tap tables: tap t of phase ph reads x at
// (q + dy, p + dx) with weight slot uh * kw + uw. The bf16 route also
// reads the phase pairs' tables: entry e of pair rh (phases (rh, 0) and
// (rh, 1)) is an offset (dy, dx) that either phase reads, with the slot
// each phase takes there, or the zero slot nslots where it reads none.
struct Geo {
  int n, h, w, ci, co;
  int ntaps[kPhases];
  int dy[kPhases][kMaxTaps], dx[kPhases][kMaxTaps], slot[kPhases][kMaxTaps];
  int npairs[2];
  int pair[2][kMaxPairs][4];  // dy, dx, slot of (rh, 0), slot of (rh, 1)
};

// ---------------------------------------------------------------------------
// bf16: tensor cores over a staged tile

// The wrapper's plan (subpixel_argmax.py `plan_bf16`), checked by `check`:
// byte offsets in shared memory of the bias (0), the tap table (after the
// bias, kTapBytes), the weights and the x tiles; a staged pixel is ldk
// bf16, a tile rows x cols pixels whose pixel (0, 0) is low-res
// (ty*th + y0, tx*16 + x0).
struct Plan {
  int kp, np, ldk;       // K padded to 16, classes padded to 4 ntp(O), kp + 8
  int th, nbuf;          // low-res rows a tile (16, 8, 4, 2 or 1), x buffers (1 or 2)
  int y0, x0;            // the taps' least dy and dx
  int rows, cols;        // staged rows th + dy range, columns 16 + dx range
  int o_w, o_x, tile_bytes, bytes;
  int max_blocks;        // a cap on the grid (0: as many as fit)
};
constexpr int kPlanFields = 14;
constexpr int kTapBytes = 2 * kMaxPairs * 16;  // int4 (A offset, B offsets, 0) an entry

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// n-tiles of 8 columns a phase pair's product takes for co classes: each
// holds 4 classes of each phase (2, 3, 5 or 8: 4 ntp classes a phase)
inline int pair_tiles(int co) { return co <= 8 ? 2 : co <= 12 ? 3 : co <= 20 ? 5 : co <= 32 ? 8 : 0; }

// the plan's fields against what they must be for g and nslots
inline bool check(const Plan& p, const Geo& g, int nslots) {
  int ymin = 1 << 20, ymax = -(1 << 20), xmin = 1 << 20, xmax = -(1 << 20);
  for (int ph = 0; ph < kPhases; ++ph)
    for (int t = 0; t < g.ntaps[ph]; ++t) {
      ymin = g.dy[ph][t] < ymin ? g.dy[ph][t] : ymin;
      ymax = g.dy[ph][t] > ymax ? g.dy[ph][t] : ymax;
      xmin = g.dx[ph][t] < xmin ? g.dx[ph][t] : xmin;
      xmax = g.dx[ph][t] > xmax ? g.dx[ph][t] : xmax;
    }
  // every phase's taps once in its pair's table, nothing else there
  for (int rh = 0; rh < 2; ++rh) {
    if (g.npairs[rh] < 1 || g.npairs[rh] > kMaxPairs) return false;
    int uses[2] = {0, 0};
    for (int e = 0; e < g.npairs[rh]; ++e) {
      const int* en = g.pair[rh][e];
      if (en[0] < ymin || en[0] > ymax || en[1] < xmin || en[1] > xmax) return false;
      for (int rw = 0; rw < 2; ++rw) {
        const int s = en[2 + rw], ph = 2 * rh + rw;
        if (s < 0 || s > nslots) return false;
        if (s == nslots) continue;
        bool found = false;
        for (int t = 0; t < g.ntaps[ph]; ++t)
          found |= g.dy[ph][t] == en[0] && g.dx[ph][t] == en[1] && g.slot[ph][t] == s;
        if (!found) return false;
        ++uses[rw];
      }
    }
    if (uses[0] != g.ntaps[2 * rh] || uses[1] != g.ntaps[2 * rh + 1]) return false;
  }
  const int o_w = round_up(p.np * 4, 16) + kTapBytes;
  const int64_t o_x = o_w + (int64_t)(nslots + 1) * p.np * p.ldk * 2;
  const int64_t tile = (int64_t)p.rows * p.cols * p.ldk * 2;
  return p.kp == round_up(g.ci, 16) && pair_tiles(g.co) > 0 && p.np == 4 * pair_tiles(g.co) &&
         p.ldk == p.kp + 8 && p.th >= 1 && p.th <= 2 * kWarps && (p.th & (p.th - 1)) == 0 &&
         (p.nbuf == 1 || p.nbuf == 2) &&
         p.y0 == ymin && p.x0 == xmin && p.rows == p.th + ymax - ymin &&
         p.cols == kTileW + xmax - xmin && p.o_w == o_w && p.o_x == o_x &&
         p.tile_bytes == tile && p.bytes == o_x + p.nbuf * tile &&
         p.bytes <= esn::kMaxSmem && p.max_blocks >= 0 &&
         (int64_t)g.h * g.w * g.ci <= INT32_MAX;  // an image's offsets are ints
}

// A thread's walk over the units (16-byte vectors, or elements) of a
// staged tile of rows x cols pixels, `units` a pixel: unit tid + k *
// kThreads at row r, column c, unit u. The same for every tile, so it is
// set up once a block and steps by kThreads units without a division.
struct Cursor {
  int r, c, u, sr, sc, su;
  __device__ Cursor(int i, int units, int cols) {
    const int pix = i / units, step = kThreads / units;
    u = i % units, c = pix % cols, r = pix / cols;
    su = kThreads % units, sc = step % cols, sr = step / cols;
  }
  __device__ __forceinline__ void next(int units, int cols) {
    u += su;
    if (u >= units) u -= units, ++c;
    c += sc;
    if (c >= cols) c -= cols, ++r;
    r += sr;
  }
};

// A tile's place: image b, tile row ty, tile column tx of tiles_y x tiles_x
// an image. A block's tiles are blockIdx.x + k gridDim.x: set up once with
// divisions, then stepped by gridDim.x tiles with carries.
struct TileAt {
  int tx, ty, b;
  __device__ TileAt(int t, int tiles_x, int tiles_y) {
    const int rest = t / tiles_x;
    tx = t - rest * tiles_x, ty = rest % tiles_y, b = rest / tiles_y;
  }
  __device__ __forceinline__ void advance(const TileAt& s, int tiles_x, int tiles_y) {
    tx += s.tx;
    if (tx >= tiles_x) tx -= tiles_x, ++ty;
    ty += s.ty;
    if (ty >= tiles_y) ty -= tiles_y, ++b;
    b += s.b;
  }
};

// x of image b, low-res rows from gy0 and columns from gx0, to the tile s,
// 8 channels (16 bytes) a unit, zero outside the image and from I to kp:
// 16-byte cp.async copies (VEC: I*2 bytes 16-byte whole, x 16-byte
// aligned), else 8 element loads in flight and one 16-byte store. The
// caller commits, waits and syncs.
template <bool VEC>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* s, const __nv_bfloat16* __restrict__ x,
                                           const Geo& g, const Plan& p, Cursor k, int b,
                                           int gy0, int gx0) {
  // an image's elements fit an int (the wrapper's check)
  const __nv_bfloat16* xb = x + (int64_t)b * g.h * g.w * g.ci;
  const int units = p.kp / 8;
  for (; k.r < p.rows; k.next(units, p.cols)) {
    const int gy = gy0 + k.r, gx = gx0 + k.c;
    const bool pix_in = (unsigned)gy < (unsigned)g.h && (unsigned)gx < (unsigned)g.w;
    __nv_bfloat16* dst = s + (k.r * p.cols + k.c) * p.ldk + 8 * k.u;
    if constexpr (VEC) {
      const bool in = pix_in && 8 * k.u < g.ci;
      cp_async16(dst, in ? xb + (gy * g.w + gx) * g.ci + 8 * k.u : x, in);
    } else {
      const __nv_bfloat16* src = xb + (gy * g.w + gx) * g.ci;
      unsigned short v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = 8 * k.u + e;
        v[e] = pix_in && c < g.ci ? __ldg(reinterpret_cast<const unsigned short*>(src) + c) : 0;
      }
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(v[0] | (unsigned)v[1] << 16, v[2] | (unsigned)v[3] << 16,
                     v[4] | (unsigned)v[5] << 16, v[6] | (unsigned)v[7] << 16);
    }
  }
}

// The first max of one half of a phase pair's accumulators: pixel
// lane/4 + 8h, phase (lane%4)/2, its classes 4j + 2(lane%2) + e at
// acc[j][2h + e] (the bias in them, padded classes -inf) and the rest on
// lane ^ 1: the largest value m over the two lanes, then the least class
// whose value equals m. Exactly the first max (strict `>` in class
// order); an all-NaN pixel gives 0.
template <int NTP>
__device__ __forceinline__ int first_max(const float (&acc)[NTP][4], int h, int lane) {
  float m = acc[0][2 * h];
#pragma unroll
  for (int j = 0; j < NTP; ++j) m = fmaxf(m, fmaxf(acc[j][2 * h], acc[j][2 * h + 1]));
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  int idx = 32;
#pragma unroll
  for (int j = NTP - 1; j >= 0; --j) {
    const int col = 4 * j + 2 * (lane & 1);
    idx = acc[j][2 * h + 1] == m ? col + 1 : idx;
    idx = acc[j][2 * h] == m ? col : idx;
  }
  idx = min(idx, __shfl_xor_sync(0xffffffffu, idx, 1));
  return idx & 31;
}

// One warp's RPW rows (r0, r0 + 8) of a staged tile whose first low-res
// pixel is (q0, px0) of image b. For each phase pair rh, one product over
// the pair's offsets: n-tile j holds classes 4j .. 4j + 3 of phase (rh, 0)
// in its columns 0-3 and of (rh, 1) in 4-7 (each B row an ldmatrix row
// address into its phase's slot, or into the zero slot), the accumulators
// starting at the bias. Lane (g, t) then holds pixels g and g + 8 of phase
// t/2, the lane pair t, t^1 all of its classes: the first max, and the
// 32 classes of the full-resolution row 2q + rh from column 2*px0 on go
// out as one store of the warp, 4 bytes a lane.
template <int NTP, int RPW>
__device__ __forceinline__ void tile_rows(const __nv_bfloat16* xs, const __nv_bfloat16* ws,
                                          const int4* pairs, const float (&bc)[NTP][2],
                                          const Geo& g, const Plan& p, int* __restrict__ out,
                                          int b, int q0, int px0, int r0, int lane) {
  // ldmatrix row addresses: A pixel lane%16 at k + 8*(lane/16); B row
  // lane%8 of n-tile j + lane/16 at k + 8*((lane/8)%2): phase (lane/4)%2,
  // class 4 (j + lane/16) + lane%4
  const __nv_bfloat16* a_row =
      xs + (r0 * p.cols + (lane & 15) - p.x0) * p.ldk + (lane >> 4) * 8;
  const __nv_bfloat16* b_lane =
      ws + (((lane >> 4) << 2) + (lane & 3)) * p.ldk + ((lane >> 3) & 1) * 8;
  const bool second = (lane & 4) != 0;
  const int row_step = kWarps * p.cols * p.ldk;
  const int64_t W2 = 2 * (int64_t)g.w;
  // this lane's store: half (lane%2), its pixel, its phase's column
  const int m = (lane >> 2) + 8 * (lane & 1), col = 2 * (px0 + m) + ((lane >> 1) & 1);
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {  // unrolled: one pair's first max beside the next's products
    float acc[RPW][NTP][4];
    // one K step of an entry (A offset, B offsets of the two phases): A
    // rows, B columns, the products; the first (FIRST) adds to the bias
    auto step = [&](auto first, const int4& en, int k0) {
      unsigned af[RPW][4];
#pragma unroll
      for (int i = 0; i < RPW; ++i) ldmatrix_x4(af[i], a_row + en.x + i * row_step + k0);
      const __nv_bfloat16* bp = b_lane + (second ? en.z : en.y) + k0;
#pragma unroll
      for (int j = 0; j < NTP; j += 2) {
        unsigned bf[4];
        const bool two = j + 1 < NTP;
        if (two)
          ldmatrix_x4(bf, bp + 4 * j * p.ldk);
        else
          ldmatrix_x2(bf, bp + 4 * j * p.ldk);
#pragma unroll
        for (int i = 0; i < RPW; ++i)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            if (jj == 1 && !two) continue;
            if constexpr (decltype(first)::value)
              mma_bf16_c(acc[i][j + jj], af[i], bf[2 * jj], bf[2 * jj + 1], bc[j + jj]);
            else
              mma_bf16(acc[i][j + jj], af[i], bf[2 * jj], bf[2 * jj + 1]);
          }
      }
    };
    const int4* en = pairs + rh * kMaxPairs;
    step(std::true_type{}, en[0], 0);
#pragma unroll 1
    for (int k0 = 16; k0 < p.kp; k0 += 16) step(std::false_type{}, en[0], k0);
#pragma unroll 1
    for (int e = 1; e < g.npairs[rh]; ++e) {
#pragma unroll 1
      for (int k0 = 0; k0 < p.kp; k0 += 16) step(std::false_type{}, en[e], k0);
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int cls0 = first_max<NTP>(acc[i], 0, lane), cls1 = first_max<NTP>(acc[i], 1, lane);
      const int q = q0 + r0 + i * kWarps;
      if (q < g.h && px0 + m < g.w)
        out[((int64_t)b * 2 * g.h + 2 * q + rh) * W2 + col] = lane & 1 ? cls1 : cls0;
    }
  }
}

// RPW rows a warp: 2 at th = 16, else 1 (warps past th idle); two blocks
// an SM (<= 128 registers a thread; 32 classes spill a little at 2 rows)
template <int NTP, int RPW, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
subpixel_argmax_mma(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wb,
                    const float* __restrict__ bias, int* __restrict__ out, Geo g, Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tap_at = round_up(p.np * 4, 16);
  const int4* pairs = reinterpret_cast<const int4*>(smem + tap_at);
  const __nv_bfloat16* ws = reinterpret_cast<const __nv_bfloat16*>(smem + p.o_w);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + p.o_x);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile_elems = p.tile_bytes / 2;
  {
    float* sb = reinterpret_cast<float*>(smem);
    for (int i = tid; i < p.np; i += kThreads) sb[i] = bias[i];
    int4* st = reinterpret_cast<int4*>(smem + tap_at);
    for (int i = tid; i < 2 * kMaxPairs; i += kThreads) {
      const int* en = g.pair[i / kMaxPairs][i % kMaxPairs];
      st[i] = make_int4(((en[0] - p.y0) * p.cols + en[1]) * p.ldk, en[2] * p.np * p.ldk,
                        en[3] * p.np * p.ldk, 0);
    }
    __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(smem + p.o_w);
    const int units = (p.o_x - p.o_w) / 16;
    for (int i = tid; i < units; i += kThreads) cp_async16(sw + 8 * i, wb + 8 * i);
  }
  const int tiles_x = (g.w + kTileW - 1) / kTileW, tiles_y = (g.h + p.th - 1) / p.th;
  const int tiles = g.n * tiles_y * tiles_x;
  const Cursor start(tid, p.kp / 8, p.cols);
  auto stage = [&](__nv_bfloat16* s, const TileAt& at) {
    stage_tile<VEC>(s, x, g, p, start, at.b, at.ty * p.th + p.y0, at.tx * kTileW + p.x0);
  };
  const TileAt step(gridDim.x, tiles_x, tiles_y);
  TileAt at(blockIdx.x, tiles_x, tiles_y), next = at;
  next.advance(step, tiles_x, tiles_y);
  int tile = blockIdx.x;
  if (p.nbuf == 2 && tile < tiles) stage(xs, at);
  esn::cp_async_commit();
  esn::cp_async_wait_all();
  __syncthreads();
  // the bias of this thread's classes, padded classes -inf (never a max)
  float bc[NTP][2];
#pragma unroll
  for (int j = 0; j < NTP; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 4 * j + 2 * (lane & 1) + e;
      bc[j][e] = c < g.co ? reinterpret_cast<const float*>(smem)[c] : -INFINITY;
    }
  for (int it = 0; tile < tiles; tile += gridDim.x, ++it) {
    const __nv_bfloat16* cur = xs;
    if (p.nbuf == 2) {
      cur = xs + (it & 1) * tile_elems;
      if (it > 0) {
        esn::cp_async_wait_all();
        __syncthreads();
      }
      if (tile + (int)gridDim.x < tiles) stage(xs + ((it + 1) & 1) * tile_elems, next);
      esn::cp_async_commit();
    } else {
      __syncthreads();  // the last tile's products are done
      stage(xs, at);
      esn::cp_async_commit();
      esn::cp_async_wait_all();
      __syncthreads();
    }
    if (warp < p.th)
      tile_rows<NTP, RPW>(cur, ws, pairs, bc, g, p, out, at.b, at.ty * p.th, at.tx * kTileW,
                          warp, lane);
    at = next;
    next.advance(step, tiles_x, tiles_y);
  }
  esn::cp_async_wait_all();
}

template <int NTP, int RPW, bool VEC>
int launch_mma(const __nv_bfloat16* x, const __nv_bfloat16* w, const float* b, int* out,
               const Geo& g, const Plan& p, cudaStream_t st) {
  auto kernel = subpixel_argmax_mma<NTP, RPW, VEC>;
  // the SM count, the shared memory granted and the blocks an SM at it,
  // per card, asked once (a call's host time sets the small heads' time)
  constexpr int kCards = 64;
  static int sms[kCards], granted[kCards], per_sm[kCards];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kCards) return cudaErrorInvalidDevice;
  if (sms[dev] == 0 &&
      (err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if (granted[dev] != p.bytes) {
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    p.bytes)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[dev], kernel, kThreads,
                                                             p.bytes)) != cudaSuccess)
      return err;
    granted[dev] = p.bytes;
  }
  const int64_t tiles = (int64_t)g.n * ((g.h + p.th - 1) / p.th) * ((g.w + kTileW - 1) / kTileW);
  int64_t blocks = (int64_t)(per_sm[dev] > 0 ? per_sm[dev] : 1) * sms[dev];
  if (p.max_blocks > 0 && blocks > p.max_blocks) blocks = p.max_blocks;
  if (blocks > tiles) blocks = tiles;
  kernel<<<(int)blocks, kThreads, p.bytes, st>>>(x, w, b, out, g, p);
  return cudaGetLastError();
}

template <int NTP>
int dispatch_mma(const __nv_bfloat16* x, const __nv_bfloat16* w, const float* b, int* out,
                 const Geo& g, const Plan& p, bool vec, cudaStream_t st) {
  const bool two = p.th > kWarps;
  if (two) return vec ? launch_mma<NTP, 2, true>(x, w, b, out, g, p, st)
                      : launch_mma<NTP, 2, false>(x, w, b, out, g, p, st);
  return vec ? launch_mma<NTP, 1, true>(x, w, b, out, g, p, st)
             : launch_mma<NTP, 1, false>(x, w, b, out, g, p, st);
}

// ---------------------------------------------------------------------------
// f32: FMAs, two pixels a thread

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
template <int OMAX, bool VEC>
__device__ __forceinline__ void accumulate(const float* r0, const float* r1, bool v0, bool v1,
                                           const float* wt, int ci, float* a0, float* a1) {
  if constexpr (VEC) {
    for (int c = 0; c < ci; c += 4) {
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 u0 = v0 ? *reinterpret_cast<const float4*>(r0 + c) : zero;
      const float4 u1 = v1 ? *reinterpret_cast<const float4*>(r1 + c) : zero;
      const float f0[4] = {u0.x, u0.y, u0.z, u0.w}, f1[4] = {u1.x, u1.y, u1.z, u1.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) fma_row<OMAX>(f0[k], f1[k], wt + (c + k) * OMAX, a0, a1);
    }
  } else {
    for (int c = 0; c < ci; ++c) {
      const float f0 = v0 ? r0[c] : 0.f;
      const float f1 = v1 ? r1[c] : 0.f;
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
template <int OMAX, bool VEC>
__global__ void __launch_bounds__(kThreads, OMAX > 20 ? 1 : 2)
subpixel_argmax_f32(const float* __restrict__ x, const float* __restrict__ wp,
                    const float* __restrict__ bias, int* __restrict__ out, Geo g, int nslots) {
  extern __shared__ __align__(16) float wsf[];  // nslots*ci rows of OMAX, then the bias
  const int nw = nslots * g.ci * OMAX;
  for (int i = threadIdx.x; i < nw + OMAX; i += kThreads) wsf[i] = i < nw ? wp[i] : bias[i - nw];
  __syncthreads();
  const float* bs = wsf + nw;
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
    const float* xb = x + (int64_t)b * g.h * g.w * g.ci;
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
          const float* r0 = xb + ((int64_t)qy * g.w + px0) * g.ci;
          accumulate<OMAX, VEC>(r0, r0 + g.ci, v0, v1, wsf + g.slot[ph][t] * g.ci * OMAX, g.ci,
                                a0, a1);
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

template <int OMAX, bool VEC>
int launch_f32(const float* x, const float* w, const float* b, int* out, const Geo& g,
               int nslots, cudaStream_t st) {
  const size_t bytes = ((size_t)nslots * g.ci + 1) * OMAX * sizeof(float);
  if (bytes > (size_t)esn::kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = subpixel_argmax_f32<OMAX, VEC>;
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

int dispatch_f32(const float* x, const float* w, const float* b, int* out, const Geo& g,
                 int co_pad, int nslots, bool vec, cudaStream_t st) {
  switch (co_pad * 2 + (vec ? 1 : 0)) {
    case 24: return launch_f32<12, false>(x, w, b, out, g, nslots, st);
    case 25: return launch_f32<12, true>(x, w, b, out, g, nslots, st);
    case 40: return launch_f32<20, false>(x, w, b, out, g, nslots, st);
    case 41: return launch_f32<20, true>(x, w, b, out, g, nslots, st);
    case 64: return launch_f32<32, false>(x, w, b, out, g, nslots, st);
    case 65: return launch_f32<32, true>(x, w, b, out, g, nslots, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x (n, h, w, ci) of dtype `dtype` contiguous; out (n, 2h, 2w) int32.
// f32: w (nslots, ci, co_pad) f32, slot uh * kw + uw, classes from co on
// zero; b (co_pad) f32. bf16: w (nslots + 1, np, ldk) bf16, [slot][n][k],
// zero from co and from ci on, slot nslots all zero; b (np) f32. desc
// (int32, host): n, h, w, ci, co, co_pad, nslots, the four phases' tap
// counts, per phase kMaxTaps (dy, dx, slot) triples, the bf16 plan (Plan's
// fields in order), the two pairs' entry counts, then per pair kMaxPairs
// (dy, dx, slot of (rh, 0), slot of (rh, 1)) entries.
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
  if (dtype == esn::kF32) {
    const bool vec = g.ci % 4 == 0 && esn::aligned16(x);
    return dispatch_f32(static_cast<const float*>(x), static_cast<const float*>(w),
                        static_cast<const float*>(b), o, g, co_pad, nslots, vec, st);
  }
  if (dtype == esn::kBF16) {
    const int* f = taps + 3 * kPhases * kMaxTaps;
    const Plan p{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9], f[10], f[11], f[12],
                 f[13]};
    static_assert(sizeof(Plan) == kPlanFields * sizeof(int), "Plan follows the tap tables");
    const int* pr = f + kPlanFields;
    for (int rh = 0; rh < 2; ++rh) {
      g.npairs[rh] = pr[rh];
      for (int e = 0; e < kMaxPairs; ++e)
        for (int k = 0; k < 4; ++k) g.pair[rh][e][k] = pr[2 + (rh * kMaxPairs + e) * 4 + k];
    }
    if (!check(p, g, nslots) || !esn::aligned16(w)) return cudaErrorInvalidValue;
    const bool vec = g.ci % 8 == 0 && esn::aligned16(x);
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* wb = static_cast<const __nv_bfloat16*>(w);
    const float* bf = static_cast<const float*>(b);
    switch (p.np / 4) {
      case 2: return dispatch_mma<2>(xb, wb, bf, o, g, p, vec, st);
      case 3: return dispatch_mma<3>(xb, wb, bf, o, g, p, vec, st);
      case 5: return dispatch_mma<5>(xb, wb, bf, o, g, p, vec, st);
      case 8: return dispatch_mma<8>(xb, wb, bf, o, g, p, vec, st);
    }
  }
  return cudaErrorInvalidValue;
}
