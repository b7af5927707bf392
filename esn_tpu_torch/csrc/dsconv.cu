// Fused depthwise-separable convolution, eval mode (NHWC).
//
// Replaces the TPU kernel esn_tpu/ops/pallas/dsconv.py (`fused_dsconv` ->
// `_dsconv_pallas`, Pallas kernel `_kernel`):
//
//   y = act2((act1(dw3x3_s(x) * a1 + b1) @ pw) * a2 + b2)
//
// with the dw conv zero-padded by 1 (torch output sizes, stride 1 or 2,
// odd widths included) and BN folded into the per-channel affines a/b.
//
// What bounds it on an H100: bytes. Fast-SCNN's ltd.ds1 at batch 8 bf16
// reads 268 MB and writes 100 MB (0.110 ms at 3.35 TB/s) for ~1 GFLOP of
// dw+pw work, far below the ~295 FLOP/byte where the tensor cores would
// be the limit; head.ds1 moves 134 MB (0.040 ms). This kernel reads x once
// and writes y once; the intermediate never leaves shared memory.
//
// Design. Persistent blocks of 256 threads (as many as fit on the SMs),
// each walking over tiles of 8 x 16 = 128 output pixels of one image (4,
// 2 or 1 rows where Cin is too wide for 8, e.g. f32 128 -> 128 at
// stride 2; every Fast-SCNN layer takes 8 in both dtypes):
//   0. once per block: pw (bf16: rounded to bf16, transposed to the
//      [cout][k] layout that ldmatrix reads as the B operand, K padded to
//      a multiple of 16 with zeros; f32: as given), the dw taps and the
//      four affines, in shared memory;
//   1. the tile's input halo ((th-1)*s+3 rows x (16-1)*s+3 columns x Cin)
//      goes to shared memory with 16-byte cp.async copies, zero-filled
//      outside the image (the conv's padding), double-buffered where
//      shared memory allows: the next tile's halo is in flight while this
//      one computes. Channel counts or an x that are not 16-byte whole
//      take an element-by-element path into the same layout;
//   2. depthwise 3x3 + affine + act into `mid`: each thread keeps one
//      group of 16 bytes of channels, its 9 taps and affine in registers,
//      and walks over the tile's pixels. bf16: mid is rounded to bf16
//      here, as the TPU kernel rounds it (`hmid.astype(xv.dtype)` before
//      its matmul); f32: mid stays f32;
//   3. the pointwise product. bf16: tensor cores, mma.sync m16n8k16
//      bf16 -> f32, each warp 16 pixels x all of Cout (A and B by
//      ldmatrix). f32: FMAs (TF32 would break the f32 tolerance), each
//      thread 4 pixels x 8 channels with float4 reads;
//   4. epilogue: affine + act, the tile in x's dtype into shared memory
//      (the halo buffer, free by then), then 16-byte coalesced stores.
// The launch raises the dynamic shared-memory limit past 48 KB and
// returns its error. Where two blocks' shared memory fits on an SM
// (ltd.ds1 in bf16) it launches an instantiation capped at 128 registers
// so that two do; elsewhere the taps in registers take ~160. The first
// design (one 32-pixel block per tile that restaged pw as f32 from L2,
// scalar halo loads, f32 FMAs for the product) moved ~4x the bytes
// through L2 and ran 8-22x over its bound; this one runs 1.9-4.7x over
// it in bf16, bound by the latency of one or two 8-warp blocks an SM
// (esn_tpu_torch/tools/kernel_phases.py times its phases).
#include "common.cuh"

#include <type_traits>

namespace {

using esn::act;
using esn::kMaxSmem;
using esn::kSmemTwoBlocks;
using esn::ldmatrix_x2;
using esn::ldmatrix_x4;
using esn::mma_bf16;
using esn::pack_bf16;
using esn::unpack;

constexpr int kThreads = 256;
constexpr int kTileW = 16;        // output columns a tile; rows: DsconvArgs::th
constexpr int kMaxTileH = 8;      // 8 x 16 = 128 pixels: the product's M

struct DsconvArgs {
  const void* x;
  const float* dw;  // (3, 3, Cin)
  const float* a1;
  const float* b1;
  const float* pw;  // (Cin, Cout)
  const float* a2;
  const float* b2;
  void* out;
  int n, h, w, cin, cout, h_out, w_out, stride, act1, act2;
  int th;  // output rows a tile (8; 4, 2 or 1 where shared memory runs out)
};

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// shared-memory plan (byte offsets) for element size `es`, tiles of th x
// 16 output pixels and `nbuf` halo buffers
struct Plan {
  int npix;       // output pixels a tile
  int ve;         // elements in 16 bytes
  int cinp;       // channels of a halo pixel (Cin rounded up to ve)
  int kp, ldk;    // bf16: K padded to 16, row stride of pw^T and mid
  int ldp;        // f32: row stride of mid^T ([Cin][pixel])
  int ldo;        // row stride of the output tile
  int ih, iw;     // halo rows, columns
  int o_dw, o_a1, o_b1, o_a2, o_b2, o_pw, o_mid, o_buf, buf_bytes, bytes;
  __host__ __device__ Plan(int es, int cin, int cout, int stride, int th, int nbuf) {
    npix = th * kTileW;
    ve = 16 / es;
    cinp = (cin + ve - 1) / ve * ve;
    kp = round16(cin);
    ldk = kp + 8;
    ldp = npix + 4;
    ldo = cout + ve;
    ih = (th - 1) * stride + 3;
    iw = (kTileW - 1) * stride + 3;
    int o = 0;
    o_dw = o, o += round16(9 * cinp * 4);
    o_a1 = o, o += round16(cinp * 4);
    o_b1 = o, o += round16(cinp * 4);
    o_a2 = o, o += round16(cout * 4);
    o_b2 = o, o += round16(cout * 4);
    o_pw = o, o += round16(es == 2 ? cout * ldk * 2 : cin * cout * 4);
    o_mid = o, o += round16(es == 2 ? npix * ldk * 2 : cinp * ldp * 4);
    buf_bytes = round16(imax(ih * iw * cinp * es, npix * ldo * es));
    o_buf = o, o += nbuf * buf_bytes;
    bytes = o;
  }
};

struct Tile {
  int img, oh0, ow0;
};

__device__ __forceinline__ Tile tile_at(const DsconvArgs& a, int t) {
  const int tiles_w = (a.w_out + kTileW - 1) / kTileW;
  const int tiles_h = (a.h_out + a.th - 1) / a.th;
  Tile r;
  r.ow0 = (t % tiles_w) * kTileW;
  t /= tiles_w;
  r.oh0 = (t % tiles_h) * a.th;
  r.img = t / tiles_h;
  return r;
}

// 1. the halo of tile `t` into `buf` ([ih][iw][cinp] in x's dtype)
template <typename T>
__device__ __forceinline__ void stage_halo(const DsconvArgs& a, const Plan& p, T* buf, int t,
                                           bool vec, int tid) {
  const Tile tl = tile_at(a, t);
  const int row0 = tl.oh0 * a.stride - 1, col0 = tl.ow0 * a.stride - 1;
  const T* x = static_cast<const T*>(a.x);
  const int64_t img = (int64_t)tl.img * a.h;
  if (vec) {  // cinp == cin, whole 16-byte vectors
    const int nv = a.cin / p.ve, total = p.ih * p.iw * nv;
    for (int i = tid; i < total; i += kThreads) {
      const int pix = i / nv, v = i - pix * nv;
      const int r = pix / p.iw, gr = row0 + r, gc = col0 + (pix - r * p.iw);
      const bool in = gr >= 0 && gr < a.h && gc >= 0 && gc < a.w;
      const T* src = in ? x + ((img + gr) * a.w + gc) * a.cin + v * p.ve : x;
      esn::cp_async16(buf + pix * p.cinp + v * p.ve, src, in);
    }
    esn::cp_async_commit();
    return;
  }
  const int total = p.ih * p.iw * p.cinp;
  for (int i = tid; i < total; i += kThreads) {
    const int pix = i / p.cinp, c = i - pix * p.cinp;
    const int r = pix / p.iw, gr = row0 + r, gc = col0 + (pix - r * p.iw);
    T v = esn::from_f32<T>(0.f);
    if (c < a.cin && gr >= 0 && gr < a.h && gc >= 0 && gc < a.w)
      v = x[((img + gr) * a.w + gc) * a.cin + c];
    buf[i] = v;
  }
}

// 2. depthwise 3x3 + affine + act of the halo in `buf` into mid. Each
// thread keeps one group of 16 bytes of channels (its taps and affine in
// registers) and walks over the tile's pixels.
template <typename T>
__device__ __forceinline__ void depthwise(const DsconvArgs& a, const Plan& p, const T* buf,
                                          unsigned char* smem, int tid) {
  constexpr int kVe = 16 / sizeof(T);
  const int groups = p.cinp / kVe, lanes = kThreads / groups, s = a.stride;
  const int g = tid % groups, lane = tid / groups, c0 = g * kVe;
  if (lane < lanes) {
    float wt[9][kVe], sa[kVe], sb[kVe];
    const float* s_dw = reinterpret_cast<const float*>(smem + p.o_dw);
#pragma unroll
    for (int e = 0; e < kVe; e += 4) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float4 v = *reinterpret_cast<const float4*>(s_dw + tap * p.cinp + c0 + e);
        wt[tap][e] = v.x, wt[tap][e + 1] = v.y, wt[tap][e + 2] = v.z, wt[tap][e + 3] = v.w;
      }
      const float4 va = *reinterpret_cast<const float4*>(smem + p.o_a1 + 4 * (c0 + e));
      const float4 vb = *reinterpret_cast<const float4*>(smem + p.o_b1 + 4 * (c0 + e));
      sa[e] = va.x, sa[e + 1] = va.y, sa[e + 2] = va.z, sa[e + 3] = va.w;
      sb[e] = vb.x, sb[e + 1] = vb.y, sb[e + 2] = vb.z, sb[e + 3] = vb.w;
    }
    for (int px = lane; px < p.npix; px += lanes) {
      const int py = px / kTileW, pxx = px - py * kTileW;
      const T* base = buf + ((py * s) * p.iw + pxx * s) * p.cinp + c0;
      float acc[kVe];
#pragma unroll
      for (int e = 0; e < kVe; ++e) acc[e] = 0.f;
#pragma unroll
      for (int di = 0; di < 3; ++di)
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          float xv[kVe];
          unpack(*reinterpret_cast<const uint4*>(base + (di * p.iw + dj) * p.cinp), xv, T());
#pragma unroll
          for (int e = 0; e < kVe; ++e) acc[e] = fmaf(xv[e], wt[di * 3 + dj][e], acc[e]);
        }
#pragma unroll
      for (int e = 0; e < kVe; ++e) acc[e] = act(acc[e] * sa[e] + sb[e], a.act1);
      if constexpr (std::is_same<T, float>::value) {
        float* mid = reinterpret_cast<float*>(smem + p.o_mid);  // [cinp][ldp]
#pragma unroll
        for (int e = 0; e < kVe; ++e) mid[(c0 + e) * p.ldp + px] = acc[e];
      } else {
        __nv_bfloat16* mid = reinterpret_cast<__nv_bfloat16*>(smem + p.o_mid);  // [pix][ldk]
        *reinterpret_cast<uint4*>(mid + px * p.ldk + c0) =
            make_uint4(pack_bf16(acc[0], acc[1]), pack_bf16(acc[2], acc[3]),
                       pack_bf16(acc[4], acc[5]), pack_bf16(acc[6], acc[7]));
      }
    }
  }
  if constexpr (!std::is_same<T, float>::value) {  // K padding of mid: zeros
    __nv_bfloat16* mid = reinterpret_cast<__nv_bfloat16*>(smem + p.o_mid);
    const int pad = (p.kp - p.cinp) / 8;
    for (int i = tid; i < p.npix * pad; i += kThreads) {
      const int px = i / pad, gp = i - px * pad;
      *reinterpret_cast<uint4*>(mid + px * p.ldk + p.cinp + 8 * gp) = make_uint4(0, 0, 0, 0);
    }
  }
}

// 3.-4. bf16: mid (npix x kp) @ pw (kp x cout) on tensor cores; warp w
// takes pixels [16w, 16w+16) and every output channel, 64 at a time
__device__ __forceinline__ void pointwise_bf16(const DsconvArgs& a, const Plan& p,
                                               unsigned char* smem, __nv_bfloat16* s_out,
                                               int tid) {
  const __nv_bfloat16* mid = reinterpret_cast<const __nv_bfloat16*>(smem + p.o_mid);
  const __nv_bfloat16* pwt = reinterpret_cast<const __nv_bfloat16*>(smem + p.o_pw);
  const float* s_a2 = reinterpret_cast<const float*>(smem + p.o_a2);
  const float* s_b2 = reinterpret_cast<const float*>(smem + p.o_b2);
  const int lane = tid & 31, m0 = (tid >> 5) * 16;
  if (m0 >= p.npix) return;
  // ldmatrix row addresses: A rows m0 + lane%16 at k + 8*(lane/16); B (two
  // n-tiles of 8) rows n + lane%8 + 8*(lane/16) at k + 8*((lane/8)%2)
  const __nv_bfloat16* a_row = mid + (m0 + (lane & 15)) * p.ldk + (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 8;
  for (int n0 = 0; n0 < a.cout; n0 += 64) {
    const int nt = min(8, (a.cout - n0) / 8);
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int k0 = 0; k0 < p.kp; k0 += 16) {
      unsigned af[4];
      ldmatrix_x4(af, a_row + k0);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        if (j >= nt) break;
        const __nv_bfloat16* b_ptr = pwt + (n0 + 8 * j + b_row) * p.ldk + k0 + b_col;
        unsigned bf[4];
        if (j + 1 < nt) {
          ldmatrix_x4(bf, b_ptr);
          mma_bf16(acc[j], af, bf[0], bf[1]);
          mma_bf16(acc[j + 1], af, bf[2], bf[3]);
        } else {
          ldmatrix_x2(bf, pwt + (n0 + 8 * j + (lane & 7)) * p.ldk + k0 + b_col);
          mma_bf16(acc[j], af, bf[0], bf[1]);
        }
      }
    }
    // acc[j]: rows m0 + lane/4 (+8), columns n0 + 8j + 2*(lane%4) (+1)
    const int r0 = m0 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j >= nt) break;
      const int col = n0 + 8 * j + 2 * (lane & 3);
      const float sa = s_a2[col], sb = s_b2[col], ta = s_a2[col + 1], tb = s_b2[col + 1];
      *reinterpret_cast<unsigned*>(s_out + r0 * p.ldo + col) =
          pack_bf16(act(acc[j][0] * sa + sb, a.act2), act(acc[j][1] * ta + tb, a.act2));
      *reinterpret_cast<unsigned*>(s_out + (r0 + 8) * p.ldo + col) =
          pack_bf16(act(acc[j][2] * sa + sb, a.act2), act(acc[j][3] * ta + tb, a.act2));
    }
  }
}

// 3.-4. f32: mid^T ([cin][pixel]) @ pw ([cin][cout]) in FMAs, 4 pixels x 8
// channels a work item
__device__ __forceinline__ void pointwise_f32(const DsconvArgs& a, const Plan& p,
                                              unsigned char* smem, float* s_out, int tid) {
  const float* mid = reinterpret_cast<const float*>(smem + p.o_mid);
  const float* pw = reinterpret_cast<const float*>(smem + p.o_pw);
  const float* s_a2 = reinterpret_cast<const float*>(smem + p.o_a2);
  const float* s_b2 = reinterpret_cast<const float*>(smem + p.o_b2);
  const int ng = a.cout / 8;
  for (int item = tid; item < (p.npix / 4) * ng; item += kThreads) {
    const int n0 = (item % ng) * 8, p0 = (item / ng) * 4;
    float acc[4][8];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[q][e] = 0.f;
    for (int k = 0; k < a.cin; ++k) {
      const float4 m = *reinterpret_cast<const float4*>(mid + k * p.ldp + p0);
      const float4 w0 = *reinterpret_cast<const float4*>(pw + k * a.cout + n0);
      const float4 w1 = *reinterpret_cast<const float4*>(pw + k * a.cout + n0 + 4);
      const float mv[4] = {m.x, m.y, m.z, m.w};
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[q][e] = fmaf(mv[q], wv[e], acc[q][e]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = act(acc[q][e] * s_a2[n0 + e] + s_b2[n0 + e], a.act2);
      float4* o = reinterpret_cast<float4*>(s_out + (p0 + q) * p.ldo + n0);
      o[0] = make_float4(v[0], v[1], v[2], v[3]);
      o[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
}

// kMinBlocks 2 caps the registers at 128 so that two blocks fit on an SM
// (where their shared memory does); 1 lets the depthwise taps stay in
// registers without that cap
template <typename T, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks) dsconv_kernel(DsconvArgs a, int nbuf) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan p(sizeof(T), a.cin, a.cout, a.stride, a.th, nbuf);
  const int tid = threadIdx.x;
  const bool vec = (a.cin * (int)sizeof(T)) % 16 == 0 && esn::aligned16(a.x);
  const int ntiles = a.n * ((a.h_out + a.th - 1) / a.th) * ((a.w_out + kTileW - 1) / kTileW);
  int t = blockIdx.x;
  if (t >= ntiles) return;
  T* bufs = reinterpret_cast<T*>(smem + p.o_buf);
  const int buf_elems = p.buf_bytes / (int)sizeof(T);
  stage_halo<T>(a, p, bufs, t, vec, tid);

  // 0. weights and affines, once per block; channels past Cin are zeros
  float* s_dw = reinterpret_cast<float*>(smem + p.o_dw);
  float* s_a1 = reinterpret_cast<float*>(smem + p.o_a1);
  float* s_b1 = reinterpret_cast<float*>(smem + p.o_b1);
  float* s_a2 = reinterpret_cast<float*>(smem + p.o_a2);
  float* s_b2 = reinterpret_cast<float*>(smem + p.o_b2);
  for (int i = tid; i < 9 * p.cinp; i += kThreads) {
    const int tap = i / p.cinp, c = i - tap * p.cinp;
    s_dw[i] = c < a.cin ? a.dw[tap * a.cin + c] : 0.f;
  }
  for (int c = tid; c < p.cinp; c += kThreads) {
    s_a1[c] = c < a.cin ? a.a1[c] : 0.f;
    s_b1[c] = c < a.cin ? a.b1[c] : 0.f;
  }
  for (int c = tid; c < a.cout; c += kThreads) {
    s_a2[c] = a.a2[c];
    s_b2[c] = a.b2[c];
  }
  if constexpr (std::is_same<T, float>::value) {
    float* pw = reinterpret_cast<float*>(smem + p.o_pw);
    for (int i = tid; i < a.cin * a.cout; i += kThreads) pw[i] = a.pw[i];
  } else {
    __nv_bfloat16* pwt = reinterpret_cast<__nv_bfloat16*>(smem + p.o_pw);  // [cout][ldk]
    for (int i = tid; i < a.cout * p.ldk; i += kThreads) {
      const int nn = i / p.ldk, k = i - nn * p.ldk;
      pwt[i] = __float2bfloat16_rn(k < a.cin ? a.pw[k * a.cout + nn] : 0.f);
    }
  }

  T* out = static_cast<T*>(a.out);
  const int nvo = a.cout / p.ve;  // 16-byte vectors of an output pixel
  for (int it = 0; t < ntiles; ++it, t += gridDim.x) {
    T* cur = bufs + (nbuf == 2 ? (it & 1) : 0) * buf_elems;
    esn::cp_async_wait_all();
    __syncthreads();
    const int next = t + gridDim.x;
    if (nbuf == 2 && next < ntiles)
      stage_halo<T>(a, p, bufs + ((it + 1) & 1) * buf_elems, next, vec, tid);
    depthwise<T>(a, p, cur, smem, tid);
    __syncthreads();
    if constexpr (std::is_same<T, float>::value)
      pointwise_f32(a, p, smem, cur, tid);
    else
      pointwise_bf16(a, p, smem, cur, tid);
    __syncthreads();
    const Tile tl = tile_at(a, t);
    for (int i = tid; i < p.npix * nvo; i += kThreads) {
      const int px = i / nvo, v = i - px * nvo;
      const int oh = tl.oh0 + px / kTileW, ow = tl.ow0 + px % kTileW;
      if (oh < a.h_out && ow < a.w_out)
        *reinterpret_cast<uint4*>(
            out + (((int64_t)tl.img * a.h_out + oh) * a.w_out + ow) * a.cout + v * p.ve) =
            *reinterpret_cast<const uint4*>(cur + px * p.ldo + v * p.ve);
    }
    if (nbuf == 1 && next < ntiles) {
      __syncthreads();
      stage_halo<T>(a, p, bufs, next, vec, tid);
    }
  }
}

// the tallest tile (8, 4, 2, 1 rows) whose plan fits with one halo
// buffer, double-buffered where that fits too
template <typename T>
cudaError_t launch(DsconvArgs a, cudaStream_t stream) {
  const int es = sizeof(T);
  a.th = kMaxTileH;
  while (a.th > 1 && Plan(es, a.cin, a.cout, a.stride, a.th, 1).bytes > kMaxSmem) a.th /= 2;
  const int nbuf = Plan(es, a.cin, a.cout, a.stride, a.th, 2).bytes <= kMaxSmem ? 2 : 1;
  const int bytes = Plan(es, a.cin, a.cout, a.stride, a.th, nbuf).bytes;
  if (bytes > kMaxSmem || (a.cin + 16 / es - 1) / (16 / es) > kThreads)
    return cudaErrorInvalidValue;
  const auto kernel = bytes <= kSmemTwoBlocks ? dsconv_kernel<T, 2> : dsconv_kernel<T, 1>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes)) !=
      cudaSuccess)
    return err;
  const int64_t tiles = (int64_t)a.n * ((a.h_out + a.th - 1) / a.th) *
                        ((a.w_out + kTileW - 1) / kTileW);
  const int64_t resident = (int64_t)imax(per_sm, 1) * sms;
  const int grid = (int)(tiles < resident ? tiles : resident);
  kernel<<<grid, kThreads, bytes, stream>>>(a, nbuf);
  return cudaGetLastError();
}

}  // namespace

// Shapes: x (n, h, w, cin) and out (n, h_out, w_out, cout) of dtype
// `dtype`, contiguous, out 16-byte aligned; dw (3, 3, cin), pw (cin, cout)
// and the affines f32. Requires cout % 8 == 0; any cin whose buffers fit
// in shared memory (cin = cout = 128 does in both dtypes).
extern "C" int esn_dsconv_forward(const void* x, const void* dw, const void* a1,
                                  const void* b1, const void* pw, const void* a2,
                                  const void* b2, void* out, int dtype, int n,
                                  int h, int w, int cin, int cout, int h_out,
                                  int w_out, int stride, int act1, int act2,
                                  void* stream) {
  if (cout % 8 != 0 || cin < 1 || (stride != 1 && stride != 2) || !esn::aligned16(out))
    return cudaErrorInvalidValue;
  const DsconvArgs a{x, static_cast<const float*>(dw), static_cast<const float*>(a1),
                     static_cast<const float*>(b1), static_cast<const float*>(pw),
                     static_cast<const float*>(a2), static_cast<const float*>(b2),
                     out, n, h, w, cin, cout, h_out, w_out, stride, act1, act2,
                     kMaxTileH};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == esn::kF32) return launch<float>(a, st);
  if (dtype == esn::kBF16) return launch<__nv_bfloat16>(a, st);
  return cudaErrorInvalidValue;
}
