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
// reads 268 MB and writes 100 MB for ~1 GFLOP of dw+pw work, far below
// the ~295 FLOP/byte where the tensor cores would be the limit. The
// unfused chain writes the dw output to device memory and reads it back
// (plus the separate BN/act passes); this kernel reads x once and writes y
// once, and the intermediate never leaves shared memory.
//
// Design. One block of 256 threads per (image, tile of `th` output rows x
// `tw` output columns):
//   1. stage pw (Cin x Cout), the dw taps and the four affines in shared
//      memory as f32, and the input halo tile ((th-1)*s+3 rows x
//      (tw-1)*s+3 columns x Cin) in the input dtype, zero-filled outside
//      the image (that zero fill is the conv's padding);
//   2. depthwise 3x3 + affine + act per (pixel, channel) into an f32 tile
//      `mid` (row stride Cin+1 against bank conflicts);
//   3. pointwise product in the kernel's own FMA loop: each thread owns
//      4 pixels x 4 output channels (float4 reads of pw), then affine +
//      act, stored in the input dtype.
// The intermediate stays f32, as the plain `dsconv_ref` keeps it; the
// Pallas kernel rounds it to the input dtype before its matmul. Shared
// memory passes 48 KB at Cin = Cout = 128 (pw alone is 64 KB), so the
// launch raises the dynamic limit with cudaFuncSetAttribute and returns
// its error. Tensor cores (mma/wgmma) and vector loads are later work.
#include "common.cuh"

namespace {

using esn::act;
using esn::from_f32;
using esn::to_f32;

constexpr int kThreads = 256;

struct DsconvArgs {
  const void* x;
  const float* dw;  // (3, 3, Cin)
  const float* a1;
  const float* b1;
  const float* pw;  // (Cin, Cout)
  const float* a2;
  const float* b2;
  void* out;
  int n, h, w, cin, cout, h_out, w_out, stride, act1, act2, th, tw;
};

__host__ __device__ inline int tile_rows(const DsconvArgs& a) { return (a.th - 1) * a.stride + 3; }
__host__ __device__ inline int tile_cols(const DsconvArgs& a) { return (a.tw - 1) * a.stride + 3; }

template <typename T>
size_t smem_bytes(const DsconvArgs& a) {
  size_t f32 = (size_t)a.cin * a.cout + (size_t)a.th * a.tw * (a.cin + 1) +
               9 * (size_t)a.cin + 2 * (size_t)a.cin + 2 * (size_t)a.cout;
  return f32 * sizeof(float) + (size_t)tile_rows(a) * tile_cols(a) * a.cin * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) dsconv_kernel(DsconvArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int cin = a.cin, cout = a.cout, s = a.stride, tw = a.tw;
  const int npix = a.th * tw;
  const int ih = tile_rows(a), iw = tile_cols(a);
  const int ms = cin + 1;
  float* s_pw = smem;                    // cin * cout (16-byte aligned)
  float* s_mid = s_pw + cin * cout;      // npix * ms
  float* s_dw = s_mid + npix * ms;       // 9 * cin
  float* s_a1 = s_dw + 9 * cin;
  float* s_b1 = s_a1 + cin;
  float* s_a2 = s_b1 + cin;
  float* s_b2 = s_a2 + cout;
  T* s_in = reinterpret_cast<T*>(s_b2 + cout);  // ih * iw * cin

  const int img = blockIdx.z;
  const int oh0 = blockIdx.y * a.th, ow0 = blockIdx.x * tw;
  const int tid = threadIdx.x;

  for (int i = tid; i < cin * cout; i += kThreads) s_pw[i] = a.pw[i];
  for (int i = tid; i < 9 * cin; i += kThreads) s_dw[i] = a.dw[i];
  for (int i = tid; i < cin; i += kThreads) {
    s_a1[i] = a.a1[i];
    s_b1[i] = a.b1[i];
  }
  for (int i = tid; i < cout; i += kThreads) {
    s_a2[i] = a.a2[i];
    s_b2[i] = a.b2[i];
  }

  // 1. halo tile; rows/cols outside the image are the conv's zero padding
  const T* x = static_cast<const T*>(a.x);
  const int row0 = oh0 * s - 1, col0 = ow0 * s - 1;
  const int rowlen = iw * cin;
  for (int i = tid; i < ih * rowlen; i += kThreads) {
    const int r = i / rowlen, rem = i - r * rowlen;
    const int j = rem / cin, c = rem - j * cin;
    const int gr = row0 + r, gc = col0 + j;
    T v = from_f32<T>(0.f);
    if (gr >= 0 && gr < a.h && gc >= 0 && gc < a.w)
      v = x[(((int64_t)img * a.h + gr) * a.w + gc) * cin + c];
    s_in[i] = v;
  }
  __syncthreads();

  // 2. depthwise 3x3 + affine + act -> f32 mid tile
  for (int i = tid; i < npix * cin; i += kThreads) {
    const int p = i / cin, c = i - p * cin;
    const int py = p / tw, px = p - py * tw;
    const T* base = s_in + ((py * s) * iw + px * s) * cin + c;
    float acc = 0.f;
#pragma unroll
    for (int di = 0; di < 3; ++di)
#pragma unroll
      for (int dj = 0; dj < 3; ++dj)
        acc = fmaf(to_f32(base[(di * iw + dj) * cin]), s_dw[(di * 3 + dj) * cin + c], acc);
    s_mid[p * ms + c] = act(acc * s_a1[c] + s_b1[c], a.act1);
  }
  __syncthreads();

  // 3. pointwise Cin -> Cout, 4 pixels x 4 channels per work item
  T* out = static_cast<T*>(a.out);
  const int cgroups = cout / 4;
  for (int item = tid; item < (npix / 4) * cgroups; item += kThreads) {
    const int d0 = (item % cgroups) * 4, p0 = (item / cgroups) * 4;
    float acc[4][4] = {};
    const float* m0 = s_mid + p0 * ms;
    for (int c = 0; c < cin; ++c) {
      const float4 wv = *reinterpret_cast<const float4*>(s_pw + c * cout + d0);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float mv = m0[q * ms + c];
        acc[q][0] = fmaf(mv, wv.x, acc[q][0]);
        acc[q][1] = fmaf(mv, wv.y, acc[q][1]);
        acc[q][2] = fmaf(mv, wv.z, acc[q][2]);
        acc[q][3] = fmaf(mv, wv.w, acc[q][3]);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = p0 + q, py = p / tw, px = p - py * tw;
      const int oh = oh0 + py, ow = ow0 + px;
      if (oh >= a.h_out || ow >= a.w_out) continue;
      T* o = out + (((int64_t)img * a.h_out + oh) * a.w_out + ow) * cout + d0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        o[k] = from_f32<T>(act(acc[q][k] * s_a2[d0 + k] + s_b2[d0 + k], a.act2));
    }
  }
}

template <typename T>
cudaError_t launch(const DsconvArgs& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(a);
  cudaError_t err = cudaFuncSetAttribute(
      dsconv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.w_out + a.tw - 1) / a.tw, (a.h_out + a.th - 1) / a.th, a.n);
  dsconv_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Shapes: x (n, h, w, cin) and out (n, h_out, w_out, cout) of dtype
// `dtype`, contiguous; dw (3, 3, cin), pw (cin, cout) and the affines f32.
// Requires cout % 4 == 0 and (th * tw) % 4 == 0.
extern "C" int esn_dsconv_forward(const void* x, const void* dw, const void* a1,
                                  const void* b1, const void* pw, const void* a2,
                                  const void* b2, void* out, int dtype, int n,
                                  int h, int w, int cin, int cout, int h_out,
                                  int w_out, int stride, int act1, int act2,
                                  int th, int tw, void* stream) {
  if (cout % 4 != 0 || (th * tw) % 4 != 0 || (stride != 1 && stride != 2))
    return cudaErrorInvalidValue;
  const DsconvArgs a{x, static_cast<const float*>(dw), static_cast<const float*>(a1),
                     static_cast<const float*>(b1), static_cast<const float*>(pw),
                     static_cast<const float*>(a2), static_cast<const float*>(b2),
                     out, n, h, w, cin, cout, h_out, w_out, stride, act1, act2, th, tw};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == esn::kF32) return launch<float>(a, st);
  if (dtype == esn::kBF16) return launch<__nv_bfloat16>(a, st);
  return cudaErrorInvalidValue;
}
