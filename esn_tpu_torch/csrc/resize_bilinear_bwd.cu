// Backward of the half-pixel bilinear resize, in a fixed order (K5).
//
// Replaces no TPU kernel. The reference differentiates
// jax.image.resize(..., antialias=False) (esn_tpu/ops/resize.py) through
// XLA, whose transpose sums in a fixed order; the port's forward is
// F.interpolate(mode="bilinear", align_corners=False, antialias=False),
// and torch's CUDA backward of it (upsample_bilinear2d_backward_out_cuda)
// adds every output gradient into its four input taps with float atomics
// in no fixed order, so two equal training steps on the card differ in
// the last bits and a resumed run drifts from the straight one. This
// kernel is that backward with one order: the transpose of the forward's
// map, gx = A_h^T g A_w.
//
// The map is torch's forward, arithmetic for arithmetic: output index d
// of an axis reads src = max(0, scale (d + 0.5) - 0.5), rounded once (the
// card's fused multiply-add, as torch's kernel is compiled), taps
// i0 = (int)src and i1 = i0 + (i0 < n_in - 1), weights l1 = src - i0 and
// l0 = 1 - l1; d reads input i with (i0 == i ? l0 : 0) + (i1 == i ? l1 : 0).
// The wrapper builds these tables on the host (axis_tables in
// ops/kernels/resize_bilinear_bwd.py, the same one rounding) and keeps
// them on the card per shape: i0, l0, l1 of each output index, and each
// input index's run [lo, hi) of the output indices that read it (i0 in
// {i - 1, i}). No term computes a tap.
//
// The order. Input element (y, x) sums its terms so: for each output row
// d of y's run, ascending, the row sum r_d = sum over the output columns
// q of x's run, ascending, of w(q, x) g[d, q], one fused multiply-add a
// term from 0; then acc = sum over those d, ascending, of w(d, y) r_d, one
// fused multiply-add a row from 0; in f32 (f64 for f64), rounded once to
// g's dtype. The order is a function of the element's own runs and
// weights alone: no tile, block, lane count, route or extent of the
// tensor enters it. Two consequences. The two routes below give the same
// bits, so the plan (a host function of the shapes) moves none. And a
// window of rows whose half-pixel grid is the whole tensor's shifted by
// whole rows (ops/resize.py's sharded backward) gives each input row whose
// run lies inside the window the same terms, weights and order as the
// whole tensor, so the same bits.
//
// What bounds it on an H100. An upsample reads g once and writes gx once,
// and g is most of it (the x8 full-resolution tail of config 5: g
// (8, 19, 1024, 2048) f32, 1.27 GB, 0.387 ms at 3.35 TB/s; the fusion's
// x4: 67 MB bf16); the arithmetic is ~2 multiply-adds a g element, far
// below the f32 rate. So bytes, where there are enough inputs to spread
// the reads over the card. PPM's upsamples are the other extreme: a few
// hundred to a few thousand inputs, each with hundreds to 2048 terms
// (bin 1 to a 32x64 map), 1 MB of g; there the bound is latency, and the
// work is spread over the terms.
//
// Route 0, streaming (taken where the input has >= 2^16 elements and a
// band fits: the fusion's x4, the x8 tail, ContextNet's, LEDNet's and
// FPENet's upsamples). A block owns a band of ti input rows x tj input
// columns of one plane (all channels in channels_last). It walks the
// output rows that read the band in ascending order, each staged once in
// shared memory by cp.async, three rows in flight (the output columns
// that read the band's columns, all values of each pixel: one contiguous
// run of memory, copied in 16-byte words from the 16-byte boundary before
// it). Each thread holds up to four (column, value) items of the band:
// for each staged row it forms the item's row sum from shared memory with
// weights from a per-block table built once, and folds it into the
// accumulators of the two input rows the output row can read. An input
// row is stored (coalesced, consecutive threads on consecutive addresses)
// once the walk passes its run. g is read from device memory once, but
// for the output rows and columns two bands share (3% of the x8 tail's,
// 12% a side of the x4's).
//
// Route 1, fan-in (the rest: PPM's upsamples, the downscales of small
// maps). A block owns one input pixel and `lines` lines (channels of an
// image, or planes), `lanes` lanes a line. Lane k takes the output rows
// k, k + lanes, ... of the element's run, counted from its first row, and
// forms each row sum from device memory (consecutive threads on
// consecutive channels in channels_last); the row sums meet in shared
// memory and lane 0 folds them in ascending rows, lanes rows at a time.
//
// Offsets: 64-bit wherever an offset spans planes (a b128 x8 tail holds
// 5.1 G elements); 32-bit within a row.
#include "gather_bwd.cuh"

namespace {

// The plan, ints from the host in this order (resize_plan).
struct Plan {
  int route;  // 0 streaming, 1 fan-in
  int ti;     // streaming: input rows a block
  int tj;     // streaming: input columns a block
  int stage;  // streaming: bytes of one staged output row (16-byte multiple)
  int wmax;   // the longest run along W: the row stride of the weight table
  int lanes;  // fan-in: lanes a line
  int lines;  // fan-in: lines a block
  int smem;   // dynamic shared memory, bytes
};
constexpr int kPlanInts = 8;

constexpr int kStreamThreads = 256;
constexpr int kItems = 4;   // items a thread, streaming
constexpr int kStages = 3;  // staged output rows, streaming

// One axis n_in -> n_out: taps[0, n_out) i0 of each output index, then lo
// and hi of each input index; wts[0, n_out) l0, then l1.
template <typename A>
struct Axis {
  const int* taps;
  const A* wts;
  int n_in, n_out;

  __device__ __forceinline__ int i0(int d) const { return __ldg(taps + d); }
  __device__ __forceinline__ int lo(int i) const { return __ldg(taps + n_out + i); }
  __device__ __forceinline__ int hi(int i) const { return __ldg(taps + n_out + n_in + i); }
  // the weight with which output d reads input i (the sum of both taps'
  // where they coincide at the edge)
  __device__ __forceinline__ A weight(int d, int i) const {
    const int a = i0(d);
    const int b = a + (a < n_in - 1 ? 1 : 0);
    return (a == i ? __ldg(wts + d) : (A)0) + (b == i ? __ldg(wts + n_out + d) : (A)0);
  }
};

// 16 bytes from gmem to smem, asynchronously; only the first `valid` bytes
// are read (the rest zero-filled): the word that holds the end of g
__device__ __forceinline__ void cp_async16_upto(void* smem, const void* gmem, int valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid)
               : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
__global__ void __launch_bounds__(kStreamThreads)
stream_kernel(const T* __restrict__ g, T* __restrict__ gx, int64_t g_bytes,
              Axis<typename esn::AccOf<T>::type> ah, Axis<typename esn::AccOf<T>::type> aw,
              int vals, Plan pl, int nrb, int ncb) {
  using A = typename esn::AccOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  int bid = blockIdx.x;
  const int cb = bid % ncb;
  bid /= ncb;
  const int rb = bid % nrb;
  const int p = bid / nrb;
  const int h = ah.n_in, w = aw.n_in, ho = ah.n_out, wo = aw.n_out;
  const int ia = rb * pl.ti, ib = min(h, ia + pl.ti);
  const int ja = cb * pl.tj, jb = min(w, ja + pl.tj), nj = jb - ja;
  const int q_lo = aw.lo(ja), q_hi = aw.hi(jb - 1);
  const int d_lo = ah.lo(ia), d_hi = ah.hi(ib - 1);

  unsigned char* stages = smem;
  A* ww = reinterpret_cast<A*>(smem + kStages * pl.stage);
  int* qoff = reinterpret_cast<int*>(ww + pl.tj * pl.wmax);
  int* qcnt = qoff + pl.tj;
  // the band's weight table: ww[jj][k] = w(lo(j) + k, j), j = ja + jj
  for (int k = tid; k < nj * pl.wmax; k += nt) {
    const int jj = k / pl.wmax, m = k - jj * pl.wmax, j = ja + jj, q = aw.lo(j) + m;
    ww[k] = q < aw.hi(j) ? aw.weight(q, j) : (A)0;
  }
  for (int jj = tid; jj < nj; jj += nt) {
    qoff[jj] = aw.lo(ja + jj) - q_lo;
    qcnt[jj] = aw.hi(ja + jj) - aw.lo(ja + jj);
  }

  // output row d's pixels q_lo..q_hi - 1, all values (contiguous), staged
  // from the 16-byte word that holds the first: its byte offset in g
  const int64_t seg = (int64_t)(q_hi - q_lo) * vals * (int64_t)sizeof(T);
  auto row_at = [&](int d) {
    return esn::pixel_offset(p, d, q_lo, ho, wo, vals) * (int64_t)sizeof(T);
  };
  auto issue = [&](int d, int slot) {
    if (d < d_hi) {
      const int64_t at = row_at(d) & ~(int64_t)15;
      const int words = (int)((row_at(d) - at + seg + 15) >> 4);
      const unsigned char* src = reinterpret_cast<const unsigned char*>(g) + at;
      unsigned char* dst = stages + slot * pl.stage;
      for (int k = tid; k < words; k += nt) {
        const int64_t left = g_bytes - (at + 16 * (int64_t)k);
        cp_async16_upto(dst + 16 * k, src + 16 * k, left < 16 ? (int)left : 16);
      }
    }
    esn::cp_async_commit();
  };

  const int items = nj * vals;
  A acc0[kItems], acc1[kItems];
#pragma unroll
  for (int m = 0; m < kItems; ++m) acc0[m] = acc1[m] = (A)0;
  const int64_t out0 = esn::pixel_offset(p, 0, ja, h, w, vals);
  const int64_t out_row = (int64_t)w * vals;
  auto store_row = [&](int y) {
#pragma unroll
    for (int m = 0; m < kItems; ++m) {
      const int it = tid + m * nt;
      if (it < items) esn::store_acc(gx + out0 + y * out_row + it, acc0[m]);
      acc0[m] = acc1[m];
      acc1[m] = (A)0;
    }
  };

  issue(d_lo, 0);
  issue(d_lo + 1, 1);
  __syncthreads();  // the weight table
  // each item's column run: its offset in a staged row, its weights, its
  // length
  int off[kItems], wat[kItems], len[kItems];
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    const int it = tid + m * nt;
    const int jj = it / vals, v = it - jj * vals;
    const bool live = it < items;
    off[m] = live ? qoff[jj] * vals + v : 0;
    wat[m] = live ? jj * pl.wmax : 0;
    len[m] = live ? qcnt[jj] : 0;
  }
  int cur = ia;     // the lowest input row not yet stored; acc0 is its, acc1 cur + 1's
  for (int d = d_lo; d < d_hi; ++d) {
    const int k = d - d_lo;
    issue(d + 2, (k + 2) % kStages);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int a = ah.i0(d);
    for (; cur < a && cur < ib; ++cur) store_row(cur);
    const int b = a + (a < h - 1 ? 1 : 0);
    const A l0 = __ldg(ah.wts + d), l1 = __ldg(ah.wts + ho + d);
    const bool use0 = a == cur || b == cur;
    const bool use1 = cur + 1 < ib && (a == cur + 1 || b == cur + 1);
    const A wh0 = (a == cur ? l0 : (A)0) + (b == cur ? l1 : (A)0);
    const A wh1 = (a == cur + 1 ? l0 : (A)0) + (b == cur + 1 ? l1 : (A)0);
    const T* row = reinterpret_cast<const T*>(stages + (k % kStages) * pl.stage) +
                   (int)(row_at(d) & 15) / (int)sizeof(T);
#pragma unroll
    for (int m = 0; m < kItems; ++m) {
      if (tid + m * nt < items) {
        const T* src = row + off[m];
        const A* wj = ww + wat[m];
        A r = (A)0;
        for (int t = 0; t < len[m]; ++t)
          r = esn::fma_rn(wj[t], esn::load_acc(src + t * vals), r);
        if (use0) acc0[m] = esn::fma_rn(wh0, r, acc0[m]);
        if (use1) acc1[m] = esn::fma_rn(wh1, r, acc1[m]);
      }
    }
    __syncthreads();  // the stage is free for the row issued next
  }
  for (; cur < ib; ++cur) store_row(cur);
  cp_async_wait<0>();
}

template <typename T>
__global__ void __launch_bounds__(256)
fanin_kernel(const T* __restrict__ g, T* __restrict__ gx,
             Axis<typename esn::AccOf<T>::type> ah, Axis<typename esn::AccOf<T>::type> aw,
             int vals, int64_t nlines, Plan pl, int nlb) {
  using A = typename esn::AccOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lb = blockIdx.x % nlb, pix = blockIdx.x / nlb;
  const int w = aw.n_in, ho = ah.n_out, wo = aw.n_out;
  const int y = pix / w, x = pix - y * w;
  A* ww = reinterpret_cast<A*>(smem);
  A* rows = ww + pl.wmax;  // [lines][lanes] row sums
  const int d0 = ah.lo(y), nd = ah.hi(y) - d0;
  const int q0 = aw.lo(x), nq = aw.hi(x) - q0;
  for (int t = tid; t < nq; t += blockDim.x) ww[t] = aw.weight(q0 + t, x);

  const int l = tid % pl.lines, lane = tid / pl.lines;
  const int64_t line = (int64_t)lb * pl.lines + l;
  const bool live = line < nlines;
  const int p = (int)(line / vals), v = (int)(line - (int64_t)p * vals);
  const T* src = g + esn::pixel_offset(p, d0, q0, ho, wo, vals) + v;
  const int64_t row_elems = (int64_t)wo * vals;
  A acc = (A)0;
  __syncthreads();
  for (int m0 = 0; m0 < nd; m0 += pl.lanes) {
    const int m = m0 + lane;
    if (live && m < nd) {
      const T* s = src + m * row_elems;
      A r = (A)0;
#pragma unroll 8
      for (int t = 0; t < nq; ++t) r = esn::fma_rn(ww[t], esn::load_acc(s + t * vals), r);
      rows[l * pl.lanes + lane] = r;
    }
    __syncthreads();
    if (live && lane == 0) {
      const int end = min(nd - m0, pl.lanes);
      for (int k = 0; k < end; ++k)
        acc = esn::fma_rn(ah.weight(d0 + m0 + k, y), rows[l * pl.lanes + k], acc);
    }
    __syncthreads();
  }
  if (live && lane == 0)
    esn::store_acc(gx + esn::pixel_offset(p, y, x, ah.n_in, w, vals) + v, acc);
}

template <typename T>
int launch(const T* g, T* gx, int n, int c, int h, int w, int ho, int wo, const int* th,
           const void* wh, const int* tw, const void* wwts, const Plan& pl, bool cl,
           cudaStream_t st) {
  using A = typename esn::AccOf<T>::type;
  const Axis<A> ah{th, static_cast<const A*>(wh), h, ho};
  const Axis<A> aw{tw, static_cast<const A*>(wwts), w, wo};
  const int vals = cl ? c : 1;
  const int64_t planes = cl ? n : (int64_t)n * c;
  if (pl.route == 0) {
    if (pl.ti < 1 || pl.tj < 1 || pl.stage < 16 || pl.stage % 16 || pl.wmax < 1 ||
        (int64_t)pl.tj * vals > (int64_t)kStreamThreads * kItems ||
        pl.smem < kStages * pl.stage + pl.tj * pl.wmax * (int)sizeof(A) + 8 * pl.tj)
      return cudaErrorInvalidValue;
    const int nrb = (h + pl.ti - 1) / pl.ti, ncb = (w + pl.tj - 1) / pl.tj;
    const int64_t blocks = planes * nrb * ncb;
    if (blocks > INT32_MAX) return cudaErrorInvalidValue;
    static int allowed = 0;
    if (const int err = esn::allow_smem(stream_kernel<T>, pl.smem, allowed)) return err;
    const int items = pl.tj * vals;
    const int threads = items >= kStreamThreads ? kStreamThreads : (items + 31) / 32 * 32;
    const int64_t g_bytes = planes * ho * (int64_t)wo * vals * (int64_t)sizeof(T);
    stream_kernel<T><<<(unsigned)blocks, threads, pl.smem, st>>>(g, gx, g_bytes, ah, aw, vals,
                                                                  pl, nrb, ncb);
  } else if (pl.route == 1) {
    if (pl.lanes < 1 || pl.lines < 1 || pl.lanes * pl.lines > 256 || pl.wmax < 1 ||
        pl.smem < (pl.wmax + pl.lanes * pl.lines) * (int)sizeof(A))
      return cudaErrorInvalidValue;
    const int64_t nlines = planes * vals;
    const int64_t nlb = (nlines + pl.lines - 1) / pl.lines;
    const int64_t blocks = nlb * h * w;
    if (blocks > INT32_MAX) return cudaErrorInvalidValue;
    static int allowed = 0;
    if (const int err = esn::allow_smem(fanin_kernel<T>, pl.smem, allowed)) return err;
    fanin_kernel<T><<<(unsigned)blocks, pl.lanes * pl.lines, pl.smem, st>>>(
        g, gx, ah, aw, vals, nlines, pl, (int)nlb);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// g (n, c, ho, wo) and gx (n, c, h, w), both NCHW or both NHWC, g 16-byte
// aligned; desc: int64s (the wrapper's _call): dtype (0 f32, 1 bf16,
// 2 f64), n, c, h, w, ho, wo, channels_last, the device tables of H (taps
// int32, weights in the accumulation type) and of W, then kPlanInts plan
// ints (resize_plan).
extern "C" int esn_resize_bilinear_bwd(const void* g, void* gx, const int64_t* desc,
                                       void* stream) {
  if (!desc || !esn::aligned16(g)) return cudaErrorInvalidValue;
  const int dtype = (int)desc[0], n = (int)desc[1], c = (int)desc[2], h = (int)desc[3],
            w = (int)desc[4], ho = (int)desc[5], wo = (int)desc[6];
  const bool cl = desc[7] != 0;
  const int* taps_h = reinterpret_cast<const int*>(desc[8]);
  const void* wts_h = reinterpret_cast<const void*>(desc[9]);
  const int* taps_w = reinterpret_cast<const int*>(desc[10]);
  const void* wts_w = reinterpret_cast<const void*>(desc[11]);
  if (n < 1 || c < 1 || h < 1 || w < 1 || ho < 1 || wo < 1 || !taps_h || !taps_w || !wts_h ||
      !wts_w)
    return cudaErrorInvalidValue;
  Plan pl;
  int* fields = &pl.route;
  for (int i = 0; i < kPlanInts; ++i) fields[i] = (int)desc[12 + i];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == esn::kF32)
    return launch(static_cast<const float*>(g), static_cast<float*>(gx), n, c, h, w, ho, wo,
                  taps_h, wts_h, taps_w, wts_w, pl, cl, st);
  if (dtype == esn::kBF16)
    return launch(static_cast<const __nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(gx), n, c,
                  h, w, ho, wo, taps_h, wts_h, taps_w, wts_w, pl, cl, st);
  if (dtype == esn::kF64)
    return launch(static_cast<const double*>(g), static_cast<double*>(gx), n, c, h, w, ho, wo,
                  taps_h, wts_h, taps_w, wts_w, pl, cl, st);
  return cudaErrorInvalidValue;
}
