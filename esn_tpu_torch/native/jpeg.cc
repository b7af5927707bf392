// jpeg: the port's JPEG decoder, on the C++ standard library alone.
//
// It replaces libjpeg on the data path (the reference decodes through
// libjpeg-turbo, native/esn_native.cc; the card's machine has no libjpeg)
// and gives what libjpeg's default decompression gives, formula for
// formula, so that a file decodes here as in the reference:
//
//   - baseline and extended sequential Huffman (SOF0, SOF1) and
//     progressive Huffman (SOF2: spectral selection, successive
//     approximation, EOB runs; jdphuff.c's four scan kinds), 8-bit, with
//     restart intervals (DRI, RSTn); scans interleaved or not;
//   - 1 component (grey), or 3 in YCbCr with the luma sampled 1 or 2 by 1
//     or 2 and the chroma 1x1 (4:4:4, 4:2:2, 4:4:0, 4:2:0);
//   - every block through the islow integer IDCT (jidctint.c: CONST_BITS
//     13, PASS1_BITS 2, its twelve constants, the range limit of
//     jdmaster.c's table), the quantisation table latched at the first
//     scan of each component (jdinput.c);
//   - the chroma upsampled as libjpeg-turbo's fancy upsampling does
//     (jdsample.c: h2v1, h1v2 and h2v2 with their rounding biases and
//     edge cases, the rows above and below the image replicated, plain
//     replication where the chroma is at most 2 columns wide);
//   - YCbCr -> BGR with jdcolor.c's 16-bit fixed-point tables; grey
//     output is the Y component itself, a grey file is replicated to BGR.
//
// Arithmetic coding, lossless and hierarchical frames, 12-bit samples,
// 4-component (CMYK, YCCK) and RGB files, and other sampling factors are
// refused, each with its own code. EXIF orientation is ignored, as the
// reference's native path ignores it. A progressive file is decoded whole
// before any block is transformed, so libjpeg's block smoothing (which
// acts only on scans still missing coefficient bits) never applies.

#include "jpeg.h"

#include <algorithm>
#include <cstring>

namespace esn_jpeg {
namespace {

// zigzag position -> natural (row-major) position, with a tail of 63s
// that an out-of-range index in corrupt data lands on (jutils.c)
const uint8_t kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kFastBits = 9;

// A Huffman table (jdhuff.c's derived table): codes of up to kFastBits
// bits looked up at once, longer ones against each length's largest code.
struct Huffman {
  bool defined = false;
  uint8_t fast_len[1 << kFastBits];
  uint8_t fast_val[1 << kFastBits];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
};

bool build_huffman(Huffman& t, const uint8_t* counts, const uint8_t* vals, int nvals) {
  std::memset(t.fast_len, 0, sizeof(t.fast_len));
  std::memcpy(t.vals, vals, nvals);
  int32_t code = 0;
  int k = 0;
  for (int len = 1; len <= 16; ++len) {
    t.valoffset[len] = k - code;
    for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
      if (len <= kFastBits) {
        const int base = code << (kFastBits - len);
        for (int j = 0; j < (1 << (kFastBits - len)); ++j) {
          t.fast_len[base + j] = static_cast<uint8_t>(len);
          t.fast_val[base + j] = vals[k];
        }
      }
    }
    if (code > (1 << len)) return false;  // oversubscribed
    t.maxcode[len] = counts[len - 1] ? code - 1 : -1;
    code <<= 1;
  }
  t.maxcode[17] = 0x7fffffff;  // a sentinel past the longest code
  t.defined = true;
  return true;
}

// The entropy-coded data, most significant bit first. A 0xFF 0x00 pair is
// a 0xFF byte; at a marker the reader stops and feeds zeros, as libjpeg's
// fill_bit_buffer does, and remembers the marker.
struct BitReader {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  uint64_t buf = 0;  // valid bits at the top
  int count = 0;
  int marker = 0;  // the marker the data ran into, 0 if none yet

  void fill() {
    while (count <= 56) {
      uint64_t byte = 0;
      if (!marker && p < end) {
        byte = *p++;
        if (byte == 0xFF) {
          while (p < end && *p == 0xFF) ++p;  // fill bytes
          const int next = p < end ? *p++ : 0xD9;
          if (next != 0) {
            marker = next;
            byte = 0;
          }
        }
      }
      buf |= byte << (56 - count);
      count += 8;
    }
  }
  uint32_t bits(int n) {  // n <= 16
    if (n == 0) return 0;
    if (count < n) fill();
    const uint32_t v = static_cast<uint32_t>(buf >> (64 - n));
    buf <<= n;
    count -= n;
    return v;
  }
  int symbol(const Huffman& t) {  // -1: no such code
    if (count < 16) fill();
    const int peek = static_cast<int>(buf >> (64 - kFastBits));
    int len = t.fast_len[peek];
    if (len) {
      buf <<= len;
      count -= len;
      return t.fast_val[peek];
    }
    len = kFastBits + 1;
    int32_t code = static_cast<int32_t>(buf >> (64 - len));
    while (code > t.maxcode[len]) {
      if (++len > 16) return -1;
      code = static_cast<int32_t>(buf >> (64 - len));
    }
    buf <<= len;
    count -= len;
    return t.vals[code + t.valoffset[len]];
  }
  // the position of the next marker: the one the data ran into, else the
  // first 0xFF followed by a marker code from here on; its code, or 0 at
  // the end of the data
  int next_marker() {
    buf = 0;
    count = 0;
    if (marker) {
      const int m = marker;
      marker = 0;
      return m;
    }
    while (p < end) {
      if (*p++ != 0xFF) continue;
      while (p < end && *p == 0xFF) ++p;
      if (p < end && *p != 0) return *p++;
    }
    return 0;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;         // the current scan's tables
  int dw = 0, dh = 0;         // downsampled_width / _height
  int bw = 0, bh = 0;         // blocks in the coefficient buffer
  bool latched = false;       // its quantisation table copied (first scan)
  uint16_t q[64];
  int dc_pred = 0;
  std::vector<int16_t> coef;  // bh x bw blocks of 64, natural order
  int16_t* block(int by, int bx) { return coef.data() + (static_cast<size_t>(by) * bw + bx) * 64; }
};

struct Frame {
  int width = 0, height = 0, ncomp = 0;
  bool progressive = false;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  Component comp[3];
};

// islow IDCT (jidctint.c, jpeg_idct_islow) of one block into out
// (stride bytes a row), with jdmaster.c's post-IDCT range limit.
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// the post-IDCT table, indexed by (x & 1023) for an IDCT output x centred
// on 0: x + 128 clamped to [0, 255] for |x| < 512, wrapping beyond
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      if (i < 128) t[i] = static_cast<uint8_t>(i + 128);
      else if (i < 512) t[i] = 255;
      else if (i < 896) t[i] = 0;
      else t[i] = static_cast<uint8_t>(i - 896);
    }
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, size_t stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {  // pass 1: columns
    const int16_t* col = in + c;
    const uint16_t* qc = q + c;
    int* w = ws + c;
    if (!col[8] && !col[16] && !col[24] && !col[32] && !col[40] && !col[48] && !col[56]) {
      const int dc = static_cast<int>(int64_t(col[0]) * qc[0] * (1 << kPass1Bits));
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = int64_t(col[16]) * qc[16], z3 = int64_t(col[48]) * qc[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int64_t(col[0]) * qc[0];
    z3 = int64_t(col[32]) * qc[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int64_t(col[56]) * qc[56];
    tmp1 = int64_t(col[40]) * qc[40];
    tmp2 = int64_t(col[24]) * qc[24];
    tmp3 = int64_t(col[8]) * qc[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int n = kConstBits - kPass1Bits;
    w[0] = static_cast<int>(descale(tmp10 + tmp3, n));
    w[56] = static_cast<int>(descale(tmp10 - tmp3, n));
    w[8] = static_cast<int>(descale(tmp11 + tmp2, n));
    w[48] = static_cast<int>(descale(tmp11 - tmp2, n));
    w[16] = static_cast<int>(descale(tmp12 + tmp1, n));
    w[40] = static_cast<int>(descale(tmp12 - tmp1, n));
    w[24] = static_cast<int>(descale(tmp13 + tmp0, n));
    w[32] = static_cast<int>(descale(tmp13 - tmp0, n));
  }
  for (int r = 0; r < 8; ++r) {  // pass 2: rows
    const int* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    constexpr int n = kConstBits + kPass1Bits + 3;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      const uint8_t v = kRange.t[descale(w[0], kPass1Bits + 3) & 1023];
      std::memset(o, v, 8);
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = kRange.t[descale(tmp10 + tmp3, n) & 1023];
    o[7] = kRange.t[descale(tmp10 - tmp3, n) & 1023];
    o[1] = kRange.t[descale(tmp11 + tmp2, n) & 1023];
    o[6] = kRange.t[descale(tmp11 - tmp2, n) & 1023];
    o[2] = kRange.t[descale(tmp12 + tmp1, n) & 1023];
    o[5] = kRange.t[descale(tmp12 - tmp1, n) & 1023];
    o[3] = kRange.t[descale(tmp13 + tmp0, n) & 1023];
    o[4] = kRange.t[descale(tmp13 - tmp0, n) & 1023];
  }
}

// jdcolor.c's YCbCr -> RGB tables (SCALEBITS 16)
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    constexpr int kScale = 16;
    constexpr int32_t kHalf = int32_t(1) << (kScale - 1);
    auto fix = [](double x) { return static_cast<int32_t>(x * (1 << kScale) + 0.5); };
    for (int i = 0; i < 256; ++i) {
      const int x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t n) : data_(data), end_(data + n) {}

  int run(int out_ch, std::vector<uint8_t>& out, int* h, int* w) {
    int rc = parse();
    if (rc) return rc;
    *h = f_.height;
    *w = f_.width;
    return render(out_ch, out);
  }

 private:
  const uint8_t* data_;
  const uint8_t* end_;
  const uint8_t* p_ = nullptr;
  uint16_t qt_[4][64] = {};
  bool qt_defined_[4] = {};
  Huffman dc_[4], ac_[4];
  int restart_ = 0;
  bool frame_ = false, jfif_ = false, adobe_ = false;
  int adobe_transform_ = -1;
  Frame f_;
  BitReader br_;
  int eobrun_ = 0;
  int scans_ = 0;  // scans decoded

  uint16_t be16(const uint8_t* q) const { return static_cast<uint16_t>((q[0] << 8) | q[1]); }

  // walk the marker segments, decoding each scan; stop at EOI
  int parse() {
    p_ = data_;
    if (end_ - p_ < 2 || p_[0] != 0xFF || p_[1] != 0xD8) return kErrJpegCorrupt;
    p_ += 2;
    int m = next_marker_at(p_);
    for (;;) {
      // EOI, or the end of the data without one (libjpeg warns and keeps
      // what it read)
      if (m == 0 || m == 0xD9) return frame_ && scans_ ? 0 : kErrJpegCorrupt;
      if (m >= 0xD0 && m <= 0xD7) {  // a stray restart marker
        m = next_marker_at(p_);
        continue;
      }
      if (end_ - p_ < 2) return kErrJpegCorrupt;
      const size_t len = be16(p_);
      if (len < 2 || static_cast<size_t>(end_ - p_) < len) return kErrJpegCorrupt;
      const uint8_t* seg = p_ + 2;
      const size_t n = len - 2;
      p_ += len;
      int rc = 0;
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2: rc = frame(seg, n, m == 0xC2); break;
        case 0xC3: case 0xC5: case 0xC6: case 0xC7: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
          return m == 0xCB ? kErrJpegArithmetic : kErrJpegLossless;
        case 0xC9: case 0xCA: return kErrJpegArithmetic;
        case 0xC4: rc = huffman_tables(seg, n); break;
        case 0xDB: rc = quant_tables(seg, n); break;
        case 0xDD: if (n < 2) return kErrJpegCorrupt; restart_ = be16(seg); break;
        case 0xDA: {
          rc = scan(seg, n);
          if (rc) return rc;
          m = br_.next_marker();  // the scan's data end at the next marker
          p_ = br_.p;
          continue;
        }
        case 0xE0:
          if (n >= 5 && std::memcmp(seg, "JFIF\0", 5) == 0) jfif_ = true;
          break;
        case 0xEE:
          if (n >= 12 && std::memcmp(seg, "Adobe", 5) == 0) {
            adobe_ = true;
            adobe_transform_ = seg[11];
          }
          break;
        default: break;  // APPn, COM, DNL and others: skipped
      }
      if (rc) return rc;
      m = next_marker_at(p_);
    }
  }

  // the marker code at p (0xFF, fill bytes, the code); 0 at the end
  int next_marker_at(const uint8_t*& p) {
    while (p < end_ && *p != 0xFF) ++p;  // garbage before a marker is skipped
    while (p < end_ && *p == 0xFF) ++p;
    if (p >= end_) return 0;
    return *p++;
  }

  int quant_tables(const uint8_t* s, size_t n) {
    size_t i = 0;
    while (i < n) {
      const int pq = s[i] >> 4, tq = s[i] & 15;
      ++i;
      if (tq > 3 || pq > 1 || n - i < static_cast<size_t>(pq ? 128 : 64)) return kErrJpegCorrupt;
      for (int k = 0; k < 64; ++k) {
        const uint16_t v = pq ? be16(s + i + 2 * k) : s[i + k];
        qt_[tq][kNatural[k]] = v;
      }
      qt_defined_[tq] = true;
      i += pq ? 128 : 64;
    }
    return 0;
  }

  int huffman_tables(const uint8_t* s, size_t n) {
    size_t i = 0;
    while (i < n) {
      if (n - i < 17) return kErrJpegCorrupt;
      const int tc = s[i] >> 4, th = s[i] & 15;
      const uint8_t* counts = s + i + 1;
      int total = 0;
      for (int k = 0; k < 16; ++k) total += counts[k];
      if (tc > 1 || th > 3 || total > 256 || n - i - 17 < static_cast<size_t>(total))
        return kErrJpegCorrupt;
      Huffman& t = tc ? ac_[th] : dc_[th];
      if (!build_huffman(t, counts, s + i + 17, total)) return kErrJpegCorrupt;
      i += 17 + total;
    }
    return 0;
  }

  int frame(const uint8_t* s, size_t n, bool progressive) {
    if (frame_ || n < 6) return kErrJpegCorrupt;
    if (s[0] != 8) return kErrJpegPrecision;
    f_.height = be16(s + 1);
    f_.width = be16(s + 3);
    f_.ncomp = s[5];
    f_.progressive = progressive;
    if (f_.height == 0 || f_.width == 0) return kErrJpegCorrupt;
    if (f_.ncomp != 1 && f_.ncomp != 3) return kErrJpegColour;
    if (n < 6 + 3 * static_cast<size_t>(f_.ncomp)) return kErrJpegCorrupt;
    for (int c = 0; c < f_.ncomp; ++c) {
      Component& k = f_.comp[c];
      k.id = s[6 + 3 * c];
      k.h = s[7 + 3 * c] >> 4;
      k.v = s[7 + 3 * c] & 15;
      k.tq = s[8 + 3 * c];
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3) return kErrJpegCorrupt;
    }
    if (f_.ncomp == 1) {
      f_.comp[0].h = f_.comp[0].v = 1;  // one component: its own MCU of one block
    } else {
      const Component* k = f_.comp;
      if (k[0].h > 2 || k[0].v > 2 || k[1].h != 1 || k[1].v != 1 || k[2].h != 1 || k[2].v != 1)
        return kErrJpegSampling;
    }
    for (int c = 0; c < f_.ncomp; ++c) {
      f_.hmax = std::max(f_.hmax, f_.comp[c].h);
      f_.vmax = std::max(f_.vmax, f_.comp[c].v);
    }
    f_.mcux = (f_.width + 8 * f_.hmax - 1) / (8 * f_.hmax);
    f_.mcuy = (f_.height + 8 * f_.vmax - 1) / (8 * f_.vmax);
    for (int c = 0; c < f_.ncomp; ++c) {
      Component& k = f_.comp[c];
      k.dw = (f_.width * k.h + f_.hmax - 1) / f_.hmax;
      k.dh = (f_.height * k.v + f_.vmax - 1) / f_.vmax;
      k.bw = f_.mcux * k.h;
      k.bh = f_.mcuy * k.v;
      k.coef.assign(static_cast<size_t>(k.bw) * k.bh * 64, 0);
    }
    frame_ = true;
    return 0;
  }

  // jdapimin.c's default_decompress_parms: a 3-component file is YCbCr
  // unless an Adobe marker says RGB or its component ids spell R, G, B
  bool ycbcr() const {
    if (f_.ncomp != 3 || jfif_) return true;
    if (adobe_) return adobe_transform_ != 0;
    const Component* k = f_.comp;
    return !(k[0].id == 82 && k[1].id == 71 && k[2].id == 66);
  }

  int scan(const uint8_t* s, size_t n) {
    if (!frame_) return kErrJpegCorrupt;
    if (f_.ncomp == 3 && !ycbcr()) return kErrJpegColour;
    if (n < 1) return kErrJpegCorrupt;
    const int ns = s[0];
    if (ns < 1 || ns > f_.ncomp || n < 4 + 2 * static_cast<size_t>(ns)) return kErrJpegCorrupt;
    Component* comps[3];
    for (int i = 0; i < ns; ++i) {
      const int id = s[1 + 2 * i];
      Component* k = nullptr;
      for (int c = 0; c < f_.ncomp; ++c)
        if (f_.comp[c].id == id) k = &f_.comp[c];
      if (!k) return kErrJpegCorrupt;
      k->td = s[2 + 2 * i] >> 4;
      k->ta = s[2 + 2 * i] & 15;
      if (k->td > 3 || k->ta > 3) return kErrJpegCorrupt;
      if (!k->latched) {  // jdinput.c's latch_quant_tables
        if (!qt_defined_[k->tq]) return kErrJpegCorrupt;
        std::memcpy(k->q, qt_[k->tq], sizeof(k->q));
        k->latched = true;
      }
      comps[i] = k;
    }
    const int ss = s[1 + 2 * ns], se = s[2 + 2 * ns];
    const int ah = s[3 + 2 * ns] >> 4, al = s[3 + 2 * ns] & 15;
    int kind;  // 0 sequential, 1 DC first, 2 DC refine, 3 AC first, 4 AC refine
    if (!f_.progressive) {
      kind = 0;
    } else {
      if (ss > se || se > 63 || al > 13 || (ss == 0 && se != 0) || (ss > 0 && ns != 1))
        return kErrJpegCorrupt;
      kind = ss == 0 ? (ah ? 2 : 1) : (ah ? 4 : 3);
    }
    for (int i = 0; i < ns; ++i) {
      Component* k = comps[i];
      const bool need_dc = kind == 0 || kind == 1, need_ac = kind == 0 || kind == 3 || kind == 4;
      if ((need_dc && !dc_[k->td].defined) || (need_ac && !ac_[k->ta].defined))
        return kErrJpegCorrupt;
      k->dc_pred = 0;
    }
    ++scans_;
    br_ = BitReader();
    br_.p = p_;
    br_.end = end_;
    eobrun_ = 0;

    // the scan's MCUs: interleaved, the frame's grid of h x v blocks of
    // each component; one component, one block an MCU over its own extent
    int rows, cols;
    if (ns == 1) {
      cols = (comps[0]->dw + 7) / 8;
      rows = (comps[0]->dh + 7) / 8;
    } else {
      cols = f_.mcux;
      rows = f_.mcuy;
    }
    int todo = restart_;
    for (int my = 0; my < rows; ++my) {
      for (int mx = 0; mx < cols; ++mx) {
        if (restart_ && todo == 0) {  // a restart marker between intervals
          const int m = br_.next_marker();
          if (m < 0xD0 || m > 0xD7) return kErrJpegCorrupt;
          for (int i = 0; i < ns; ++i) comps[i]->dc_pred = 0;
          eobrun_ = 0;
          todo = restart_;
        }
        int rc = 0;
        if (ns == 1) {
          rc = block(*comps[0], comps[0]->block(my, mx), kind, ss, se, al);
        } else {
          for (int i = 0; i < ns && !rc; ++i) {
            Component& k = *comps[i];
            for (int by = 0; by < k.v && !rc; ++by)
              for (int bx = 0; bx < k.h && !rc; ++bx)
                rc = block(k, k.block(my * k.v + by, mx * k.h + bx), kind, ss, se, al);
          }
        }
        if (rc) return rc;
        --todo;
      }
    }
    return 0;
  }

  int block(Component& k, int16_t* b, int kind, int ss, int se, int al) {
    BitReader& br = br_;
    switch (kind) {
      case 0: {  // sequential: DC difference, then the AC run/size pairs
        const int s = br.symbol(dc_[k.td]);
        if (s < 0 || s > 11) return kErrJpegCorrupt;
        k.dc_pred += s ? extend(static_cast<int>(br.bits(s)), s) : 0;
        b[0] = static_cast<int16_t>(k.dc_pred);
        const Huffman& t = ac_[k.ta];
        for (int z = 1; z < 64; ++z) {
          const int rs = br.symbol(t);
          if (rs < 0) return kErrJpegCorrupt;
          const int r = rs >> 4, sz = rs & 15;
          if (sz) {
            z += r;
            if (z > 63) return kErrJpegCorrupt;
            b[kNatural[z]] = static_cast<int16_t>(extend(static_cast<int>(br.bits(sz)), sz));
          } else if (r == 15) {
            z += 15;
          } else {
            break;
          }
        }
        return 0;
      }
      case 1: {  // DC first scan (decode_mcu_DC_first)
        const int s = br.symbol(dc_[k.td]);
        if (s < 0 || s > 11) return kErrJpegCorrupt;
        k.dc_pred += s ? extend(static_cast<int>(br.bits(s)), s) : 0;
        b[0] = static_cast<int16_t>(static_cast<unsigned>(k.dc_pred) << al);
        return 0;
      }
      case 2:  // DC refinement (decode_mcu_DC_refine)
        if (br.bits(1)) b[0] = static_cast<int16_t>(b[0] | (1 << al));
        return 0;
      case 3: {  // AC first scan (decode_mcu_AC_first)
        if (eobrun_ > 0) {
          --eobrun_;
          return 0;
        }
        const Huffman& t = ac_[k.ta];
        for (int z = ss; z <= se; ++z) {
          const int rs = br.symbol(t);
          if (rs < 0) return kErrJpegCorrupt;
          const int r = rs >> 4, s = rs & 15;
          if (s) {
            z += r;
            if (z > 63) return kErrJpegCorrupt;
            const int v = extend(static_cast<int>(br.bits(s)), s);
            b[kNatural[z]] = static_cast<int16_t>(static_cast<unsigned>(v) << al);
          } else if (r == 15) {
            z += 15;
          } else {
            eobrun_ = 1 << r;
            if (r) eobrun_ += static_cast<int>(br.bits(r));
            --eobrun_;
            break;
          }
        }
        return 0;
      }
      default: {  // AC refinement (decode_mcu_AC_refine)
        const int p1 = 1 << al, m1 = -1 * (1 << al);
        const Huffman& t = ac_[k.ta];
        int z = ss;
        if (eobrun_ == 0) {
          for (; z <= se; ++z) {
            const int rs = br.symbol(t);
            if (rs < 0) return kErrJpegCorrupt;
            int r = rs >> 4, s = rs & 15;
            if (s) {
              if (s != 1) return kErrJpegCorrupt;
              s = br.bits(1) ? p1 : m1;
            } else if (r != 15) {
              eobrun_ = 1 << r;
              if (r) eobrun_ += static_cast<int>(br.bits(r));
              break;  // the rest of the block is the EOB run's
            }
            // past the nonzero coefficients (a correction bit each) and r
            // zero ones, to the zero coefficient that takes s
            do {
              int16_t* c = b + kNatural[z];
              if (*c != 0) {
                if (br.bits(1) && (*c & p1) == 0)
                  *c = static_cast<int16_t>(*c >= 0 ? *c + p1 : *c + m1);
              } else if (--r < 0) {
                break;
              }
              ++z;
            } while (z <= se);
            if (s) {
              if (z > 63) return kErrJpegCorrupt;
              b[kNatural[z]] = static_cast<int16_t>(s);
            }
          }
        }
        if (eobrun_ > 0) {  // correction bits for the rest of the band
          for (; z <= se; ++z) {
            int16_t* c = b + kNatural[z];
            if (*c != 0 && br.bits(1) && (*c & p1) == 0)
              *c = static_cast<int16_t>(*c >= 0 ? *c + p1 : *c + m1);
          }
          --eobrun_;
        }
        return 0;
      }
    }
  }

  // every block of a component through the IDCT: its plane, bw*8 wide
  std::vector<uint8_t> plane(Component& k) {
    const size_t stride = static_cast<size_t>(k.bw) * 8;
    const int rows = (k.dh + 7) / 8, cols = (k.dw + 7) / 8;
    std::vector<uint8_t> out(stride * rows * 8);
    for (int by = 0; by < rows; ++by)
      for (int bx = 0; bx < cols; ++bx)
        idct_islow(k.block(by, bx), k.q, out.data() + by * 8 * stride + bx * 8, stride);
    return out;
  }

  // one output row of a chroma component at full width (jdsample.c)
  void upsample_row(const Component& k, const std::vector<uint8_t>& pl, int y,
                    std::vector<int>& colsum, uint8_t* out) const {
    const size_t stride = static_cast<size_t>(k.bw) * 8;
    const int hx = f_.hmax / k.h, vy = f_.vmax / k.v;
    const int dw = k.dw, wide = f_.width;
    const int ci = y / vy;
    const uint8_t* near = pl.data() + ci * stride;
    if (hx == 1 && vy == 1) {
      std::memcpy(out, near, wide);
      return;
    }
    if (vy == 1) {  // h2v1
      if (dw <= 2) {  // plain replication
        for (int x = 0; x < wide; ++x) out[x] = near[x >> 1];
        return;
      }
      std::vector<uint8_t> full(2 * dw);
      full[0] = near[0];
      full[1] = static_cast<uint8_t>((near[0] * 3 + near[1] + 2) >> 2);
      for (int c = 1; c < dw - 1; ++c) {
        const int v = near[c] * 3;
        full[2 * c] = static_cast<uint8_t>((v + near[c - 1] + 1) >> 2);
        full[2 * c + 1] = static_cast<uint8_t>((v + near[c + 1] + 2) >> 2);
      }
      full[2 * dw - 2] = static_cast<uint8_t>((near[dw - 1] * 3 + near[dw - 2] + 1) >> 2);
      full[2 * dw - 1] = near[dw - 1];
      std::memcpy(out, full.data(), wide);
      return;
    }
    // v2: the nearer row, and the row above (upper output row) or below
    // (lower), the image's first and last rows replicated
    const bool upper = (y % 2) == 0;
    const int fi = upper ? std::max(ci - 1, 0) : std::min(ci + 1, k.dh - 1);
    const uint8_t* far = pl.data() + fi * stride;
    if (hx == 1) {  // h1v2
      const int bias = upper ? 1 : 2;
      for (int x = 0; x < wide; ++x)
        out[x] = static_cast<uint8_t>((near[x] * 3 + far[x] + bias) >> 2);
      return;
    }
    if (dw <= 2) {  // h2v2 plain replication
      for (int x = 0; x < wide; ++x) out[x] = near[x >> 1];
      return;
    }
    colsum.resize(dw);
    for (int c = 0; c < dw; ++c) colsum[c] = near[c] * 3 + far[c];
    std::vector<uint8_t> full(2 * dw);
    full[0] = static_cast<uint8_t>((colsum[0] * 4 + 8) >> 4);
    full[1] = static_cast<uint8_t>((colsum[0] * 3 + colsum[1] + 7) >> 4);
    for (int c = 1; c < dw - 1; ++c) {
      full[2 * c] = static_cast<uint8_t>((colsum[c] * 3 + colsum[c - 1] + 8) >> 4);
      full[2 * c + 1] = static_cast<uint8_t>((colsum[c] * 3 + colsum[c + 1] + 7) >> 4);
    }
    full[2 * dw - 2] = static_cast<uint8_t>((colsum[dw - 1] * 3 + colsum[dw - 2] + 8) >> 4);
    full[2 * dw - 1] = static_cast<uint8_t>((colsum[dw - 1] * 4 + 7) >> 4);
    std::memcpy(out, full.data(), wide);
  }

  int render(int out_ch, std::vector<uint8_t>& out) {
    const int h = f_.height, w = f_.width;
    out.resize(static_cast<size_t>(h) * w * out_ch);
    Component& y = f_.comp[0];
    const std::vector<uint8_t> luma = plane(y);
    const size_t ls = static_cast<size_t>(y.bw) * 8;
    if (out_ch == 1 || f_.ncomp == 1) {  // grey: Y itself, replicated to BGR
      for (int r = 0; r < h; ++r) {
        const uint8_t* src = luma.data() + r * ls;
        uint8_t* dst = out.data() + static_cast<size_t>(r) * w * out_ch;
        if (out_ch == 1) {
          std::memcpy(dst, src, w);
        } else {
          for (int x = 0; x < w; ++x) dst[3 * x] = dst[3 * x + 1] = dst[3 * x + 2] = src[x];
        }
      }
      return 0;
    }
    const std::vector<uint8_t> cb = plane(f_.comp[1]), cr = plane(f_.comp[2]);
    std::vector<uint8_t> cb_row(w), cr_row(w);
    std::vector<int> colsum;
    for (int r = 0; r < h; ++r) {
      upsample_row(f_.comp[1], cb, r, colsum, cb_row.data());
      upsample_row(f_.comp[2], cr, r, colsum, cr_row.data());
      const uint8_t* yy = luma.data() + r * ls;
      uint8_t* dst = out.data() + static_cast<size_t>(r) * w * 3;
      for (int x = 0; x < w; ++x) {
        const int l = yy[x], b = cb_row[x], c = cr_row[x];
        dst[3 * x] = clamp255(l + kYcc.cb_b[b]);
        dst[3 * x + 1] = clamp255(l + ((kYcc.cb_g[b] + kYcc.cr_g[c]) >> 16));
        dst[3 * x + 2] = clamp255(l + kYcc.cr_r[c]);
      }
    }
    return 0;
  }
};

}  // namespace

int decode(const uint8_t* data, size_t n, int out_ch, std::vector<uint8_t>& out, int* h,
           int* w) {
  Decoder d(data, n);
  return d.run(out_ch, out, h, w);
}

}  // namespace esn_jpeg
