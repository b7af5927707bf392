// esn_native: the port's image decoder, resizes and threaded prefetch.
//
// Counterpart of native/esn_native.cc, on the C++ standard library alone
// (no libpng, zlib or libjpeg headers are needed to build it):
//
//   - PNG: the chunk walk, an inflate of its own (RFC 1950/1951, checked
//     against the stream's Adler-32), the five row filters, and each kind
//     of PNG converted to what cv2.imread returns: IMREAD_COLOR ->
//     (H, W, 3) BGR, IMREAD_GRAYSCALE -> (H, W). 8-bit grey and RGB are
//     what the datasets hold; palette (1-8 bits), grey at 1, 2 and 4 bits
//     (scaled to 0..255), grey+alpha and RGBA (alpha dropped), 16-bit (the
//     high byte) and colour read as grey (libpng's fixed-point weights,
//     which cv2 asks for) follow libpng's transforms as cv2 sets them up.
//     Adam7-interlaced files decode pass by pass, each pass's sub-image
//     unfiltered and converted, then scattered into the image. Colour
//     files with a gamma (a gAMA or sRGB chunk, which makes libpng's
//     colour-to-grey weigh linear values) read as grey are refused. Chunk CRCs and the other ancillary chunks
//     (tRNS, ...) are not read: cv2's outputs drop alpha.
//   - JPEG: the size from the SOF marker here; the pixels from the
//     decoder of jpeg.cc, compiled into the same library (libjpeg's
//     default decompression, formula for formula, with no libjpeg).
//   - resizes, formula for formula the reference's: bilinear with
//     half-pixel centres and +0.5f rounding (images), floor(dst * scale)
//     nearest (labels).
//   - a bounded-ring prefetch pipeline: N decode threads, in-order
//     delivery, the epoch's order given by the caller.
//
// Built by esn_tpu_torch/data/native.py with the host C++ compiler at first
// use; every entry point is extern "C" for ctypes, which releases the GIL
// around each call.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "jpeg.h"

namespace {

// Error codes, mapped to exceptions by data/native.py.
enum : int {
  kErrOpen = -1,         // file missing or unreadable
  kErrFormat = -2,       // neither PNG nor JPEG
  kErrUnsupported = -4,  // bit depth / colour type not in the PNG spec
  kErrCorrupt = -5,      // bad chunk, inflate or filter data
  // -7 and -10 to -14: the JPEG decoder's (jpeg.h)
  kErrSize = -8,         // a size argument out of range
  kErrGamma = -9,        // a colour PNG with a gamma read as grey
};

// The file's bytes, or its first `limit` bytes when limit > 0; *whole says
// whether data holds all of it.
bool read_file(const char* path, std::vector<uint8_t>& data, size_t limit = 0,
               bool* whole = nullptr) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  if (n < 0) { std::fclose(f); return false; }
  std::fseek(f, 0, SEEK_SET);
  size_t want = static_cast<size_t>(n);
  if (limit && limit < want) want = limit;
  if (whole) *whole = want == static_cast<size_t>(n);
  data.resize(want);
  size_t got = want ? std::fread(data.data(), 1, want, f) : 0;
  std::fclose(f);
  return got == want;
}

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

const uint8_t kPngSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

bool is_png(const std::vector<uint8_t>& d) {
  return d.size() >= 8 && std::memcmp(d.data(), kPngSig, 8) == 0;
}

bool is_jpeg(const std::vector<uint8_t>& d) {
  return d.size() >= 3 && d[0] == 0xFF && d[1] == 0xD8 && d[2] == 0xFF;
}

// ---------------------------------------------------------------------------
// Inflate (RFC 1951) behind a zlib wrapper (RFC 1950)
// ---------------------------------------------------------------------------

constexpr int kFastBits = 10;
constexpr int kFastMask = (1 << kFastBits) - 1;

// Canonical Huffman code. `fast` maps the next kFastBits input bits to
// (length << 9) | symbol for codes of at most kFastBits bits (0: look the
// code up by length); longer codes are found by their bit-reversed value
// against each length's first and last code.
struct Huffman {
  uint16_t fast[1 << kFastBits];
  uint16_t first_code[17];
  int max_code[18];
  uint16_t first_symbol[17];
  uint8_t size[288];
  uint16_t value[288];
};

int reverse_bits(int v, int bits) {
  int r = 0;
  for (int i = 0; i < bits; ++i) { r = (r << 1) | (v & 1); v >>= 1; }
  return r;
}

bool build_huffman(Huffman& h, const uint8_t* lengths, int n) {
  int counts[17] = {0};
  int next_code[16];
  std::memset(h.fast, 0, sizeof(h.fast));
  std::memset(h.size, 0, sizeof(h.size));
  for (int i = 0; i < n; ++i) ++counts[lengths[i]];
  counts[0] = 0;
  int code = 0, k = 0;
  for (int i = 1; i < 16; ++i) {
    next_code[i] = code;
    h.first_code[i] = static_cast<uint16_t>(code);
    h.first_symbol[i] = static_cast<uint16_t>(k);
    code += counts[i];
    if (counts[i] && code - 1 >= (1 << i)) return false;  // oversubscribed
    h.max_code[i] = code << (16 - i);  // first bit-reversed value beyond
    code <<= 1;
    k += counts[i];
  }
  h.max_code[16] = 0x10000;
  h.max_code[17] = 0x10000;
  for (int i = 0; i < n; ++i) {
    const int s = lengths[i];
    if (!s) continue;
    const int c = next_code[s] - h.first_code[s] + h.first_symbol[s];
    h.size[c] = static_cast<uint8_t>(s);
    h.value[c] = static_cast<uint16_t>(i);
    if (s <= kFastBits) {
      const uint16_t entry = static_cast<uint16_t>((s << 9) | i);
      for (int j = reverse_bits(next_code[s], s); j < (1 << kFastBits);
           j += 1 << s)
        h.fast[j] = entry;
    }
    ++next_code[s];
  }
  return true;
}

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int count = 0;      // valid bits in buf
  size_t padded = 0;  // zero bytes fed past the end

  void refill() {
    if (end - p >= 8) {
      uint64_t word;
      std::memcpy(&word, p, 8);  // little-endian hosts (x86-64, aarch64)
      buf |= word << count;
      p += (63 - count) >> 3;
      count |= 56;
      return;
    }
    while (count <= 56) {
      uint64_t byte = 0;
      if (p < end) byte = *p++; else ++padded;
      buf |= byte << count;
      count += 8;
    }
  }
  uint32_t bits(int n) {  // n <= count, n <= 32
    const uint32_t v = static_cast<uint32_t>(buf & ((uint64_t(1) << n) - 1));
    buf >>= n;
    count -= n;
    return v;
  }
  // read past the data: more zero bits used than were padded in
  bool overrun() const { return padded * 8 > static_cast<size_t>(count); }
};

int decode_symbol(BitReader& br, const Huffman& h) {
  const uint16_t f = h.fast[br.buf & kFastMask];
  if (f) {
    br.buf >>= f >> 9;
    br.count -= f >> 9;
    return f & 511;
  }
  const int k = reverse_bits(static_cast<int>(br.buf & 0xffff), 16);
  int s = kFastBits + 1;
  while (k >= h.max_code[s]) ++s;
  if (s >= 16) return -1;
  const int b = (k >> (16 - s)) - h.first_code[s] + h.first_symbol[s];
  if (b < 0 || b >= 288 || h.size[b] != s) return -1;
  br.buf >>= s;
  br.count -= s;
  return h.value[b];
}

const uint16_t kLengthBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 13,
                                  15, 17, 19, 23, 27, 31, 35, 43, 51, 59,
                                  67, 83, 99, 115, 131, 163, 195, 227, 258};
const uint8_t kLengthExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                  2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
const uint16_t kDistBase[30] = {1,    2,    3,    4,    5,    7,     9,
                                13,   17,   25,   33,   49,   65,    97,
                                129,  193,  257,  385,  513,  769,   1025,
                                1537, 2049, 3073, 4097, 6145, 8193, 12289,
                                16385, 24577};
const uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                                6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

struct FixedTables {
  Huffman lit, dist;
  FixedTables() {
    uint8_t l[288], d[30];
    for (int i = 0; i < 288; ++i)
      l[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
    for (int i = 0; i < 30; ++i) d[i] = 5;
    build_huffman(lit, l, 288);
    build_huffman(dist, d, 30);
  }
};

const FixedTables& fixed_tables() {
  static const FixedTables t;  // thread-safe initialisation (C++11)
  return t;
}

bool read_dynamic(BitReader& br, Huffman& lit, Huffman& dist) {
  static const uint8_t kOrder[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                     11, 4,  12, 3, 13, 2, 14, 1, 15};
  br.refill();
  const int hlit = static_cast<int>(br.bits(5)) + 257;
  const int hdist = static_cast<int>(br.bits(5)) + 1;
  const int hclen = static_cast<int>(br.bits(4)) + 4;
  if (hlit > 286 || hdist > 30) return false;
  uint8_t clen[19] = {0};
  for (int i = 0; i < hclen; ++i) {
    br.refill();
    clen[kOrder[i]] = static_cast<uint8_t>(br.bits(3));
  }
  Huffman code_lengths;
  if (!build_huffman(code_lengths, clen, 19)) return false;
  uint8_t lengths[286 + 30];
  int n = 0;
  while (n < hlit + hdist) {
    br.refill();
    const int sym = decode_symbol(br, code_lengths);
    if (sym < 0) return false;
    if (sym < 16) {
      lengths[n++] = static_cast<uint8_t>(sym);
      continue;
    }
    int repeat;
    uint8_t fill = 0;
    if (sym == 16) {
      if (n == 0) return false;
      repeat = 3 + static_cast<int>(br.bits(2));
      fill = lengths[n - 1];
    } else if (sym == 17) {
      repeat = 3 + static_cast<int>(br.bits(3));
    } else {
      repeat = 11 + static_cast<int>(br.bits(7));
    }
    if (n + repeat > hlit + hdist) return false;
    std::memset(lengths + n, fill, repeat);
    n += repeat;
  }
  if (lengths[256] == 0) return false;  // no end-of-block code
  return build_huffman(lit, lengths, hlit) &&
         build_huffman(dist, lengths + hlit, hdist) && !br.overrun();
}

uint32_t adler32(const uint8_t* p, size_t n) {
  uint32_t a = 1, b = 0;
  while (n) {
    size_t k = std::min<size_t>(n, 5552);
    n -= k;
    while (k--) { a += *p++; b += a; }
    a %= 65521;
    b %= 65521;
  }
  return (b << 16) | a;
}

// Inflate the zlib stream src[0, n) into exactly `want` bytes of dst.
// Returns want, or kErrCorrupt on a malformed stream, a wrong Adler-32, or
// a stream whose data is longer or shorter than `want`.
long inflate_zlib(const uint8_t* src, size_t n, uint8_t* dst, size_t want) {
  if (n < 6) return kErrCorrupt;
  const int cmf = src[0], flg = src[1];
  if ((cmf & 15) != 8 || (cmf >> 4) > 7 || (cmf * 256 + flg) % 31 != 0 ||
      (flg & 32))
    return kErrCorrupt;
  BitReader br{src + 2, src + n};
  size_t pos = 0;
  Huffman dyn_lit, dyn_dist;
  for (;;) {
    br.refill();
    const int final_block = static_cast<int>(br.bits(1));
    const int type = static_cast<int>(br.bits(2));
    if (type == 0) {  // stored
      br.bits(br.count & 7);
      const uint32_t len = br.bits(16);
      const uint32_t nlen = br.bits(16);
      if ((len ^ 0xffff) != nlen || pos + len > want) return kErrCorrupt;
      uint32_t left = len;
      while (left && br.count >= 8) {  // bytes still in the bit buffer
        dst[pos++] = static_cast<uint8_t>(br.bits(8));
        --left;
      }
      if (br.count == 0) br.buf = 0;  // drop the partial byte read ahead
      if (static_cast<size_t>(br.end - br.p) < left) return kErrCorrupt;
      std::memcpy(dst + pos, br.p, left);
      br.p += left;
      pos += left;
    } else if (type == 1 || type == 2) {
      const Huffman* lit = &fixed_tables().lit;
      const Huffman* dist = &fixed_tables().dist;
      if (type == 2) {
        if (!read_dynamic(br, dyn_lit, dyn_dist)) return kErrCorrupt;
        lit = &dyn_lit;
        dist = &dyn_dist;
      }
      for (;;) {
        br.refill();  // >= 57 bits: one length/distance pair takes <= 48
        const int sym = decode_symbol(br, *lit);
        if (sym < 256) {
          if (sym < 0 || pos >= want) return kErrCorrupt;
          dst[pos++] = static_cast<uint8_t>(sym);
          continue;
        }
        if (sym == 256) break;
        const int li = sym - 257;
        if (li >= 29) return kErrCorrupt;
        const size_t len = kLengthBase[li] + br.bits(kLengthExtra[li]);
        const int di = decode_symbol(br, *dist);
        if (di < 0 || di >= 30) return kErrCorrupt;
        const size_t d = kDistBase[di] + br.bits(kDistExtra[di]);
        if (d > pos || pos + len > want) return kErrCorrupt;
        uint8_t* out = dst + pos;
        const uint8_t* from = out - d;
        if (d >= len) {
          std::memcpy(out, from, len);
        } else if (d == 1) {
          std::memset(out, *from, len);
        } else {
          for (size_t i = 0; i < len; ++i) out[i] = from[i];
        }
        pos += len;
      }
    } else {
      return kErrCorrupt;
    }
    if (br.overrun()) return kErrCorrupt;
    if (final_block) break;
  }
  // the Adler-32 of the data, big-endian, on the next byte boundary
  br.bits(br.count & 7);
  uint8_t tail[4];
  for (int i = 0; i < 4; ++i) {
    br.refill();
    tail[i] = static_cast<uint8_t>(br.bits(8));
  }
  if (br.overrun() || be32(tail) != adler32(dst, pos)) return kErrCorrupt;
  if (pos != want) return kErrCorrupt;
  return static_cast<long>(pos);
}

// ---------------------------------------------------------------------------
// PNG
// ---------------------------------------------------------------------------

struct PngHeader {
  int w = 0, h = 0, depth = 0, color = 0, interlace = 0;
  int channels = 0;  // samples a pixel
};

int png_header(const std::vector<uint8_t>& d, PngHeader* hd) {
  if (d.size() < 33 || be32(d.data() + 8) != 13 ||
      std::memcmp(d.data() + 12, "IHDR", 4) != 0)
    return kErrCorrupt;
  const uint8_t* p = d.data() + 16;
  const uint32_t w = be32(p), h = be32(p + 4);
  hd->depth = p[8];
  hd->color = p[9];
  hd->interlace = p[12];
  if (w == 0 || h == 0 || w > (1u << 24) || h > (1u << 24) || p[10] != 0 ||
      p[11] != 0 || p[12] > 1)
    return kErrCorrupt;
  hd->w = static_cast<int>(w);
  hd->h = static_cast<int>(h);
  const int dp = hd->depth;
  switch (hd->color) {
    case 0: hd->channels = 1;
      if (dp != 1 && dp != 2 && dp != 4 && dp != 8 && dp != 16)
        return kErrUnsupported;
      break;
    case 3: hd->channels = 1;
      if (dp != 1 && dp != 2 && dp != 4 && dp != 8) return kErrUnsupported;
      break;
    case 2: hd->channels = 3; break;
    case 4: hd->channels = 2; break;
    case 6: hd->channels = 4; break;
    default: return kErrUnsupported;
  }
  if (hd->color != 0 && hd->color != 3 && dp != 8 && dp != 16)
    return kErrUnsupported;
  return 0;
}

// libpng's rgb_to_gray as cv2 sets it up (png_set_rgb_to_gray(png, 1,
// 0.299, 0.587)): coefficients 29900 * 32768 / 100000 = 9797 and 19234 in
// 15-bit fixed point, blue the rest, the sum truncated; grey pixels pass.
constexpr uint32_t kRc = 9797, kGc = 19234, kBc = 32768 - kRc - kGc;

uint32_t rgb_to_grey(uint32_t r, uint32_t g, uint32_t b) {
  if (r == g && r == b) return r;
  return (kRc * r + kGc * g + kBc * b) >> 15;
}

// Whether a file gamma (libpng's fixed point, 1.0 is 100000) changes
// libpng's colour-to-grey: it or its reciprocal more than 5% from 1.
bool gamma_significant(int g) {
  const int inv = static_cast<int>(std::floor(1e10 / g + .5));
  return g < 95000 || g > 105000 || inv < 95000 || inv > 105000;
}

uint8_t paeth(int a, int b, int c) {
  const int pa = std::abs(b - c), pb = std::abs(a - c),
            pc = std::abs(a + b - 2 * c);
  return static_cast<uint8_t>((pa <= pb && pa <= pc) ? a : pb <= pc ? b : c);
}

// Undo one row's filter in place; `prev` is the row above, unfiltered
// (zeros for the first row).
bool unfilter(uint8_t* row, const uint8_t* prev, int type, size_t stride,
              int bpp) {
  switch (type) {
    case 0: break;
    case 1:
      for (size_t i = bpp; i < stride; ++i) row[i] += row[i - bpp];
      break;
    case 2:
      for (size_t i = 0; i < stride; ++i) row[i] += prev[i];
      break;
    case 3:
      for (int i = 0; i < bpp; ++i) row[i] += prev[i] >> 1;
      for (size_t i = bpp; i < stride; ++i)
        row[i] += static_cast<uint8_t>((row[i - bpp] + prev[i]) >> 1);
      break;
    case 4:
      for (int i = 0; i < bpp; ++i) row[i] += prev[i];  // paeth(0, b, 0) = b
      for (size_t i = bpp; i < stride; ++i)
        row[i] += paeth(row[i - bpp], prev[i], prev[i - bpp]);
      break;
    default: return false;
  }
  return true;
}

// One unfiltered row to the output's pixels: out_ch 3 (BGR) or 1 (grey).
void convert_row(const PngHeader& hd, const uint8_t* row,
                 const uint8_t (*palette)[3], uint8_t* out, int out_ch) {
  const int w = hd.w, dp = hd.depth;
  if (dp < 8) {  // grey or palette, samples packed high bit first
    const int per_byte = 8 / dp, mask = (1 << dp) - 1;
    const int scale = 255 / mask;  // 255, 85, 17 for 1, 2, 4 bits
    for (int x = 0; x < w; ++x) {
      const int shift = 8 - dp * (x % per_byte + 1);
      const int v = (row[x / per_byte] >> shift) & mask;
      if (hd.color == 3) {
        const uint8_t* c = palette[v];
        if (out_ch == 3) {
          out[3 * x] = c[2]; out[3 * x + 1] = c[1]; out[3 * x + 2] = c[0];
        } else {
          out[x] = static_cast<uint8_t>(rgb_to_grey(c[0], c[1], c[2]));
        }
      } else if (out_ch == 3) {
        out[3 * x] = out[3 * x + 1] = out[3 * x + 2] =
            static_cast<uint8_t>(v * scale);
      } else {
        out[x] = static_cast<uint8_t>(v * scale);
      }
    }
    return;
  }
  const int bytes = dp / 8, ch = hd.channels;
  const int step = bytes * ch;
  if (hd.color == 3) {  // 8-bit palette
    for (int x = 0; x < w; ++x) {
      const uint8_t* c = palette[row[x]];
      if (out_ch == 3) {
        out[3 * x] = c[2]; out[3 * x + 1] = c[1]; out[3 * x + 2] = c[0];
      } else {
        out[x] = static_cast<uint8_t>(rgb_to_grey(c[0], c[1], c[2]));
      }
    }
    return;
  }
  const bool colour = hd.color == 2 || hd.color == 6;
  if (out_ch == 3) {  // the high byte of each sample; alpha dropped
    for (int x = 0; x < w; ++x) {
      const uint8_t* px = row + static_cast<size_t>(x) * step;
      if (colour) {
        out[3 * x] = px[2 * bytes];
        out[3 * x + 1] = px[bytes];
        out[3 * x + 2] = px[0];
      } else {
        out[3 * x] = out[3 * x + 1] = out[3 * x + 2] = px[0];
      }
    }
    return;
  }
  for (int x = 0; x < w; ++x) {
    const uint8_t* px = row + static_cast<size_t>(x) * step;
    if (!colour) {
      out[x] = px[0];
    } else if (bytes == 1) {
      out[x] = static_cast<uint8_t>(rgb_to_grey(px[0], px[1], px[2]));
    } else {  // libpng converts 16-bit samples, rounded, before it strips
      const uint32_t r = (px[0] << 8) | px[1], g = (px[2] << 8) | px[3],
                     b = (px[4] << 8) | px[5];
      const uint32_t v = (r == g && r == b)
                             ? r : (kRc * r + kGc * g + kBc * b + 16384) >> 15;
      out[x] = static_cast<uint8_t>(v >> 8);
    }
  }
}

// Adam7's seven passes, (x0, y0, dx, dy) each; kWhole, the image itself
const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                          {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                          {0, 1, 1, 2}};
const int kWhole[4] = {0, 0, 1, 1};

// A pass's sub-image: pixels (x0 + c dx, y0 + r dy) of the image, w x h of
// them (0 x 0 for a pass that holds none, which has no bytes at all), each
// row `stride` bytes after its filter byte.
struct Pass {
  int x0 = 0, y0 = 0, dx = 1, dy = 1, w = 0, h = 0;
  size_t stride = 0;
  size_t bytes() const { return static_cast<size_t>(h) * (stride + 1); }
};

Pass make_pass(const PngHeader& hd, const int (&p)[4], int bits) {
  Pass ps;
  ps.x0 = p[0];
  ps.y0 = p[1];
  ps.dx = p[2];
  ps.dy = p[3];
  ps.w = hd.w > ps.x0 ? (hd.w - ps.x0 + ps.dx - 1) / ps.dx : 0;
  ps.h = hd.h > ps.y0 ? (hd.h - ps.y0 + ps.dy - 1) / ps.dy : 0;
  if (ps.w == 0 || ps.h == 0) ps.w = ps.h = 0;
  ps.stride = (static_cast<size_t>(ps.w) * bits + 7) / 8;
  return ps;
}

int png_decode(const std::vector<uint8_t>& d, int out_ch,
               std::vector<uint8_t>& out, int* oh, int* ow) {
  PngHeader hd;
  int rc = png_header(d, &hd);
  if (rc) return rc;
  uint8_t palette[256][3] = {};  // entries past PLTE's read black, as libpng
  std::vector<uint8_t> z;
  bool have_palette = false, srgb = false;
  int file_gamma = 0;
  size_t pos = 8;
  for (;;) {
    if (pos + 12 > d.size()) return kErrCorrupt;
    const uint32_t len = be32(d.data() + pos);
    const uint8_t* kind = d.data() + pos + 4;
    const uint8_t* body = d.data() + pos + 8;
    if (len > d.size() - pos - 12) return kErrCorrupt;
    // libpng ignores a gAMA or sRGB chunk after PLTE or IDAT
    const bool early = !have_palette && z.empty();
    if (std::memcmp(kind, "IDAT", 4) == 0) {
      z.insert(z.end(), body, body + len);
    } else if (std::memcmp(kind, "PLTE", 4) == 0) {
      if (len % 3 || len > 768) return kErrCorrupt;
      std::memcpy(palette, body, len);
      have_palette = true;
    } else if (std::memcmp(kind, "gAMA", 4) == 0 && len == 4 && early) {
      const uint32_t g = be32(body);  // libpng's range, else ignored
      if (g >= 16 && g <= 625000000) file_gamma = static_cast<int>(g);
    } else if (std::memcmp(kind, "sRGB", 4) == 0 && len == 1 && early) {
      srgb = true;
    } else if (std::memcmp(kind, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + len;
  }
  if (hd.color == 3 && !have_palette) return kErrCorrupt;
  const bool colour = hd.color == 2 || hd.color == 3 || hd.color == 6;
  // sRGB's gamma is 45455
  if (out_ch == 1 && colour && (srgb || (file_gamma > 0 &&
      gamma_significant(file_gamma))))
    return kErrGamma;
  const int bits = hd.channels * hd.depth;
  const int bpp = std::max(1, bits / 8);
  // the passes' sub-images, one (the image) when not interlaced; each row
  // a filter byte and `stride` bytes, each pass's first row filtered
  // against zeros
  const int n_passes = hd.interlace ? 7 : 1;
  Pass passes[7];
  size_t total = 0;
  for (int i = 0; i < n_passes; ++i) {
    passes[i] = make_pass(hd, hd.interlace ? kAdam7[i] : kWhole, bits);
    total += passes[i].bytes();
  }
  std::vector<uint8_t> raw(total);
  if (inflate_zlib(z.data(), z.size(), raw.data(), raw.size()) < 0)
    return kErrCorrupt;
  out.resize(static_cast<size_t>(hd.h) * hd.w * out_ch);
  size_t widest = 0;
  for (int i = 0; i < n_passes; ++i) widest = std::max(widest, passes[i].stride);
  std::vector<uint8_t> zeros(widest + 1, 0), px;
  uint8_t* line = raw.data();
  for (int i = 0; i < n_passes; ++i) {
    const Pass& ps = passes[i];
    PngHeader sub = hd;
    sub.w = ps.w;
    px.resize(static_cast<size_t>(ps.w) * out_ch);
    const uint8_t* prev = zeros.data();
    for (int r = 0; r < ps.h; ++r, line += ps.stride + 1) {
      if (!unfilter(line + 1, prev, line[0], ps.stride, bpp))
        return kErrCorrupt;
      const int y = ps.y0 + r * ps.dy;
      uint8_t* row = out.data() + static_cast<size_t>(y) * hd.w * out_ch;
      if (ps.dx == 1) {
        convert_row(sub, line + 1, palette, row, out_ch);
      } else {  // scatter the pass's pixels into the row
        convert_row(sub, line + 1, palette, px.data(), out_ch);
        for (int c = 0; c < ps.w; ++c)
          std::memcpy(row + static_cast<size_t>(ps.x0 + c * ps.dx) * out_ch,
                      px.data() + static_cast<size_t>(c) * out_ch, out_ch);
      }
      prev = line + 1;
    }
  }
  *oh = hd.h;
  *ow = hd.w;
  return 0;
}

// ---------------------------------------------------------------------------
// JPEG: the size from the frame header here, the pixels from jpeg.cc
// ---------------------------------------------------------------------------

int jpeg_dims(const std::vector<uint8_t>& d, int* h, int* w) {
  size_t p = 2;
  while (p + 4 <= d.size()) {
    if (d[p] != 0xFF) return kErrCorrupt;
    const int m = d[p + 1];
    if (m == 0xFF) { ++p; continue; }  // fill byte
    if (m == 0xD8 || m == 0x01 || (m >= 0xD0 && m <= 0xD7)) { p += 2; continue; }
    const size_t len = (size_t(d[p + 2]) << 8) | d[p + 3];
    const bool sof = m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 &&
                     m != 0xCC;
    if (sof) {
      if (p + 9 > d.size()) return kErrCorrupt;
      *h = (d[p + 5] << 8) | d[p + 6];
      *w = (d[p + 7] << 8) | d[p + 8];
      return (*h > 0 && *w > 0) ? 0 : kErrCorrupt;
    }
    if (m == 0xD9 || m == 0xDA) return kErrCorrupt;  // no frame before scan
    p += 2 + len;
  }
  return kErrCorrupt;
}

int jpeg_decode(const std::vector<uint8_t>& d, int out_ch,
                std::vector<uint8_t>& out, int* oh, int* ow) {
  return esn_jpeg::decode(d.data(), d.size(), out_ch, out, oh, ow);
}

int decode_file(const char* path, int out_ch, std::vector<uint8_t>& out,
                int* h, int* w) {
  std::vector<uint8_t> data;
  if (!read_file(path, data)) return kErrOpen;
  if (is_png(data)) return png_decode(data, out_ch, out, h, w);
  if (is_jpeg(data)) return jpeg_decode(data, out_ch, out, h, w);
  return kErrFormat;
}

// ---------------------------------------------------------------------------
// Resizes (the reference's, formula for formula)
// ---------------------------------------------------------------------------

// bilinear, half-pixel centres (cv2 INTER_LINEAR up to +-1)
void resize_bilinear(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh,
                     int dw, int channels) {
  const float sy = static_cast<float>(sh) / dh;
  const float sx = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(std::floor(fy));
    float wy = fy - y0;
    int y1 = y0 + 1;
    if (y0 < 0) { y0 = 0; y1 = 0; wy = 0.f; }
    if (y1 >= sh) { y1 = sh - 1; if (y0 >= sh) y0 = sh - 1; }
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = static_cast<int>(std::floor(fx));
      float wx = fx - x0;
      int x1 = x0 + 1;
      if (x0 < 0) { x0 = 0; x1 = 0; wx = 0.f; }
      if (x1 >= sw) { x1 = sw - 1; if (x0 >= sw) x0 = sw - 1; }
      for (int c = 0; c < channels; ++c) {
        const float v00 = src[(static_cast<size_t>(y0) * sw + x0) * channels + c];
        const float v01 = src[(static_cast<size_t>(y0) * sw + x1) * channels + c];
        const float v10 = src[(static_cast<size_t>(y1) * sw + x0) * channels + c];
        const float v11 = src[(static_cast<size_t>(y1) * sw + x1) * channels + c];
        const float v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                        v10 * wy * (1 - wx) + v11 * wy * wx;
        dst[(static_cast<size_t>(y) * dw + x) * channels + c] =
            static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

// nearest neighbour, floor(dst * scale) (cv2 INTER_NEAREST)
void resize_nearest(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh,
                    int dw) {
  const float sy = static_cast<float>(sh) / dh;
  const float sx = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    int ys = static_cast<int>(y * sy);
    if (ys >= sh) ys = sh - 1;
    for (int x = 0; x < dw; ++x) {
      int xs = static_cast<int>(x * sx);
      if (xs >= sw) xs = sw - 1;
      dst[static_cast<size_t>(y) * dw + x] =
          src[static_cast<size_t>(ys) * sw + xs];
    }
  }
}

// Decode `path` and resize it to (th, tw) unless th <= 0 or it has that
// size already: bilinear for 3 channels, nearest for 1.
int decode_sized(const char* path, int channels, int th, int tw,
                 std::vector<uint8_t>& out) {
  std::vector<uint8_t> raw;
  int h = 0, w = 0;
  const int rc = decode_file(path, channels, raw, &h, &w);
  if (rc) return rc;
  if (th <= 0 || (th == h && tw == w)) {
    out = std::move(raw);
    return 0;
  }
  out.resize(static_cast<size_t>(th) * tw * channels);
  if (channels == 3)
    resize_bilinear(raw.data(), h, w, out.data(), th, tw, 3);
  else
    resize_nearest(raw.data(), h, w, out.data(), th, tw);
  return 0;
}

// ---------------------------------------------------------------------------
// Prefetch pipeline: bounded ring, worker pool, in-order delivery
// ---------------------------------------------------------------------------

struct Slot {
  std::vector<uint8_t> img, lab;
  int ticket = -1;  // the position in the epoch's order this slot holds
  int record = -1;
  int status = 0;   // 0 or an error code
  bool label_failed = false;  // the status is the label's
  bool ready = false;
};

struct Pipe {
  std::vector<std::string> imgs, labs;  // labs[i] empty: no label
  int th = 0, tw = 0;
  int capacity = 0;
  std::vector<Slot> slots;
  std::vector<int> order;
  std::atomic<int> next_ticket{0};
  int consumed = 0;
  int epoch_len = 0;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  void worker() {
    while (!stop.load()) {
      const int ticket = next_ticket.fetch_add(1);
      if (ticket >= epoch_len) return;
      const int rec = order[ticket];
      Slot& s = slots[ticket % capacity];
      {
        std::unique_lock<std::mutex> lk(mu);
        // wait until the consumer has drained the slot's previous lap
        cv_free.wait(lk, [&] {
          return stop.load() || ticket - consumed < capacity;
        });
        if (stop.load()) return;
      }
      std::vector<uint8_t> img, lab;
      int status = decode_sized(imgs[rec].c_str(), 3, th, tw, img);
      bool label_failed = false;
      if (status == 0 && !labs[rec].empty()) {
        status = decode_sized(labs[rec].c_str(), 1, th, tw, lab);
        label_failed = status != 0;
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        s.img = std::move(img);
        s.lab = std::move(lab);
        s.ticket = ticket;
        s.record = rec;
        s.status = status;
        s.label_failed = label_failed;
        s.ready = true;
      }
      cv_ready.notify_all();
    }
  }

  void start(int n_threads) {
    for (int i = 0; i < n_threads; ++i)
      workers.emplace_back([this] { worker(); });
  }

  void join() {
    stop.store(true);
    cv_free.notify_all();
    cv_ready.notify_all();
    for (auto& t : workers)
      if (t.joinable()) t.join();
    workers.clear();
    stop.store(false);
  }
};

}  // namespace

extern "C" {

// (H, W) of a PNG or JPEG from the head of the file (the whole file only
// for a JPEG whose frame header lies past the first 64 KiB): 0, or an error
// code.
int esn_image_info(const char* path, int* h, int* w) {
  std::vector<uint8_t> data;
  bool whole = false;
  if (!read_file(path, data, 1 << 16, &whole)) return kErrOpen;
  if (is_png(data)) {
    PngHeader hd;
    const int rc = png_header(data, &hd);
    if (rc) return rc;
    *h = hd.h;
    *w = hd.w;
    return 0;
  }
  if (!is_jpeg(data)) return kErrFormat;
  if (jpeg_dims(data, h, w) == 0) return 0;
  if (whole || !read_file(path, data)) return kErrCorrupt;
  return jpeg_dims(data, h, w);
}

// Decode into out: (th, tw, channels) when th > 0, else the native size
// from esn_image_info. channels 3: BGR; 1: grey. Returns bytes written or
// an error code.
int esn_decode(const char* path, int channels, uint8_t* out, int th, int tw) {
  if (channels != 1 && channels != 3) return kErrSize;
  std::vector<uint8_t> img;
  const int rc = decode_sized(path, channels, th, tw, img);
  if (rc) return rc;
  if (th > 0 && img.size() != static_cast<size_t>(th) * tw * channels)
    return kErrSize;
  std::memcpy(out, img.data(), img.size());
  return static_cast<int>(img.size());
}

void esn_resize_bilinear(const uint8_t* src, int sh, int sw, uint8_t* dst,
                         int dh, int dw, int channels) {
  resize_bilinear(src, sh, sw, dst, dh, dw, channels);
}

void esn_resize_nearest(const uint8_t* src, int sh, int sw, uint8_t* dst,
                        int dh, int dw) {
  resize_nearest(src, sh, sw, dst, dh, dw);
}

void* esn_pipe_create(int n, const char** imgs, const char** labs, int th,
                      int tw, int capacity) {
  if (n <= 0 || th <= 0 || tw <= 0) return nullptr;
  Pipe* p = new Pipe();
  for (int i = 0; i < n; ++i) {
    p->imgs.emplace_back(imgs[i]);
    p->labs.emplace_back(labs && labs[i] ? labs[i] : "");
  }
  p->th = th;
  p->tw = tw;
  p->capacity = capacity > 0 ? capacity : 8;
  p->slots.resize(p->capacity);
  return p;
}

// Begin an epoch with the given visiting order (len entries in [0, n)).
void esn_pipe_epoch(void* pipe, const int* order, int len, int n_threads) {
  Pipe* p = static_cast<Pipe*>(pipe);
  p->join();
  p->order.assign(order, order + len);
  p->epoch_len = len;
  p->next_ticket.store(0);
  p->consumed = 0;
  for (auto& s : p->slots) s = Slot{};
  p->start(n_threads > 0 ? n_threads : 4);
}

// Blocking: fills img (th * tw * 3) and lab (th * tw, when the record has
// one). Returns the record index, or -1 at the end of the epoch; *status is
// 0 or the error code of the record's image (*label_failed 0) or label (1).
int esn_pipe_next(void* pipe, uint8_t* img, uint8_t* lab, int* has_label,
                  int* status, int* label_failed) {
  Pipe* p = static_cast<Pipe*>(pipe);
  if (p->consumed >= p->epoch_len) return -1;
  const int ticket = p->consumed;
  Slot& s = p->slots[ticket % p->capacity];
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_ready.wait(lk, [&] { return s.ready && s.ticket == ticket; });
  const int rec = s.record;
  *status = s.status;
  *label_failed = s.label_failed ? 1 : 0;
  *has_label = s.lab.empty() ? 0 : 1;
  if (s.status == 0) {
    std::memcpy(img, s.img.data(), s.img.size());
    if (!s.lab.empty()) std::memcpy(lab, s.lab.data(), s.lab.size());
  }
  s.ready = false;
  p->consumed = ticket + 1;
  lk.unlock();
  p->cv_free.notify_all();
  return rec;
}

void esn_pipe_destroy(void* pipe) {
  Pipe* p = static_cast<Pipe*>(pipe);
  p->join();
  delete p;
}

}  // extern "C"
