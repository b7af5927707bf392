// The port's JPEG decoder (jpeg.cc), called by esn_native.cc.
#pragma once

#include <cstddef>
#include <cstdint>
#include <vector>

namespace esn_jpeg {

// Error codes beside esn_native.cc's, mapped to exceptions by
// data/native.py.
enum : int {
  kErrJpegCorrupt = -7,      // malformed markers or entropy-coded data
  kErrJpegArithmetic = -10,  // arithmetic coding (SOF9-11)
  kErrJpegLossless = -11,    // lossless or hierarchical (SOF3, 5-7, 13-15)
  kErrJpegPrecision = -12,   // samples of other than 8 bits (12-bit data)
  kErrJpegColour = -13,      // not 1 or 3 components, or not YCbCr (CMYK,
                             // YCCK, RGB)
  kErrJpegSampling = -14,    // sampling factors other than luma 1-2 x 1-2
                             // with 1x1 chroma
};

// Decode the JPEG data[0, n) to out: (h, w, 3) BGR when out_ch is 3,
// (h, w) grey when 1, as libjpeg's default decompression gives them
// (islow IDCT, fancy upsampling, its fixed-point YCbCr -> RGB; grey is the
// Y component). Returns 0 or an error code.
int decode(const uint8_t* data, size_t n, int out_ch, std::vector<uint8_t>& out,
           int* h, int* w);

}  // namespace esn_jpeg
