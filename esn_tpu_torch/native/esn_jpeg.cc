// esn_jpeg: the JPEG decoder that esn_native.cc calls through the function
// pointer registered with esn_set_jpeg_decoder. Linked against libjpeg
// (libjpeg-turbo's BGR output where it has one); built by
// esn_tpu_torch/data/native.py the first time a JPEG is decoded, and only
// where jpeglib.h is installed.

#include <csetjmp>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <utility>

#include <jpeglib.h>

namespace {

struct ErrorJump {
  jpeg_error_mgr mgr;
  std::jmp_buf jump;
};

void on_error(j_common_ptr cinfo) {
  std::longjmp(reinterpret_cast<ErrorJump*>(cinfo->err)->jump, 1);
}

void on_message(j_common_ptr) {}  // warnings stay quiet, as cv2's

}  // namespace

extern "C" {

// Decode data[0, n) into out, (h, w, channels): channels 3 is BGR, 1 grey.
// Returns 0, or -1 when libjpeg fails or the size is not (h, w).
int esn_jpeg_decode(const uint8_t* data, size_t n, int channels, int h, int w,
                    uint8_t* out) {
  jpeg_decompress_struct cinfo;
  ErrorJump err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = on_error;
  err.mgr.output_message = on_message;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(n));
  jpeg_read_header(&cinfo, TRUE);
#ifdef JCS_EXTENSIONS
  cinfo.out_color_space = channels == 3 ? JCS_EXT_BGR : JCS_GRAYSCALE;
  const bool swap = false;
#else
  cinfo.out_color_space = channels == 3 ? JCS_RGB : JCS_GRAYSCALE;
  const bool swap = channels == 3;
#endif
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_height) != h ||
      static_cast<int>(cinfo.output_width) != w ||
      cinfo.output_components != channels) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  const size_t stride = static_cast<size_t>(w) * channels;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  if (swap) {
    for (size_t i = 0; i + 2 < stride * h; i += 3) std::swap(out[i], out[i + 2]);
  }
  return 0;
}

}  // extern "C"
