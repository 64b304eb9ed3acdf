// Native image loader of the spef_tpu_torch data pipeline: a copy of
// spef_tpu/native/impreproc.cpp, the JAX package's host loader, kept here so
// that the port builds its own library and reads no file of the JAX package.
// The code below the includes is that file's, unchanged, so both packages
// decode and resize a frame to the same bytes.
//
// Multi-threaded JPEG (libjpeg) and PNG (libpng) decode, then a bilinear
// resize that samples the four nearest pixels of each output pixel (it does
// not filter when it downscales, as PIL does), straight into a caller-owned
// NHWC uint8 batch, behind a plain C ABI for ctypes.
//
// Build: spef_tpu_torch/native/__init__.py::build (g++ -O3 -shared -fPIC
// -ffp-contract=off, links libjpeg, libpng and pthread).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <atomic>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <csetjmp>

namespace {

struct Image {
  std::vector<uint8_t> data;  // RGB8, row-major
  int width = 0;
  int height = 0;
};

// ---------------------------------------------------------------------------
// JPEG decode (libjpeg) with error-resilient longjmp handler.
// ---------------------------------------------------------------------------

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

bool decode_jpeg(const uint8_t* buf, size_t len, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->width = cinfo.output_width;
  out->height = cinfo.output_height;
  out->data.resize(size_t(out->width) * out->height * 3);
  const size_t stride = size_t(out->width) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data.data() + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ---------------------------------------------------------------------------
// PNG decode (libpng) from memory, forced to RGB8.
// ---------------------------------------------------------------------------

struct PngReadState {
  const uint8_t* data;
  size_t len;
  size_t pos;
};

void png_read_fn(png_structp png, png_bytep out, png_size_t n) {
  auto* st = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (st->pos + n > st->len) {
    png_error(png, "png: read past end");
  }
  memcpy(out, st->data + st->pos, n);
  st->pos += n;
}

bool decode_png(const uint8_t* buf, size_t len, Image* out) {
  if (len < 8 || png_sig_cmp(buf, 0, 8) != 0) return false;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  PngReadState st{buf, len, 0};
  png_set_read_fn(png, &st, png_read_fn);
  png_read_info(png, info);

  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type, nullptr, nullptr, nullptr);

  // Normalize to 8-bit RGB.
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color_type == PNG_COLOR_TYPE_GRAY || color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (color_type & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  png_read_update_info(png, info);

  out->width = int(w);
  out->height = int(h);
  out->data.resize(size_t(w) * h * 3);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y) rows[y] = out->data.data() + size_t(y) * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

// ---------------------------------------------------------------------------
// Bilinear resize RGB8 -> RGB8 (half-pixel centres; four-tap sampling).
// ---------------------------------------------------------------------------

void resize_bilinear(const Image& src, uint8_t* dst, int out_h, int out_w) {
  const float sx = float(src.width) / out_w;
  const float sy = float(src.height) / out_h;
  const uint8_t* sp = src.data.data();
  const int sw = src.width, sh = src.height;
  for (int oy = 0; oy < out_h; ++oy) {
    float fy = (oy + 0.5f) * sy - 0.5f;
    int y0 = int(fy < 0 ? 0 : fy);
    if (y0 > sh - 1) y0 = sh - 1;
    int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    float dy = fy - y0;
    if (dy < 0) dy = 0;
    for (int ox = 0; ox < out_w; ++ox) {
      float fx = (ox + 0.5f) * sx - 0.5f;
      int x0 = int(fx < 0 ? 0 : fx);
      if (x0 > sw - 1) x0 = sw - 1;
      int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
      float dx = fx - x0;
      if (dx < 0) dx = 0;
      const uint8_t* p00 = sp + (size_t(y0) * sw + x0) * 3;
      const uint8_t* p01 = sp + (size_t(y0) * sw + x1) * 3;
      const uint8_t* p10 = sp + (size_t(y1) * sw + x0) * 3;
      const uint8_t* p11 = sp + (size_t(y1) * sw + x1) * 3;
      uint8_t* o = dst + (size_t(oy) * out_w + ox) * 3;
      for (int c = 0; c < 3; ++c) {
        float top = p00[c] * (1 - dx) + p01[c] * dx;
        float bot = p10[c] * (1 - dx) + p11[c] * dx;
        float v = top * (1 - dy) + bot * dy;
        o[c] = uint8_t(v + 0.5f);
      }
    }
  }
}

bool load_and_resize(const char* path, uint8_t* dst, int out_h, int out_w) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long len = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(len);
  size_t rd = fread(buf.data(), 1, len, f);
  fclose(f);
  if (long(rd) != len) return false;

  Image img;
  bool ok = false;
  if (len > 3 && buf[0] == 0xFF && buf[1] == 0xD8) {
    ok = decode_jpeg(buf.data(), len, &img);
  } else {
    ok = decode_png(buf.data(), len, &img);
    if (!ok) ok = decode_jpeg(buf.data(), len, &img);
  }
  if (!ok || img.width <= 0 || img.height <= 0) return false;
  resize_bilinear(img, dst, out_h, out_w);
  return true;
}

}  // namespace

extern "C" {

// Decode+resize a batch of images into a preallocated NHWC uint8 buffer.
// paths: array of n C strings; out: n*out_h*out_w*3 bytes.
// Returns the number of successfully loaded images (failed slots zeroed).
int spef_load_batch(const char** paths, int n, uint8_t* out, int out_h, int out_w,
                    int n_threads) {
  const size_t frame = size_t(out_h) * out_w * 3;
  std::atomic<int> next(0);
  std::atomic<int> ok_count(0);
  if (n_threads <= 0) n_threads = int(std::thread::hardware_concurrency());
  if (n_threads > n) n_threads = n;
  if (n_threads < 1) n_threads = 1;

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      uint8_t* dst = out + frame * i;
      if (load_and_resize(paths[i], dst, out_h, out_w)) {
        ok_count.fetch_add(1);
      } else {
        memset(dst, 0, frame);
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return ok_count.load();
}

// Single-image variant (returns 1 on success).
int spef_load_image(const char* path, uint8_t* out, int out_h, int out_w) {
  return load_and_resize(path, out, out_h, out_w) ? 1 : 0;
}

}  // extern "C"
