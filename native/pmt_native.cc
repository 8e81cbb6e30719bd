// pmt_native — host-side native layer for points_matching.
//
// The reference's native layer is OpenCV's highgui C++ (image decode behind
// cv::imread, "Points Matching/main.cpp:14-15"); accelerators have no imread, so the
// framework's data path is: native C++ decode on the host (this file) →
// pinned numpy buffers → jax.device_put (SURVEY.md §1.2 "Native layer").
//
// Formats: JPEG (libjpeg), PNG (libpng), BMP (8/24/32-bit uncompressed —
// the reference's img1.bmp/img2.bmp family), PGM/PPM (P5/P6).  Output is
// grayscale float32 in [0, 255] with Rec.601 luma (OpenCV's convention), so
// detector thresholds transfer between stacks.
//
// C API (ctypes-friendly), all functions return 0 on success:
//   pmt_image_info(path, &w, &h)            — header-only probe
//   pmt_decode_gray_f32(path, out, w, h)    — decode into caller buffer
//   pmt_decode_batch_gray_f32(paths, n, out, w, h, threads)
//                                            — thread-pool batch decode
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <csetjmp>

namespace {

constexpr float kR = 0.299f, kG = 0.587f, kB = 0.114f;

struct Image {
  int w = 0, h = 0, channels = 0;
  std::vector<uint8_t> data;  // interleaved, row-major
};

// ---------------------------------------------------------------------------
// JPEG
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jmp;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jmp, 1);
}

bool decode_jpeg(FILE* f, Image* img, bool header_only) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  img->w = static_cast<int>(cinfo.image_width);
  img->h = static_cast<int>(cinfo.image_height);
  if (header_only) {
    jpeg_destroy_decompress(&cinfo);
    return true;
  }
  jpeg_start_decompress(&cinfo);
  img->channels = cinfo.output_components;
  img->data.resize(static_cast<size_t>(img->w) * img->h * img->channels);
  const size_t stride = static_cast<size_t>(img->w) * img->channels;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = img->data.data() + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ---------------------------------------------------------------------------
// PNG
// ---------------------------------------------------------------------------

bool decode_png(FILE* f, Image* img, bool header_only) {
  uint8_t sig[8];
  if (fread(sig, 1, 8, f) != 8 || png_sig_cmp(sig, 0, 8)) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
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
  png_init_io(png, f);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);
  img->w = static_cast<int>(png_get_image_width(png, info));
  img->h = static_cast<int>(png_get_image_height(png, info));
  if (header_only) {
    png_destroy_read_struct(&png, &info, nullptr);
    return true;
  }
  // normalize to 8-bit RGB or gray
  png_byte color = png_get_color_type(png, info);
  png_byte depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);
  img->channels = static_cast<int>(png_get_channels(png, info));
  const size_t stride = png_get_rowbytes(png, info);
  img->data.resize(stride * img->h);
  std::vector<png_bytep> rows(img->h);
  for (int y = 0; y < img->h; ++y) rows[y] = img->data.data() + y * stride;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

// ---------------------------------------------------------------------------
// BMP (uncompressed 8/24/32-bit — covers the reference's inputs)
// ---------------------------------------------------------------------------

uint32_t rd_u32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}
int32_t rd_i32(const uint8_t* p) { return static_cast<int32_t>(rd_u32(p)); }
uint16_t rd_u16(const uint8_t* p) { return p[0] | (p[1] << 8); }

bool decode_bmp(FILE* f, Image* img, bool header_only) {
  uint8_t hdr[54];
  if (fread(hdr, 1, 54, f) != 54) return false;
  if (hdr[0] != 'B' || hdr[1] != 'M') return false;
  const uint32_t data_off = rd_u32(hdr + 10);
  const int32_t w = rd_i32(hdr + 18);
  const int32_t h_raw = rd_i32(hdr + 22);
  const uint16_t bpp = rd_u16(hdr + 28);
  const uint32_t compression = rd_u32(hdr + 30);
  if (compression != 0 || (bpp != 8 && bpp != 24 && bpp != 32)) return false;
  const bool flipped = h_raw > 0;  // bottom-up storage
  const int h = flipped ? h_raw : -h_raw;
  img->w = w;
  img->h = h;
  if (header_only) return true;

  // 8-bit BMPs carry a palette right after the header block
  std::vector<uint8_t> palette;
  if (bpp == 8) {
    const uint32_t info_size = rd_u32(hdr + 14);
    uint32_t ncolors = rd_u32(hdr + 46);
    if (ncolors == 0) ncolors = 256;
    palette.resize(4 * ncolors);
    if (fseek(f, 14 + info_size, SEEK_SET) != 0) return false;
    if (fread(palette.data(), 1, palette.size(), f) != palette.size()) return false;
  }
  if (fseek(f, static_cast<long>(data_off), SEEK_SET) != 0) return false;

  const int src_ch = bpp / 8;
  const size_t row_bytes = (static_cast<size_t>(w) * src_ch + 3) & ~size_t{3};
  std::vector<uint8_t> row(row_bytes);
  img->channels = 3;
  img->data.resize(static_cast<size_t>(w) * h * 3);
  for (int y = 0; y < h; ++y) {
    if (fread(row.data(), 1, row_bytes, f) != row_bytes) return false;
    const int dy = flipped ? (h - 1 - y) : y;
    uint8_t* dst = img->data.data() + static_cast<size_t>(dy) * w * 3;
    for (int x = 0; x < w; ++x) {
      uint8_t r, g, b;
      if (bpp == 8) {
        const uint8_t* entry = palette.data() + 4 * row[x];
        b = entry[0]; g = entry[1]; r = entry[2];
      } else {  // BGR(A)
        b = row[x * src_ch + 0];
        g = row[x * src_ch + 1];
        r = row[x * src_ch + 2];
      }
      dst[x * 3 + 0] = r;
      dst[x * 3 + 1] = g;
      dst[x * 3 + 2] = b;
    }
  }
  return true;
}

// ---------------------------------------------------------------------------
// PGM/PPM (P5/P6 binary)
// ---------------------------------------------------------------------------

bool pnm_token(FILE* f, char* buf, size_t cap) {
  int c;
  do {
    c = fgetc(f);
    if (c == '#') {
      while (c != '\n' && c != EOF) c = fgetc(f);
    }
  } while (c == ' ' || c == '\t' || c == '\n' || c == '\r');
  size_t i = 0;
  while (c != EOF && c != ' ' && c != '\t' && c != '\n' && c != '\r') {
    if (i + 1 < cap) buf[i++] = static_cast<char>(c);
    c = fgetc(f);
  }
  buf[i] = 0;
  return i > 0;
}

bool decode_pnm(FILE* f, Image* img, bool header_only) {
  char tok[64];
  if (!pnm_token(f, tok, sizeof tok)) return false;
  int ch;
  if (strcmp(tok, "P5") == 0) ch = 1;
  else if (strcmp(tok, "P6") == 0) ch = 3;
  else return false;
  if (!pnm_token(f, tok, sizeof tok)) return false;
  img->w = atoi(tok);
  if (!pnm_token(f, tok, sizeof tok)) return false;
  img->h = atoi(tok);
  if (!pnm_token(f, tok, sizeof tok)) return false;  // maxval
  if (header_only) return true;
  img->channels = ch;
  const size_t n = static_cast<size_t>(img->w) * img->h * ch;
  img->data.resize(n);
  return fread(img->data.data(), 1, n, f) == n;
}

// ---------------------------------------------------------------------------
// Dispatch + gray conversion
// ---------------------------------------------------------------------------

bool decode_any(const char* path, Image* img, bool header_only) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t magic[8] = {0};
  const size_t got = fread(magic, 1, 8, f);
  rewind(f);
  bool ok = false;
  if (got >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
    ok = decode_jpeg(f, img, header_only);
  } else if (got >= 8 && png_sig_cmp(magic, 0, 8) == 0) {
    ok = decode_png(f, img, header_only);
  } else if (got >= 2 && magic[0] == 'B' && magic[1] == 'M') {
    ok = decode_bmp(f, img, header_only);
  } else if (got >= 2 && magic[0] == 'P' && (magic[1] == '5' || magic[1] == '6')) {
    ok = decode_pnm(f, img, header_only);
  }
  fclose(f);
  return ok;
}

void to_gray_f32(const Image& img, float* out) {
  const size_t n = static_cast<size_t>(img.w) * img.h;
  if (img.channels == 1) {
    for (size_t i = 0; i < n; ++i) out[i] = static_cast<float>(img.data[i]);
  } else {
    const int ch = img.channels;
    for (size_t i = 0; i < n; ++i) {
      const uint8_t* px = img.data.data() + i * ch;
      out[i] = kR * px[0] + kG * px[1] + kB * px[2];
    }
  }
}

}  // namespace

extern "C" {

int pmt_image_info(const char* path, int* w, int* h) {
  Image img;
  if (!decode_any(path, &img, /*header_only=*/true)) return -1;
  *w = img.w;
  *h = img.h;
  return 0;
}

int pmt_decode_gray_f32(const char* path, float* out, int w, int h) {
  Image img;
  if (!decode_any(path, &img, /*header_only=*/false)) return -1;
  if (img.w != w || img.h != h) return -2;
  to_gray_f32(img, out);
  return 0;
}

// Thread-pool batch decode into one [n, h, w] float32 buffer.  Returns the
// number of failures (0 = all decoded); failed slots are zero-filled.
int pmt_decode_batch_gray_f32(const char** paths, int n, float* out, int w,
                              int h, int num_threads) {
  if (num_threads <= 0) num_threads = static_cast<int>(
      std::max(1u, std::thread::hardware_concurrency()));
  std::atomic<int> next{0}, failures{0};
  const size_t stride = static_cast<size_t>(w) * h;
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      Image img;
      float* dst = out + static_cast<size_t>(i) * stride;
      if (decode_any(paths[i], &img, false) && img.w == w && img.h == h) {
        to_gray_f32(img, dst);
      } else {
        memset(dst, 0, stride * sizeof(float));
        failures.fetch_add(1);
      }
    }
  };
  // The calling thread is always worker 0: when the host process has
  // busy-spinning runtime threads (JAX/XLA), freshly spawned workers can be
  // starved of CPU while the caller blocks in join — running inline keeps
  // at least one core productive, and nt==1 degenerates to a plain loop.
  std::vector<std::thread> pool;
  const int nt = std::min(num_threads, n);
  pool.reserve(nt - 1);
  for (int t = 0; t < nt - 1; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return failures.load();
}

}  // extern "C"
