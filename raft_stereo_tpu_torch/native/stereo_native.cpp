// Native host-side decoders for the stereo data pipeline: the PyTorch
// port's own copy of the JAX package's decoders, byte for byte the same
// functions below this comment.
//
// The card runs the model; the host decodes the images and ground truth
// that feed the loader (data/frame_utils.py does the same in Python via
// PIL/cv2/re).  These decoders release the GIL for the whole decode
// (ctypes does that automatically), so the threaded StereoLoader scales
// past the interpreter.
//
// Exposed as a plain C ABI for ctypes, built at first use with g++ into
// the package's _build/ directory (native/__init__.py).
// Protocol: all decoders parse from a caller-provided byte buffer; callers
// first ask for dimensions, allocate a NumPy array, then decode into it.
// Every entry point returns 0 on success, negative on failure.
//
// Formats:
//   PFM  — 'PF' (3ch) / 'Pf' (1ch) float maps, bottom-up row order, scale
//          sign = endianness (decoded to native-endian, top-down).
//   PNG  — 8-bit gray/RGB/RGBA -> (H,W,3) uint8 (gray replicated,
//          alpha dropped), and 16-bit gray -> (H,W) uint16 (KITTI
//          disparity PNGs, decoded big-endian as libpng delivers).

#include <png.h>

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <vector>

extern "C" {

// ------------------------------------------------------------------ PFM
// Header: magic line, "W H" line, scale line; '#' comments are not part of
// the spec and are rejected (matching the Python reader's strictness).

static int pfm_parse_header(const uint8_t* buf, int64_t len,
                            int64_t* w, int64_t* h, int64_t* channels,
                            double* scale, int64_t* data_offset) {
  // Tokenize the first three whitespace-separated header fields after the
  // magic; PFM allows any whitespace between them.
  int64_t pos = 0;
  if (len < 2) return -1;
  if (buf[0] == 'P' && buf[1] == 'F') *channels = 3;
  else if (buf[0] == 'P' && buf[1] == 'f') *channels = 1;
  else return -2;
  pos = 2;

  long long fields[2] = {0, 0};
  double sc = 0.0;
  for (int field = 0; field < 3; ++field) {
    while (pos < len && (buf[pos] == ' ' || buf[pos] == '\t' ||
                         buf[pos] == '\r' || buf[pos] == '\n'))
      ++pos;
    if (pos >= len) return -3;
    char tok[64];
    int ti = 0;
    while (pos < len && ti < 63 && buf[pos] > ' ') tok[ti++] = buf[pos++];
    tok[ti] = '\0';
    char* end = nullptr;
    if (field < 2) {
      fields[field] = strtoll(tok, &end, 10);
      if (end == tok || *end != '\0' || fields[field] <= 0) return -4;
    } else {
      sc = strtod(tok, &end);
      if (end == tok || *end != '\0' || sc == 0.0) return -5;
    }
  }
  // The header ends at the first '\n' after the scale token (an optional
  // '\r' before it is tolerated) — matching the Python reader's readline()
  // semantics; anything else would silently shift the float data.
  if (pos < len && buf[pos] == '\r') ++pos;
  if (pos >= len || buf[pos] != '\n') return -8;
  ++pos;
  *w = fields[0];
  *h = fields[1];
  *scale = sc;
  *data_offset = pos;
  return 0;
}

int pfm_dims(const uint8_t* buf, int64_t len,
             int64_t* w, int64_t* h, int64_t* channels) {
  double scale;
  int64_t off;
  return pfm_parse_header(buf, len, w, h, channels, &scale, &off);
}

// out: float32 buffer of h*w*channels, filled top-down, native endian.
int pfm_decode(const uint8_t* buf, int64_t len, float* out) {
  int64_t w, h, c, off;
  double scale;
  int rc = pfm_parse_header(buf, len, &w, &h, &c, &scale, &off);
  if (rc) return rc;
  const int64_t count = w * h * c;
  if (off + count * 4 > len) return -6;

  const uint8_t* data = buf + off;
  const bool file_le = scale < 0.0;
  uint16_t probe = 1;
  const bool host_le = *reinterpret_cast<uint8_t*>(&probe) == 1;
  const bool swap = file_le != host_le;

  // PFM rows are stored bottom-up; emit top-down.
  const int64_t row_elems = w * c;
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* src = data + (h - 1 - y) * row_elems * 4;
    float* dst = out + y * row_elems;
    if (!swap) {
      memcpy(dst, src, row_elems * 4);
    } else {
      for (int64_t i = 0; i < row_elems; ++i) {
        uint8_t b[4] = {src[i * 4 + 3], src[i * 4 + 2],
                        src[i * 4 + 1], src[i * 4 + 0]};
        memcpy(dst + i, b, 4);
      }
    }
  }
  return 0;
}

// ------------------------------------------------------------------ PNG

struct PngReadState {
  const uint8_t* buf;
  int64_t len;
  int64_t pos;
};

static void png_mem_read(png_structp png, png_bytep out, png_size_t n) {
  PngReadState* s = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (s->pos + static_cast<int64_t>(n) > s->len) {
    png_error(png, "read past end of buffer");
    return;
  }
  memcpy(out, s->buf + s->pos, n);
  s->pos += n;
}

static int png_open(const uint8_t* buf, int64_t len, png_structp* png_out,
                    png_infop* info_out, PngReadState* state) {
  if (len < 8 || png_sig_cmp(buf, 0, 8)) return -2;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING,
                                           nullptr, nullptr, nullptr);
  if (!png) return -3;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return -3;
  }
  state->buf = buf;
  state->len = len;
  state->pos = 0;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -4;
  }
  png_set_read_fn(png, state, png_mem_read);
  png_read_info(png, info);
  *png_out = png;
  *info_out = info;
  return 0;
}

int png_dims(const uint8_t* buf, int64_t len,
             int64_t* w, int64_t* h, int64_t* bit_depth, int64_t* channels) {
  png_structp png;
  png_infop info;
  PngReadState st;
  int rc = png_open(buf, len, &png, &info, &st);
  if (rc) return rc;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -4;
  }
  *w = png_get_image_width(png, info);
  *h = png_get_image_height(png, info);
  *bit_depth = png_get_bit_depth(png, info);
  *channels = png_get_channels(png, info);
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

// 8-bit path: any color type -> (H, W, 3) uint8, gray replicated, alpha
// dropped, palette expanded (mirrors data/frame_utils.py read_image).
int png_decode_rgb8(const uint8_t* buf, int64_t len, uint8_t* out) {
  png_structp png;
  png_infop info;
  PngReadState st;
  int rc = png_open(buf, len, &png, &info, &st);
  if (rc) return rc;
  // Constructed before setjmp so a longjmp unwind path still runs its
  // destructor on the normal function return below.
  std::vector<png_bytep> rows;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -4;
  }
  png_set_palette_to_rgb(png);
  png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_bit_depth(png, info) == 16) png_set_strip_16(png);
  png_set_strip_alpha(png);
  png_set_gray_to_rgb(png);
  png_read_update_info(png, info);
  const png_size_t rowbytes = png_get_rowbytes(png, info);
  const int64_t h = png_get_image_height(png, info);
  const int64_t w = png_get_image_width(png, info);
  if (rowbytes != static_cast<png_size_t>(w * 3)) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -5;
  }
  rows.resize(h);
  for (int64_t y = 0; y < h; ++y) rows[y] = out + y * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

// 16-bit grayscale path -> (H, W) uint16 native-endian (KITTI disparity
// PNGs; value/256.0 = disparity px — reference core/utils/frame_utils.py:124).
int png_decode_gray16(const uint8_t* buf, int64_t len, uint16_t* out) {
  png_structp png;
  png_infop info;
  PngReadState st;
  int rc = png_open(buf, len, &png, &info, &st);
  if (rc) return rc;
  std::vector<png_bytep> rows;  // before setjmp — see png_decode_rgb8
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -4;
  }
  if (png_get_bit_depth(png, info) != 16 ||
      png_get_channels(png, info) != 1) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -7;
  }
  uint16_t probe = 1;
  if (*reinterpret_cast<uint8_t*>(&probe) == 1) png_set_swap(png);
  png_read_update_info(png, info);
  const int64_t h = png_get_image_height(png, info);
  const int64_t w = png_get_image_width(png, info);
  rows.resize(h);
  for (int64_t y = 0; y < h; ++y)
    rows[y] = reinterpret_cast<png_bytep>(out + y * w);
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

}  // extern "C"
