// PNG pixels (host C++): what Pillow's Image.open(path).convert("RGB")
// gives for every PNG kind, from the image data once inflated.
//
// Role: io/png.py walks the chunks (CRCs, IHDR, PLTE), inflates the IDAT
// stream with CPython's zlib and checks its length; kernels/_build.py
// compiles this file with g++ into _build/libicat_png-<hash>.so on first
// use, and io/png.py loads it with ctypes.  io/png.py::decode is its plain
// numpy version and is held to it bit for bit.  Done here:
//
//   * the five scanline filters (None, Sub, Up, Average, Paeth) over bytes,
//     each predicting from the byte one pixel (at least one byte) to the
//     left, the byte above and the one above-left;
//   * Adam7 deinterlacing: seven passes, each a small image of its own
//     with its own filtered rows, scattered to their pixels; a pass of no
//     columns or no rows has no bytes;
//   * bit depths 1, 2, 4 (samples packed from the high bit), 8 and 16 (big
//     endian);
//   * colour types 0 (gray), 2 (RGB), 3 (palette), 4 (gray+alpha) and 6
//     (RGBA), converted to RGB as Pillow converts the mode it opens each
//     as: gray 1-bit to 0 or 255, 2-bit times 85, 4-bit times 17, 16-bit
//     (mode I;16) clipped to 255; RGB, RGBA and gray+alpha at 16 bits their
//     high bytes; alpha dropped; a palette index looked up in PLTE, black
//     past its end.
//
// Exposed as a C ABI for ctypes.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <utility>
#include <vector>

namespace {

// Adam7's passes: first column, first row, column step, row step
constexpr int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                              {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
constexpr int kWhole[1][4] = {{0, 0, 1, 1}};

int channels_of(int colour) {
  switch (colour) {
    case 0: return 1;
    case 2: return 3;
    case 3: return 1;
    case 4: return 2;
    case 6: return 4;
    default: return 0;
  }
}

void set_error(char* err, int len, const char* msg) {
  if (err && len > 0) std::snprintf(err, static_cast<size_t>(len), "%s", msg);
}

inline int paeth(int a, int b, int c) {
  const int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Undo filter `kind` of `row` (stride bytes) in place, given the row above
// (zeros above the first) and `bpp` bytes a pixel (at least 1).
bool unfilter(int kind, uint8_t* row, const uint8_t* above, int64_t stride, int bpp) {
  switch (kind) {
    case 0: return true;
    case 1:
      for (int64_t i = bpp; i < stride; ++i) row[i] = static_cast<uint8_t>(row[i] + row[i - bpp]);
      return true;
    case 2:
      for (int64_t i = 0; i < stride; ++i) row[i] = static_cast<uint8_t>(row[i] + above[i]);
      return true;
    case 3:
      for (int64_t i = 0; i < stride; ++i) {
        const int a = i >= bpp ? row[i - bpp] : 0;
        row[i] = static_cast<uint8_t>(row[i] + ((a + above[i]) >> 1));
      }
      return true;
    case 4:
      for (int64_t i = 0; i < stride; ++i) {
        const int a = i >= bpp ? row[i - bpp] : 0, c = i >= bpp ? above[i - bpp] : 0;
        row[i] = static_cast<uint8_t>(row[i] + paeth(a, above[i], c));
      }
      return true;
    default: return false;
  }
}

// Sample `j` of pixel `x` in an unfiltered row.
inline int sample(const uint8_t* row, int64_t x, int j, int ch, int depth) {
  const int64_t i = x * ch + j;
  if (depth == 8) return row[i];
  if (depth == 16) return (row[2 * i] << 8) | row[2 * i + 1];
  const int64_t bit = i * depth;
  return (row[bit >> 3] >> (8 - depth - (bit & 7))) & ((1 << depth) - 1);
}

}  // namespace

extern "C" {

// The RGB pixels (height x width x 3 into `out`) of a PNG's inflated image
// data `raw[0:len]` (each row of each pass a filter byte, then the row):
// `depth` bits a sample, colour type `colour`, `interlace` 0 or 1 (Adam7),
// `palette` the PLTE chunk's body (palette_len bytes; colour type 3).
// Returns 0, or 1 with a message in `err`.
int icat_png_decode(const uint8_t* raw, int64_t len, int width, int height, int depth,
                    int colour, int interlace, const uint8_t* palette, int palette_len,
                    uint8_t* out, char* err, int err_len) {
  const int ch = channels_of(colour);
  if (ch == 0 || width <= 0 || height <= 0 || interlace < 0 || interlace > 1 ||
      !(depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16) ||
      (depth < 8 && ch != 1)) {
    set_error(err, err_len, "PNG header: bad size, depth, colour type or interlace method");
    return 1;
  }
  const int64_t bits = static_cast<int64_t>(ch) * depth;
  const int bpp = bits >= 8 ? static_cast<int>(bits / 8) : 1;
  const int npass = interlace ? 7 : 1;
  const int(*passes)[4] = interlace ? kAdam7 : kWhole;
  int64_t need = 0;
  for (int p = 0; p < npass; ++p) {
    const int64_t pw = width > passes[p][0] ? (width - passes[p][0] + passes[p][2] - 1) / passes[p][2] : 0;
    const int64_t ph = height > passes[p][1] ? (height - passes[p][1] + passes[p][3] - 1) / passes[p][3] : 0;
    if (pw && ph) need += ph * (1 + (pw * bits + 7) / 8);
  }
  if (need != len) {
    set_error(err, err_len, "PNG image data is not the size its header gives");
    return 1;
  }
  const int entries = palette_len / 3 < 256 ? palette_len / 3 : 256;
  const uint8_t* at = raw;
  std::vector<uint8_t> above, row;
  for (int p = 0; p < npass; ++p) {
    const int x0 = passes[p][0], y0 = passes[p][1], dx = passes[p][2], dy = passes[p][3];
    const int64_t pw = width > x0 ? (width - x0 + dx - 1) / dx : 0;
    const int64_t ph = height > y0 ? (height - y0 + dy - 1) / dy : 0;
    if (!pw || !ph) continue;
    const int64_t stride = (pw * bits + 7) / 8;
    above.assign(static_cast<size_t>(stride), 0);
    row.resize(static_cast<size_t>(stride));
    for (int64_t y = 0; y < ph; ++y) {
      const int kind = *at++;
      std::memcpy(row.data(), at, static_cast<size_t>(stride));
      at += stride;
      if (!unfilter(kind, row.data(), above.data(), stride, bpp)) {
        char msg[64];
        std::snprintf(msg, sizeof(msg), "PNG filter type %d is not one of the five", kind);
        set_error(err, err_len, msg);
        return 1;
      }
      uint8_t* dst_row = out + ((y0 + y * dy) * static_cast<int64_t>(width)) * 3;
      for (int64_t x = 0; x < pw; ++x) {
        uint8_t* px = dst_row + (x0 + x * dx) * 3;
        const int v = sample(row.data(), x, 0, ch, depth);
        if (colour == 2 || colour == 6) {
          for (int j = 0; j < 3; ++j) {
            const int s = sample(row.data(), x, j, ch, depth);
            px[j] = static_cast<uint8_t>(depth == 16 ? s >> 8 : s);
          }
        } else if (colour == 3) {
          for (int j = 0; j < 3; ++j) px[j] = v < entries ? palette[3 * v + j] : 0;
        } else {
          int g = v;  // gray, or the gray of gray+alpha
          if (colour == 4) g = depth == 16 ? v >> 8 : v;
          else if (depth == 1) g = v ? 255 : 0;
          else if (depth == 2) g = v * 85;
          else if (depth == 4) g = v * 17;
          else if (depth == 16) g = v > 255 ? 255 : v;
          px[0] = px[1] = px[2] = static_cast<uint8_t>(g);
        }
      }
      std::swap(above, row);
    }
  }
  return 0;
}

}  // extern "C"
