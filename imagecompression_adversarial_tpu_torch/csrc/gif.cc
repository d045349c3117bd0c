// GIF first frame (host C++): the palette indices Pillow's GIF decoder
// (GifDecode.c) writes for the first image of a GIF file.
//
// Role: io/gif.py walks the blocks (the screen, the global and local
// colour tables, the graphic control extension, the image descriptor)
// and joins the image's data sub-blocks; kernels/_build.py compiles this
// file with g++ into _build/libicat_gif-<hash>.so on first use, and
// io/gif.py loads it with ctypes and looks the indices up in the palette.
// Done here:
//
//   * GIF's LZW: codes LSB first, from the minimum code size + 1 bits up
//     to 12, the code width growing as the table's next free entry
//     reaches 2^width - 1 past the last; clear and end codes; the first
//     code after a clear a literal; a code equal to the next free entry
//     the last string and its first byte; no entry added once the table
//     holds 4096 (a deferred clear);
//   * the frame's pixels written row by row into its rectangle of the
//     canvas, which io/gif.py fills first (the transparency index, or 0),
//     in the four passes of an interlaced frame (rows 0, 8, ...; 4, 12,
//     ...; 2, 6, ...; 1, 3, ...);
//   * the decode stops at the frame's last pixel; the data running out, or
//     an end code, before it raises.
//
// Exposed as a C ABI for ctypes.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

void set_error(char* err, int len, const char* msg) {
  if (err && len > 0) std::snprintf(err, static_cast<size_t>(len), "%s", msg);
}

}  // namespace

extern "C" {

// Decode the LZW data `data[0:len]` (the sub-blocks joined) of a frame of
// `fw` x `fh` pixels at (x0, y0) into the `width` x `height` canvas
// `out` (row-major indices), with minimum code size `bits` (1 to 11) and
// `interlace` 0 or 1.  Returns 0, or 1 with a message in `err`.
int icat_gif_decode(const uint8_t* data, int64_t len, int bits, int interlace, int x0, int y0,
                    int fw, int fh, int width, int height, uint8_t* out, char* err,
                    int err_len) {
  if (bits < 1 || bits > 11 || fw <= 0 || fh <= 0 || x0 < 0 || y0 < 0 ||
      static_cast<int64_t>(x0) + fw > width || static_cast<int64_t>(y0) + fh > height) {
    set_error(err, err_len, "GIF frame out of range");
    return 1;
  }
  constexpr int kTable = 4096, kMaxBits = 12;
  const int clear = 1 << bits, end = clear + 1;
  std::vector<uint8_t> value(kTable), stack(kTable);
  std::vector<int> link(kTable);
  int next = clear + 2, size = bits + 1, mask = (1 << size) - 1;
  int last = -1, first = 0;  // the previous code and its string's first byte
  uint32_t acc = 0;
  int nacc = 0;
  int64_t pos = 0;
  // where the next pixel goes: row y of the frame, column x; the pass's step
  int x = 0, y = 0, step = interlace ? 8 : 1, pass = interlace ? 1 : 0;
  auto put = [&](uint8_t v) -> bool {  // true once the frame is whole
    out[static_cast<int64_t>(y0 + y) * width + x0 + x] = v;
    if (++x < fw) return false;
    x = 0;
    y += step;
    while (y >= fh) {
      switch (pass) {
        case 1: y = 4; pass = 2; break;
        case 2: step = 4; y = 2; pass = 3; break;
        case 3: step = 2; y = 1; pass = 0; break;
        default: return true;
      }
    }
    return false;
  };
  for (;;) {
    while (nacc < size) {
      if (pos >= len) {
        set_error(err, err_len, "GIF image data ends before the frame's last pixel");
        return 1;
      }
      acc |= static_cast<uint32_t>(data[pos++]) << nacc;
      nacc += 8;
    }
    int c = static_cast<int>(acc & static_cast<uint32_t>(mask));
    acc >>= size;
    nacc -= size;
    if (c == clear) {
      next = clear + 2;
      size = bits + 1;
      mask = (1 << size) - 1;
      last = -1;
      continue;
    }
    if (c == end) {
      set_error(err, err_len, "GIF end code before the frame's last pixel");
      return 1;
    }
    int n = 0;  // the string's bytes, last first, in stack[kTable - n:]
    if (last < 0) {  // the first code after a clear: a literal
      if (c > clear) {
        set_error(err, err_len, "GIF LZW: a code past the table after a clear code");
        return 1;
      }
      stack[kTable - ++n] = static_cast<uint8_t>(c);
      first = c;
      last = c;
    } else {
      const int code = c;
      if (c > next) {
        set_error(err, err_len, "GIF LZW: a code past the table");
        return 1;
      }
      if (c == next) {  // the last string and its first byte
        stack[kTable - ++n] = static_cast<uint8_t>(first);
        c = last;
      }
      while (c >= clear) {
        if (n >= kTable || c >= kTable) {
          set_error(err, err_len, "GIF LZW: a string longer than the table");
          return 1;
        }
        stack[kTable - ++n] = value[c];
        c = link[c];
      }
      if (n >= kTable) {
        set_error(err, err_len, "GIF LZW: a string longer than the table");
        return 1;
      }
      stack[kTable - ++n] = static_cast<uint8_t>(c);
      first = c;
      if (next < kTable) {
        value[next] = static_cast<uint8_t>(c);
        link[next] = last;
        if (next == mask && size < kMaxBits) {
          ++size;
          mask = (1 << size) - 1;
        }
        ++next;
      }
      last = code;
    }
    for (int k = kTable - n; k < kTable; ++k)
      if (put(stack[k])) return 0;
  }
}

}  // extern "C"
