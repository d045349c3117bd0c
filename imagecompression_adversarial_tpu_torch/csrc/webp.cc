// WebP pixels (host C++): what Pillow's Image.open(path).convert("RGB")
// gives for a still WebP, from its VP8 (lossy) or VP8L (lossless)
// bitstream.
//
// Role: io/webp.py walks the RIFF container (VP8X, ALPH, ICCP, EXIF, XMP,
// the image chunk) and hands this file the image chunk's payload;
// kernels/_build.py compiles it with g++ into _build/libicat_webp-<hash>.so
// on first use, and io/webp.py loads it with ctypes.  Pillow's RGB does not
// depend on the alpha channel (libwebp decodes unpremultiplied RGBA), so
// ALPH is never decoded here.  Every read is bounds-checked: a broken
// bitstream returns 1 with a message, and nothing reads or writes out of
// bounds.
//
// VP8L (lossless), exact by its definition:
//   * the header (signature 0x2f, 14-bit sizes, alpha bit, version 0);
//   * prefix codes: simple (one or two symbols) and normal, through the
//     code-length code in its fixed order, with the repeat codes 16-18;
//   * meta prefix codes (the entropy image) and the color cache (hash
//     0x1e35a7bd * argb >> (32 - bits));
//   * LZ77 copies with lengths and distances by prefix and extra bits and
//     the 120 short distances of the plane map;
//   * the four transforms, undone in the reverse of their stream order:
//     predictor (modes 0-13; 14 and 15 predict black, as libwebp), cross
//     color, subtract green, and color indexing with pixel bundling at 1,
//     2 and 4 bits a pixel.
//
// VP8 (lossy) key frames, per RFC 6386, to Y, U and V planes:
//   * the frame tag, start code and 14-bit sizes;
//   * the boolean decoder (libwebp's, 56 bits a load);
//   * segmentation (quantizer and filter level, absolute or relative to
//     the frame's, and the segment map), the quantizer indices and deltas,
//     the coefficient probability updates, the skip flag;
//   * 1, 2, 4 or 8 token partitions, macroblock rows taking them in turn;
//   * intra modes: 16x16, the ten 4x4 modes with their above/left
//     contexts, 8x8 chroma; frame edges read 127 above and 129 left;
//   * the inverse WHT and DCT; reconstruction from unfiltered neighbours;
//   * the normal and the simple loop filters over the whole frame in
//     macroblock order (edges 2*level+ilevel+4, the level moved by the
//     intra-frame and 4x4-mode deltas, the interior limit ilevel cut by the
//     sharpness, inner edges skipped for a coefficient-free macroblock not
//     in 4x4 mode, hev thresholds 0/1/2 at levels 15/40);
//   * cropping to the frame's width and height.
//
// Then libwebp's colour output: the "fancy" upsampler (each pixel's chroma
// (9 near + 3 + 3 + far + 8) >> 4 over the four chroma samples around it,
// the planes edge-replicated) and its fixed-point YUV to RGB (14-bit
// coefficients, >> 6 and clamped).
//
// The transforms here are libwebp's C ones.  Its SSE2 ones, which Pillow's
// build runs on x86, compute in 16 bits and give the same pixels wherever
// the coefficients lie in VP8's range; on a corrupt token stream that
// leaves it they wrap, and the two may then differ.
//
// Exposed as a C ABI for ctypes.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

// what makes a bitstream broken
struct Broken {
  std::string message;
};

[[noreturn]] void broken(const std::string& message) { throw Broken{message}; }

// ---------------------------------------------------------------------------
// VP8L

constexpr int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

// the 120 short distances: (dy << 4) | (8 - dx)
constexpr uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a, 0x38, 0x05, 0x37,
    0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b,
    0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56,
    0x5a, 0x23, 0x2d, 0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e, 0x78, 0x01, 0x77,
    0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b,
    0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e,
    0x30, 0x73, 0x7d, 0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70,
};

// LSB-first bits; past the end it reads zeros and counts them, and the
// stream is broken once more bits were taken than it holds
struct LsbReader {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  uint64_t acc = 0;
  int nbits = 0;
  uint64_t taken = 0;

  LsbReader(const uint8_t* d, size_t n) : data(d), size(n) {}

  void fill() {
    while (nbits <= 56) {
      const uint64_t byte = pos < size ? data[pos] : 0;
      ++pos;
      acc |= byte << nbits;
      nbits += 8;
    }
  }
  uint32_t peek(int n) {
    if (nbits < n) fill();
    return static_cast<uint32_t>(acc & ((uint64_t{1} << n) - 1));
  }
  void skip(int n) {
    acc >>= n;
    nbits -= n;
    taken += static_cast<uint64_t>(n);
  }
  uint32_t read(int n) {
    const uint32_t v = peek(n);
    skip(n);
    return v;
  }
  bool past_end() const { return taken > 8 * static_cast<uint64_t>(size); }
};

// a canonical prefix code as an 8-bit root table with second-level tables
struct Prefix {
  struct Entry {
    uint16_t value;  // the symbol, or the offset of a second-level table
    uint8_t bits;    // its length (root: <= 8), or 8 + the second level's bits
  };
  std::vector<Entry> table;

  // false where the lengths make no complete code (nor a single symbol)
  bool build(const int* lengths, int n) {
    int count[16] = {0};
    for (int s = 0; s < n; ++s) {
      if (lengths[s] < 0 || lengths[s] > 15) return false;
      ++count[lengths[s]];
    }
    if (count[0] == n) return false;
    table.assign(256, Entry{0, 0});
    if (n - count[0] == 1) {  // one symbol: a code of no bits
      for (int s = 0; s < n; ++s)
        if (lengths[s]) table.assign(256, Entry{static_cast<uint16_t>(s), 0});
      return true;
    }
    int left = 1;
    for (int len = 1; len <= 15; ++len) {
      left = (left << 1) - count[len];
      if (left < 0) return false;
    }
    if (left != 0) return false;
    // canonical codes, as DEFLATE's: by length, then by symbol
    int next[16] = {0};
    for (int len = 2; len <= 15; ++len) next[len] = (next[len - 1] + count[len - 1]) << 1;
    std::vector<int> reversed(static_cast<size_t>(n), 0);
    int sub_bits[256] = {0};
    for (int s = 0; s < n; ++s) {
      const int len = lengths[s];
      if (!len) continue;
      const int code = next[len]++;
      int r = 0;
      for (int i = 0; i < len; ++i) r |= ((code >> i) & 1) << (len - 1 - i);
      reversed[static_cast<size_t>(s)] = r;
      if (len > 8) sub_bits[r & 255] = std::max(sub_bits[r & 255], len - 8);
    }
    for (int p = 0; p < 256; ++p) {
      if (!sub_bits[p]) continue;
      table[static_cast<size_t>(p)] =
          Entry{static_cast<uint16_t>(table.size()), static_cast<uint8_t>(8 + sub_bits[p])};
      table.resize(table.size() + (size_t{1} << sub_bits[p]), Entry{0, 0});
    }
    for (int s = 0; s < n; ++s) {
      const int len = lengths[s];
      if (!len) continue;
      const int r = reversed[static_cast<size_t>(s)];
      if (len <= 8) {
        for (int j = r; j < 256; j += 1 << len)
          table[static_cast<size_t>(j)] = Entry{static_cast<uint16_t>(s), static_cast<uint8_t>(len)};
      } else {
        const Entry root = table[static_cast<size_t>(r & 255)];
        const int span = 1 << (root.bits - 8);
        for (int j = r >> 8; j < span; j += 1 << (len - 8))
          table[root.value + static_cast<size_t>(j)] =
              Entry{static_cast<uint16_t>(s), static_cast<uint8_t>(len - 8)};
      }
    }
    return true;
  }

  int read(LsbReader& br) const {
    const uint32_t bits = br.peek(15);
    const Entry e = table[bits & 255];
    if (e.bits <= 8) {
      br.skip(e.bits);
      return e.value;
    }
    const Entry s = table[e.value + ((bits >> 8) & ((1u << (e.bits - 8)) - 1))];
    br.skip(8 + s.bits);
    return s.value;
  }
};

// one group of the five codes: green (with lengths and cache), red, blue,
// alpha, distance
struct Group {
  Prefix codes[5];
};

int sub_sample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

int read_copy(int symbol, LsbReader& br) {
  if (symbol < 4) return symbol + 1;
  const int extra = (symbol - 2) >> 1;
  const int offset = (2 + (symbol & 1)) << extra;
  return offset + static_cast<int>(br.read(extra)) + 1;
}

int plane_distance(int xsize, int code) {
  if (code > 120) return code - 120;
  const int plane = kCodeToPlane[code - 1];
  const int dist = (plane >> 4) * xsize + (8 - (plane & 0xf));
  return dist >= 1 ? dist : 1;
}

void read_code(LsbReader& br, int alphabet, Prefix& out) {
  std::vector<int> lengths(static_cast<size_t>(std::max(alphabet, 256)), 0);
  if (br.read(1)) {  // simple: one or two symbols
    const int two = static_cast<int>(br.read(1));
    const int first_bits = br.read(1) ? 8 : 1;
    lengths[br.read(first_bits)] = 1;
    if (two) lengths[br.read(8)] = 1;
  } else {
    int code_lengths[19] = {0};
    const int num = static_cast<int>(br.read(4)) + 4;
    for (int i = 0; i < num; ++i) code_lengths[kCodeLengthOrder[i]] = static_cast<int>(br.read(3));
    Prefix lens;
    if (!lens.build(code_lengths, 19)) broken("VP8L code-length code is not a prefix code");
    int max_symbol = alphabet;
    if (br.read(1)) {
      const int nbits = 2 + 2 * static_cast<int>(br.read(3));
      max_symbol = 2 + static_cast<int>(br.read(nbits));
      if (max_symbol > alphabet) broken("VP8L code lengths run past the alphabet");
    }
    int symbol = 0, prev = 8;
    while (symbol < alphabet) {
      if (max_symbol-- == 0) break;
      const int len = lens.read(br);
      if (len < 16) {
        lengths[static_cast<size_t>(symbol++)] = len;
        if (len) prev = len;
      } else {
        static constexpr int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
        int repeat = static_cast<int>(br.read(kExtra[len - 16])) + kOffset[len - 16];
        if (symbol + repeat > alphabet) broken("VP8L code lengths run past the alphabet");
        const int value = len == 16 ? prev : 0;
        while (repeat-- > 0) lengths[static_cast<size_t>(symbol++)] = value;
      }
    }
  }
  if (br.past_end()) broken("VP8L bitstream is truncated");
  if (!out.build(lengths.data(), alphabet)) broken("VP8L prefix code is not complete");
}

std::vector<uint32_t> decode_stream(LsbReader& br, int xsize, int ysize, bool top);

// the pixels of one entropy-coded image of xsize x ysize
void decode_pixels(LsbReader& br, uint32_t* out, int xsize, int ysize, int cache_bits,
                   const std::vector<Group>& groups, const std::vector<uint32_t>& meta,
                   int meta_bits, int meta_xsize) {
  std::vector<uint32_t> cache(cache_bits ? size_t{1} << cache_bits : 0, 0);
  const int cache_shift = 32 - cache_bits;
  const size_t total = static_cast<size_t>(xsize) * static_cast<size_t>(ysize);
  size_t i = 0;
  int col = 0, row = 0;
  auto remember = [&](uint32_t argb) {
    if (cache_bits) cache[(0x1e35a7bdu * argb) >> cache_shift] = argb;
  };
  while (i < total) {
    const Group& g =
        meta.empty() ? groups[0]
                     : groups[meta[static_cast<size_t>(row >> meta_bits) * static_cast<size_t>(meta_xsize) +
                                   static_cast<size_t>(col >> meta_bits)]];
    const int code = g.codes[0].read(br);
    if (code < 256) {
      const uint32_t red = static_cast<uint32_t>(g.codes[1].read(br));
      const uint32_t blue = static_cast<uint32_t>(g.codes[2].read(br));
      const uint32_t alpha = static_cast<uint32_t>(g.codes[3].read(br));
      if (br.past_end()) break;
      const uint32_t argb = (alpha << 24) | (red << 16) | (static_cast<uint32_t>(code) << 8) | blue;
      out[i++] = argb;
      remember(argb);
      if (++col == xsize) {
        col = 0;
        ++row;
      }
    } else if (code < 280) {
      const size_t length = static_cast<size_t>(read_copy(code - 256, br));
      const int dist_symbol = g.codes[4].read(br);
      const size_t dist = static_cast<size_t>(plane_distance(xsize, read_copy(dist_symbol, br)));
      if (br.past_end()) break;
      if (i < dist || total - i < length) broken("VP8L copy reaches outside the image");
      for (size_t k = 0; k < length; ++k, ++i) {
        out[i] = out[i - dist];
        remember(out[i]);
      }
      col += static_cast<int>(length % static_cast<size_t>(xsize));
      row += static_cast<int>(length / static_cast<size_t>(xsize));
      if (col >= xsize) {
        col -= xsize;
        ++row;
      }
    } else {  // a color cache key (the green alphabet ends with the cache)
      const uint32_t argb = cache[static_cast<size_t>(code - 280)];
      out[i++] = argb;
      remember(argb);
      if (++col == xsize) {
        col = 0;
        ++row;
      }
    }
  }
  if (br.past_end()) broken("VP8L bitstream is truncated");
}

struct Transform {
  int type;
  int bits;
  int xsize;  // the width the transform gives back
  std::vector<uint32_t> data;
};

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}
inline int clip255(int a) { return a < 0 ? 0 : a > 255 ? 255 : a; }
inline uint32_t clamped_add_subtract_full(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int v = static_cast<int>((a >> s) & 0xff) + static_cast<int>((b >> s) & 0xff) -
                  static_cast<int>((c >> s) & 0xff);
    out |= static_cast<uint32_t>(clip255(v)) << s;
  }
  return out;
}
inline uint32_t clamped_add_subtract_half(uint32_t a, uint32_t b) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int x = static_cast<int>((a >> s) & 0xff), y = static_cast<int>((b >> s) & 0xff);
    out |= static_cast<uint32_t>(clip255(x + (x - y) / 2)) << s;
  }
  return out;
}
inline uint32_t select(uint32_t top, uint32_t left, uint32_t top_left) {
  int pa_minus_pb = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = static_cast<int>((top >> s) & 0xff), b = static_cast<int>((left >> s) & 0xff),
              c = static_cast<int>((top_left >> s) & 0xff);
    pa_minus_pb += std::abs(b - c) - std::abs(a - c);
  }
  return pa_minus_pb <= 0 ? top : left;
}

// the prediction of mode m for the pixel at p, its row above at p - width
inline uint32_t predict(int m, const uint32_t* p, int width) {
  const uint32_t left = p[-1];
  const uint32_t* up = p - width;
  switch (m) {
    case 1: return left;
    case 2: return up[0];
    case 3: return up[1];
    case 4: return up[-1];
    case 5: return average2(average2(left, up[1]), up[0]);
    case 6: return average2(left, up[-1]);
    case 7: return average2(left, up[0]);
    case 8: return average2(up[-1], up[0]);
    case 9: return average2(up[0], up[1]);
    case 10: return average2(average2(left, up[-1]), average2(up[0], up[1]));
    case 11: return select(up[0], left, up[-1]);
    case 12: return clamped_add_subtract_full(left, up[0], up[-1]);
    case 13: return clamped_add_subtract_half(average2(left, up[0]), up[-1]);
    default: return 0xff000000u;  // 0, and 14 and 15 as libwebp
  }
}

void undo_predictor(const Transform& t, std::vector<uint32_t>& px, int height) {
  const int width = t.xsize;
  uint32_t* p = px.data();
  p[0] = add_pixels(p[0], 0xff000000u);
  for (int x = 1; x < width; ++x) p[x] = add_pixels(p[x], p[x - 1]);
  const int tiles = sub_sample(width, t.bits);
  for (int y = 1; y < height; ++y) {
    uint32_t* row = p + static_cast<size_t>(y) * static_cast<size_t>(width);
    const uint32_t* modes = t.data.data() + static_cast<size_t>(y >> t.bits) * static_cast<size_t>(tiles);
    row[0] = add_pixels(row[0], row[-width]);
    for (int x = 1; x < width; ++x)
      row[x] = add_pixels(row[x], predict((modes[x >> t.bits] >> 8) & 0xf, row + x, width));
  }
}

inline int color_delta(int8_t pred, int8_t color) { return (static_cast<int>(pred) * color) >> 5; }

void undo_cross_color(const Transform& t, std::vector<uint32_t>& px, int height) {
  const int width = t.xsize;
  const int tiles = sub_sample(width, t.bits);
  for (int y = 0; y < height; ++y) {
    uint32_t* row = px.data() + static_cast<size_t>(y) * static_cast<size_t>(width);
    const uint32_t* codes = t.data.data() + static_cast<size_t>(y >> t.bits) * static_cast<size_t>(tiles);
    for (int x = 0; x < width; ++x) {
      const uint32_t code = codes[x >> t.bits];
      const int8_t g2r = static_cast<int8_t>(code & 0xff), g2b = static_cast<int8_t>((code >> 8) & 0xff),
                   r2b = static_cast<int8_t>((code >> 16) & 0xff);
      const uint32_t argb = row[x];
      const int8_t green = static_cast<int8_t>((argb >> 8) & 0xff);
      int red = static_cast<int>((argb >> 16) & 0xff), blue = static_cast<int>(argb & 0xff);
      red = (red + color_delta(g2r, green)) & 0xff;
      blue = (blue + color_delta(g2b, green) + color_delta(r2b, static_cast<int8_t>(red))) & 0xff;
      row[x] = (argb & 0xff00ff00u) | (static_cast<uint32_t>(red) << 16) | static_cast<uint32_t>(blue);
    }
  }
}

void undo_subtract_green(std::vector<uint32_t>& px) {
  for (uint32_t& argb : px) {
    const uint32_t g = (argb >> 8) & 0xff;
    const uint32_t rb = ((argb & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu;
    argb = (argb & 0xff00ff00u) | rb;
  }
}

std::vector<uint32_t> undo_color_indexing(const Transform& t, const std::vector<uint32_t>& px, int height) {
  const int width = t.xsize;
  const int packed = sub_sample(width, t.bits);
  const int per_pixel = 8 >> t.bits;
  const uint32_t mask = (1u << per_pixel) - 1;
  std::vector<uint32_t> out(static_cast<size_t>(width) * static_cast<size_t>(height));
  for (int y = 0; y < height; ++y) {
    const uint32_t* src = px.data() + static_cast<size_t>(y) * static_cast<size_t>(packed);
    uint32_t* dst = out.data() + static_cast<size_t>(y) * static_cast<size_t>(width);
    uint32_t bundle = 0;
    for (int x = 0; x < width; ++x) {
      if ((x & ((1 << t.bits) - 1)) == 0) bundle = (src[x >> t.bits] >> 8) & 0xff;
      dst[x] = t.data[bundle & mask];
      bundle >>= per_pixel;
    }
  }
  return out;
}

// an image stream: transforms (top level only), color cache, codes, pixels
std::vector<uint32_t> decode_stream(LsbReader& br, int xsize, int ysize, bool top) {
  std::vector<Transform> transforms;
  int width = xsize;
  if (top) {
    unsigned seen = 0;
    while (br.read(1)) {
      Transform t;
      t.type = static_cast<int>(br.read(2));
      if (seen & (1u << t.type)) broken("VP8L transform repeated");
      seen |= 1u << t.type;
      t.xsize = width;
      t.bits = 0;
      if (t.type == 0 || t.type == 1) {
        t.bits = static_cast<int>(br.read(3)) + 2;
        t.data = decode_stream(br, sub_sample(width, t.bits), sub_sample(ysize, t.bits), false);
      } else if (t.type == 3) {
        const int colors = static_cast<int>(br.read(8)) + 1;
        t.bits = colors > 16 ? 0 : colors > 4 ? 1 : colors > 2 ? 2 : 3;
        std::vector<uint32_t> palette = decode_stream(br, colors, 1, false);
        t.data.assign(size_t{1} << (8 >> t.bits), 0);
        t.data[0] = palette[0];
        for (size_t c = 1; c < palette.size(); ++c) t.data[c] = add_pixels(palette[c], t.data[c - 1]);
        width = sub_sample(width, t.bits);
      }
      if (br.past_end()) broken("VP8L bitstream is truncated");
      transforms.push_back(std::move(t));
    }
  }
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = static_cast<int>(br.read(4));
    if (cache_bits < 1 || cache_bits > 11) broken("VP8L color cache size is not valid");
  }
  std::vector<uint32_t> meta;
  int meta_bits = 0, meta_xsize = 0, num_groups = 1;
  if (top && br.read(1)) {
    meta_bits = static_cast<int>(br.read(3)) + 2;
    meta_xsize = sub_sample(width, meta_bits);
    meta = decode_stream(br, meta_xsize, sub_sample(ysize, meta_bits), false);
    for (uint32_t& m : meta) {
      m = (m >> 8) & 0xffff;
      num_groups = std::max(num_groups, static_cast<int>(m) + 1);
    }
  }
  if (br.past_end()) broken("VP8L bitstream is truncated");
  std::vector<Group> groups(static_cast<size_t>(num_groups));
  const int green = 256 + 24 + (cache_bits ? 1 << cache_bits : 0);
  const int alphabets[5] = {green, 256, 256, 256, 40};
  for (Group& g : groups)
    for (int j = 0; j < 5; ++j) read_code(br, alphabets[j], g.codes[j]);
  std::vector<uint32_t> px(static_cast<size_t>(width) * static_cast<size_t>(ysize));
  decode_pixels(br, px.data(), width, ysize, cache_bits, groups, meta, meta_bits, meta_xsize);
  for (size_t n = transforms.size(); n-- > 0;) {
    const Transform& t = transforms[n];
    switch (t.type) {
      case 0: undo_predictor(t, px, ysize); break;
      case 1: undo_cross_color(t, px, ysize); break;
      case 2: undo_subtract_green(px); break;
      default: px = undo_color_indexing(t, px, ysize); break;
    }
  }
  return px;
}

void decode_vp8l(const uint8_t* data, size_t size, int width, int height, uint8_t* rgb) {
  LsbReader br(data, size);
  if (size < 5 || br.read(8) != 0x2f) broken("VP8L signature is missing");
  const int w = static_cast<int>(br.read(14)) + 1, h = static_cast<int>(br.read(14)) + 1;
  br.read(1);  // alpha_is_used: the mode, read by io/webp.py
  if (br.read(3) != 0) broken("VP8L version is not 0");
  if (w != width || h != height) broken("VP8L size disagrees with the container");
  const std::vector<uint32_t> px = decode_stream(br, w, h, true);
  for (size_t i = 0; i < px.size(); ++i) {
    rgb[3 * i] = static_cast<uint8_t>(px[i] >> 16);
    rgb[3 * i + 1] = static_cast<uint8_t>(px[i] >> 8);
    rgb[3 * i + 2] = static_cast<uint8_t>(px[i]);
  }
}

// ---------------------------------------------------------------------------
// VP8

// RFC 6386's tables, as libwebp holds them: the quantizer steps by index
// (section 14.1)
constexpr uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
constexpr uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};
// the coefficient probabilities' update probabilities (section 13.4) and
// defaults (section 13.5), by type, band, context and node
constexpr uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    {{{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}, {{176, 246, 255,
    255, 255, 255, 255, 255, 255, 255, 255}, {223, 241, 252, 255, 255, 255, 255, 255, 255, 255,
    255}, {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}}, {{255, 244, 252, 255, 255, 255,
    255, 255, 255, 255, 255}, {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {253, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255}}, {{255, 246, 254, 255, 255, 255, 255, 255, 255,
    255, 255}, {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 254, 255, 255,
    255, 255, 255, 255, 255, 255}}, {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {251,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255}}, {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {251, 254, 254, 255, 255,
    255, 255, 255, 255, 255, 255}, {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}}, {{255,
    254, 253, 255, 254, 255, 255, 255, 255, 255, 255}, {250, 255, 254, 255, 254, 255, 255, 255, 255,
    255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}, {{255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}}, {{{217, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255}, {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255}, {234, 250, 241, 250,
    253, 255, 253, 254, 255, 255, 255}}, {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {238, 253, 254, 254, 255, 255, 255,
    255, 255, 255, 255}}, {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {249, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255}}, {{255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {247, 254, 255, 255, 255, 255,
    255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}, {{255, 253,
    254, 255, 255, 255, 255, 255, 255, 255, 255}, {252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}, {{255, 254, 254, 255, 255, 255,
    255, 255, 255, 255, 255}, {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255}}, {{255, 254, 253, 255, 255, 255, 255, 255, 255,
    255, 255}, {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255}}, {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255}}}, {{{186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255}, {234, 251, 244, 254,
    255, 255, 255, 255, 255, 255, 255}, {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}},
    {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {236, 253, 254, 255, 255, 255, 255,
    255, 255, 255, 255}, {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}}, {{255, 254, 254,
    255, 255, 255, 255, 255, 255, 255, 255}, {254, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}, {{255, 254, 255, 255, 255, 255,
    255, 255, 255, 255, 255}, {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255}}, {{255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255}}, {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255}}, {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}, {{255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}}, {{{248, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255}, {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255},
    {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}}, {{255, 253, 253, 255, 255, 255, 255,
    255, 255, 255, 255}, {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {252, 254, 251,
    254, 254, 255, 255, 255, 255, 255, 255}}, {{255, 254, 252, 255, 255, 255, 255, 255, 255, 255,
    255}, {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {253, 255, 254, 254, 255, 255,
    255, 255, 255, 255, 255}}, {{255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {245, 251,
    254, 255, 255, 255, 255, 255, 255, 255, 255}, {253, 253, 254, 255, 255, 255, 255, 255, 255, 255,
    255}}, {{255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {252, 253, 254, 255, 255, 255,
    255, 255, 255, 255, 255}, {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}}, {{255, 252,
    255, 255, 255, 255, 255, 255, 255, 255, 255}, {249, 255, 254, 255, 255, 255, 255, 255, 255, 255,
    255}, {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}}, {{255, 255, 253, 255, 255, 255,
    255, 255, 255, 255, 255}, {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255}}, {{255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255}}}};
constexpr uint8_t kCoeffsProba0[4][8][3][11] = {
    {{{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}, {128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128}, {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}}, {{253, 136, 254,
    255, 228, 219, 128, 128, 128, 128, 128}, {189, 129, 242, 255, 227, 213, 255, 219, 128, 128,
    128}, {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}}, {{1, 98, 248, 255, 236, 226,
    255, 255, 128, 128, 128}, {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128}, {78, 134,
    202, 247, 198, 180, 255, 219, 128, 128, 128}}, {{1, 185, 249, 255, 243, 255, 128, 128, 128, 128,
    128}, {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128}, {77, 110, 216, 255, 236, 230,
    128, 128, 128, 128, 128}}, {{1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128}, {170, 139,
    241, 252, 236, 209, 255, 255, 128, 128, 128}, {37, 116, 196, 243, 228, 255, 255, 255, 128, 128,
    128}}, {{1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128}, {207, 160, 250, 255, 238, 128,
    128, 128, 128, 128, 128}, {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}}, {{1, 152,
    252, 255, 240, 255, 128, 128, 128, 128, 128}, {177, 135, 243, 255, 234, 225, 128, 128, 128, 128,
    128}, {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}}, {{1, 1, 255, 128, 128, 128, 128,
    128, 128, 128, 128}, {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {255, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128}}}, {{{198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62},
    {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1}, {68, 47, 146, 208, 149, 167, 221, 162,
    255, 223, 128}}, {{1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128}, {184, 141, 234, 253,
    222, 220, 255, 199, 128, 128, 128}, {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}}, {{1,
    129, 232, 253, 214, 197, 242, 196, 255, 255, 128}, {99, 121, 210, 250, 201, 198, 255, 202, 128,
    128, 128}, {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}}, {{1, 200, 246, 255, 234, 255,
    128, 128, 128, 128, 128}, {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128}, {44, 130,
    201, 253, 205, 192, 255, 255, 128, 128, 128}}, {{1, 132, 239, 251, 219, 209, 255, 165, 128, 128,
    128}, {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128}, {22, 100, 174, 245, 186, 161, 255,
    199, 128, 128, 128}}, {{1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128}, {124, 143, 241,
    255, 227, 234, 128, 128, 128, 128, 128}, {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}},
    {{1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128}, {121, 141, 235, 255, 225, 227, 255, 255,
    128, 128, 128}, {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}}, {{1, 1, 251, 255, 213,
    255, 128, 128, 128, 128, 128}, {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128}, {137, 1,
    177, 255, 224, 255, 128, 128, 128, 128, 128}}}, {{{253, 9, 248, 251, 207, 208, 255, 192, 128,
    128, 128}, {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128}, {73, 17, 171, 221, 161, 179,
    236, 167, 255, 234, 128}}, {{1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128}, {239, 90, 244,
    250, 211, 209, 255, 255, 128, 128, 128}, {155, 77, 195, 248, 188, 195, 255, 255, 128, 128,
    128}}, {{1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128}, {201, 51, 219, 255, 196, 186, 128,
    128, 128, 128, 128}, {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}}, {{1, 191, 251, 255,
    255, 128, 128, 128, 128, 128, 128}, {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128},
    {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}}, {{1, 16, 248, 255, 255, 128, 128, 128,
    128, 128, 128}, {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128}, {149, 1, 255, 128, 128,
    128, 128, 128, 128, 128, 128}}, {{1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {247,
    192, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {240, 128, 255, 128, 128, 128, 128, 128, 128,
    128, 128}}, {{1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128}, {213, 62, 250, 255, 255,
    128, 128, 128, 128, 128, 128}, {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}}, {{128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128}, {128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128}, {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}}}, {{{202, 24, 213, 235, 186,
    191, 220, 160, 240, 175, 255}, {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128}, {61, 46,
    138, 219, 151, 178, 240, 170, 255, 216, 128}}, {{1, 112, 230, 250, 199, 191, 247, 159, 255, 255,
    128}, {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128}, {39, 77, 162, 232, 172, 180, 245,
    178, 255, 255, 128}}, {{1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128}, {124, 74, 191, 243,
    183, 193, 250, 221, 255, 255, 128}, {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}}, {{1,
    182, 225, 249, 219, 240, 255, 224, 128, 128, 128}, {149, 150, 226, 252, 216, 205, 255, 171, 128,
    128, 128}, {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}}, {{1, 81, 230, 252, 204, 203,
    255, 192, 128, 128, 128}, {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128}, {20, 95, 153,
    243, 164, 173, 255, 203, 128, 128, 128}}, {{1, 222, 248, 255, 216, 213, 128, 128, 128, 128,
    128}, {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128}, {47, 116, 215, 255, 211, 212,
    255, 255, 128, 128, 128}}, {{1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128}, {141, 84,
    213, 252, 201, 202, 255, 219, 128, 128, 128}, {42, 80, 160, 240, 162, 185, 255, 205, 128, 128,
    128}}, {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {244, 1, 255, 128, 128, 128, 128,
    128, 128, 128, 128}, {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}}}};
// a key frame's 4x4 mode probabilities by the modes above and to the left
// (section 11.5), both in libwebp's mode order
constexpr uint8_t kBModesProba[10][10][9] = {
    {{231, 120, 48, 89, 115, 113, 120, 152, 112}, {152, 179, 64, 126, 170, 118, 46, 70, 95}, {175,
    69, 143, 80, 85, 82, 72, 155, 103}, {56, 58, 10, 171, 218, 189, 17, 13, 152}, {114, 26, 17, 163,
    44, 195, 21, 10, 173}, {121, 24, 80, 195, 26, 62, 44, 64, 85}, {144, 71, 10, 38, 171, 213, 144,
    34, 26}, {170, 46, 55, 19, 136, 160, 33, 206, 71}, {63, 20, 8, 114, 114, 208, 12, 9, 226}, {81,
    40, 11, 96, 182, 84, 29, 16, 36}}, {{134, 183, 89, 137, 98, 101, 106, 165, 148}, {72, 187, 100,
    130, 157, 111, 32, 75, 80}, {66, 102, 167, 99, 74, 62, 40, 234, 128}, {41, 53, 9, 178, 241, 141,
    26, 8, 107}, {74, 43, 26, 146, 73, 166, 49, 23, 157}, {65, 38, 105, 160, 51, 52, 31, 115, 128},
    {104, 79, 12, 27, 217, 255, 87, 17, 7}, {87, 68, 71, 44, 114, 51, 15, 186, 23}, {47, 41, 14,
    110, 182, 183, 21, 17, 194}, {66, 45, 25, 102, 197, 189, 23, 18, 22}}, {{88, 88, 147, 150, 42,
    46, 45, 196, 205}, {43, 97, 183, 117, 85, 38, 35, 179, 61}, {39, 53, 200, 87, 26, 21, 43, 232,
    171}, {56, 34, 51, 104, 114, 102, 29, 93, 77}, {39, 28, 85, 171, 58, 165, 90, 98, 64}, {34, 22,
    116, 206, 23, 34, 43, 166, 73}, {107, 54, 32, 26, 51, 1, 81, 43, 31}, {68, 25, 106, 22, 64, 171,
    36, 225, 114}, {34, 19, 21, 102, 132, 188, 16, 76, 124}, {62, 18, 78, 95, 85, 57, 50, 48, 51}},
    {{193, 101, 35, 159, 215, 111, 89, 46, 111}, {60, 148, 31, 172, 219, 228, 21, 18, 111}, {112,
    113, 77, 85, 179, 255, 38, 120, 114}, {40, 42, 1, 196, 245, 209, 10, 25, 109}, {88, 43, 29, 140,
    166, 213, 37, 43, 154}, {61, 63, 30, 155, 67, 45, 68, 1, 209}, {100, 80, 8, 43, 154, 1, 51, 26,
    71}, {142, 78, 78, 16, 255, 128, 34, 197, 171}, {41, 40, 5, 102, 211, 183, 4, 1, 221}, {51, 50,
    17, 168, 209, 192, 23, 25, 82}}, {{138, 31, 36, 171, 27, 166, 38, 44, 229}, {67, 87, 58, 169,
    82, 115, 26, 59, 179}, {63, 59, 90, 180, 59, 166, 93, 73, 154}, {40, 40, 21, 116, 143, 209, 34,
    39, 175}, {47, 15, 16, 183, 34, 223, 49, 45, 183}, {46, 17, 33, 183, 6, 98, 15, 32, 183}, {57,
    46, 22, 24, 128, 1, 54, 17, 37}, {65, 32, 73, 115, 28, 128, 23, 128, 205}, {40, 3, 9, 115, 51,
    192, 18, 6, 223}, {87, 37, 9, 115, 59, 77, 64, 21, 47}}, {{104, 55, 44, 218, 9, 54, 53, 130,
    226}, {64, 90, 70, 205, 40, 41, 23, 26, 57}, {54, 57, 112, 184, 5, 41, 38, 166, 213}, {30, 34,
    26, 133, 152, 116, 10, 32, 134}, {39, 19, 53, 221, 26, 114, 32, 73, 255}, {31, 9, 65, 234, 2,
    15, 1, 118, 73}, {75, 32, 12, 51, 192, 255, 160, 43, 51}, {88, 31, 35, 67, 102, 85, 55, 186,
    85}, {56, 21, 23, 111, 59, 205, 45, 37, 192}, {55, 38, 70, 124, 73, 102, 1, 34, 98}}, {{125, 98,
    42, 88, 104, 85, 117, 175, 82}, {95, 84, 53, 89, 128, 100, 113, 101, 45}, {75, 79, 123, 47, 51,
    128, 81, 171, 1}, {57, 17, 5, 71, 102, 57, 53, 41, 49}, {38, 33, 13, 121, 57, 73, 26, 1, 85},
    {41, 10, 67, 138, 77, 110, 90, 47, 114}, {115, 21, 2, 10, 102, 255, 166, 23, 6}, {101, 29, 16,
    10, 85, 128, 101, 196, 26}, {57, 18, 10, 102, 102, 213, 34, 20, 43}, {117, 20, 15, 36, 163, 128,
    68, 1, 26}}, {{102, 61, 71, 37, 34, 53, 31, 243, 192}, {69, 60, 71, 38, 73, 119, 28, 222, 37},
    {68, 45, 128, 34, 1, 47, 11, 245, 171}, {62, 17, 19, 70, 146, 85, 55, 62, 70}, {37, 43, 37, 154,
    100, 163, 85, 160, 1}, {63, 9, 92, 136, 28, 64, 32, 201, 85}, {75, 15, 9, 9, 64, 255, 184, 119,
    16}, {86, 6, 28, 5, 64, 255, 25, 248, 1}, {56, 8, 17, 132, 137, 255, 55, 116, 128}, {58, 15, 20,
    82, 135, 57, 26, 121, 40}}, {{164, 50, 31, 137, 154, 133, 25, 35, 218}, {51, 103, 44, 131, 131,
    123, 31, 6, 158}, {86, 40, 64, 135, 148, 224, 45, 183, 128}, {22, 26, 17, 131, 240, 154, 14, 1,
    209}, {45, 16, 21, 91, 64, 222, 7, 1, 197}, {56, 21, 39, 155, 60, 138, 23, 102, 213}, {83, 12,
    13, 54, 192, 255, 68, 47, 28}, {85, 26, 85, 85, 128, 128, 32, 146, 171}, {18, 11, 7, 63, 144,
    171, 4, 4, 246}, {35, 27, 10, 146, 174, 171, 12, 26, 128}}, {{190, 80, 35, 99, 180, 80, 126, 54,
    45}, {85, 126, 47, 87, 176, 51, 41, 20, 32}, {101, 75, 128, 139, 118, 146, 116, 128, 85}, {56,
    41, 15, 176, 236, 85, 37, 9, 62}, {71, 30, 17, 119, 118, 255, 17, 18, 138}, {101, 38, 60, 138,
    55, 70, 43, 26, 142}, {146, 36, 19, 30, 171, 255, 97, 27, 20}, {138, 45, 61, 62, 219, 1, 81,
    188, 64}, {32, 41, 20, 117, 151, 142, 20, 21, 163}, {112, 19, 12, 61, 195, 128, 48, 4, 24}}};

constexpr uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
// the band of each coefficient position, and one past the last
constexpr uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
constexpr uint8_t kCat3[] = {173, 148, 140, 0};
constexpr uint8_t kCat4[] = {176, 155, 140, 135, 0};
constexpr uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
constexpr uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
constexpr const uint8_t* kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};

// the 4x4 modes, in libwebp's order, and the 16x16/chroma modes that share
// their numbers
enum { B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };
enum { DC_PRED = B_DC, TM_PRED = B_TM, V_PRED = B_VE, H_PRED = B_HE };
// the 4x4 mode tree: entries > 0 index the next pair, others are -mode
constexpr int8_t kModeTree[18] = {-B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6, -B_HE, 5,
                                  -B_RD, -B_VR, -B_LD, 7, -B_VL, 8, -B_HD, -B_HU};

// RFC 6386's boolean decoder, as libwebp keeps it: `range` holds range - 1
// and `value` up to 56 bits ahead of `bits`
struct BoolReader {
  uint64_t value = 0;
  uint32_t range = 254;
  int bits = -8;
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  const uint8_t* buf_max = nullptr;
  bool eof = false;

  void init(const uint8_t* start, size_t size) {
    value = 0;
    range = 254;
    bits = -8;
    eof = false;
    buf = start;
    end = start + size;
    buf_max = size >= 8 ? start + size - 7 : start;
    load();
  }
  void load() {
    if (buf < buf_max) {
      uint64_t v = 0;
      for (int i = 0; i < 7; ++i) v = (v << 8) | buf[i];
      buf += 7;
      value = v | (value << 56);
      bits += 56;
    } else if (buf < end) {
      bits += 8;
      value = static_cast<uint64_t>(*buf++) | (value << 8);
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int get(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * static_cast<uint32_t>(prob)) >> 8;
    const uint32_t v = static_cast<uint32_t>(value >> pos);
    int bit;
    if (v > split) {
      r -= split;
      value -= static_cast<uint64_t>(split + 1) << pos;
      bit = 1;
    } else {
      r = split + 1;
      bit = 0;
    }
    const int shift = 7 ^ (31 - __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }
  int literal(int n) {
    int v = 0;
    while (n-- > 0) v |= get(0x80) << n;
    return v;
  }
  int signed_literal(int n) {
    const int v = literal(n);
    return literal(1) ? -v : v;
  }
};

constexpr int BPS = 32;  // the stride of the reconstruction buffers

inline uint8_t clip_u8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }
inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2(int a, int b) { return (a + b + 1) >> 1; }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  for (int y = 0; y < size; ++y, dst += BPS)
    for (int x = 0; x < size; ++x) dst[x] = clip_u8(top[x] + dst[-1] - top[-1]);
}

void fill(uint8_t* dst, int size, int value) {
  for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, value, static_cast<size_t>(size));
}

// a 16x16 (size 16) or 8x8 chroma (size 8) prediction; DC by what lies
// inside the frame
void predict_block(uint8_t* dst, int size, int mode, bool has_top, bool has_left) {
  const int shift = size == 16 ? 4 : 3;
  switch (mode) {
    case DC_PRED: {
      int dc = 0;
      if (has_top && has_left) {
        for (int j = 0; j < size; ++j) dc += dst[j - BPS] + dst[j * BPS - 1];
        fill(dst, size, (dc + size) >> (shift + 1));
      } else if (has_top || has_left) {
        for (int j = 0; j < size; ++j) dc += has_top ? dst[j - BPS] : dst[j * BPS - 1];
        fill(dst, size, (dc + (size >> 1)) >> shift);
      } else {
        fill(dst, size, 0x80);
      }
      break;
    }
    case TM_PRED: true_motion(dst, size); break;
    case V_PRED:
      for (int y = 0; y < size; ++y) std::memcpy(dst + y * BPS, dst - BPS, static_cast<size_t>(size));
      break;
    default:  // H_PRED
      for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, dst[y * BPS - 1], static_cast<size_t>(size));
      break;
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]
void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5],
            G = top[6], H = top[7];
  const int I = dst[-1], J = dst[BPS - 1], K = dst[2 * BPS - 1], L = dst[3 * BPS - 1];
  switch (mode) {
    case B_DC: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[i * BPS - 1];
      fill(dst, 4, dc >> 3);
      break;
    }
    case B_TM: true_motion(dst, 4); break;
    case B_VE: {
      const uint8_t v[4] = {static_cast<uint8_t>(avg3(X, A, B)), static_cast<uint8_t>(avg3(A, B, C)),
                            static_cast<uint8_t>(avg3(B, C, D)), static_cast<uint8_t>(avg3(C, D, E))};
      for (int y = 0; y < 4; ++y) std::memcpy(dst + y * BPS, v, 4);
      break;
    }
    case B_HE:
      std::memset(dst, avg3(X, I, J), 4);
      std::memset(dst + BPS, avg3(I, J, K), 4);
      std::memset(dst + 2 * BPS, avg3(J, K, L), 4);
      std::memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    case B_RD:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HD:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    default:  // B_HU
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
  }
}
#undef DST

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// the inverse DCT of `in` added to the 4x4 block at dst
void idct_add(const int16_t* in, uint8_t* dst) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {  // vertical
    const int a = in[i] + in[8 + i], b = in[i] - in[8 + i];
    const int c = mul2(in[4 + i]) - mul1(in[12 + i]), d = mul1(in[4 + i]) + mul2(in[12 + i]);
    tmp[4 * i] = a + d;
    tmp[4 * i + 1] = b + c;
    tmp[4 * i + 2] = b - c;
    tmp[4 * i + 3] = a - d;
  }
  for (int i = 0; i < 4; ++i, dst += BPS) {  // horizontal
    const int dc = tmp[i] + 4;
    const int a = dc + tmp[8 + i], b = dc - tmp[8 + i];
    const int c = mul2(tmp[4 + i]) - mul1(tmp[12 + i]), d = mul1(tmp[4 + i]) + mul2(tmp[12 + i]);
    dst[0] = clip_u8(dst[0] + ((a + d) >> 3));
    dst[1] = clip_u8(dst[1] + ((b + c) >> 3));
    dst[2] = clip_u8(dst[2] + ((b - c) >> 3));
    dst[3] = clip_u8(dst[3] + ((a - d) >> 3));
  }
}

// the inverse WHT of the 16 DCs into coefficient 0 of each Y block
void iwht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[i] - in[12 + i];
    tmp[i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i, out += 64) {
    const int dc = tmp[4 * i] + 3;
    const int a0 = dc + tmp[4 * i + 3], a1 = tmp[4 * i + 1] + tmp[4 * i + 2];
    const int a2 = tmp[4 * i + 1] - tmp[4 * i + 2], a3 = dc - tmp[4 * i + 3];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
  }
}

// loop filter, on unsigned samples (RFC 6386 section 15, libwebp's form)
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }  // [-1020, 1020]
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }      // [-112, 112]

inline void filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = clip_u8(p0 + a2);
  p[0] = clip_u8(q0 - a1);
}
inline void filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip_u8(p1 + a3);
  p[-step] = clip_u8(p0 + a2);
  p[0] = clip_u8(q0 - a1);
  p[step] = clip_u8(q1 - a3);
}
inline void filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip_u8(p2 + a3);
  p[-2 * step] = clip_u8(p1 + a2);
  p[-step] = clip_u8(p0 + a1);
  p[0] = clip_u8(q0 - a1);
  p[step] = clip_u8(q1 - a2);
  p[2 * step] = clip_u8(q2 - a3);
}
inline bool high_variance(const uint8_t* p, int step, int thresh) {
  return std::abs(p[-2 * step] - p[-step]) > thresh || std::abs(p[step] - p[0]) > thresh;
}
inline bool needs_filter(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}
// `size` positions along an edge: hstride crosses it, vstride walks it;
// macroblock edges take filter6, inner edges filter4
void filter_edge(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh, int hev,
                 bool macroblock_edge) {
  const int t = 2 * thresh + 1;
  for (; size-- > 0; p += vstride) {
    if (!needs_filter(p, hstride, t, ithresh)) continue;
    if (high_variance(p, hstride, hev)) {
      filter2(p, hstride);
    } else if (macroblock_edge) {
      filter6(p, hstride);
    } else {
      filter4(p, hstride);
    }
  }
}

// the simple filter along 16 positions of a luma edge
void simple_edge(uint8_t* p, int hstride, int vstride, int thresh) {
  const int t = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (4 * std::abs(p[-hstride] - p[0]) + std::abs(p[-2 * hstride] - p[hstride]) <= t)
      filter2(p, hstride);
}

struct FilterInfo {
  int limit = 0;  // 2 * level + ilevel, 0: no filtering
  int ilevel = 0;
  int hev = 0;
  bool inner = false;
};

struct Vp8 {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  bool use_segment = false, update_map = false, absolute_delta = true;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  int segment_proba[3] = {255, 255, 255};
  bool simple = false;  // the simple loop filter, on luma alone
  int level = 0;
  int dq[4][3][2];  // per segment: y1, y2, uv; dc then ac
  uint8_t proba[4][8][3][11];
  bool use_skip = false;
  int skip_proba = 0;
  FilterInfo strengths[4][2];
  BoolReader br;                   // the first partition
  std::vector<BoolReader> tokens;  // the token partitions, one a macroblock row in turn
};

int get_large_value(BoolReader& br, const uint8_t* p) {
  if (!br.get(p[3])) {
    if (!br.get(p[4])) return 2;
    return 3 + br.get(p[5]);
  }
  if (!br.get(p[6])) {
    if (!br.get(p[7])) return 5 + br.get(159);
    int v = 7 + 2 * br.get(165);
    return v + br.get(145);
  }
  const int bit1 = br.get(p[8]);
  const int bit0 = br.get(p[9 + bit1]);
  const int cat = 2 * bit1 + bit0;
  int v = 0;
  for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.get(*tab);
  return v + 3 + (8 << cat);
}

// the tokens of one 4x4 block from position n; returns the position after
// its last token (libwebp's GetCoeffs)
int get_coeffs(BoolReader& br, const uint8_t (*bands)[3][11], int ctx, const int* dq, int n, int16_t* out) {
  const uint8_t* p = bands[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.get(p[0])) return n;
    while (!br.get(p[1])) {
      p = bands[kBands[++n]][0];
      if (n == 16) return 16;
    }
    const uint8_t (*next)[11] = bands[kBands[n + 1]];
    int v;
    if (!br.get(p[2])) {
      v = 1;
      p = next[1];
    } else {
      v = get_large_value(br, p);
      p = next[2];
    }
    const int sign = br.get(0x80);
    out[kZigzag[n]] = static_cast<int16_t>((sign ? -v : v) * dq[n > 0]);
  }
  return 16;
}

inline uint32_t nz_code(uint32_t bits, int nz, int dc_nz) {
  return (bits << 2) | static_cast<uint32_t>(nz > 3 ? 3 : nz > 1 ? 2 : dc_nz);
}

struct Context {
  uint8_t nz = 0, nz_dc = 0;
};

// libwebp's ParseResiduals: the 384 coefficients of a macroblock; returns
// true where all are zero
bool parse_residuals(Vp8& d, BoolReader& tokens, Context& top, Context& left, int segment, bool i4x4,
                     int16_t* coeffs) {
  std::memset(coeffs, 0, 384 * sizeof(int16_t));
  const int* y1 = d.dq[segment][0];
  const int* y2 = d.dq[segment][1];
  const int* uv = d.dq[segment][2];
  int16_t* dst = coeffs;
  int first;
  const uint8_t (*ac)[3][11];
  if (!i4x4) {
    int16_t dc[16] = {0};
    const int ctx = top.nz_dc + left.nz_dc;
    const int nz = get_coeffs(tokens, d.proba[1], ctx, y2, 0, dc);
    top.nz_dc = left.nz_dc = nz > 0;
    if (nz > 1) {
      iwht(dc, dst);
    } else {
      const int16_t dc0 = static_cast<int16_t>((dc[0] + 3) >> 3);
      for (int i = 0; i < 256; i += 16) dst[i] = dc0;
    }
    first = 1;
    ac = d.proba[0];
  } else {
    first = 0;
    ac = d.proba[3];
  }
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  uint32_t tnz = top.nz & 0x0f, lnz = left.nz & 0x0f;
  for (int y = 0; y < 4; ++y) {
    int l = lnz & 1;
    uint32_t codes = 0;
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + static_cast<int>(tnz & 1);
      const int nz = get_coeffs(tokens, ac, ctx, y1, first, dst);
      l = nz > first;
      tnz = (tnz >> 1) | (static_cast<uint32_t>(l) << 7);
      codes = nz_code(codes, nz, dst[0] != 0);
      dst += 16;
    }
    tnz >>= 4;
    lnz = (lnz >> 1) | (static_cast<uint32_t>(l) << 7);
    non_zero_y = (non_zero_y << 8) | codes;
  }
  uint32_t out_tnz = tnz, out_lnz = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t codes = 0;
    tnz = static_cast<uint32_t>(top.nz) >> (4 + ch);
    lnz = static_cast<uint32_t>(left.nz) >> (4 + ch);
    for (int y = 0; y < 2; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        const int ctx = l + static_cast<int>(tnz & 1);
        const int nz = get_coeffs(tokens, d.proba[2], ctx, uv, 0, dst);
        l = nz > 0;
        tnz = (tnz >> 1) | (static_cast<uint32_t>(l) << 3);
        codes = nz_code(codes, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 2;
      lnz = (lnz >> 1) | (static_cast<uint32_t>(l) << 5);
    }
    non_zero_uv |= codes << (4 * ch);
    out_tnz |= (tnz << 4) << ch;
    out_lnz |= (lnz & 0xf0) << ch;
  }
  top.nz = static_cast<uint8_t>(out_tnz);
  left.nz = static_cast<uint8_t>(out_lnz);
  return !(non_zero_y | non_zero_uv);
}

inline int clip_q(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }

void parse_header(Vp8& d, const uint8_t* data, size_t size) {
  if (size < 10) broken("VP8 frame header is truncated");
  const uint32_t tag = data[0] | (data[1] << 8) | (data[2] << 16);
  if (tag & 1) broken("VP8 frame is not a key frame");
  if (((tag >> 1) & 7) > 3) broken("VP8 profile is not valid");
  if (!((tag >> 4) & 1)) broken("VP8 frame is not shown");
  const size_t part0 = tag >> 5;
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) broken("VP8 start code is missing");
  d.width = (data[6] | (data[7] << 8)) & 0x3fff;
  d.height = (data[8] | (data[9] << 8)) & 0x3fff;
  if (!d.width || !d.height) broken("VP8 size is 0");
  d.mb_w = (d.width + 15) >> 4;
  d.mb_h = (d.height + 15) >> 4;
  data += 10;
  size -= 10;
  if (part0 > size) broken("VP8 first partition is truncated");
  BoolReader& br = d.br;
  br.init(data, part0);
  data += part0;
  size -= part0;
  br.literal(1);  // colour space: ignored, as libwebp
  br.literal(1);  // clamping type: ignored, as libwebp (it always clamps)
  // segments
  d.use_segment = br.literal(1);
  if (d.use_segment) {
    d.update_map = br.literal(1);
    if (br.literal(1)) {  // update data
      d.absolute_delta = br.literal(1);
      for (int& q : d.quantizer) q = br.literal(1) ? br.signed_literal(7) : 0;
      for (int& f : d.filter_strength) f = br.literal(1) ? br.signed_literal(6) : 0;
    }
    if (d.update_map)
      for (int& p : d.segment_proba) p = br.literal(1) ? br.literal(8) : 255;
  }
  // loop filter
  d.simple = br.literal(1);
  d.level = br.literal(6);
  const int sharpness = br.literal(3);
  int ref_lf_delta = 0, mode_lf_delta = 0;  // of intra frames and of 4x4 mode
  const bool use_lf_delta = br.literal(1);
  if (use_lf_delta && br.literal(1)) {  // update the deltas
    int deltas[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int& delta : deltas)
      if (br.literal(1)) delta = br.signed_literal(6);
    ref_lf_delta = deltas[0];
    mode_lf_delta = deltas[4];
  }
  if (br.eof) broken("VP8 frame header is truncated");
  // token partitions: the sizes of all but the last, then their bytes
  const size_t parts = size_t{1} << br.literal(2);
  if (size < 3 * (parts - 1)) broken("VP8 token partition sizes are truncated");
  const uint8_t* sizes = data;
  const uint8_t* part = data + 3 * (parts - 1);
  size_t left = size - 3 * (parts - 1);
  d.tokens.resize(parts);
  for (size_t p = 0; p + 1 < parts; ++p, sizes += 3) {
    const size_t psize = std::min<size_t>(sizes[0] | (sizes[1] << 8) | (sizes[2] << 16), left);
    d.tokens[p].init(part, psize);
    part += psize;
    left -= psize;
  }
  if (left == 0) broken("VP8 last token partition is empty");
  d.tokens[parts - 1].init(part, left);
  // quantizers
  const int base_q = br.literal(7);
  int deltas[5];
  for (int& dq : deltas) dq = br.literal(1) ? br.signed_literal(4) : 0;
  for (int s = 0; s < 4; ++s) {
    const int q = !d.use_segment ? base_q : d.quantizer[s] + (d.absolute_delta ? 0 : base_q);
    int(*m)[2] = d.dq[s];
    m[0][0] = kDcTable[clip_q(q + deltas[0], 127)];
    m[0][1] = kAcTable[clip_q(q, 127)];
    m[1][0] = kDcTable[clip_q(q + deltas[1], 127)] * 2;
    m[1][1] = std::max((kAcTable[clip_q(q + deltas[2], 127)] * 101581) >> 16, 8);
    m[2][0] = kDcTable[clip_q(q + deltas[3], 117)];
    m[2][1] = kAcTable[clip_q(q + deltas[4], 127)];
  }
  br.literal(1);  // refresh entropy probabilities: one frame, ignored
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p)
          d.proba[t][b][c][p] = static_cast<uint8_t>(
              br.get(kCoeffsUpdateProba[t][b][c][p]) ? br.literal(8) : kCoeffsProba0[t][b][c][p]);
  d.use_skip = br.literal(1);
  if (d.use_skip) d.skip_proba = br.literal(8);
  if (br.eof) broken("VP8 frame header is truncated");
  // filter strengths by segment and 4x4 mode
  for (int s = 0; s < 4; ++s) {
    const int base = !d.use_segment ? d.level
                     : d.filter_strength[s] + (d.absolute_delta ? 0 : d.level);
    for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
      FilterInfo& f = d.strengths[s][i4x4];
      f.inner = i4x4;
      int level = base + (use_lf_delta ? ref_lf_delta + (i4x4 ? mode_lf_delta : 0) : 0);
      level = level < 0 ? 0 : level > 63 ? 63 : level;
      if (d.level && level > 0) {
        int ilevel = level;
        if (sharpness > 0) {
          ilevel >>= sharpness > 4 ? 2 : 1;
          ilevel = std::min(ilevel, 9 - sharpness);
        }
        f.ilevel = std::max(ilevel, 1);
        f.limit = 2 * level + f.ilevel;
        f.hev = level >= 40 ? 2 : level >= 15 ? 1 : 0;
      } else {
        f.limit = 0;
      }
    }
  }
}

struct Planes {
  int y_stride, uv_stride;
  std::vector<uint8_t> y, u, v;
};

// YUV planes, mb_w*16 x mb_h*16 (chroma half that), reconstructed and
// loop-filtered
Planes decode_frame(Vp8& d) {
  Planes pl;
  pl.y_stride = d.mb_w * 16;
  pl.uv_stride = d.mb_w * 8;
  pl.y.assign(static_cast<size_t>(pl.y_stride) * static_cast<size_t>(d.mb_h * 16), 0);
  pl.u.assign(static_cast<size_t>(pl.uv_stride) * static_cast<size_t>(d.mb_h * 8), 0);
  pl.v.assign(pl.u.size(), 0);
  std::vector<Context> top_ctx(static_cast<size_t>(d.mb_w));
  std::vector<uint8_t> intra_top(static_cast<size_t>(4 * d.mb_w), B_DC);
  std::vector<FilterInfo> finfo(static_cast<size_t>(d.mb_w) * static_cast<size_t>(d.mb_h));
  struct Mode {
    int segment;
    bool skip, i4x4;
    uint8_t modes[16];
    int uv;
  };
  std::vector<Mode> row_modes(static_cast<size_t>(d.mb_w));
  alignas(16) int16_t coeffs[384];
  uint8_t ywork[BPS * 17 + 8], uwork[BPS * 9 + 8], vwork[BPS * 9 + 8];
  uint8_t* const yb = ywork + BPS + 8;
  uint8_t* const ub = uwork + BPS + 8;
  uint8_t* const vb = vwork + BPS + 8;
  for (int my = 0; my < d.mb_h; ++my) {
    uint8_t intra_left[4] = {B_DC, B_DC, B_DC, B_DC};
    for (int mx = 0; mx < d.mb_w; ++mx) {  // the row's modes, from the first partition
      Mode& m = row_modes[static_cast<size_t>(mx)];
      BoolReader& br = d.br;
      m.segment = !d.update_map ? 0
                  : !br.get(d.segment_proba[0]) ? br.get(d.segment_proba[1])
                                                : 2 + br.get(d.segment_proba[2]);
      m.skip = d.use_skip ? br.get(d.skip_proba) : false;
      m.i4x4 = !br.get(145);
      uint8_t* top = &intra_top[static_cast<size_t>(4 * mx)];
      if (!m.i4x4) {
        const int ymode = br.get(156) ? (br.get(128) ? TM_PRED : H_PRED) : (br.get(163) ? V_PRED : DC_PRED);
        m.modes[0] = static_cast<uint8_t>(ymode);
        std::memset(top, ymode, 4);
        std::memset(intra_left, ymode, 4);
      } else {
        for (int y = 0; y < 4; ++y) {
          int ymode = intra_left[y];
          for (int x = 0; x < 4; ++x) {
            const uint8_t* prob = kBModesProba[top[x]][ymode];
            int i = kModeTree[br.get(prob[0])];
            while (i > 0) i = kModeTree[2 * i + br.get(prob[i])];
            ymode = -i;
            top[x] = static_cast<uint8_t>(ymode);
          }
          std::memcpy(m.modes + 4 * y, top, 4);
          intra_left[y] = static_cast<uint8_t>(ymode);
        }
      }
      m.uv = !br.get(142) ? DC_PRED : !br.get(114) ? V_PRED : br.get(183) ? TM_PRED : H_PRED;
    }
    if (d.br.eof) broken("VP8 first partition is truncated");
    Context left_ctx;
    BoolReader& tokens = d.tokens[static_cast<size_t>(my) & (d.tokens.size() - 1)];
    for (int mx = 0; mx < d.mb_w; ++mx) {
      const Mode& m = row_modes[static_cast<size_t>(mx)];
      Context& top = top_ctx[static_cast<size_t>(mx)];
      bool skip = m.skip;
      if (!skip) {
        skip = parse_residuals(d, tokens, top, left_ctx, m.segment, m.i4x4, coeffs);
      } else {
        std::memset(coeffs, 0, sizeof(coeffs));
        left_ctx.nz = top.nz = 0;
        if (!m.i4x4) left_ctx.nz_dc = top.nz_dc = 0;
      }
      if (tokens.eof) broken("VP8 token partition is truncated");
      FilterInfo f = d.strengths[m.segment][m.i4x4];
      f.inner = f.inner || !skip;
      finfo[static_cast<size_t>(my) * static_cast<size_t>(d.mb_w) + static_cast<size_t>(mx)] = f;

      // the work buffers: row -1 above (127 on the first row), column -1
      // left (129 on the first column), 4 top-right samples for 4x4 modes
      uint8_t* const py = &pl.y[static_cast<size_t>(my * 16) * static_cast<size_t>(pl.y_stride) + static_cast<size_t>(mx * 16)];
      const size_t uv_off = static_cast<size_t>(my * 8) * static_cast<size_t>(pl.uv_stride) + static_cast<size_t>(mx * 8);
      uint8_t* const pu = &pl.u[uv_off];
      uint8_t* const pv = &pl.v[uv_off];
      const int ys = pl.y_stride, uvs = pl.uv_stride;
      if (my == 0) {
        std::memset(yb - BPS - 1, 127, 21);
        std::memset(ub - BPS - 1, 127, 9);
        std::memset(vb - BPS - 1, 127, 9);
      } else {
        yb[-BPS - 1] = mx ? py[-ys - 1] : 129;
        ub[-BPS - 1] = mx ? pu[-uvs - 1] : 129;
        vb[-BPS - 1] = mx ? pv[-uvs - 1] : 129;
        std::memcpy(yb - BPS, py - ys, 16);
        std::memcpy(ub - BPS, pu - uvs, 8);
        std::memcpy(vb - BPS, pv - uvs, 8);
        if (mx < d.mb_w - 1)
          std::memcpy(yb - BPS + 16, py - ys + 16, 4);
        else
          std::memset(yb - BPS + 16, py[-ys + 15], 4);
      }
      for (int j = 0; j < 16; ++j) yb[j * BPS - 1] = mx ? py[j * ys - 1] : 129;
      for (int j = 0; j < 8; ++j) {
        ub[j * BPS - 1] = mx ? pu[j * uvs - 1] : 129;
        vb[j * BPS - 1] = mx ? pv[j * uvs - 1] : 129;
      }
      if (m.i4x4) {
        for (int r = 3; r < 12; r += 4) std::memcpy(yb + r * BPS + 16, yb - BPS + 16, 4);
        for (int n = 0; n < 16; ++n) {
          uint8_t* dst = yb + (n >> 2) * 4 * BPS + (n & 3) * 4;
          predict4(dst, m.modes[n]);
          idct_add(coeffs + 16 * n, dst);
        }
      } else {
        predict_block(yb, 16, m.modes[0], my > 0, mx > 0);
        for (int n = 0; n < 16; ++n) idct_add(coeffs + 16 * n, yb + (n >> 2) * 4 * BPS + (n & 3) * 4);
      }
      predict_block(ub, 8, m.uv, my > 0, mx > 0);
      predict_block(vb, 8, m.uv, my > 0, mx > 0);
      for (int n = 0; n < 4; ++n) {
        idct_add(coeffs + 256 + 16 * n, ub + (n >> 1) * 4 * BPS + (n & 1) * 4);
        idct_add(coeffs + 320 + 16 * n, vb + (n >> 1) * 4 * BPS + (n & 1) * 4);
      }
      for (int j = 0; j < 16; ++j) std::memcpy(py + j * ys, yb + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        std::memcpy(pu + j * uvs, ub + j * BPS, 8);
        std::memcpy(pv + j * uvs, vb + j * BPS, 8);
      }
    }
  }
  if (d.level) {  // the normal loop filter, macroblock by macroblock
    const int ys = pl.y_stride, uvs = pl.uv_stride;
    for (int my = 0; my < d.mb_h; ++my) {
      for (int mx = 0; mx < d.mb_w; ++mx) {
        const FilterInfo& f = finfo[static_cast<size_t>(my) * static_cast<size_t>(d.mb_w) + static_cast<size_t>(mx)];
        if (!f.limit) continue;
        uint8_t* y = &pl.y[static_cast<size_t>(my * 16) * static_cast<size_t>(ys) + static_cast<size_t>(mx * 16)];
        const size_t uv_off = static_cast<size_t>(my * 8) * static_cast<size_t>(uvs) + static_cast<size_t>(mx * 8);
        uint8_t* u = &pl.u[uv_off];
        uint8_t* v = &pl.v[uv_off];
        const int edge = f.limit + 4;
        if (d.simple) {
          if (mx > 0) simple_edge(y, 1, ys, edge);
          if (f.inner)
            for (int k = 4; k < 16; k += 4) simple_edge(y + k, 1, ys, f.limit);
          if (my > 0) simple_edge(y, ys, 1, edge);
          if (f.inner)
            for (int k = 4; k < 16; k += 4) simple_edge(y + k * ys, ys, 1, f.limit);
          continue;
        }
        if (mx > 0) {
          filter_edge(y, 1, ys, 16, edge, f.ilevel, f.hev, true);
          filter_edge(u, 1, uvs, 8, edge, f.ilevel, f.hev, true);
          filter_edge(v, 1, uvs, 8, edge, f.ilevel, f.hev, true);
        }
        if (f.inner) {
          for (int k = 4; k < 16; k += 4) filter_edge(y + k, 1, ys, 16, f.limit, f.ilevel, f.hev, false);
          filter_edge(u + 4, 1, uvs, 8, f.limit, f.ilevel, f.hev, false);
          filter_edge(v + 4, 1, uvs, 8, f.limit, f.ilevel, f.hev, false);
        }
        if (my > 0) {
          filter_edge(y, ys, 1, 16, edge, f.ilevel, f.hev, true);
          filter_edge(u, uvs, 1, 8, edge, f.ilevel, f.hev, true);
          filter_edge(v, uvs, 1, 8, edge, f.ilevel, f.hev, true);
        }
        if (f.inner) {
          for (int k = 4; k < 16; k += 4) filter_edge(y + k * ys, ys, 1, 16, f.limit, f.ilevel, f.hev, false);
          filter_edge(u + 4 * uvs, uvs, 1, 8, f.limit, f.ilevel, f.hev, false);
          filter_edge(v + 4 * uvs, uvs, 1, 8, f.limit, f.ilevel, f.hev, false);
        }
      }
    }
  }
  return pl;
}

// libwebp's YUV to RGB (14-bit fixed point)
inline int mult_hi(int v, int c) { return (v * c) >> 8; }
inline uint8_t clip8(int v) { return static_cast<uint8_t>((v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255); }
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  const int yy = mult_hi(y, 19077);
  rgb[0] = clip8(yy + mult_hi(v, 26149) - 14234);
  rgb[1] = clip8(yy - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgb[2] = clip8(yy + mult_hi(u, 33050) - 17685);
}

// the fancy upsampler and the colour conversion over the cropped planes
void planes_to_rgb(const Planes& pl, int width, int height, uint8_t* rgb) {
  const int cw = (width + 1) / 2, ch = (height + 1) / 2;
  std::vector<int> mix_u(static_cast<size_t>(cw)), mix_v(static_cast<size_t>(cw));
  std::vector<int> near_col(static_cast<size_t>(width)), far_col(static_cast<size_t>(width));
  for (int x = 0; x < width; ++x) {
    near_col[static_cast<size_t>(x)] = x >> 1;
    far_col[static_cast<size_t>(x)] = std::min(std::max((x & 1) ? (x >> 1) + 1 : (x >> 1) - 1, 0), cw - 1);
  }
  for (int y = 0; y < height; ++y) {
    const int nr = y >> 1;
    const int fr = std::min(std::max((y & 1) ? nr + 1 : nr - 1, 0), ch - 1);
    const uint8_t* un = &pl.u[static_cast<size_t>(nr) * static_cast<size_t>(pl.uv_stride)];
    const uint8_t* uf = &pl.u[static_cast<size_t>(fr) * static_cast<size_t>(pl.uv_stride)];
    const uint8_t* vn = &pl.v[static_cast<size_t>(nr) * static_cast<size_t>(pl.uv_stride)];
    const uint8_t* vf = &pl.v[static_cast<size_t>(fr) * static_cast<size_t>(pl.uv_stride)];
    for (int c = 0; c < cw; ++c) {
      mix_u[static_cast<size_t>(c)] = 3 * un[c] + uf[c];
      mix_v[static_cast<size_t>(c)] = 3 * vn[c] + vf[c];
    }
    const uint8_t* yrow = &pl.y[static_cast<size_t>(y) * static_cast<size_t>(pl.y_stride)];
    uint8_t* out = rgb + static_cast<size_t>(y) * static_cast<size_t>(width) * 3;
    for (int x = 0; x < width; ++x) {
      const size_t n = static_cast<size_t>(near_col[static_cast<size_t>(x)]);
      const size_t f = static_cast<size_t>(far_col[static_cast<size_t>(x)]);
      const int u = (3 * mix_u[n] + mix_u[f] + 8) >> 4;
      const int v = (3 * mix_v[n] + mix_v[f] + 8) >> 4;
      yuv_to_rgb(yrow[x], u, v, out + 3 * x);
    }
  }
}

void decode_vp8(const uint8_t* data, size_t size, int width, int height, uint8_t* rgb) {
  Vp8 d;
  parse_header(d, data, size);
  if (d.width != width || d.height != height) broken("VP8 size disagrees with the container");
  const Planes pl = decode_frame(d);
  planes_to_rgb(pl, d.width, d.height, rgb);
}

void set_error(char* err, int len, const std::string& msg) {
  if (err && len > 0) std::snprintf(err, static_cast<size_t>(len), "%s", msg.c_str());
}

}  // namespace

extern "C" {

// Decode the image chunk `data` (`size` bytes; VP8L when `lossless`, else
// VP8) of a width x height still WebP into `rgb` (height x width x 3).
// Returns 0, or 1 with a message in `err` on a broken bitstream.
int icat_webp_decode(const uint8_t* data, int64_t size, int lossless, int width, int height,
                     uint8_t* rgb, char* err, int err_len) {
  try {
    if (size < 0 || width <= 0 || height <= 0) broken("bad arguments");
    if (lossless)
      decode_vp8l(data, static_cast<size_t>(size), width, height, rgb);
    else
      decode_vp8(data, static_cast<size_t>(size), width, height, rgb);
    return 0;
  } catch (const Broken& b) {
    set_error(err, err_len, b.message);
    return 1;
  } catch (const std::bad_alloc&) {
    set_error(err, err_len, "out of memory");
    return 1;
  }
}

}  // extern "C"
