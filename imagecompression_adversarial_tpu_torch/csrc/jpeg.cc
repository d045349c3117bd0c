// Baseline JPEG decoder (host C++): the pixels libjpeg(-turbo) decodes with
// its default settings (islow IDCT, fancy upsampling), which is what
// Pillow's Image.open gives.
//
// Role: io/jpeg.py parses the markers (frame, tables, restart interval) and
// hands this file the entropy-coded segment of the one scan and the tables
// of each component; kernels/_build.py compiles it with g++ into
// _build/libicat_jpeg-<hash>.so on first use, and io/jpeg.py loads it with
// ctypes.  io/jpeg.py::decode is its plain numpy version and is held to it
// bit for bit.  Decoded here, in libjpeg's order and arithmetic:
//
//   * the Huffman scan: one interleaved scan of 1 or 3 components, each MCU
//     hs x vs blocks of luma and one block of each chroma component (a
//     single component: one block an MCU, in raster order), DC predictors,
//     and restart intervals (RSTn markers, after which the predictors reset
//     and the bit reader starts on the next byte);
//   * dequantization and jidctint (13-bit fixed point, PASS1_BITS 2) with
//     its range-limit table;
//   * the chroma's fancy upsampling: h2v1 (4:2:2) and h2v2 (4:2:0), the
//     triangle filters of jdsample.c with the edge samples repeated, and
//     box upsampling where a plane is 2 or fewer samples wide (libjpeg-
//     turbo's rule); none for 4:4:4;
//   * jdcolor.c's fixed-point YCbCr -> RGB (16 fractional bits).
//
// A gray image is its one component.  Exposed as a C ABI for ctypes.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

// zigzag index -> row-major index in the 8x8 block (jpeg_natural_order)
constexpr int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270;
constexpr int64_t F0_899 = 7373, F1_175 = 9633, F1_501 = 12299, F1_847 = 15137;
constexpr int64_t F1_961 = 16069, F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t{1} << (n - 1))) >> n; }

// jidctint's output table, indexed by (descaled sample & 1023): [-128, 383]
// -> clamp(x + 128), beyond that libjpeg's wrap-around
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      if (i < 128) t[i] = static_cast<uint8_t>(128 + i);
      else if (i < 512) t[i] = 255;
      else if (i < 896) t[i] = 0;
      else t[i] = static_cast<uint8_t>(i - 896);
    }
  }
};
const RangeLimit kLimit;

// One pass of jidctint over 8 values d[0], d[s], ..., d[7s] into o[0], o[os],
// ...: columns first (shift CONST_BITS - PASS1_BITS), then rows (shift
// CONST_BITS + PASS1_BITS + 3).
inline void idct_1d(const int64_t* d, int s, int64_t* o, int os, int shift) {
  int64_t z1 = (d[2 * s] + d[6 * s]) * F0_541;
  int64_t t2 = z1 - d[6 * s] * F1_847;
  int64_t t3 = z1 + d[2 * s] * F0_765;
  int64_t t0 = (d[0] + d[4 * s]) * (int64_t{1} << kConstBits);
  int64_t t1 = (d[0] - d[4 * s]) * (int64_t{1} << kConstBits);
  const int64_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
  t0 = d[7 * s];
  t1 = d[5 * s];
  t2 = d[3 * s];
  t3 = d[1 * s];
  z1 = t0 + t3;
  int64_t z2 = t1 + t2, z3 = t0 + t2, z4 = t1 + t3;
  const int64_t z5 = (z3 + z4) * F1_175;
  t0 *= F0_298;
  t1 *= F2_053;
  t2 *= F3_072;
  t3 *= F1_501;
  z1 *= -F0_899;
  z2 *= -F2_562;
  z3 = z3 * -F1_961 + z5;
  z4 = z4 * -F0_390 + z5;
  t0 += z1 + z3;
  t1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1 + z4;
  o[0] = descale(t10 + t3, shift);
  o[os] = descale(t11 + t2, shift);
  o[2 * os] = descale(t12 + t1, shift);
  o[3 * os] = descale(t13 + t0, shift);
  o[4 * os] = descale(t13 - t0, shift);
  o[5 * os] = descale(t12 - t1, shift);
  o[6 * os] = descale(t11 - t2, shift);
  o[7 * os] = descale(t10 - t3, shift);
}

// Dequantized natural-order coefficients -> 8x8 samples at out (row stride).
void idct_block(const int64_t* coef, uint8_t* out, int stride) {
  int64_t ws[64], rows[8];
  for (int c = 0; c < 8; ++c) idct_1d(coef + c, 8, ws + c, 8, kConstBits - kPass1Bits);
  for (int r = 0; r < 8; ++r) {
    idct_1d(ws + 8 * r, 1, rows, 1, kConstBits + kPass1Bits + 3);
    for (int c = 0; c < 8; ++c) out[r * stride + c] = kLimit.t[rows[c] & 1023];
  }
}

// A Huffman table as a lookup on the next 16 bits: (length << 8) | symbol,
// length 0 where no code of the table starts the window.
struct Huffman {
  std::vector<uint16_t> lut;
  bool build(const uint8_t* counts, const uint8_t* symbols) {
    lut.assign(1 << 16, 0);
    int code = 0, k = 0;
    for (int len = 1; len <= 16; ++len) {
      for (int i = 0; i < counts[len - 1]; ++i) {
        if (code >= (1 << len)) return false;
        const int lo = code << (16 - len), n = 1 << (16 - len);
        for (int j = 0; j < n; ++j) lut[lo + j] = static_cast<uint16_t>((len << 8) | symbols[k]);
        ++code;
        ++k;
      }
      code <<= 1;
    }
    return true;
  }
};

// MSB-first reader of the entropy-coded bytes: 0xFF 0x00 is a 0xFF byte; at
// a marker it stops and feeds zero bits (as libjpeg does) until the caller
// steps over an RSTn marker.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;  // the next `n` bits, left-aligned
  int n = 0;
  int64_t real = 0;  // bits taken from the data
  int64_t used = 0;  // bits consumed

  void fill() {
    while (n <= 56) {
      uint64_t byte = 0;
      if (p < end && !(p[0] == 0xFF && (p + 1 >= end || p[1] != 0x00))) {
        byte = *p++;
        if (byte == 0xFF) ++p;  // the stuffed 0x00
        real += 8;
      }
      buf |= byte << (56 - n);
      n += 8;
    }
  }
  inline uint32_t peek16() {
    if (n < 16) fill();
    return static_cast<uint32_t>(buf >> 48);
  }
  inline void skip(int k) {
    buf <<= k;
    n -= k;
    used += k;
  }
  inline int32_t receive_extend(int s) {
    if (s == 0) return 0;
    if (n < s) fill();
    int32_t v = static_cast<int32_t>(buf >> (64 - s));
    skip(s);
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }
  // step over the RSTn marker that must follow a restart interval
  bool restart() {
    while (p < end && p[0] == 0xFF && p + 1 < end && p[1] == 0xFF) ++p;  // fill bytes
    if (p + 1 >= end || p[0] != 0xFF || p[1] < 0xD0 || p[1] > 0xD7) return false;
    p += 2;
    buf = 0;
    n = 0;
    used = real;
    return true;
  }
};

struct Component {
  int hs, vs;             // sampling factors (MCU blocks across, down)
  int bw, bh;             // blocks across, down of its plane
  int w, h;               // its samples across, down (downsampled size)
  const int32_t* quant;   // natural order
  Huffman dc, ac;
  std::vector<uint8_t> plane;  // (bh * 8) x (bw * 8)
};

void set_error(char* err, int len, const char* msg) {
  if (err && len > 0) std::snprintf(err, static_cast<size_t>(len), "%s", msg);
}

// h2v1_fancy_upsample: each row of `in` (w samples) doubled across into
// `out` (2w), 3/4 of the nearer and 1/4 of the further sample, biases 1, 2.
void h2v1_fancy(const uint8_t* in, int w, uint8_t* out) {
  for (int i = 0; i < w; ++i) {
    const int v = 3 * in[i];
    const int left = in[i > 0 ? i - 1 : 0], right = in[i < w - 1 ? i + 1 : w - 1];
    out[2 * i] = static_cast<uint8_t>((v + left + 1) >> 2);
    out[2 * i + 1] = static_cast<uint8_t>((v + right + 2) >> 2);
  }
}

// h2v2_fancy_upsample of output row `y` (2w samples) from a plane of w x h
// samples (row stride `stride`): 3/4 of its input row y / 2 and 1/4 of the
// row above (even y) or below (odd y), then across as h2v1 with biases 8
// and 7 over 16; edge rows and columns repeated.
void h2v2_fancy(const uint8_t* plane, int stride, int w, int h, int y, uint8_t* out) {
  const int sy = y / 2, oy = y % 2 ? std::min(sy + 1, h - 1) : std::max(sy - 1, 0);
  const uint8_t* in = plane + static_cast<int64_t>(sy) * stride;
  const uint8_t* other = plane + static_cast<int64_t>(oy) * stride;
  auto sum = [&](int i) { return 3 * in[i] + other[i]; };
  for (int i = 0; i < w; ++i) {
    const int s = sum(i), left = sum(i > 0 ? i - 1 : 0), right = sum(i < w - 1 ? i + 1 : w - 1);
    out[2 * i] = static_cast<uint8_t>((3 * s + left + 8) >> 4);
    out[2 * i + 1] = static_cast<uint8_t>((3 * s + right + 7) >> 4);
  }
}

// A chroma plane brought to the image's width and height (w x h, row major).
void upsample(const Component& c, int hmax, int vmax, int width, int height, uint8_t* out) {
  const int stride = c.bw * 8, fx = hmax / c.hs, fy = vmax / c.vs;
  std::vector<uint8_t> row(2 * static_cast<size_t>(c.w));
  const bool fancy = c.w > 2;
  for (int y = 0; y < height; ++y) {
    const uint8_t* in = c.plane.data() + static_cast<int64_t>(y / fy) * stride;
    uint8_t* dst = out + static_cast<int64_t>(y) * width;
    if (fx == 1) {
      std::memcpy(dst, in, static_cast<size_t>(width));
      continue;
    }
    if (!fancy) {
      for (int x = 0; x < width; ++x) dst[x] = in[x / 2];
      continue;
    }
    if (fy == 1) {
      h2v1_fancy(in, c.w, row.data());
    } else {
      h2v2_fancy(c.plane.data(), stride, c.w, c.h, y, row.data());
    }
    std::memcpy(dst, row.data(), static_cast<size_t>(width));
  }
}

inline uint8_t clamp255(int64_t v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

}  // namespace

extern "C" {

// Decode the scan `data[0:len]` (its entropy-coded bytes, RSTn markers
// included) of a `width` x `height` baseline frame of `ncomp` (1 or 3)
// components into `out`: height x width x 3 RGB for 3 components (YCbCr),
// height x width for 1.  Per component k: sampling factors hs[k], vs[k] (1
// for a single component), its 64 quantization values in natural order at
// quant[64k], its DC and AC Huffman tables as 16 code counts at
// dc_counts[16k] / ac_counts[16k] and up to 256 symbols at dc_symbols[256k] /
// ac_symbols[256k].  `restart` MCUs an interval (0: none).  Returns 0, or 1
// with a message in `err`.
int icat_jpeg_decode(const uint8_t* data, int64_t len, int width, int height, int ncomp,
                     const int32_t* hs, const int32_t* vs, const int32_t* quant,
                     const uint8_t* dc_counts, const uint8_t* dc_symbols,
                     const uint8_t* ac_counts, const uint8_t* ac_symbols, int restart,
                     uint8_t* out, char* err, int err_len) {
  if ((ncomp != 1 && ncomp != 3) || width <= 0 || height <= 0) {
    set_error(err, err_len, "JPEG frame: bad size or component count");
    return 1;
  }
  int hmax = 1, vmax = 1;
  for (int k = 0; k < ncomp; ++k) {
    hmax = hs[k] > hmax ? hs[k] : hmax;
    vmax = vs[k] > vmax ? vs[k] : vmax;
  }
  const int mcux = (width + 8 * hmax - 1) / (8 * hmax), mcuy = (height + 8 * vmax - 1) / (8 * vmax);
  std::vector<Component> comps(static_cast<size_t>(ncomp));
  for (int k = 0; k < ncomp; ++k) {
    Component& c = comps[k];
    c.hs = hs[k];
    c.vs = vs[k];
    c.bw = mcux * c.hs;
    c.bh = mcuy * c.vs;
    c.w = static_cast<int>((static_cast<int64_t>(width) * c.hs + hmax - 1) / hmax);
    c.h = static_cast<int>((static_cast<int64_t>(height) * c.vs + vmax - 1) / vmax);
    c.quant = quant + 64 * k;
    if (!c.dc.build(dc_counts + 16 * k, dc_symbols + 256 * k) ||
        !c.ac.build(ac_counts + 16 * k, ac_symbols + 256 * k)) {
      set_error(err, err_len, "JPEG Huffman table: more codes than its lengths hold");
      return 1;
    }
    c.plane.assign(static_cast<size_t>(c.bh) * 8 * static_cast<size_t>(c.bw) * 8, 0);
  }

  BitReader bits{data, data + len};
  std::vector<int32_t> pred(static_cast<size_t>(ncomp), 0);
  int32_t zz[64];
  int64_t coef[64];
  const int64_t n_mcus = static_cast<int64_t>(mcux) * mcuy;
  for (int64_t m = 0; m < n_mcus; ++m) {
    if (restart && m && m % restart == 0) {
      if (!bits.restart()) {
        set_error(err, err_len, "JPEG scan: no RST marker where a restart interval ends");
        return 1;
      }
      std::fill(pred.begin(), pred.end(), 0);
    }
    const int my = static_cast<int>(m / mcux), mx = static_cast<int>(m % mcux);
    for (int k = 0; k < ncomp; ++k) {
      Component& c = comps[k];
      for (int v = 0; v < c.vs; ++v) {
        for (int u = 0; u < c.hs; ++u) {
          std::memset(zz, 0, sizeof(zz));
          uint16_t e = c.dc.lut[bits.peek16()];
          if (!(e >> 8)) {
            set_error(err, err_len, "JPEG scan: bad DC code");
            return 1;
          }
          bits.skip(e >> 8);
          pred[k] += bits.receive_extend(e & 0xFF);
          zz[0] = pred[k];
          for (int i = 1; i < 64;) {
            e = c.ac.lut[bits.peek16()];
            if (!(e >> 8)) {
              set_error(err, err_len, "JPEG scan: bad AC code");
              return 1;
            }
            bits.skip(e >> 8);
            const int r = (e & 0xFF) >> 4, s = e & 15;
            if (s) {
              i += r;
              const int32_t val = bits.receive_extend(s);
              if (i > 63) {
                set_error(err, err_len, "JPEG scan: coefficient past the block");
                return 1;
              }
              zz[i++] = val;
            } else if (r == 15) {
              i += 16;
            } else {
              break;
            }
          }
          for (int i = 0; i < 64; ++i)
            coef[kNatural[i]] = static_cast<int64_t>(zz[i]) * c.quant[kNatural[i]];
          const int by = my * c.vs + v, bx = mx * c.hs + u, stride = c.bw * 8;
          idct_block(coef, c.plane.data() + static_cast<int64_t>(by) * 8 * stride + bx * 8, stride);
        }
      }
      if (bits.used > bits.real) {
        set_error(err, err_len, "JPEG scan ends early");
        return 1;
      }
    }
  }

  const int64_t npix = static_cast<int64_t>(width) * height;
  const Component& y = comps[0];
  if (ncomp == 1) {
    for (int r = 0; r < height; ++r)
      std::memcpy(out + static_cast<int64_t>(r) * width,
                  y.plane.data() + static_cast<int64_t>(r) * y.bw * 8, static_cast<size_t>(width));
    return 0;
  }
  std::vector<uint8_t> cb(static_cast<size_t>(npix)), cr(static_cast<size_t>(npix));
  upsample(comps[1], hmax, vmax, width, height, cb.data());
  upsample(comps[2], hmax, vmax, width, height, cr.data());
  // jdcolor.c: FIX(x) = x * 65536 + 0.5, ONE_HALF = 1 << 15
  constexpr int64_t kR = 91881, kG_cb = 22554, kG_cr = 46802, kB = 116130, kHalf = 1 << 15;
  for (int r = 0; r < height; ++r) {
    const uint8_t* yr = y.plane.data() + static_cast<int64_t>(r) * y.bw * 8;
    for (int x = 0; x < width; ++x) {
      const int64_t i = static_cast<int64_t>(r) * width + x;
      const int64_t yy = yr[x], b = cb[i] - 128, c = cr[i] - 128;
      uint8_t* px = out + 3 * i;
      px[0] = clamp255(yy + ((kR * c + kHalf) >> 16));
      px[1] = clamp255(yy + ((-kG_cb * b + kHalf - kG_cr * c) >> 16));
      px[2] = clamp255(yy + ((kB * b + kHalf) >> 16));
    }
  }
  return 0;
}

}  // extern "C"
