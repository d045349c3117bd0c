// JPEG decoder (host C++): the pixels libjpeg(-turbo) decodes with its
// default settings (islow IDCT, fancy upsampling), which is what Pillow's
// Image.open gives, and for CMYK and YCCK what Pillow's convert("RGB")
// gives; Huffman or arithmetic-coded, and lossless.
//
// Role: io/jpeg.py parses the markers (frame, tables, restart intervals,
// every scan's header) and hands this file each scan's entropy-coded
// segment and tables; kernels/_build.py compiles it with g++ into
// _build/libicat_jpeg-<hash>.so on first use, and io/jpeg.py loads it with
// ctypes.  io/jpeg.py::decode is its plain numpy version and is held to it
// bit for bit.  Decoded here, in libjpeg's order and arithmetic:
//
//   * each scan into int16 coefficient planes, one per component, padded
//     to whole MCUs: an interleaved scan MCU by MCU (each component's
//     hs x vs blocks), a scan of one component over that component's own
//     block grid; DC predictors, end-of-band runs and restart intervals
//     (RSTn markers, after which both reset and the bit reader starts on
//     the next byte).  Sequential scans as jdhuff.c (a baseline file is
//     one interleaved scan of band 0..63); progressive ones as jdphuff.c:
//     DC first and refine, AC first with its EOBRUN, AC refine with its
//     correction bits and zero-run skipping.  Arithmetic-coded scans as
//     jdarith.c: its QM decoder (Table D.2's states), statistics bins per
//     conditioning table (DC contexts by the DAC bounds L and U, AC bins
//     by Kx), reset with the DC predictors at each restart, sequential
//     blocks and the four progressive passes;
//   * or, in a lossless frame, each scan's Huffman-coded differences added
//     modulo 2^16 to their predictions (jdlhuff.c, jdlossls.c: predictors
//     1-7 of the left, upper and upper-left samples, the first row of each
//     restart interval from 2^(7 - Pt) and the sample to the left, the
//     first column from the sample above), shifted left by the point
//     transform Pt, in place of the next two steps;
//   * dequantization and jidctint (13-bit fixed point, PASS1_BITS 2) with
//     its range-limit table;
//   * each component's upsampler as libjpeg-turbo's jinit_upsampler picks
//     it by the ratio of the largest sampling factors to its own: none at
//     1x1; the triangle filters of jdsample.c at 2x1 (h2v1), 1x2 (h1v2)
//     and 2x2 (h2v2) with the edge samples repeated, box upsampling for
//     h2v1 and h2v2 where a plane is 2 or fewer samples wide; int_upsample
//     (box) at every other whole ratio (4:1:1's 4x1, ...);
//   * jdcolor.c's fixed-point YCbCr -> RGB (16 fractional bits), RGB-coded
//     samples as they are, or for four components Pillow's CMYK: its
//     "CMYK;I" raw mode inverts the samples and Convert.c's cmyk2rgb maps
//     them to RGB; YCCK first through jdcolor.c's ycck_cmyk_convert (C, M,
//     Y = 255 less the YCbCr's R, G, B; K as it is).
//
// A gray image is its one component.  Exposed as a C ABI for ctypes.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
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
        if (code >= (1 << len) || k >= 256) return false;
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
  inline uint32_t get(int k) {
    if (k == 0) return 0;
    if (n < k) fill();
    const uint32_t v = static_cast<uint32_t>(buf >> (64 - k));
    skip(k);
    return v;
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
  int hs, vs;                 // sampling factors (MCU blocks across, down)
  int bw, bh;                 // blocks across, down of its MCU-padded plane
  int gw, gh;                 // blocks across, down a scan of it alone codes
  int w, h;                   // its samples across, down (downsampled size)
  const int32_t* quant;       // natural order
  std::vector<int16_t> coef;  // bh x bw blocks of 64, zigzag order
  std::unique_ptr<uint8_t[]> plane;  // (bh * 8) x (bw * 8), every sample written
};

inline int16_t as_jcoef(int32_t v) { return static_cast<int16_t>(static_cast<uint16_t>(v)); }

// libjpeg's LEFT_SHIFT: the shift of the unsigned bits
inline int32_t left_shift(int32_t v, int n) {
  return static_cast<int32_t>(static_cast<uint32_t>(v) << n);
}

// What a scan's decode of one block can find wrong.
enum Fault { kOk = 0, kBadDc, kBadAc, kPastBand, kBadRefine, kBadDiff, kSpectral, kMagnitude };
const char* const kFaults[] = {"", "bad DC code", "bad AC code", "coefficient past the band",
                               "bad AC refinement code", "bad difference code",
                               "arithmetic code error: spectral overflow",
                               "arithmetic code error: magnitude overflow"};

// Reads one Huffman symbol into `sym`; false where no code of the table
// starts the window.
inline bool huff_decode(BitReader& b, const Huffman& t, int& sym) {
  const uint16_t e = t.lut[b.peek16()];
  if (!(e >> 8)) return false;
  b.skip(e >> 8);
  sym = e & 0xFF;
  return true;
}

// A sequential block (jdhuff.c): zeroed, then its DC difference and AC
// run/size codes over band 0..63.
Fault decode_sequential(BitReader& b, const Huffman& dc, const Huffman& ac, int32_t& pred,
                        int16_t* blk) {
  int s;
  if (!huff_decode(b, dc, s) || s > 15) return kBadDc;
  std::memset(blk, 0, 64 * sizeof(int16_t));
  pred += b.receive_extend(s);
  blk[0] = as_jcoef(pred);
  for (int k = 1; k < 64; ++k) {
    if (!huff_decode(b, ac, s)) return kBadAc;
    const int r = s >> 4;
    s &= 15;
    if (s) {
      k += r;
      const int32_t v = b.receive_extend(s);
      if (k > 63) return kPastBand;
      blk[k] = as_jcoef(v);
    } else if (r == 15) {
      k += 15;
    } else {
      break;
    }
  }
  return kOk;
}

// A progressive DC first scan's block (decode_mcu_DC_first).
Fault decode_dc_first(BitReader& b, const Huffman& dc, int al, int32_t& pred, int16_t* blk) {
  int s;
  if (!huff_decode(b, dc, s) || s > 15) return kBadDc;
  pred += b.receive_extend(s);
  blk[0] = as_jcoef(left_shift(pred, al));
  return kOk;
}

// A progressive AC first scan's block (decode_mcu_AC_first): band ss..se,
// the coefficients shifted left by al; an EOBr code starts a run of
// 2^r + r bits blocks (this one included) with nothing more in the band.
Fault decode_ac_first(BitReader& b, const Huffman& ac, int ss, int se, int al, int32_t& eobrun,
                      int16_t* blk) {
  if (eobrun > 0) {
    --eobrun;
    return kOk;
  }
  for (int k = ss; k <= se; ++k) {
    int s;
    if (!huff_decode(b, ac, s)) return kBadAc;
    const int r = s >> 4;
    s &= 15;
    if (s) {
      k += r;
      const int32_t v = b.receive_extend(s);
      if (k > se) return kPastBand;
      blk[k] = as_jcoef(left_shift(v, al));
    } else if (r == 15) {
      k += 15;
    } else {
      eobrun = (1 << r) - 1 + static_cast<int32_t>(b.get(r));
      break;
    }
  }
  return kOk;
}

// The correction bit of a coefficient already nonzero: where set and the
// bit al of its magnitude is not, its magnitude grows by 2^al.
inline void refine(BitReader& b, int16_t& c, int32_t p1, int32_t m1) {
  if (b.get(1) && !(c & p1)) c = as_jcoef(c + (c >= 0 ? p1 : m1));
}

// A progressive AC refine scan's block (decode_mcu_AC_refine): each code
// places one new coefficient of magnitude 2^al after r zero ones (or
// skips 16 zeros, or starts an end-of-band run), and every nonzero
// coefficient passed on the way takes a correction bit; in an end-of-band
// run the rest of the band's nonzero coefficients take theirs.
Fault decode_ac_refine(BitReader& b, const Huffman& ac, int ss, int se, int al,
                       int32_t& eobrun, int16_t* blk) {
  const int32_t p1 = 1 << al, m1 = -(1 << al);
  int k = ss;
  if (eobrun == 0) {
    for (; k <= se; ++k) {
      int s;
      if (!huff_decode(b, ac, s)) return kBadAc;
      int r = s >> 4;
      s &= 15;
      int32_t value = 0;
      if (s) {
        if (s != 1) return kBadRefine;
        value = b.get(1) ? p1 : m1;
      } else if (r != 15) {
        eobrun = (1 << r) + static_cast<int32_t>(b.get(r));
        break;
      }
      do {
        if (blk[k]) {
          refine(b, blk[k], p1, m1);
        } else if (--r < 0) {
          break;
        }
        ++k;
      } while (k <= se);
      if (value) {
        if (k > se) return kPastBand;
        blk[k] = as_jcoef(value);
      }
    }
  }
  if (eobrun > 0) {
    for (; k <= se; ++k)
      if (blk[k]) refine(b, blk[k], p1, m1);
    --eobrun;
  }
  return kOk;
}

// One scan's header as io/jpeg.py hands it over; per slot, in an
// arithmetic-coded frame, its DC and AC conditioning tables and their
// values L, U (DC) and Kx (AC).
struct ScanDesc {
  int n, comp[4], ss, se, ah, al, restart;
  int64_t offset, length;
  int cond[4][5];
};

// jaricom.c's jpeg_aritab (T.81 Table D.2) as (Qe << 16) | (next state after
// an MPS << 8) | (an LPS switches the MPS << 7) | next state after an LPS;
// state 113 is the fixed one-half estimate of sign and refinement bits.
#define V(qe, lps, mps, sw) ((static_cast<uint32_t>(qe) << 16) | ((mps) << 8) | ((sw) << 7) | (lps))
constexpr uint32_t kQe[114] = {
    V(0x5A1D, 1, 1, 1),     V(0x2586, 14, 2, 0),    V(0x1114, 16, 3, 0),    V(0x080B, 18, 4, 0),
    V(0x03D8, 20, 5, 0),    V(0x01DA, 23, 6, 0),    V(0x00E5, 25, 7, 0),    V(0x006F, 28, 8, 0),
    V(0x0036, 30, 9, 0),    V(0x001A, 33, 10, 0),   V(0x000D, 35, 11, 0),   V(0x0006, 9, 12, 0),
    V(0x0003, 10, 13, 0),   V(0x0001, 12, 13, 0),   V(0x5A7F, 15, 15, 1),   V(0x3F25, 36, 16, 0),
    V(0x2CF2, 38, 17, 0),   V(0x207C, 39, 18, 0),   V(0x17B9, 40, 19, 0),   V(0x1182, 42, 20, 0),
    V(0x0CEF, 43, 21, 0),   V(0x09A1, 45, 22, 0),   V(0x072F, 46, 23, 0),   V(0x055C, 48, 24, 0),
    V(0x0406, 49, 25, 0),   V(0x0303, 51, 26, 0),   V(0x0240, 52, 27, 0),   V(0x01B1, 54, 28, 0),
    V(0x0144, 56, 29, 0),   V(0x00F5, 57, 30, 0),   V(0x00B7, 59, 31, 0),   V(0x008A, 60, 32, 0),
    V(0x0068, 62, 33, 0),   V(0x004E, 63, 34, 0),   V(0x003B, 32, 35, 0),   V(0x002C, 33, 9, 0),
    V(0x5AE1, 37, 37, 1),   V(0x484C, 64, 38, 0),   V(0x3A0D, 65, 39, 0),   V(0x2EF1, 67, 40, 0),
    V(0x261F, 68, 41, 0),   V(0x1F33, 69, 42, 0),   V(0x19A8, 70, 43, 0),   V(0x1518, 72, 44, 0),
    V(0x1177, 73, 45, 0),   V(0x0E74, 74, 46, 0),   V(0x0BFB, 75, 47, 0),   V(0x09F8, 77, 48, 0),
    V(0x0861, 78, 49, 0),   V(0x0706, 79, 50, 0),   V(0x05CD, 48, 51, 0),   V(0x04DE, 50, 52, 0),
    V(0x040F, 50, 53, 0),   V(0x0363, 51, 54, 0),   V(0x02D4, 52, 55, 0),   V(0x025C, 53, 56, 0),
    V(0x01F8, 54, 57, 0),   V(0x01A4, 55, 58, 0),   V(0x0160, 56, 59, 0),   V(0x0125, 57, 60, 0),
    V(0x00F6, 58, 61, 0),   V(0x00CB, 59, 62, 0),   V(0x00AB, 61, 63, 0),   V(0x008F, 61, 32, 0),
    V(0x5B12, 65, 65, 1),   V(0x4D04, 80, 66, 0),   V(0x412C, 81, 67, 0),   V(0x37D8, 82, 68, 0),
    V(0x2FE8, 83, 69, 0),   V(0x293C, 84, 70, 0),   V(0x2379, 86, 71, 0),   V(0x1EDF, 87, 72, 0),
    V(0x1AA9, 87, 73, 0),   V(0x174E, 72, 74, 0),   V(0x1424, 72, 75, 0),   V(0x119C, 74, 76, 0),
    V(0x0F6B, 74, 77, 0),   V(0x0D51, 75, 78, 0),   V(0x0BB6, 77, 79, 0),   V(0x0A40, 77, 48, 0),
    V(0x5832, 80, 81, 1),   V(0x4D1C, 88, 82, 0),   V(0x438E, 89, 83, 0),   V(0x3BDD, 90, 84, 0),
    V(0x34EE, 91, 85, 0),   V(0x2EAE, 92, 86, 0),   V(0x299A, 93, 87, 0),   V(0x2516, 86, 71, 0),
    V(0x5570, 88, 89, 1),   V(0x4CA9, 95, 90, 0),   V(0x44D9, 96, 91, 0),   V(0x3E22, 97, 92, 0),
    V(0x3824, 99, 93, 0),   V(0x32B4, 99, 94, 0),   V(0x2E17, 93, 86, 0),   V(0x56A8, 95, 96, 1),
    V(0x4F46, 101, 97, 0),  V(0x47E5, 102, 98, 0),  V(0x41CF, 103, 99, 0),  V(0x3C3D, 104, 100, 0),
    V(0x375E, 99, 93, 0),   V(0x5231, 105, 102, 0), V(0x4C0F, 106, 103, 0), V(0x4639, 107, 104, 0),
    V(0x415E, 103, 99, 0),  V(0x5627, 105, 106, 1), V(0x50E7, 108, 107, 0), V(0x4B85, 109, 103, 0),
    V(0x5597, 110, 109, 0), V(0x504F, 111, 107, 0), V(0x5A10, 110, 111, 1), V(0x5522, 112, 109, 0),
    V(0x59EB, 112, 111, 1), V(0x5A1D, 113, 113, 0)};
#undef V
constexpr uint8_t kFixedBin = 113;
// Tables F.4 and F.5: a DC table's bins (contexts at 0, 4, 8, 12, 16; the
// categories X1.. at 20), an AC table's (coefficient k's at 3 (k - 1); the
// categories past the second at 189 up to Kx, at 217 past it)
constexpr int kDcBins = 64, kAcBins = 256, kDcX1 = 20, kAcXLow = 189, kAcXHigh = 217;

// jdarith.c's decoder over a scan's bytes: 0xFF 0x00 is a 0xFF byte, fill
// 0xFFs are skipped, and at a marker it supplies zeros until the caller
// steps over an RSTn marker.
struct ArithDecoder {
  const uint8_t* p;
  const uint8_t* end;
  int64_t c = 0, a = 0;
  int ct = -16;  // -16: the first decision reads two bytes
  bool at_marker = false;

  int byte() {
    if (at_marker || p >= end) return 0;
    const int data = *p++;
    if (data != 0xFF) return data;
    const uint8_t* q = p;
    while (q < end && *q == 0xFF) ++q;
    if (q < end && *q == 0) {
      p = q + 1;
      return 0xFF;
    }
    p = q - 1;  // the 0xFF before the marker's code
    at_marker = true;
    return 0;
  }

  // One decision in bin *st (the MPS in bit 7, the state below), which it
  // updates (T.81 D.2.4 to D.2.6).
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    const uint32_t e = kQe[sv & 0x7F];
    const int64_t qe = e >> 16;
    const int nl = e & 0xFF, nm = (e >> 8) & 0xFF;
    a -= qe;
    const int64_t temp = a << ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
      a = qe;
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  // Skip what the decoder left unread to the next marker (libjpeg's
  // next_marker), step over it if it is an RSTn, and start afresh.
  bool restart() {
    while (!at_marker && p < end) byte();
    if (p + 1 >= end || p[0] != 0xFF || p[1] < 0xD0 || p[1] > 0xD7) return false;
    p += 2;
    c = a = 0;
    ct = -16;
    at_marker = false;
    return true;
  }
};

// Figures F.23 and F.24: a nonzero value's magnitude less one, its category
// from bin st (an AC value's first two decisions from it), then from x1, its
// bits from the category's bin + 14; -1 past 15 bits.
int32_t arith_magnitude(ArithDecoder& d, uint8_t* stats, int st, int x1, bool ac) {
  int32_t m = d.decode(stats + st);
  if (m && (!ac || d.decode(stats + st))) {
    m <<= ac ? 1 : 0;
    st = x1;
    while (d.decode(stats + st)) {
      if ((m <<= 1) == 0x8000) return -1;
      ++st;
    }
  }
  int32_t v = m;
  st += 14;
  while (m >>= 1)
    if (d.decode(stats + st)) v |= m;
  return v;
}

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

// h1v2_fancy_upsample of output row `y` (w samples): 3/4 of its input row
// y / 2 and 1/4 of the row above (even y, bias 1) or below (odd y, bias
// 2), edge rows repeated.
void h1v2_fancy(const uint8_t* plane, int stride, int w, int h, int y, uint8_t* out) {
  const int sy = y / 2, odd = y % 2, oy = odd ? std::min(sy + 1, h - 1) : std::max(sy - 1, 0);
  const uint8_t* in = plane + static_cast<int64_t>(sy) * stride;
  const uint8_t* other = plane + static_cast<int64_t>(oy) * stride;
  for (int i = 0; i < w; ++i) out[i] = static_cast<uint8_t>((3 * in[i] + other[i] + 1 + odd) >> 2);
}

// Row `y` of a component at the image's sampling (`width` samples): its
// plane's own row where it is not downsampled, else that row upsampled
// into `buf` (at least `width` samples) by jdsample.c's method for the
// component's ratio.
const uint8_t* sampled_row(const Component& c, int hmax, int vmax, int width, int y,
                           uint8_t* buf) {
  const int stride = c.bw * 8, fx = hmax / c.hs, fy = vmax / c.vs;
  const uint8_t* in = c.plane.get() + static_cast<int64_t>(y / fy) * stride;
  if (fx == 1 && fy == 1) return in;
  if (fx == 1 && fy == 2) {
    h1v2_fancy(c.plane.get(), stride, c.w, c.h, y, buf);
  } else if (fx == 2 && fy <= 2 && c.w > 2) {
    if (fy == 1) h2v1_fancy(in, c.w, buf);
    else h2v2_fancy(c.plane.get(), stride, c.w, c.h, y, buf);
  } else {  // h2v1_upsample, h2v2_upsample, int_upsample: boxes
    for (int x = 0; x < width; ++x) buf[x] = in[x / fx];
  }
  return buf;
}

// A DCT scan's pass, and each unit's blocks: (slot in the scan, component,
// row, column in the MCU) per block; a scan of one component has one block
// a unit, over its own grid.
enum Pass { kSequential, kDcFirst, kDcRefine, kAcFirst, kAcRefine };
struct ScanPlan {
  struct Step {
    int j, k, v, u;
  };
  Pass pass = kSequential;
  std::vector<Step> steps;
  int64_t units;
  int n, mcux;

  ScanPlan(const ScanDesc& sd, bool progressive, int mcux_, int mcuy,
           const std::vector<Component>& comps)
      : n(sd.n), mcux(mcux_) {
    if (progressive) pass = sd.ss == 0 ? (sd.ah ? kDcRefine : kDcFirst) : (sd.ah ? kAcRefine : kAcFirst);
    for (int j = 0; j < sd.n; ++j) {
      const Component& c = comps[sd.comp[j]];
      for (int v = 0; v < (sd.n == 1 ? 1 : c.vs); ++v)
        for (int u = 0; u < (sd.n == 1 ? 1 : c.hs); ++u) steps.push_back({j, sd.comp[j], v, u});
    }
    const Component& one = comps[sd.comp[0]];
    units = sd.n == 1 ? static_cast<int64_t>(one.gw) * one.gh : static_cast<int64_t>(mcux) * mcuy;
  }

  // the coefficients of step st's block in unit m
  int16_t* block(std::vector<Component>& comps, const Step& st, int64_t m) const {
    Component& c = comps[st.k];
    const int64_t by = n == 1 ? m / c.gw : (m / mcux) * c.vs + st.v;
    const int64_t bx = n == 1 ? m % c.gw : (m % mcux) * c.hs + st.u;
    return c.coef.data() + (by * c.bw + bx) * 64;
  }
};

// Decode one scan into the components' coefficient planes.  Returns kOk,
// or the fault with the scan's bytes ending early as -1.
int decode_scan(const ScanDesc& sd, const uint8_t* tables, const uint8_t* coded, bool progressive,
                int mcux, int mcuy, std::vector<Component>& comps, const char** what) {
  Huffman dc[4], ac[4];
  for (int j = 0; j < sd.n; ++j) {
    const uint8_t* t = tables + static_cast<int64_t>(j) * 2 * 272;
    const bool needs_dc = sd.ss == 0 && (!progressive || sd.ah == 0), needs_ac = sd.se > 0;
    if ((needs_dc && !dc[j].build(t, t + 16)) || (needs_ac && !ac[j].build(t + 272, t + 288))) {
      *what = "JPEG Huffman table: more codes than its lengths hold";
      return 1;
    }
  }
  const ScanPlan plan(sd, progressive, mcux, mcuy, comps);
  const Pass kind = plan.pass;
  const int64_t units = plan.units;
  BitReader bits{coded + sd.offset, coded + sd.offset + sd.length};
  int32_t pred[4] = {0, 0, 0, 0}, eobrun = 0;
  for (int64_t m = 0; m < units; ++m) {
    if (sd.restart && m && m % sd.restart == 0) {
      if (!bits.restart()) {
        *what = "no RST marker where a restart interval ends";
        return 2;
      }
      std::fill(pred, pred + 4, 0);
      eobrun = 0;
    }
    for (const ScanPlan::Step& st : plan.steps) {
      int16_t* blk = plan.block(comps, st, m);
      Fault f = kOk;
      switch (kind) {
        case kSequential: f = decode_sequential(bits, dc[st.j], ac[st.j], pred[st.j], blk); break;
        case kDcFirst: f = decode_dc_first(bits, dc[st.j], sd.al, pred[st.j], blk); break;
        case kDcRefine:
          if (bits.get(1)) blk[0] = as_jcoef(blk[0] | (1 << sd.al));
          break;
        case kAcFirst: f = decode_ac_first(bits, ac[st.j], sd.ss, sd.se, sd.al, eobrun, blk); break;
        case kAcRefine: f = decode_ac_refine(bits, ac[st.j], sd.ss, sd.se, sd.al, eobrun, blk); break;
      }
      if (f != kOk) {
        *what = kFaults[f];
        return 2;
      }
      if (bits.used > bits.real) {
        *what = "ends early";
        return 2;
      }
    }
  }
  return 0;
}

// Decode one arithmetic-coded scan into the components' coefficient planes
// (jdarith.c's decode_mcu, decode_mcu_DC_first, _DC_refine, _AC_first and
// _AC_refine).  Returns kOk, or 2 with the fault in *what.
int decode_arith_scan(const ScanDesc& sd, const uint8_t* coded, bool progressive, int mcux,
                      int mcuy, std::vector<Component>& comps, const char** what) {
  const ScanPlan plan(sd, progressive, mcux, mcuy, comps);
  const Pass kind = plan.pass;
  const int64_t units = plan.units;
  ArithDecoder d{coded + sd.offset, coded + sd.offset + sd.length};
  uint8_t dc_stats[16][kDcBins], ac_stats[16][kAcBins], fixed = kFixedBin;
  int32_t pred[4] = {0, 0, 0, 0};
  int ctx[4] = {0, 0, 0, 0};
  const int32_t p1 = 1 << sd.al, m1 = -(1 << sd.al);
  for (int64_t m = 0; m < units; ++m) {
    if (m == 0 || (sd.restart && m % sd.restart == 0)) {
      if (m && !d.restart()) {
        *what = "no RST marker where a restart interval ends";
        return 2;
      }
      for (int j = 0; j < sd.n; ++j) {
        std::memset(dc_stats[sd.cond[j][0]], 0, kDcBins);
        std::memset(ac_stats[sd.cond[j][1]], 0, kAcBins);
      }
      std::fill(pred, pred + 4, 0);
      std::fill(ctx, ctx + 4, 0);
    }
    for (const ScanPlan::Step& stp : plan.steps) {
      int16_t* blk = plan.block(comps, stp, m);
      const int* cond = sd.cond[stp.j];
      if (kind == kSequential || kind == kDcFirst) {
        uint8_t* stats = dc_stats[cond[0]];
        int st = ctx[stp.j];
        if (!d.decode(stats + st)) {
          ctx[stp.j] = 0;
        } else {
          const int sign = d.decode(stats + st + 1);
          st += 2 + sign;
          const int32_t v = arith_magnitude(d, stats, st, kDcX1, false);
          if (v < 0) {
            *what = kFaults[kMagnitude];
            return 2;
          }
          const int32_t cat = v ? 1 << (31 - __builtin_clz(static_cast<uint32_t>(v))) : 0;
          if (cat < (1 << cond[2]) >> 1) ctx[stp.j] = 0;
          else if (cat > (1 << cond[3]) >> 1) ctx[stp.j] = 12 + 4 * sign;
          else ctx[stp.j] = 4 + 4 * sign;
          pred[stp.j] = (pred[stp.j] + (sign ? -(v + 1) : v + 1)) & 0xFFFF;
        }
        if (kind == kDcFirst) {
          blk[0] = as_jcoef(left_shift(pred[stp.j], sd.al));
        } else {
          std::memset(blk, 0, 64 * sizeof(int16_t));
          blk[0] = as_jcoef(pred[stp.j]);
        }
      }
      if (kind == kDcRefine) {
        if (d.decode(&fixed)) blk[0] = as_jcoef(blk[0] | p1);
      } else if (kind == kSequential || kind == kAcFirst) {
        uint8_t* stats = ac_stats[cond[1]];
        const int last = kind == kSequential ? 63 : sd.se;
        for (int k = kind == kSequential ? 1 : sd.ss; k <= last; ++k) {
          int st = 3 * (k - 1);
          if (d.decode(stats + st)) break;  // end of block
          while (!d.decode(stats + st + 1)) {
            st += 3;
            if (++k > last) {
              *what = kFaults[kSpectral];
              return 2;
            }
          }
          const int sign = d.decode(&fixed);
          const int32_t v = arith_magnitude(d, stats, st + 2, k <= cond[4] ? kAcXLow : kAcXHigh,
                                            true);
          if (v < 0) {
            *what = kFaults[kMagnitude];
            return 2;
          }
          blk[k] = as_jcoef(left_shift(sign ? -(v + 1) : v + 1, sd.al));
        }
      } else if (kind == kAcRefine) {
        uint8_t* stats = ac_stats[cond[1]];
        int kex = sd.se;
        while (kex > 0 && !blk[kex]) --kex;
        for (int k = sd.ss; k <= sd.se; ++k) {
          int st = 3 * (k - 1);
          if (k > kex && d.decode(stats + st)) break;  // end of band
          for (;;) {
            int16_t& coef = blk[k];
            if (coef) {
              if (d.decode(stats + st + 2)) coef = as_jcoef(coef + (coef < 0 ? m1 : p1));
              break;
            }
            if (d.decode(stats + st + 1)) {
              coef = as_jcoef(d.decode(&fixed) ? m1 : p1);
              break;
            }
            st += 3;
            if (++k > sd.se) {
              *what = kFaults[kSpectral];
              return 2;
            }
          }
        }
      }
    }
  }
  return 0;
}

// Decode one lossless scan into its components' planes: per sample (each
// component of the scan in turn) a Huffman-coded difference added modulo
// 2^16 to the prediction, the result shifted left by the point transform
// into the plane's 8 bits (jdlhuff.c, jdlossls.c).  `vals` holds each
// component's undifferenced samples (width x height).  Returns kOk, 1 with
// a bad table, or 2 with the fault in *what.
int decode_lossless_scan(const ScanDesc& sd, const uint8_t* tables, const uint8_t* coded,
                         int width, int height, std::vector<Component>& comps,
                         std::vector<std::vector<uint16_t>>& vals, const char** what) {
  Huffman dc[4];
  for (int j = 0; j < sd.n; ++j) {
    if (!dc[j].build(tables + static_cast<int64_t>(j) * 2 * 272,
                     tables + static_cast<int64_t>(j) * 2 * 272 + 16)) {
      *what = "JPEG Huffman table: more codes than its lengths hold";
      return 1;
    }
  }
  const int rows = sd.restart ? sd.restart / width : height;
  const int initial = 1 << (7 - sd.al);
  BitReader bits{coded + sd.offset, coded + sd.offset + sd.length};
  for (int y = 0; y < height; ++y) {
    const bool first = y % rows == 0;
    if (first && y && !bits.restart()) {
      *what = "no RST marker where a restart interval ends";
      return 2;
    }
    for (int x = 0; x < width; ++x) {
      for (int j = 0; j < sd.n; ++j) {
        int s;
        if (!huff_decode(bits, dc[j], s) || s > 16) {
          *what = kFaults[kBadDiff];
          return 2;
        }
        const int32_t diff = s == 16 ? 32768 : bits.receive_extend(s);
        if (bits.used > bits.real) {
          *what = "ends early";
          return 2;
        }
        uint16_t* row = vals[sd.comp[j]].data() + static_cast<int64_t>(y) * width;
        int32_t px;
        if (first) {
          px = x ? row[x - 1] : initial;
        } else if (x == 0) {
          px = row[-width];
        } else {
          const int32_t ra = row[x - 1], rb = row[x - width], rc = row[x - 1 - width];
          switch (sd.ss) {
            case 1: px = ra; break;
            case 2: px = rb; break;
            case 3: px = rc; break;
            case 4: px = ra + rb - rc; break;
            case 5: px = ra + ((rb - rc) >> 1); break;
            case 6: px = rb + ((ra - rc) >> 1); break;
            default: px = (ra + rb) >> 1; break;
          }
        }
        row[x] = static_cast<uint16_t>((diff + px) & 0xFFFF);
      }
    }
  }
  for (int j = 0; j < sd.n; ++j) {
    Component& c = comps[sd.comp[j]];
    const int stride = c.bw * 8;
    const uint16_t* v = vals[sd.comp[j]].data();
    for (int y = 0; y < height; ++y)
      for (int x = 0; x < width; ++x)
        c.plane[static_cast<int64_t>(y) * stride + x] =
            static_cast<uint8_t>(v[static_cast<int64_t>(y) * width + x] << sd.al);
  }
  return 0;
}

inline uint8_t clamp255(int64_t v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

}  // namespace

extern "C" {

// Decode the `nscans` scans of a `width` x `height` frame of `ncomp` (1, 3
// or 4) components into `out`: height x width x 3 RGB for 3 components
// (`colour` 1: YCbCr, 2: RGB) and for 4 (3: CMYK, 4: YCCK, through
// Pillow's conversion), height x width for 1 (`colour` 0).  Per component
// k: sampling factors hs[k], vs[k] (1 for a single component), its 64
// quantization values in natural order at quant[64k].  Per scan i, 32
// values at scans[32i]: its component count n, their indices (4 slots),
// ss, se, ah, al, its restart interval in units (0: none), the offset and
// length of its entropy-coded bytes (RSTn markers included) in `coded`,
// and per slot j at 12 + 5j its DC and AC conditioning tables and their L,
// U and Kx; at tables[2176i + 544j] the DC then the AC Huffman table of its
// slot j, each 16 code counts and 256 symbols.  `coding`: bit 0 for a
// progressive frame (jdphuff.c's or jdarith.c's passes), bit 1 for an
// arithmetic-coded one, 4 for a lossless one (ss the predictor, al the
// point transform, every component at 1x1).  Returns 0; or 1 with a
// message in `err`, and in `fault_scan` the scan whose decode failed (-1
// for none).
int icat_jpeg_decode(int width, int height, int ncomp, int colour, int coding,
                     const int32_t* hs, const int32_t* vs, const int32_t* quant, int nscans,
                     const int64_t* scans, const uint8_t* tables, const uint8_t* coded,
                     uint8_t* out, int* fault_scan, char* err, int err_len) {
  *fault_scan = -1;
  const bool progressive = coding & 1, arithmetic = coding & 2, lossless = coding == 4;
  if ((ncomp != 1 && ncomp != 3 && ncomp != 4) || width <= 0 || height <= 0 ||
      colour < 0 || colour > 4 || (ncomp == 1) != (colour == 0) ||
      (ncomp == 4) != (colour >= 3)) {
    set_error(err, err_len, "JPEG frame: bad size, component count or colour space");
    return 1;
  }
  int hmax = 1, vmax = 1;
  for (int k = 0; k < ncomp; ++k) {
    if (hs[k] < 1 || hs[k] > 4 || vs[k] < 1 || vs[k] > 4) {
      set_error(err, err_len, "JPEG frame: sampling factors outside 1 to 4");
      return 1;
    }
    hmax = hs[k] > hmax ? hs[k] : hmax;
    vmax = vs[k] > vmax ? vs[k] : vmax;
  }
  for (int k = 0; k < ncomp; ++k) {
    if (hmax % hs[k] || vmax % vs[k]) {
      set_error(err, err_len, "JPEG frame: a sampling factor not a whole fraction of the largest");
      return 1;
    }
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
    c.gw = (c.w + 7) / 8;
    c.gh = (c.h + 7) / 8;
    c.quant = quant + 64 * k;
    if (lossless) {
      if (c.hs != 1 || c.vs != 1) {
        set_error(err, err_len, "JPEG lossless frame: a component not at 1x1");
        return 1;
      }
      c.plane.reset(new uint8_t[static_cast<size_t>(c.bh) * 8 * static_cast<size_t>(c.bw) * 8]());
    } else {
      c.coef.assign(static_cast<size_t>(c.bh) * c.bw * 64, 0);
    }
  }
  std::vector<std::vector<uint16_t>> vals(lossless ? static_cast<size_t>(ncomp) : 0,
                                          std::vector<uint16_t>(static_cast<size_t>(width) * height));
  for (int i = 0; i < nscans; ++i) {
    const int64_t* s = scans + 32 * static_cast<int64_t>(i);
    ScanDesc sd{static_cast<int>(s[0]), {0, 0, 0, 0}, static_cast<int>(s[5]),
                static_cast<int>(s[6]), static_cast<int>(s[7]), static_cast<int>(s[8]),
                static_cast<int>(s[9]), s[10], s[11], {}};
    bool ok = sd.n >= 1 && sd.n <= 4 && sd.ss >= 0 && sd.se <= 63 && sd.ss <= sd.se &&
              sd.al >= 0 && sd.al <= 13;
    if (lossless)
      ok = sd.n >= 1 && sd.n <= 4 && sd.ss >= 1 && sd.ss <= 7 && sd.al >= 0 && sd.al <= 7 &&
           (sd.restart == 0 || sd.restart % width == 0);
    for (int j = 0; ok && j < sd.n; ++j) {
      sd.comp[j] = static_cast<int>(s[1 + j]);
      ok = sd.comp[j] >= 0 && sd.comp[j] < ncomp;
      for (int t = 0; t < 5; ++t) sd.cond[j][t] = static_cast<int>(s[12 + 5 * j + t]);
      ok = ok && (!arithmetic || (sd.cond[j][0] >= 0 && sd.cond[j][0] < 16 && sd.cond[j][1] >= 0 &&
                                  sd.cond[j][1] < 16 && sd.cond[j][2] >= 0 &&
                                  sd.cond[j][2] <= sd.cond[j][3] && sd.cond[j][3] <= 15));
    }
    if (!ok) {
      set_error(err, err_len, "JPEG scan header out of range");
      return 1;
    }
    const char* what = "";
    const uint8_t* t = tables + 2176 * static_cast<int64_t>(i);
    const int rc = lossless ? decode_lossless_scan(sd, t, coded, width, height, comps, vals, &what)
                   : arithmetic ? decode_arith_scan(sd, coded, progressive, mcux, mcuy, comps, &what)
                                : decode_scan(sd, t, coded, progressive, mcux, mcuy, comps, &what);
    if (rc) {
      set_error(err, err_len, what);
      if (rc == 2) *fault_scan = i;
      return 1;
    }
  }

  int64_t coef[64];
  for (Component& c : comps) {
    if (lossless) break;
    const int stride = c.bw * 8;
    c.plane.reset(new uint8_t[static_cast<size_t>(c.bh) * 8 * static_cast<size_t>(stride)]);
    for (int64_t b = 0; b < static_cast<int64_t>(c.bh) * c.bw; ++b) {
      const int16_t* zz = c.coef.data() + b * 64;
      for (int i = 0; i < 64; ++i)
        coef[kNatural[i]] = static_cast<int64_t>(zz[i]) * c.quant[kNatural[i]];
      const int64_t by = b / c.bw, bx = b % c.bw;
      idct_block(coef, c.plane.get() + by * 8 * stride + bx * 8, stride);
    }
  }

  const Component& y = comps[0];
  if (ncomp == 1) {
    for (int r = 0; r < height; ++r)
      std::memcpy(out + static_cast<int64_t>(r) * width,
                  y.plane.get() + static_cast<int64_t>(r) * y.bw * 8, static_cast<size_t>(width));
    return 0;
  }
  std::vector<std::vector<uint8_t>> bufs(static_cast<size_t>(ncomp));
  for (int k = 0; k < ncomp; ++k)
    bufs[k].resize(4 * static_cast<size_t>(comps[k].w) + static_cast<size_t>(width));
  const uint8_t* row[4];
  // jdcolor.c: FIX(x) = x * 65536 + 0.5, ONE_HALF = 1 << 15
  constexpr int64_t kR = 91881, kG_cb = 22554, kG_cr = 46802, kB = 116130, kHalf = 1 << 15;
  for (int r = 0; r < height; ++r) {
    for (int k = 0; k < ncomp; ++k)
      row[k] = sampled_row(comps[k], hmax, vmax, width, r, bufs[k].data());
    uint8_t* px = out + static_cast<int64_t>(r) * width * 3;
    for (int x = 0; x < width; ++x, px += 3) {
      if (colour >= 3) {
        int cmy[3];
        if (colour == 4) {  // ycck_cmyk_convert: 255 - the YCbCr's R, G, B
          const int64_t yy = row[0][x], b = row[1][x] - 128, c = row[2][x] - 128;
          cmy[0] = 255 - clamp255(yy + ((kR * c + kHalf) >> 16));
          cmy[1] = 255 - clamp255(yy + ((-kG_cb * b + kHalf - kG_cr * c) >> 16));
          cmy[2] = 255 - clamp255(yy + ((kB * b + kHalf) >> 16));
        } else {
          for (int ch = 0; ch < 3; ++ch) cmy[ch] = row[ch][x];
        }
        // Pillow's "CMYK;I" unpacking (v -> 255 - v), then Convert.c's
        // cmyk2rgb: 255 - K less MULDIV255(C, 255 - K), clipped
        const int nk = row[3][x];  // 255 - (255 - K)
        for (int ch = 0; ch < 3; ++ch) {
          const int tmp = (255 - cmy[ch]) * nk + 128;
          px[ch] = clamp255(nk - (((tmp >> 8) + tmp) >> 8));
        }
      } else if (colour == 2) {
        for (int ch = 0; ch < 3; ++ch) px[ch] = row[ch][x];
      } else {
        const int64_t yy = row[0][x], b = row[1][x] - 128, c = row[2][x] - 128;
        px[0] = clamp255(yy + ((kR * c + kHalf) >> 16));
        px[1] = clamp255(yy + ((-kG_cb * b + kHalf - kG_cr * c) >> 16));
        px[2] = clamp255(yy + ((kB * b + kHalf) >> 16));
      }
    }
  }
  return 0;
}

}  // extern "C"
