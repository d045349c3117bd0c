// TIFF samples (host C++): the strips or tiles of a TIFF's first image,
// decompressed and put together as what libtiff and Pillow's own raw
// reader give Pillow.
//
// Role: io/tiff.py reads the header and the first IFD (classic TIFF or
// BigTIFF, either byte order), picks the mode Pillow opens the file as,
// inflates Deflate chunks with CPython's zlib, reverses the bits of fill
// order 2 and hands this file every strip or tile; kernels/_build.py
// compiles it with g++ into _build/libicat_tiff-<hash>.so on first use,
// and io/tiff.py loads it with ctypes and turns the samples into Pillow's
// convert("RGB").  Done here, for each chunk (a strip of `ch` rows, the
// last one cut at the image's foot, or a `cw` x `ch` tile; all samples of
// a pixel, or one sample plane of PlanarConfiguration 2):
//
//   * decompression to rows x ceil(cw * samples * bits / 8) bytes:
//     none (the bytes as they are), PackBits (libtiff's PackBitsDecode: a
//     run or a literal past the chunk's end clipped, a no-op code 128 skipped) or
//     LZW (libtiff's LZWDecode: codes MSB first, 9 to 12 bits, the code
//     width growing as the table reaches 511, 1023 and 2047 entries, a
//     clear code first, the table growing to 5119 entries, a string cut
//     where the chunk fills); a chunk the data leaves short raises, as
//     libtiff's "Not enough data" does;
//   * horizontal differencing undone (Predictor 2, LZW and Deflate only)
//     on 8-bit samples or on 16-bit ones in the file's byte order, each
//     sample from the one `samples` before it in its row;
//   * samples of 1, 2 or 4 bits unpacked from each byte's high bits, 8
//     bits as they are, 16 bits in the file's byte order;
//   * each chunk's samples written to its place in the (height, width,
//     spp) output, tiles cut at the right and bottom edges.
//
// Every read and write is bounds-checked.  Exposed as a C ABI for ctypes.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

void set_error(char* err, int len, const char* msg) {
  if (err && len > 0) std::snprintf(err, static_cast<size_t>(len), "%s", msg);
}

// libtiff's PackBitsDecode into out[0:occ]; false where the data runs out
// first.
bool unpack_bits(const uint8_t* in, int64_t cc, uint8_t* out, int64_t occ) {
  while (cc > 0 && occ > 0) {
    int n = *in++;
    --cc;
    if (n >= 128) n -= 256;
    if (n < 0) {  // the next byte -n + 1 times
      if (n == -128) continue;
      int64_t run = -n + 1;
      if (run > occ) run = occ;
      if (cc == 0) break;
      std::memset(out, *in++, static_cast<size_t>(run));
      --cc;
      out += run;
      occ -= run;
    } else {  // the next n + 1 bytes as they are
      int64_t run = n + 1;
      if (run > occ) run = occ;
      if (cc < run) break;
      std::memcpy(out, in, static_cast<size_t>(run));
      out += run;
      occ -= run;
      in += run;
      cc -= run;
    }
  }
  return occ == 0;
}

// libtiff's LZWDecode (new-style codes) into out[0:occ].  Returns null, or
// what went wrong.
const char* lzw(const uint8_t* in, int64_t cc, uint8_t* out, int64_t occ) {
  constexpr int kClear = 256, kEoi = 257, kFirst = 258, kMaxBits = 12;
  constexpr int kSize = (1 << kMaxBits) - 1 + 1024;  // libtiff's CSIZE
  struct Entry {
    int next;  // the code of the string less its last byte; -1: none
    int length;
    uint8_t value, first;
  };
  std::vector<Entry> tab(kSize);
  for (int i = 0; i < 256; ++i) tab[i] = {-1, 1, static_cast<uint8_t>(i), static_cast<uint8_t>(i)};
  int64_t bitsleft = cc * 8;
  uint64_t data = 0;
  int nbits = 9, databits = 0, free_ent = kFirst, old = -1;
  auto reset = [&]() {
    for (int i = kClear; i < kSize; ++i) tab[i] = {-1, 0, 0, 0};
    free_ent = kFirst;
    nbits = 9;
  };
  auto next_code = [&]() -> int {
    if (bitsleft < nbits) return kEoi;  // libtiff: "not terminated with EOI code"
    while (databits < nbits) {
      data = (data << 8) | *in++;
      databits += 8;
    }
    const int code = static_cast<int>((data >> (databits - nbits)) & ((1u << nbits) - 1));
    databits -= nbits;
    bitsleft -= nbits;
    return code;
  };
  reset();
  while (occ > 0) {
    int code = next_code();
    if (code == kEoi) break;
    if (code == kClear) {
      do {
        reset();
        code = next_code();
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kClear) return "TIFF LZW: a code past the table after a clear code";
      *out++ = static_cast<uint8_t>(code);
      --occ;
      old = code;
      continue;
    }
    if (old < 0) return "TIFF LZW: the strip does not start with a clear code";
    if (free_ent >= kSize) return "TIFF LZW: the code table overflows";
    Entry& e = tab[free_ent];
    e.next = old;
    e.first = tab[old].first;
    e.length = tab[old].length + 1;
    e.value = code < free_ent ? tab[code].first : e.first;
    if (++free_ent > (1 << nbits) - 2 && nbits < kMaxBits) ++nbits;
    old = code;
    if (code >= 256) {
      const int len = tab[code].length;
      if (len == 0) return "TIFF LZW: a code not yet in the table";
      // the string's bytes, last first; only its first occ fit
      int c = code;
      for (int k = len - 1; k >= 0; --k) {
        if (k < occ) out[k] = tab[c].value;
        c = tab[c].next;
      }
      const int64_t n = len < occ ? len : occ;
      out += n;
      occ -= n;
    } else {
      *out++ = static_cast<uint8_t>(code);
      --occ;
    }
  }
  return occ > 0 ? "TIFF LZW: not enough data for the strip" : nullptr;
}

}  // namespace

extern "C" {

// The samples of a TIFF image, (height, width, spp) uint16 into `out`.
// `data` holds the `nchunks` strips or tiles, chunk i at data[offsets[i]:
// offsets[i] + lengths[i]], compressed by `compression` (1: none, the
// chunk's whole decompressed size; 5: LZW; 32773: PackBits).  A chunk is
// `ch` rows of `cw` pixels (strips: cw = width, the last strip cut at the
// foot; tiles: whole tiles, cut here at the edges), of all `spp` samples
// (planar 1) or one (planar 2: the chunks of sample 0, then of 1, ...),
// `bits` (1, 2, 4, 8, 16) each, 16-bit ones big-endian where `big`;
// `predictor` 2 undoes horizontal differencing.  Returns 0, or 1 with a
// message in `err`.
int icat_tiff_decode(const uint8_t* data, const int64_t* offsets, const int64_t* lengths,
                     int64_t data_len, int nchunks, int compression, int width, int height,
                     int cw, int ch, int tiled, int planar, int spp, int bits, int predictor,
                     int big, uint16_t* out, char* err, int err_len) {
  if (width <= 0 || height <= 0 || cw <= 0 || ch <= 0 || spp < 1 || spp > 8 ||
      !(bits == 1 || bits == 2 || bits == 4 || bits == 8 || bits == 16) ||
      (planar != 1 && planar != 2) || (predictor == 2 && bits < 8) ||
      (compression != 1 && compression != 5 && compression != 32773)) {
    set_error(err, err_len, "TIFF layout out of range");
    return 1;
  }
  const int per = planar == 2 ? 1 : spp;  // samples a pixel in a chunk
  const int across = tiled ? (width + cw - 1) / cw : 1;
  const int down = (height + ch - 1) / ch;
  const int64_t planes = planar == 2 ? spp : 1;
  if (static_cast<int64_t>(across) * down * planes > nchunks) {
    set_error(err, err_len, "TIFF has fewer strips or tiles than its image needs");
    return 1;
  }
  const int64_t row_bytes = (static_cast<int64_t>(cw) * per * bits + 7) / 8;
  std::vector<uint8_t> buf;
  for (int64_t p = 0; p < planes; ++p) {
    for (int ty = 0; ty < down; ++ty) {
      for (int tx = 0; tx < across; ++tx) {
        const int64_t i = (p * down + ty) * across + tx;
        const int y0 = ty * ch, x0 = tx * cw;
        const int rows = tiled ? ch : (height - y0 < ch ? height - y0 : ch);
        const int64_t size = row_bytes * rows;
        if (offsets[i] < 0 || lengths[i] < 0 || offsets[i] > data_len ||
            lengths[i] > data_len - offsets[i]) {
          set_error(err, err_len, "TIFF strip or tile lies outside the data");
          return 1;
        }
        const uint8_t* in = data + offsets[i];
        buf.assign(static_cast<size_t>(size), 0);
        if (compression == 1) {
          if (lengths[i] != size) {
            set_error(err, err_len, "TIFF strip or tile is not the size its rows need");
            return 1;
          }
          std::memcpy(buf.data(), in, static_cast<size_t>(size));
        } else if (compression == 32773) {
          if (!unpack_bits(in, lengths[i], buf.data(), size)) {
            set_error(err, err_len, "TIFF PackBits: not enough data for the strip");
            return 1;
          }
        } else if (const char* what = lzw(in, lengths[i], buf.data(), size)) {
          set_error(err, err_len, what);
          return 1;
        }
        for (int r = 0; r < rows; ++r) {
          uint8_t* row = buf.data() + r * row_bytes;
          if (predictor == 2 && bits == 8) {
            for (int64_t k = per; k < static_cast<int64_t>(cw) * per; ++k)
              row[k] = static_cast<uint8_t>(row[k] + row[k - per]);
          } else if (predictor == 2) {
            const int hi = big ? 0 : 1, lo = 1 - hi;
            for (int64_t k = per; k < static_cast<int64_t>(cw) * per; ++k) {
              uint8_t* s = row + 2 * k;
              const uint8_t* prev = s - 2 * per;
              const unsigned v = ((s[hi] << 8) | s[lo]) + ((prev[hi] << 8) | prev[lo]);
              s[hi] = static_cast<uint8_t>(v >> 8);
              s[lo] = static_cast<uint8_t>(v);
            }
          }
          const int y = y0 + r;
          if (y >= height) break;
          for (int x = 0; x < cw && x0 + x < width; ++x) {
            uint16_t* px = out + (static_cast<int64_t>(y) * width + x0 + x) * spp + p;
            for (int j = 0; j < per; ++j) {
              const int64_t k = static_cast<int64_t>(x) * per + j;
              unsigned v;
              if (bits == 16) {
                v = big ? (row[2 * k] << 8) | row[2 * k + 1] : row[2 * k] | (row[2 * k + 1] << 8);
              } else if (bits == 8) {
                v = row[k];
              } else {
                const int64_t bit = k * bits;
                v = (row[bit >> 3] >> (8 - bits - (bit & 7))) & ((1u << bits) - 1);
              }
              px[j] = static_cast<uint16_t>(v);
            }
          }
        }
      }
    }
  }
  return 0;
}

}  // extern "C"
