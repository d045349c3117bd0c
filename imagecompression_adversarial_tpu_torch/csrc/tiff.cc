// TIFF samples (host C++): the strips or tiles of a TIFF's first image,
// decompressed and put together as what libtiff and Pillow's own raw
// reader give Pillow.
//
// Role: io/tiff.py reads the header and the first IFD (classic TIFF or
// BigTIFF, either byte order), picks the mode Pillow opens the file as,
// inflates Deflate, Zstandard and LZMA chunks with CPython's zlib, the
// system's libzstd and CPython's lzma, decodes JPEG chunks with
// csrc/jpeg.cc, reverses the bits of fill order 2 and hands this file
// every other strip or tile; kernels/_build.py compiles it with g++ into
// _build/libicat_tiff-<hash>.so on first use, and io/tiff.py loads it
// with ctypes and turns the samples into Pillow's convert("RGB").  Done
// here, for each chunk (a strip of `ch` rows, the last one cut at the
// image's foot, or a `cw` x `ch` tile; all samples of a pixel, or one
// sample plane of PlanarConfiguration 2):
//
//   * decompression to rows x ceil(cw * samples * bits / 8) bytes:
//     none (the bytes as they are), PackBits (libtiff's PackBitsDecode: a
//     run or a literal past the chunk's end clipped, a no-op code 128 skipped),
//     LZW (libtiff's LZWDecode: codes MSB first, 9 to 12 bits, the code
//     width growing as the table reaches 511, 1023 and 2047 entries, a
//     clear code first, the table growing to 5119 entries, a string cut
//     where the chunk fills), or CCITT modified Huffman (RLE), Group 3
//     (1-D or 2-D) and Group 4 (tif_fax3.c's Fax3DecodeRLE, Fax3Decode1D,
//     Fax3Decode2D and Fax4Decode: its lookup tables, bit reader, run
//     arrays and their clean-up, its fill of the rows; a fault in the
//     codes is reported, not repaired); a chunk the data leaves short
//     raises, as libtiff's "Not enough data" does;
//   * horizontal differencing undone (Predictor 2) on 8-bit samples or on
//     16- and 32-bit ones in the file's byte order, each sample from the
//     one `samples` before it in its row; libtiff's floating-point
//     predictor (Predictor 3, fpAcc) on 32-bit samples: the row's bytes
//     summed `samples` apart, then each sample's four bytes gathered from
//     the row's four byte planes, most significant first;
//   * samples of 1, 2, 4 or 12 bits unpacked MSB first, 8 bits as they
//     are, 16 and 32 bits in the file's byte order;
//   * subsampled YCbCr (`ycbcr_h` x `ycbcr_v` luma samples, then Cb and
//     Cr, a data unit) spread over the pixels as tif_getimage.c's
//     putcontig8bitYCbCr{12,21,22,41,42,44}tile spread them: every pixel of
//     a unit takes its own luma and the unit's Cb and Cr;
//   * each chunk's samples written to its place in the (height, width,
//     spp) output, tiles cut at the right and bottom edges.
//
// Every read and write is bounds-checked.  Exposed as a C ABI for ctypes.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
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


// ---- CCITT (tif_fax3.c) ----

const char* const kWhiteTerm[] = {
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111", "10011", "10100",
    "00111", "01000", "001000", "000011", "110100", "110101", "101010", "101011", "0100111",
    "0001100", "0001000", "0010111", "0000011", "0000100", "0101000", "0101011", "0010011",
    "0100100", "0011000", "00000010", "00000011", "00011010", "00011011", "00010010", "00010011",
    "00010100", "00010101", "00010110", "00010111", "00101000", "00101001", "00101010",
    "00101011", "00101100", "00101101", "00000100", "00000101", "00001010", "00001011",
    "01010010", "01010011", "01010100", "01010101", "00100100", "00100101", "01011000",
    "01011001", "01011010", "01011011", "01001010", "01001011", "00110010", "00110011",
    "00110100",
};
const char* const kWhiteMakeUp[] = {
    "11011", "10010", "010111", "0110111", "00110110", "00110111", "01100100", "01100101",
    "01101000", "01100111", "011001100", "011001101", "011010010", "011010011", "011010100",
    "011010101", "011010110", "011010111", "011011000", "011011001", "011011010", "011011011",
    "010011000", "010011001", "010011010", "011000", "010011011",
};
const char* const kBlackTerm[] = {
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011", "000101", "000100",
    "0000100", "0000101", "0000111", "00000100", "00000111", "000011000", "0000010111",
    "0000011000", "0000001000", "00001100111", "00001101000", "00001101100", "00000110111",
    "00000101000", "00000010111", "00000011000", "000011001010", "000011001011", "000011001100",
    "000011001101", "000001101000", "000001101001", "000001101010", "000001101011",
    "000011010010", "000011010011", "000011010100", "000011010101", "000011010110",
    "000011010111", "000001101100", "000001101101", "000011011010", "000011011011",
    "000001010100", "000001010101", "000001010110", "000001010111", "000001100100",
    "000001100101", "000001010010", "000001010011", "000000100100", "000000110111",
    "000000111000", "000000100111", "000000101000", "000001011000", "000001011001",
    "000000101011", "000000101100", "000001011010", "000001100110", "000001100111",
};
const char* const kBlackMakeUp[] = {
    "0000001111", "000011001000", "000011001001", "000001011011", "000000110011", "000000110100",
    "000000110101", "0000001101100", "0000001101101", "0000001001010", "0000001001011",
    "0000001001100", "0000001001101", "0000001110010", "0000001110011", "0000001110100",
    "0000001110101", "0000001110110", "0000001110111", "0000001010010", "0000001010011",
    "0000001010100", "0000001010101", "0000001011010", "0000001011011", "0000001100100",
    "0000001100101",
};
const char* const kExtMakeUp[] = {
    "00000001000", "00000001100", "00000001101", "000000010010", "000000010011", "000000010100",
    "000000010101", "000000010110", "000000010111", "000000011100", "000000011101",
    "000000011110", "000000011111",
};

// the states of tif_fax3.h's lookup tables
enum { S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB, S_MakeUpW,
       S_MakeUpB, S_MakeUp, S_EOL };

struct TabEnt {
  uint8_t state = S_Null, width = 0;
  int32_t param = 0;
};

// A table of 2**wid entries indexed by the next `wid` bits, the first in
// the lowest bit (as mkg3states builds TIFFFaxMainTable, 7 bits;
// TIFFFaxWhiteTable, 12; TIFFFaxBlackTable, 13).
struct FaxTable {
  int wid;
  std::vector<TabEnt> ent;
  explicit FaxTable(int w) : wid(w), ent(size_t{1} << w) {}
  void fill(const char* code, uint8_t state, int32_t param) {
    const int n = static_cast<int>(std::strlen(code));
    unsigned rev = 0;
    for (int i = 0; i < n; ++i) rev |= static_cast<unsigned>(code[i] == '1') << i;
    for (unsigned hi = 0; hi < (1u << (wid - n)); ++hi) ent[rev | (hi << n)] = {state, static_cast<uint8_t>(n), param};
  }
};

struct FaxTables {
  FaxTable main{7}, white{12}, black{13};
  FaxTables() {
    main.fill("0001", S_Pass, 0);
    main.fill("001", S_Horiz, 0);
    main.fill("1", S_V0, 0);
    main.fill("011", S_VR, 1);
    main.fill("000011", S_VR, 2);
    main.fill("0000011", S_VR, 3);
    main.fill("010", S_VL, 1);
    main.fill("000010", S_VL, 2);
    main.fill("0000010", S_VL, 3);
    main.fill("0000001", S_Ext, 0);
    main.fill("0000000", S_EOL, 0);
    for (int i = 0; i < 64; ++i) white.fill(kWhiteTerm[i], S_TermW, i);
    for (int i = 0; i < 27; ++i) white.fill(kWhiteMakeUp[i], S_MakeUpW, 64 * (i + 1));
    for (int i = 0; i < 64; ++i) black.fill(kBlackTerm[i], S_TermB, i);
    for (int i = 0; i < 27; ++i) black.fill(kBlackMakeUp[i], S_MakeUpB, 64 * (i + 1));
    for (int i = 0; i < 13; ++i) {
      white.fill(kExtMakeUp[i], S_MakeUp, 1792 + 64 * i);
      black.fill(kExtMakeUp[i], S_MakeUp, 1792 + 64 * i);
    }
    white.fill("000000000001", S_EOL, 0);
    black.fill("000000000001", S_EOL, 0);
  }
};

const FaxTables& fax_tables() {
  static const FaxTables t;
  return t;
}

// What a CCITT chunk came to: decoded whole; libtiff decodes it with a
// warning (a bad code, a row of the wrong length; libtiff cleans the row
// up and goes on); libtiff fails on it (the data ends first, the run
// arrays overflow); or a Group 4 chunk that ends early after a whole row,
// which libtiff hands over as it stands.
enum FaxResult { kFaxOk = 0, kFaxWarned = 1, kFaxFailed = 2, kFaxCut = 3 };

// tif_fax3.c's decoder state for one chunk: its bit reader (BitAcc,
// BitsAvail: bytes MSB first, each taken into the accumulator's high end;
// past the data's end a lookup is padded with zeros while a bit is left),
// run arrays and counters.
class Fax {
 public:
  Fax(const uint8_t* in, int64_t cc, int compression, int options, int rowpixels)
      : cp_(in), ep_(in + cc), lastx_(rowpixels), t_(fax_tables()) {
    two_d_ = compression == 4 || (compression == 3 && (options & 1));
    nruns_ = ((static_cast<int64_t>(rowpixels) + 1 + 31) / 32) * 32 * (two_d_ ? 2 : 1);
    runs_.assign(static_cast<size_t>(2 * nruns_ + 2), 0);  // + the slots a full row's fill pads
  }

  // Decode `rows` rows of `rowbytes` bytes into `out` by the scheme of
  // `compression` (2: RLE, 3: Group 3, 4: Group 4).
  FaxResult decode(int compression, uint8_t* out, int rows, int64_t rowbytes) {
    cur_ = runs_.data();
    ref_ = two_d_ ? runs_.data() + nruns_ : nullptr;
    if (ref_) {
      ref_[0] = static_cast<uint32_t>(lastx_);
      ref_[1] = 0;
    }
    for (line_ = 0; line_ < rows; ++line_) {
      uint8_t* buf = out + line_ * rowbytes;
      a0_ = 0;
      run_length_ = 0;
      pa_ = cur_;
      if (compression == 2) {
        if (!expand_1d()) return kFaxFailed;
        fill(buf, cur_, pa_);
        clr(bits_ & 7);  // FAXMODE_BYTEALIGN: on to the next byte
        continue;
      }
      if (compression == 3) {
        if (!sync_eol()) return kFaxFailed;
        bool one_d = true;
        if (two_d_) {
          if (!need(1)) return kFaxFailed;
          one_d = get(1);
          clr(1);
          pb_ = ref_;
          b1_ = *pb_++;
        }
        if (!(one_d ? expand_1d() : expand_2d())) return kFaxFailed;
        fill(buf, cur_, pa_);
        if (two_d_) {
          if (pa_ < cur_ + nruns_ && !setvalue(0)) return kFaxFailed;
          std::swap(cur_, ref_);
        }
        continue;
      }
      pb_ = ref_;  // Group 4
      b1_ = *pb_++;
      const bool whole = expand_2d();
      if (overflow_) return kFaxFailed;
      if (!whole || eol_count_) return line_ ? kFaxCut : kFaxFailed;  // the data or an EOFB ends it
      fill(buf, cur_, pa_);
      if (!setvalue(0)) return kFaxFailed;
      std::swap(cur_, ref_);
    }
    return warned_ ? kFaxWarned : kFaxOk;
  }

 private:
  const uint8_t* cp_;
  const uint8_t* ep_;
  uint32_t acc_ = 0;
  int bits_ = 0;
  int lastx_;
  const FaxTables& t_;
  bool two_d_ = false, warned_ = false, overflow_ = false;
  int64_t nruns_ = 0;
  std::vector<uint32_t> runs_;
  uint32_t *cur_ = nullptr, *ref_ = nullptr, *pa_ = nullptr, *pb_ = nullptr;
  int a0_ = 0, b1_ = 0, run_length_ = 0, eol_count_ = 0;
  int64_t line_ = 0;

  // NeedBits8/NeedBits16: false where no bit is left
  bool need(int n) {
    if (bits_ < n) {
      if (cp_ >= ep_) {
        if (bits_ == 0) return false;
        bits_ = n;  // pad with zeros
      } else {
        acc_ |= static_cast<uint32_t>(rev8(*cp_++)) << bits_;
        if ((bits_ += 8) < n) {
          if (cp_ >= ep_) {
            bits_ = n;
          } else {
            acc_ |= static_cast<uint32_t>(rev8(*cp_++)) << bits_;
            bits_ += 8;
          }
        }
      }
    }
    return true;
  }
  static uint8_t rev8(uint8_t b) {
    b = static_cast<uint8_t>((b & 0xF0) >> 4 | (b & 0x0F) << 4);
    b = static_cast<uint8_t>((b & 0xCC) >> 2 | (b & 0x33) << 2);
    return static_cast<uint8_t>((b & 0xAA) >> 1 | (b & 0x55) << 1);
  }
  uint32_t get(int n) const { return acc_ & ((1u << n) - 1); }
  void clr(int n) {
    bits_ -= n;
    acc_ >>= n;
  }
  bool lookup(const FaxTable& tab, const TabEnt*& e) {
    if (!need(tab.wid)) return false;
    e = &tab.ent[get(tab.wid)];
    clr(e->width);
    return true;
  }

  bool setvalue(int x) {
    if (pa_ >= cur_ + nruns_) {
      overflow_ = true;
      return false;
    }
    *pa_++ = static_cast<uint32_t>(run_length_ + x);
    a0_ += x;
    run_length_ = 0;
    return true;
  }

  // CLEANUP_RUNS: close the row at lastx, whatever its runs summed to
  void cleanup_runs() {
    if (run_length_) setvalue(0);
    if (a0_ != lastx_) {
      warned_ = true;  // badlength
      while (a0_ > lastx_ && pa_ > cur_) a0_ -= static_cast<int>(*--pa_);
      if (a0_ < lastx_) {
        if (a0_ < 0) a0_ = 0;
        if ((pa_ - cur_) & 1) setvalue(0);
        setvalue(lastx_ - a0_);
      } else if (a0_ > lastx_) {
        setvalue(lastx_);
        setvalue(0);
      }
    }
  }

  // SYNC_EOL: skip to the end of the next EOL (after an EOL seen: the rest
  // of it)
  bool sync_eol() {
    if (eol_count_ == 0) {
      for (;;) {
        if (!need(11)) return false;
        if (get(11) == 0) break;
        clr(1);
      }
    }
    for (;;) {
      if (!need(8)) return false;
      if (get(8)) break;
      clr(8);
    }
    while (get(1) == 0) clr(1);
    clr(1);
    eol_count_ = 0;
    return true;
  }

  // one colour's run (make-up codes, then a terminating code); 0: done,
  // 1: an EOL or a bad code ended the row, -1: the data ended
  int run(const FaxTable& tab, uint8_t term, uint8_t makeup, bool one_d) {
    for (;;) {
      const TabEnt* e;
      if (!lookup(tab, e)) return -1;
      if (e->state == term) {
        if (!setvalue(e->param)) return -2;
        return 0;
      }
      if (e->state == makeup || e->state == S_MakeUp) {
        a0_ += e->param;
        run_length_ += e->param;
        continue;
      }
      if (one_d && e->state == S_EOL) {
        eol_count_ = 1;
        return 1;
      }
      warned_ = true;  // unexpected
      return 1;
    }
  }

  // EXPAND1D; false where the data ends first or the runs overflow
  bool expand_1d() {
    for (;;) {
      int r = run(t_.white, S_TermW, S_MakeUpW, true);
      if (r == 0 && a0_ < lastx_) r = run(t_.black, S_TermB, S_MakeUpB, true);
      if (r < 0) return false;  // the data ended, or the runs overflowed
      if (r == 1 || a0_ >= lastx_) break;
      if (*(pa_ - 1) == 0 && *(pa_ - 2) == 0) pa_ -= 2;
    }
    cleanup_runs();
    return !overflow_;
  }

  // CHECK_b1
  bool check_b1() {
    if (pa_ != cur_) {
      while (b1_ <= a0_ && b1_ < lastx_) {
        if (pb_ + 1 >= ref_ + nruns_) {
          overflow_ = true;
          return false;
        }
        b1_ += static_cast<int>(pb_[0] + pb_[1]);
        pb_ += 2;
      }
    }
    return true;
  }

  // EXPAND2D; false on a premature end of the data or an overflow
  bool expand_2d() {
    while (a0_ < lastx_) {
      if (pa_ >= cur_ + nruns_) {
        overflow_ = true;
        return false;
      }
      const TabEnt* e;
      if (!lookup(t_.main, e)) return false;
      switch (e->state) {
        case S_Pass:
          if (!check_b1()) return false;
          if (pb_ + 1 >= ref_ + nruns_) {
            overflow_ = true;
            return false;
          }
          b1_ += static_cast<int>(*pb_++);
          run_length_ += b1_ - a0_;
          a0_ = b1_;
          b1_ += static_cast<int>(*pb_++);
          break;
        case S_Horiz: {
          const bool black_first = (pa_ - cur_) & 1;
          int r = black_first ? run(t_.black, S_TermB, S_MakeUpB, false)
                              : run(t_.white, S_TermW, S_MakeUpW, false);
          if (r == 0)
            r = black_first ? run(t_.white, S_TermW, S_MakeUpW, false)
                            : run(t_.black, S_TermB, S_MakeUpB, false);
          if (r == -2) return false;
          if (r == -1) return false;
          if (r == 1) return eol_2d();
          if (!check_b1()) return false;
          break;
        }
        case S_V0:
        case S_VR:
          if (!check_b1()) return false;
          if (!setvalue(b1_ - a0_ + (e->state == S_VR ? e->param : 0))) return false;
          if (pb_ >= ref_ + nruns_) {
            overflow_ = true;
            return false;
          }
          b1_ += static_cast<int>(*pb_++);
          break;
        case S_VL:
          if (!check_b1()) return false;
          if (b1_ < a0_ + e->param) {
            warned_ = true;
            return eol_2d();
          }
          if (!setvalue(b1_ - a0_ - e->param)) return false;
          b1_ -= static_cast<int>(*--pb_);
          break;
        case S_Ext:
          *pa_++ = static_cast<uint32_t>(lastx_ - a0_);
          warned_ = true;  // uncompressed data: not supported by libtiff
          return eol_2d();
        case S_EOL:
          *pa_++ = static_cast<uint32_t>(lastx_ - a0_);
          if (!need(4)) return false;
          if (get(4)) warned_ = true;
          clr(4);
          eol_count_ = 1;
          return eol_2d();
        default:
          warned_ = true;
          return eol_2d();
      }
    }
    if (run_length_) {
      if (run_length_ + a0_ < lastx_) {  // expect a final V0
        if (!need(1)) return false;
        if (!get(1)) {
          warned_ = true;
          return eol_2d();
        }
        clr(1);
      }
      if (!setvalue(0)) return false;
    }
    return eol_2d();
  }
  bool eol_2d() {
    cleanup_runs();
    return !overflow_;
  }

  // _TIFFFax3fillruns: white runs as 0 bits, black as 1, clipped at lastx
  void fill(uint8_t* buf, uint32_t* runs, uint32_t* erun) {
    if ((erun - runs) & 1) *erun++ = 0;
    uint32_t x = 0;
    const uint32_t lastx = static_cast<uint32_t>(lastx_);
    for (; runs < erun; runs += 2) {
      for (int k = 0; k < 2; ++k) {
        uint32_t r = runs[k];
        if (x + r > lastx || r > lastx) r = runs[k] = lastx - x;
        for (uint32_t i = x; i < x + r; ++i) {
          const uint8_t bit = static_cast<uint8_t>(0x80 >> (i & 7));
          buf[i >> 3] = k ? static_cast<uint8_t>(buf[i >> 3] | bit)
                          : static_cast<uint8_t>(buf[i >> 3] & ~bit);
        }
        x += r;
      }
    }
  }
};

}  // namespace

extern "C" {

// The samples of a TIFF image, (height, width, spp) into `out`: uint16
// for `bits` up to 16, uint32 for 32.  `data` holds the `nchunks` strips
// or tiles, chunk i at data[offsets[i]: offsets[i] + lengths[i]],
// compressed by `compression` (1: none, the chunk's whole decompressed
// size; 2, 3, 4: CCITT RLE, Group 3 with `fax_options` its T4Options,
// Group 4; 5: LZW; 32773: PackBits).  A chunk is `ch` rows of `cw` pixels
// (strips: cw = width, the last strip cut at the foot; tiles: whole tiles,
// cut here at the edges), of all `spp` samples (planar 1) or one (planar
// 2: the chunks of sample 0, then of 1, ...), `bits` (1, 2, 4, 8, 12, 16,
// 32) each, 16- and 32-bit ones big-endian where `big`; `predictor` 2
// undoes horizontal differencing, 3 libtiff's floating-point predictor.
// `ycbcr_h` x `ycbcr_v` other than 1 x 1: 8-bit YCbCr in data units of
// that many luma samples, then Cb and Cr.  Returns 0; 1 with a message in
// `err`; or 2, with what went wrong, on a CCITT chunk that does not
// decode whole (libtiff warns and goes on, or fails, by its own rules).
int icat_tiff_decode(const uint8_t* data, const int64_t* offsets, const int64_t* lengths,
                     int64_t data_len, int nchunks, int compression, int width, int height,
                     int cw, int ch, int tiled, int planar, int spp, int bits, int predictor,
                     int big, int ycbcr_h, int ycbcr_v, int fax_options, void* out_ptr,
                     char* err, int err_len) {
  const bool fax = compression >= 2 && compression <= 4;
  const bool sub = ycbcr_h * ycbcr_v > 1;
  if (width <= 0 || height <= 0 || cw <= 0 || ch <= 0 || spp < 1 || spp > 8 ||
      !(bits == 1 || bits == 2 || bits == 4 || bits == 8 || bits == 12 || bits == 16 ||
        bits == 32) ||
      (planar != 1 && planar != 2) || (predictor == 2 && bits < 8) ||
      (predictor == 2 && bits == 12) || (predictor == 3 && bits != 32) ||
      (compression != 1 && compression != 5 && compression != 32773 && !fax) ||
      (fax && (bits != 1 || spp != 1)) || ycbcr_h < 1 || ycbcr_h > 4 || ycbcr_v < 1 ||
      ycbcr_v > 4 || (sub && (bits != 8 || spp != 3 || planar != 1 || predictor != 1))) {
    set_error(err, err_len, "TIFF layout out of range");
    return 1;
  }
  uint16_t* out16 = static_cast<uint16_t*>(out_ptr);
  uint32_t* out32 = static_cast<uint32_t*>(out_ptr);
  const int per = planar == 2 ? 1 : spp;  // samples a pixel in a chunk
  const int across = tiled ? (width + cw - 1) / cw : 1;
  const int down = (height + ch - 1) / ch;
  const int64_t planes = planar == 2 ? spp : 1;
  if (static_cast<int64_t>(across) * down * planes > nchunks) {
    set_error(err, err_len, "TIFF has fewer strips or tiles than its image needs");
    return 1;
  }
  const int64_t row_bytes = (static_cast<int64_t>(cw) * per * bits + 7) / 8;
  const int unit = ycbcr_h * ycbcr_v + 2;  // bytes a YCbCr data unit
  const int64_t units_across = (cw + ycbcr_h - 1) / ycbcr_h;
  std::vector<uint8_t> buf, planes_tmp;
  for (int64_t p = 0; p < planes; ++p) {
    for (int ty = 0; ty < down; ++ty) {
      for (int tx = 0; tx < across; ++tx) {
        const int64_t i = (p * down + ty) * across + tx;
        const int y0 = ty * ch, x0 = tx * cw;
        const int rows = tiled ? ch : (height - y0 < ch ? height - y0 : ch);
        const int64_t size = sub ? (rows + ycbcr_v - 1) / ycbcr_v * units_across * unit
                                 : row_bytes * rows;
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
        } else if (fax) {
          Fax f(in, lengths[i], compression, fax_options, cw);
          const FaxResult r = f.decode(compression, buf.data(), rows, row_bytes);
          if (r != kFaxOk) {
            set_error(err, err_len,
                      r == kFaxWarned ? "TIFF CCITT: a bad code or a row of the wrong length"
                      : r == kFaxCut  ? "TIFF CCITT: a Group 4 strip that ends early"
                                      : "TIFF CCITT: the data ends before the strip's rows do, "
                                        "or its runs overflow libtiff's run arrays");
            return 2;
          }
        } else if (const char* what = lzw(in, lengths[i], buf.data(), size)) {
          set_error(err, err_len, what);
          return 1;
        }
        if (sub) {  // the data units' samples spread over their pixels
          for (int r = 0; r < rows && y0 + r < height; ++r) {
            const uint8_t* urow = buf.data() + (r / ycbcr_v) * units_across * unit;
            for (int x = 0; x < cw && x0 + x < width; ++x) {
              const uint8_t* u = urow + (x / ycbcr_h) * unit;
              uint16_t* px = out16 + (static_cast<int64_t>(y0 + r) * width + x0 + x) * 3;
              px[0] = u[(r % ycbcr_v) * ycbcr_h + x % ycbcr_h];
              px[1] = u[unit - 2];
              px[2] = u[unit - 1];
            }
          }
          continue;
        }
        for (int r = 0; r < rows; ++r) {
          uint8_t* row = buf.data() + r * row_bytes;
          const int64_t n = static_cast<int64_t>(cw) * per;  // samples in the row
          bool row_big = big;
          if (predictor == 2 && bits == 8) {
            for (int64_t k = per; k < n; ++k) row[k] = static_cast<uint8_t>(row[k] + row[k - per]);
          } else if (predictor == 2) {
            const int w = bits / 8;
            for (int64_t k = per; k < n; ++k) {
              uint8_t* s = row + w * k;
              const uint8_t* prev = s - w * per;
              uint32_t v = 0, pv = 0;
              for (int b = 0; b < w; ++b) {
                const int at = big ? b : w - 1 - b;  // most significant first
                v = (v << 8) | s[at];
                pv = (pv << 8) | prev[at];
              }
              v += pv;
              for (int b = w - 1; b >= 0; --b) {
                s[big ? b : w - 1 - b] = static_cast<uint8_t>(v);
                v >>= 8;
              }
            }
          } else if (predictor == 3) {  // fpAcc
            for (int64_t k = per; k < 4 * n; ++k) row[k] = static_cast<uint8_t>(row[k] + row[k - per]);
            planes_tmp.assign(row, row + 4 * n);
            for (int64_t k = 0; k < n; ++k)
              for (int b = 0; b < 4; ++b) row[4 * k + b] = planes_tmp[b * n + k];
            row_big = true;
          }
          const int y = y0 + r;
          if (y >= height) break;
          for (int x = 0; x < cw && x0 + x < width; ++x) {
            const int64_t at = (static_cast<int64_t>(y) * width + x0 + x) * spp + p;
            for (int j = 0; j < per; ++j) {
              const int64_t k = static_cast<int64_t>(x) * per + j;
              uint32_t v;
              if (bits == 32) {
                const uint8_t* s = row + 4 * k;
                v = row_big ? (uint32_t{s[0]} << 24) | (s[1] << 16) | (s[2] << 8) | s[3]
                            : (uint32_t{s[3]} << 24) | (s[2] << 16) | (s[1] << 8) | s[0];
                out32[at + j] = v;
                continue;
              }
              if (bits == 16) {
                v = big ? (row[2 * k] << 8) | row[2 * k + 1] : row[2 * k] | (row[2 * k + 1] << 8);
              } else if (bits == 12) {
                const uint8_t* s = row + (k * 12 >> 3);
                v = (k & 1) ? ((s[0] & 15) << 8) | s[1] : (s[0] << 4) | (s[1] >> 4);
              } else if (bits == 8) {
                v = row[k];
              } else {
                const int64_t bit = k * bits;
                v = (row[bit >> 3] >> (8 - bits - (bit & 7))) & ((1u << bits) - 1);
              }
              out16[at + j] = static_cast<uint16_t>(v);
            }
          }
        }
      }
    }
  }
  return 0;
}

}  // extern "C"
