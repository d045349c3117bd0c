// rANS range coder for learned-compression bitstreams (host C++).
//
// Role: the entropy coder behind the PyTorch port's RealCodec
// (entropy/rans.py binds it with ctypes; kernels/_build.py compiles it with
// g++ into _build/libicat_rans-<hash>.so on first use).  A copy of the JAX
// package's native/rans/rans.cc with the same C ABI and the same bytes, so a
// stream written by one package decodes with the other.  It is the classic
// byte-renormalized rANS construction (Duda 2014):
//
//   * 32-bit state, 8-bit renormalization, 16-bit probability precision
//   * encoding runs in reverse symbol order; decoding is streaming forward
//   * per-symbol CDF rows are selected by an index array (one row per
//     channel / per scale-table entry)
//   * out-of-alphabet values use an escape symbol followed by bypass-coded
//     raw bits (Exp-Golomb-style length prefix), so any integer round-trips.
//
// CDF row layout (see entropy/tables.py):
//   cdf[i] : i in [0, size], monotone, cdf[0] == 0, cdf[size] == 1 << 16.
//   alphabet symbols 0..size-2 are regular; symbol size-1 is the escape.
//
// Exposed as a C ABI for ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kProbBits = 16;
constexpr uint32_t kProbScale = 1u << kProbBits;
// Renormalization interval: state in [kLow, kLow * 256) after decode step.
constexpr uint32_t kLow = 1u << 16;

constexpr int kBypassPrecision = 4;  // raw bits emitted per bypass chunk
constexpr uint32_t kMaxBypass = (1u << kBypassPrecision) - 1;

struct RansEncState {
  uint32_t state = kLow;
  std::vector<uint8_t> out;  // filled in reverse, reversed at flush

  inline void put(uint32_t start, uint32_t freq) {
    // renormalize: keep state < ((kLow >> kProbBits) << 8) * freq
    const uint32_t x_max = ((kLow >> kProbBits) << 8) * freq;
    while (state >= x_max) {
      out.push_back(static_cast<uint8_t>(state & 0xFF));
      state >>= 8;
    }
    state = ((state / freq) << kProbBits) + (state % freq) + start;
  }

  inline void put_bits(uint32_t val, int nbits) {
    // bypass: uniform distribution over 1<<nbits
    const uint32_t freq = 1;
    const uint32_t x_max = ((kLow >> nbits) << 8);
    while (state >= x_max * freq) {
      out.push_back(static_cast<uint8_t>(state & 0xFF));
      state >>= 8;
    }
    state = (state << nbits) | (val & ((1u << nbits) - 1));
  }

  void flush() {
    for (int i = 0; i < 4; ++i) {
      out.push_back(static_cast<uint8_t>(state & 0xFF));
      state >>= 8;
    }
  }
};

struct RansDecState {
  // The encoder emits bytes newest-first and the buffer is stored reversed,
  // so the flushed final state sits at the FRONT (MSB first) and decode
  // consumes the stream strictly forward.
  uint32_t state = 0;
  const uint8_t* ptr;
  const uint8_t* end;

  inline uint8_t next() { return ptr < end ? *ptr++ : 0; }

  void init(const uint8_t* data, int len) {
    ptr = data;
    end = data + len;
    state = 0;
    for (int i = 0; i < 4; ++i) {
      state = (state << 8) | next();
    }
  }

  inline uint32_t peek() const { return state & (kProbScale - 1); }

  inline void advance(uint32_t start, uint32_t freq) {
    state = freq * (state >> kProbBits) + (state & (kProbScale - 1)) - start;
    while (state < kLow) {
      state = (state << 8) | next();
    }
  }

  inline uint32_t get_bits(int nbits) {
    const uint32_t val = state & ((1u << nbits) - 1);
    state >>= nbits;
    while (state < kLow) {
      state = (state << 8) | next();
    }
    return val;
  }
};

struct Op {
  // one queued encode op (encoding must run in reverse order)
  uint32_t start;
  uint32_t freq;
  int32_t bypass_val;  // >= 0: also emit bypass chunks for this value
  bool is_bits;
  uint32_t bits_val;
  int nbits;
};

}  // namespace

extern "C" {

// Encode n symbols.  cdfs: rows of (max_size+1) uint32 entries; sizes[i]
// entries are valid for row i.  offsets shift symbols into alphabet space.
// Returns number of bytes written to out, or -1 if capacity exceeded.
int rans_encode_with_indexes(
    const int32_t* symbols, const int32_t* indexes, int n,
    const uint32_t* cdfs, int cdf_stride, const int32_t* cdf_sizes,
    const int32_t* offsets, uint8_t* out, int out_capacity) {
  // Build the op list forward, then run the encoder in reverse.
  std::vector<Op> ops;
  ops.reserve(n);

  for (int i = 0; i < n; ++i) {
    const int32_t idx = indexes[i];
    const uint32_t* cdf = cdfs + static_cast<int64_t>(idx) * cdf_stride;
    const int32_t size = cdf_sizes[idx];       // number of cdf entries - 1
    const int32_t max_sym = size - 1;          // escape symbol id
    int32_t value = symbols[i] - offsets[idx];

    Op op{};
    op.is_bits = false;
    op.bypass_val = -1;
    if (value < 0) {
      op.bypass_val = -2 * value - 1;  // odd -> negative overflow
      value = max_sym;
    } else if (value >= max_sym) {
      op.bypass_val = 2 * (value - max_sym);  // even -> positive overflow
      value = max_sym;
    }
    op.start = cdf[value];
    op.freq = cdf[value + 1] - cdf[value];
    ops.push_back(op);

    if (op.bypass_val >= 0) {
      // Bypass chunks, kBypassPrecision raw bits each: a chunk equal to
      // kMaxBypass means "continue, add the next chunk"; the decoder sums
      // chunks until it sees one below kMaxBypass.
      uint32_t v = static_cast<uint32_t>(op.bypass_val);
      while (v >= kMaxBypass) {
        Op c{};
        c.is_bits = true; c.bits_val = kMaxBypass; c.nbits = kBypassPrecision;
        ops.push_back(c);
        v -= kMaxBypass;
      }
      Op c{};
      c.is_bits = true; c.bits_val = v; c.nbits = kBypassPrecision;
      ops.push_back(c);
    }
  }

  RansEncState enc;
  enc.out.reserve(n * 2);
  for (auto it = ops.rbegin(); it != ops.rend(); ++it) {
    if (it->is_bits) {
      enc.put_bits(it->bits_val, it->nbits);
    } else {
      enc.put(it->start, it->freq);
    }
  }
  enc.flush();

  const int total = static_cast<int>(enc.out.size());
  if (total > out_capacity) return -1;
  // encoder produced bytes last-first; write them reversed so the decoder
  // reads from the end backward over a forward-stored buffer
  for (int i = 0; i < total; ++i) {
    out[i] = enc.out[total - 1 - i];
  }
  return total;
}

// Decode n symbols given the same cdf tables/indexes used to encode.
int rans_decode_with_indexes(
    const uint8_t* data, int data_len,
    const int32_t* indexes, int n,
    const uint32_t* cdfs, int cdf_stride, const int32_t* cdf_sizes,
    const int32_t* offsets, int32_t* symbols_out) {
  RansDecState dec;
  dec.init(data, data_len);

  for (int i = 0; i < n; ++i) {
    const int32_t idx = indexes[i];
    const uint32_t* cdf = cdfs + static_cast<int64_t>(idx) * cdf_stride;
    const int32_t size = cdf_sizes[idx];
    const int32_t max_sym = size - 1;

    const uint32_t cum = dec.peek();
    // linear scan is fine: alphabets are small (<= ~260 symbols)
    int32_t sym = 0;
    while (sym < size && cdf[sym + 1] <= cum) ++sym;
    dec.advance(cdf[sym], cdf[sym + 1] - cdf[sym]);

    int32_t value = sym;
    if (sym == max_sym) {
      // bypass-decoded overflow value
      uint32_t raw = 0;
      while (true) {
        uint32_t chunk = dec.get_bits(kBypassPrecision);
        raw += chunk;
        if (chunk != kMaxBypass) break;
      }
      const int32_t overflow = static_cast<int32_t>(raw);
      if (overflow & 1) {
        value = -((overflow + 1) / 2);
      } else {
        value = max_sym + overflow / 2;
      }
    }
    symbols_out[i] = value + offsets[idx];
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Streaming decoder: the autoregressive context models interleave symbol
// decoding with context computation (the row index for symbol k is only
// known after symbols < k are decoded), so the one-shot API above cannot be
// used.  A heap-allocated decoder persists across calls; each call decodes
// the next n symbols with caller-supplied per-symbol rows.

struct RansStreamDec {
  RansDecState st;
  std::vector<uint8_t> data;  // own the buffer; python side may free theirs
};

void* rans_dec_create(const uint8_t* data, int data_len) {
  auto* h = new RansStreamDec();
  h->data.assign(data, data + data_len);
  h->st.init(h->data.data(), data_len);
  return h;
}

int rans_dec_decode(
    void* handle, const int32_t* indexes, int n,
    const uint32_t* cdfs, int cdf_stride, const int32_t* cdf_sizes,
    const int32_t* offsets, int32_t* symbols_out) {
  auto* h = static_cast<RansStreamDec*>(handle);
  for (int i = 0; i < n; ++i) {
    const int32_t idx = indexes[i];
    const uint32_t* cdf = cdfs + static_cast<int64_t>(idx) * cdf_stride;
    const int32_t size = cdf_sizes[idx];
    const int32_t max_sym = size - 1;

    const uint32_t cum = h->st.peek();
    int32_t sym = 0;
    while (sym < size && cdf[sym + 1] <= cum) ++sym;
    h->st.advance(cdf[sym], cdf[sym + 1] - cdf[sym]);

    int32_t value = sym;
    if (sym == max_sym) {
      uint32_t raw = 0;
      while (true) {
        uint32_t chunk = h->st.get_bits(kBypassPrecision);
        raw += chunk;
        if (chunk != kMaxBypass) break;
      }
      const int32_t overflow = static_cast<int32_t>(raw);
      value = (overflow & 1) ? -((overflow + 1) / 2) : max_sym + overflow / 2;
    }
    symbols_out[i] = value + offsets[idx];
  }
  return 0;
}

void rans_dec_free(void* handle) {
  delete static_cast<RansStreamDec*>(handle);
}

}  // extern "C"
