// JPEG 2000 tiles (host C++): the samples OpenJPEG 2.5 gives Pillow for one
// tile of a Part 1 codestream, before Pillow's unpacking.
//
// Role: io/jpeg2000.py reads the JP2 boxes and the codestream's marker
// segments (SIZ, COD/COC, QCD/QCC, RGN, POC, PPM/PPT, SOT), gathers each
// tile's tile-part bodies and packed packet headers and hands them here
// with the tile's coding parameters as flat int32 arrays;
// kernels/_build.py compiles this file with g++ (-ffp-contract=off) into
// _build/libicat_jpeg2000-<hash>.so on first use, and io/jpeg2000.py loads
// it with ctypes.  Every read is bounds-checked: a broken tile returns 1
// with a message.
//
// The decode, in OpenJPEG's (opj_t2, opj_t1, opj_dwt, opj_mct, opj_tcd)
// order and arithmetic:
//   * tier 2: the tile's packets in its progression (LRCP, RLCP, RPCL,
//     PCRL, CPRL) and POC changes, each packet once (OpenJPEG's include
//     table); SOP and EPH markers; packet headers from the stream or from
//     PPM/PPT; tag trees for inclusion and zero bit-planes, pass counts,
//     Lblock, the code-block segments of the bypass and termall styles;
//   * tier 1: EBCOT's three passes with the MQ decoder (19 contexts, the
//     0xFF 0xFF OpenJPEG appends to each segment), raw bypass passes,
//     context reset, vertically causal contexts, segmentation symbols;
//     each magnitude carries one bit below its last decoded plane and
//     sits at the middle of its interval (OpenJPEG's oneplushalf);
//   * ROI maxshift; reversible coefficients halved (C division), the
//     irreversible ones times 0.5 * the band's step, in float;
//   * the inverse 5/3 (integer lifting, symmetric extension) and 9/7
//     (OpenJPEG's float lifting: K for low, its historic 1.625732422 for
//     high, then delta, gamma, beta, alpha, each `x + (l + r) * c`),
//     per resolution rows then columns;
//   * the inverse RCT or ICT (OpenJPEG's float constants), the DC level
//     shift (lrintf for the 9/7) and clamping to the component precision.
//
// Exposed as a C ABI for ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

struct Broken {
  std::string message;
};

[[noreturn]] void broken(const std::string& message) { throw Broken{message}; }

void set_error(char* err, int err_len, const std::string& message) {
  if (err && err_len > 0) std::snprintf(err, static_cast<size_t>(err_len), "%s", message.c_str());
}

int ceildiv(int64_t a, int64_t b) { return static_cast<int>((a + b - 1) / b); }
int ceildivpow2(int64_t a, int b) { return static_cast<int>((a + (int64_t(1) << b) - 1) >> b); }
int floordivpow2(int64_t a, int b) { return static_cast<int>(a >> b); }

// ---------------------------------------------------------------- parameters

// code-block styles (predictable termination, 16, changes nothing here)
enum { LAZY = 1, RESET = 2, TERMALL = 4, VSC = 8, SEGSYM = 32 };
enum { LRCP = 0, RLCP = 1, RPCL = 2, PCRL = 3, CPRL = 4 };

constexpr int kMaxRes = 33, kMaxBands = 3 * (kMaxRes - 1) + 1;
// a component's parameters, as io/jpeg2000.py lays them out
constexpr int kCompStride = 16 + 2 * kMaxRes + 2 * kMaxBands;

struct CompParams {
  int dx, dy, prec, sgnd, numres, cblkw, cblkh, cblksty, qmfbid, qntsty, numgbits, roishift;
  int ppx[kMaxRes], ppy[kMaxRes], expn[kMaxBands], mant[kMaxBands];
};

CompParams read_comp(const int32_t* p) {
  CompParams c;
  c.dx = p[0]; c.dy = p[1]; c.prec = p[2]; c.sgnd = p[3]; c.numres = p[4]; c.cblkw = p[5];
  c.cblkh = p[6]; c.cblksty = p[7]; c.qmfbid = p[8]; c.qntsty = p[9]; c.numgbits = p[10];
  c.roishift = p[11];
  for (int i = 0; i < kMaxRes; ++i) {
    c.ppx[i] = p[16 + i];
    c.ppy[i] = p[16 + kMaxRes + i];
  }
  for (int i = 0; i < kMaxBands; ++i) {
    c.expn[i] = p[16 + 2 * kMaxRes + i];
    c.mant[i] = p[16 + 2 * kMaxRes + kMaxBands + i];
  }
  return c;
}

// ---------------------------------------------------------------- structures

struct Segment {
  int maxpasses = 0, numpasses = 0, newpasses = 0, newlen = 0;
  std::vector<uint8_t> data;
};

struct CodeBlock {
  int x0, y0, x1, y1;
  int numbps = 0, numlenbits = 0, numnewpasses = 0;
  std::vector<Segment> segs;  // segs.size() is OpenJPEG's numsegs
};

struct TagTree {
  struct Node {
    int parent, value, low;
  };
  std::vector<Node> nodes;
  void init(int w, int h) {
    nodes.clear();
    std::vector<int> start;
    int lw = w, lh = h, total = 0;
    std::vector<std::pair<int, int>> dims;
    for (;;) {
      dims.push_back({lw, lh});
      start.push_back(total);
      total += lw * lh;
      if (lw * lh <= 1) break;
      lw = (lw + 1) / 2;
      lh = (lh + 1) / 2;
    }
    nodes.assign(total, Node{-1, 999, 0});
    for (size_t l = 0; l + 1 < dims.size(); ++l)
      for (int y = 0; y < dims[l].second; ++y)
        for (int x = 0; x < dims[l].first; ++x)
          nodes[start[l] + y * dims[l].first + x].parent =
              start[l + 1] + (y / 2) * dims[l + 1].first + x / 2;
  }
};

struct Bio {  // opj_bio: packet-header bits, a 0 bit stuffed after 0xFF
  const uint8_t *start, *bp, *end;
  uint32_t buf = 0;
  int ct = 0;
  Bio(const uint8_t* p, const uint8_t* e) : start(p), bp(p), end(e) {}
  void bytein() {
    buf = (buf << 8) & 0xffff;
    ct = buf == 0xff00 ? 7 : 8;
    if (bp < end) buf |= *bp++;
  }
  uint32_t bit() {
    if (ct == 0) bytein();
    --ct;
    return (buf >> ct) & 1;
  }
  uint32_t read(int n) {
    uint32_t v = 0;
    for (int i = n - 1; i >= 0; --i) v |= bit() << i;
    return v;
  }
  void inalign() {
    ct = 0;
    if ((buf & 0xff) == 0xff) {
      bytein();
      ct = 0;
    }
  }
};

bool tgt_decode(Bio& bio, TagTree& tree, int leaf, int threshold) {
  int stack[32], n = 0;
  int node = leaf;
  while (tree.nodes[node].parent >= 0) {
    stack[n++] = node;
    node = tree.nodes[node].parent;
  }
  int low = 0;
  for (;;) {
    TagTree::Node& nd = tree.nodes[node];
    if (low > nd.low)
      nd.low = low;
    else
      low = nd.low;
    while (low < threshold && low < nd.value) {
      if (bio.read(1))
        nd.value = low;
      else
        ++low;
    }
    nd.low = low;
    if (n == 0) break;
    node = stack[--n];
  }
  return tree.nodes[node].value < threshold;
}

struct Precinct {
  int x0, y0, x1, y1, cw = 0, ch = 0;
  std::vector<CodeBlock> cblks;
  TagTree incl, imsb;
};

struct Band {
  int bandno, x0, y0, x1, y1, numbps;
  float stepsize;
  std::vector<Precinct> precincts;
  bool empty() const { return x0 == x1 || y0 == y1; }
};

struct Resolution {
  int x0, y0, x1, y1, pdx, pdy, pw, ph;
  std::vector<Band> bands;
};

struct TileComp {
  CompParams p;
  int x0, y0, x1, y1;
  std::vector<Resolution> res;
  std::vector<int32_t> idata;  // the 5/3 path
  std::vector<float> fdata;    // the 9/7 path
};

void init_tilecomp(TileComp& tc, int tx0, int ty0, int tx1, int ty1) {
  const CompParams& p = tc.p;
  tc.x0 = ceildiv(tx0, p.dx);
  tc.y0 = ceildiv(ty0, p.dy);
  tc.x1 = ceildiv(tx1, p.dx);
  tc.y1 = ceildiv(ty1, p.dy);
  tc.res.resize(p.numres);
  for (int r = 0; r < p.numres; ++r) {
    Resolution& res = tc.res[r];
    int level = p.numres - 1 - r;
    res.x0 = ceildivpow2(tc.x0, level);
    res.y0 = ceildivpow2(tc.y0, level);
    res.x1 = ceildivpow2(tc.x1, level);
    res.y1 = ceildivpow2(tc.y1, level);
    res.pdx = p.ppx[r];
    res.pdy = p.ppy[r];
    int px0 = floordivpow2(res.x0, res.pdx) << res.pdx;
    int py0 = floordivpow2(res.y0, res.pdy) << res.pdy;
    int px1 = ceildivpow2(res.x1, res.pdx) << res.pdx;
    int py1 = ceildivpow2(res.y1, res.pdy) << res.pdy;
    res.pw = res.x0 == res.x1 ? 0 : (px1 - px0) >> res.pdx;
    res.ph = res.y0 == res.y1 ? 0 : (py1 - py0) >> res.pdy;
    int tlcbgx, tlcbgy, cbgw, cbgh;
    if (r == 0) {
      tlcbgx = px0;
      tlcbgy = py0;
      cbgw = res.pdx;
      cbgh = res.pdy;
    } else {
      tlcbgx = ceildivpow2(px0, 1);
      tlcbgy = ceildivpow2(py0, 1);
      cbgw = res.pdx - 1;
      cbgh = res.pdy - 1;
    }
    int cbw = std::min(p.cblkw, cbgw), cbh = std::min(p.cblkh, cbgh);
    int nbands = r == 0 ? 1 : 3;
    res.bands.resize(nbands);
    for (int b = 0; b < nbands; ++b) {
      Band& band = res.bands[b];
      int stepno;
      if (r == 0) {
        band.bandno = 0;
        band.x0 = ceildivpow2(tc.x0, level);
        band.y0 = ceildivpow2(tc.y0, level);
        band.x1 = ceildivpow2(tc.x1, level);
        band.y1 = ceildivpow2(tc.y1, level);
        stepno = 0;
      } else {
        band.bandno = b + 1;
        int x0b = band.bandno & 1, y0b = band.bandno >> 1;
        band.x0 = ceildivpow2(tc.x0 - (int64_t(x0b) << level), level + 1);
        band.y0 = ceildivpow2(tc.y0 - (int64_t(y0b) << level), level + 1);
        band.x1 = ceildivpow2(tc.x1 - (int64_t(x0b) << level), level + 1);
        band.y1 = ceildivpow2(tc.y1 - (int64_t(y0b) << level), level + 1);
        stepno = 3 * (r - 1) + b + 1;
      }
      // Table E-1's gains, but 0 for every band of the 9/7 (OpenJPEG's
      // BUG_WEIRD_TWO_INVK, which its 9/7 synthesis makes up for)
      int log2_gain = p.qmfbid == 0 ? 0 : band.bandno == 0 ? 0 : band.bandno == 3 ? 2 : 1;
      int rb = p.prec + log2_gain;
      band.stepsize = static_cast<float>((1.0 + p.mant[stepno] / 2048.0) *
                                         std::pow(2.0, rb - p.expn[stepno]));
      band.numbps = p.expn[stepno] + p.numgbits - 1;
      band.precincts.resize(static_cast<size_t>(res.pw) * res.ph);
      for (int pno = 0; pno < res.pw * res.ph; ++pno) {
        Precinct& prc = band.precincts[pno];
        int cx0 = tlcbgx + (pno % res.pw) * (1 << cbgw);
        int cy0 = tlcbgy + (pno / res.pw) * (1 << cbgh);
        prc.x0 = std::max(cx0, band.x0);
        prc.y0 = std::max(cy0, band.y0);
        prc.x1 = std::min(cx0 + (1 << cbgw), band.x1);
        prc.y1 = std::min(cy0 + (1 << cbgh), band.y1);
        int tlx = floordivpow2(prc.x0, cbw) << cbw, tly = floordivpow2(prc.y0, cbh) << cbh;
        int brx = ceildivpow2(prc.x1, cbw) << cbw, bry = ceildivpow2(prc.y1, cbh) << cbh;
        prc.cw = std::max(0, (brx - tlx) >> cbw);
        prc.ch = std::max(0, (bry - tly) >> cbh);
        prc.cblks.resize(static_cast<size_t>(prc.cw) * prc.ch);
        for (int k = 0; k < prc.cw * prc.ch; ++k) {
          CodeBlock& cb = prc.cblks[k];
          int bx0 = tlx + (k % prc.cw) * (1 << cbw), by0 = tly + (k / prc.cw) * (1 << cbh);
          cb.x0 = std::max(bx0, prc.x0);
          cb.y0 = std::max(by0, prc.y0);
          cb.x1 = std::min(bx0 + (1 << cbw), prc.x1);
          cb.y1 = std::min(by0 + (1 << cbh), prc.y1);
        }
        prc.incl.init(prc.cw, prc.ch);
        prc.imsb.init(prc.cw, prc.ch);
      }
    }
  }
}

// ---------------------------------------------------------------- tier 2

struct Packet {
  int layer, res, comp, prec;
};

struct Poc {
  int r0, c0, l1, r1, c1, prg;
};

// the packets of a tile in OpenJPEG's order (opj_pi_next_*): each
// (layer, resolution, component, precinct) once, the first time a
// progression reaches it
std::vector<Packet> packet_order(const std::vector<TileComp>& comps, int numlayers,
                                 const std::vector<Poc>& pocs, int tx0, int ty0, int tx1,
                                 int ty1) {
  int ncomp = static_cast<int>(comps.size());
  int maxres = 0, maxprec = 0;
  for (const TileComp& tc : comps) {
    maxres = std::max(maxres, tc.p.numres);
    for (const Resolution& r : tc.res) maxprec = std::max(maxprec, r.pw * r.ph);
  }
  std::vector<uint8_t> include(static_cast<size_t>(numlayers) * maxres * ncomp * std::max(maxprec, 1));
  std::vector<Packet> out;
  auto add = [&](int l, int r, int c, int p) {
    size_t index = ((static_cast<size_t>(l) * maxres + r) * ncomp + c) * std::max(maxprec, 1) + p;
    if (index >= include.size()) broken("JPEG 2000 packet index out of range");
    if (include[index]) return;
    include[index] = 1;
    out.push_back({l, r, c, p});
  };
  // a position-driven order's precinct at (x, y) of a resolution, or -1
  auto precinct_at = [&](int c, int r, int64_t x, int64_t y) -> int {
    const TileComp& tc = comps[c];
    const Resolution& res = tc.res[r];
    int level = tc.p.numres - 1 - r;
    uint32_t dx = tc.p.dx, dy = tc.p.dy;
    int rpx = res.pdx + level, rpy = res.pdy + level;
    if (rpx >= 31 || ((dx << rpx) >> rpx) != dx || rpy >= 31 || ((dy << rpy) >> rpy) != dy)
      return -1;
    int64_t dxl = int64_t(dx) << level, dyl = int64_t(dy) << level;
    int64_t trx0 = ceildiv(tx0, dxl), try0 = ceildiv(ty0, dyl);
    int64_t trx1 = ceildiv(tx1, dxl), try1 = ceildiv(ty1, dyl);
    if (!((y % (int64_t(dy) << rpy) == 0) || (y == ty0 && ((try0 << level) % (int64_t(1) << rpy)))))
      return -1;
    if (!((x % (int64_t(dx) << rpx) == 0) || (x == tx0 && ((trx0 << level) % (int64_t(1) << rpx)))))
      return -1;
    if (res.pw == 0 || res.ph == 0) return -1;
    if (trx0 == trx1 || try0 == try1) return -1;
    int prci = floordivpow2(ceildiv(x, dxl), res.pdx) - floordivpow2(trx0, res.pdx);
    int prcj = floordivpow2(ceildiv(y, dyl), res.pdy) - floordivpow2(try0, res.pdy);
    return prci + prcj * res.pw;
  };
  auto steps = [&](int c0, int c1, int64_t& sx, int64_t& sy) {
    sx = 0;
    sy = 0;
    for (int c = c0; c < c1; ++c) {
      const TileComp& tc = comps[c];
      for (int r = 0; r < tc.p.numres; ++r) {
        int ex = tc.res[r].pdx + tc.p.numres - 1 - r, ey = tc.res[r].pdy + tc.p.numres - 1 - r;
        if (ex < 32 && uint64_t(tc.p.dx) <= (0xffffffffull >> ex)) {
          int64_t d = int64_t(tc.p.dx) << ex;
          sx = sx ? std::min(sx, d) : d;
        }
        if (ey < 32 && uint64_t(tc.p.dy) <= (0xffffffffull >> ey)) {
          int64_t d = int64_t(tc.p.dy) << ey;
          sy = sy ? std::min(sy, d) : d;
        }
      }
    }
    if (sx == 0 || sy == 0) broken("JPEG 2000 precinct step is 0");
  };
  for (const Poc& poc : pocs) {
    int l1 = std::min(poc.l1, numlayers), c1 = std::min(poc.c1, ncomp);
    int r0 = poc.r0, r1 = poc.r1, c0 = poc.c0;
    switch (poc.prg) {
      case LRCP:
        for (int l = 0; l < l1; ++l)
          for (int r = r0; r < r1; ++r)
            for (int c = c0; c < c1; ++c) {
              if (r >= comps[c].p.numres) continue;
              const Resolution& res = comps[c].res[r];
              for (int p = 0; p < res.pw * res.ph; ++p) add(l, r, c, p);
            }
        break;
      case RLCP:
        for (int r = r0; r < r1; ++r)
          for (int l = 0; l < l1; ++l)
            for (int c = c0; c < c1; ++c) {
              if (r >= comps[c].p.numres) continue;
              const Resolution& res = comps[c].res[r];
              for (int p = 0; p < res.pw * res.ph; ++p) add(l, r, c, p);
            }
        break;
      case RPCL: {
        int64_t sx, sy;
        steps(0, ncomp, sx, sy);
        for (int r = r0; r < r1; ++r)
          for (int64_t y = ty0; y < ty1; y += sy - (y % sy))
            for (int64_t x = tx0; x < tx1; x += sx - (x % sx))
              for (int c = c0; c < c1; ++c) {
                if (r >= comps[c].p.numres) continue;
                int p = precinct_at(c, r, x, y);
                if (p < 0) continue;
                for (int l = 0; l < l1; ++l) add(l, r, c, p);
              }
        break;
      }
      case PCRL: {
        int64_t sx, sy;
        steps(0, ncomp, sx, sy);
        for (int64_t y = ty0; y < ty1; y += sy - (y % sy))
          for (int64_t x = tx0; x < tx1; x += sx - (x % sx))
            for (int c = c0; c < c1; ++c)
              for (int r = r0; r < std::min(r1, comps[c].p.numres); ++r) {
                int p = precinct_at(c, r, x, y);
                if (p < 0) continue;
                for (int l = 0; l < l1; ++l) add(l, r, c, p);
              }
        break;
      }
      case CPRL:
        for (int c = c0; c < c1; ++c) {
          int64_t sx, sy;
          steps(c, c + 1, sx, sy);
          for (int64_t y = ty0; y < ty1; y += sy - (y % sy))
            for (int64_t x = tx0; x < tx1; x += sx - (x % sx))
              for (int r = r0; r < std::min(r1, comps[c].p.numres); ++r) {
                int p = precinct_at(c, r, x, y);
                if (p < 0) continue;
                for (int l = 0; l < l1; ++l) add(l, r, c, p);
              }
        }
        break;
      default:
        broken("JPEG 2000 progression order " + std::to_string(poc.prg) + " is not valid");
    }
  }
  return out;
}

void init_segment(CodeBlock& cb, int cblksty, bool first) {
  Segment seg;
  if (cblksty & TERMALL)
    seg.maxpasses = 1;
  else if (cblksty & LAZY)
    seg.maxpasses = first ? 10
                    : (cb.segs.back().maxpasses == 1 || cb.segs.back().maxpasses == 10) ? 2 : 1;
  else
    seg.maxpasses = 109;
  cb.segs.push_back(std::move(seg));
}

int floorlog2(uint32_t v) {
  int l = 0;
  while (v >>= 1) ++l;
  return l;
}

uint32_t numpasses(Bio& bio) {
  if (!bio.read(1)) return 1;
  if (!bio.read(1)) return 2;
  uint32_t n = bio.read(2);
  if (n != 3) return 3 + n;
  n = bio.read(5);
  if (n != 31) return 6 + n;
  return 37 + bio.read(7);
}

// One packet: its header (from the stream or the packed headers), then its
// body, whose segments are appended to their code-blocks.
void read_packet(std::vector<TileComp>& comps, const Packet& pk, int csty, const uint8_t*& cur,
                 const uint8_t* end, const uint8_t*& hcur, const uint8_t* hend, bool packed) {
  TileComp& tc = comps[pk.comp];
  Resolution& res = tc.res[pk.res];
  if (pk.layer == 0) {
    for (Band& band : res.bands) {
      if (band.empty()) continue;
      Precinct& prc = band.precincts[pk.prec];
      prc.incl.init(prc.cw, prc.ch);
      prc.imsb.init(prc.cw, prc.ch);
      for (CodeBlock& cb : prc.cblks) cb.segs.clear();
    }
  }
  if ((csty & 2) && end - cur >= 6 && cur[0] == 0xff && cur[1] == 0x91) cur += 6;  // SOP
  const uint8_t* h = packed ? hcur : cur;
  const uint8_t* he = packed ? hend : end;
  Bio bio(h, he);
  bool present = bio.read(1);
  if (present) {
    for (Band& band : res.bands) {
      if (band.empty()) continue;
      Precinct& prc = band.precincts[pk.prec];
      for (int k = 0; k < prc.cw * prc.ch; ++k) {
        CodeBlock& cb = prc.cblks[k];
        bool included = cb.segs.empty() ? tgt_decode(bio, prc.incl, k, pk.layer + 1) : bio.read(1);
        if (!included) {
          cb.numnewpasses = 0;
          continue;
        }
        if (cb.segs.empty()) {
          int i = 0;
          while (!tgt_decode(bio, prc.imsb, k, i)) {
            ++i;
            if (i > 64) broken("JPEG 2000 zero bit-plane count is past 64");
          }
          cb.numbps = band.numbps + 1 - i;
          cb.numlenbits = 3;
        }
        cb.numnewpasses = static_cast<int>(numpasses(bio));
        int increment = 0;
        while (bio.read(1)) {
          if (++increment > 32) broken("JPEG 2000 Lblock increment is past 32");
        }
        cb.numlenbits += increment;
        // the segments the new passes fall in: those opened here get no
        // data until the body, as in opj_t2_read_packet_header
        size_t segno;
        if (cb.segs.empty()) {
          init_segment(cb, tc.p.cblksty, true);
          segno = 0;
        } else {
          segno = cb.segs.size() - 1;
          if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
            init_segment(cb, tc.p.cblksty, false);
            ++segno;
          }
        }
        cb.segs[segno].newpasses = 0;
        int n = cb.numnewpasses;
        for (;;) {
          Segment& seg = cb.segs[segno];
          seg.newpasses = std::min(seg.maxpasses - seg.numpasses, n);
          int bits = cb.numlenbits + floorlog2(static_cast<uint32_t>(seg.newpasses));
          if (bits > 32) broken("JPEG 2000 segment length of more than 32 bits");
          seg.newlen = static_cast<int>(bio.read(bits));
          n -= seg.newpasses;
          if (n <= 0) break;
          init_segment(cb, tc.p.cblksty, false);
          ++segno;
        }
      }
    }
  }
  bio.inalign();
  h = bio.bp;
  if (csty & 4) {  // EPH: OpenJPEG 2.5 refuses a header without it
    if (he - h < 2 || h[0] != 0xff || h[1] != 0x92) broken("JPEG 2000 packet header lacks its EPH");
    h += 2;
  }
  if (packed)
    hcur = h;
  else
    cur = h;
  if (!present) return;
  for (Band& band : res.bands) {
    if (band.empty()) continue;
    Precinct& prc = band.precincts[pk.prec];
    for (CodeBlock& cb : prc.cblks) {
      if (!cb.numnewpasses) continue;
      // the segments that hold new passes: from the first not yet full
      size_t segno = 0;
      while (segno < cb.segs.size() && cb.segs[segno].numpasses == cb.segs[segno].maxpasses) ++segno;
      int n = cb.numnewpasses;
      while (n > 0) {
        if (segno >= cb.segs.size()) broken("JPEG 2000 code-block segments out of step");
        Segment& seg = cb.segs[segno];
        if (seg.newlen < 0 || end - cur < seg.newlen)
          broken("JPEG 2000 code-block segment runs past its tile");
        seg.data.insert(seg.data.end(), cur, cur + seg.newlen);
        cur += seg.newlen;
        seg.numpasses += seg.newpasses;
        n -= seg.newpasses;
        seg.newpasses = 0;
        seg.newlen = 0;
        ++segno;
      }
    }
  }
}

// ---------------------------------------------------------------- tier 1

const uint16_t kQe[47] = {
    0x5601, 0x3401, 0x1801, 0x0ac1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801, 0x3801, 0x3001, 0x2401,
    0x1c01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201,
    0x1c01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0ac1, 0x09c1, 0x08a1, 0x0521, 0x0441, 0x02a1,
    0x0221, 0x0141, 0x0111, 0x0085, 0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601};
const uint8_t kNmps[47] = {1,  2,  3,  4,  5,  38, 7,  8,  9,  10, 11, 12, 13, 29, 15, 16,
                           17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
                           33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46};
const uint8_t kNlps[47] = {1,  6,  9,  12, 29, 33, 6,  14, 14, 14, 17, 18, 20, 21, 14, 14,
                           15, 16, 17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
                           30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
const uint8_t kSwitch[47] = {1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};

enum { CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18, NCTX = 19 };

struct Mqc {
  const uint8_t* bp;  // the segment, followed by 0xFF 0xFF
  uint32_t a = 0, c = 0;
  int ct = 0;
  uint8_t state[NCTX], mps[NCTX];

  void reset_contexts() {
    std::memset(state, 0, sizeof state);
    std::memset(mps, 0, sizeof mps);
    state[CTX_UNI] = 46;
    state[CTX_AGG] = 3;
    state[0] = 4;
  }
  void bytein() {
    if (bp[0] == 0xff) {
      if (bp[1] > 0x8f) {
        c += 0xff00;
        ct = 8;
      } else {
        ++bp;
        c += uint32_t(bp[0]) << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += uint32_t(bp[0]) << 8;
      ct = 8;
    }
  }
  void init(const uint8_t* data) {
    bp = data;
    c = uint32_t(bp[0]) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (!(a & 0x8000));
  }
  int decode(int cx) {
    int s = state[cx];
    uint32_t qe = kQe[s];
    int d;
    a -= qe;
    if ((c >> 16) < qe) {
      if (a < qe) {
        a = qe;
        d = mps[cx];
        state[cx] = kNmps[s];
      } else {
        a = qe;
        d = 1 - mps[cx];
        if (kSwitch[s]) mps[cx] ^= 1;
        state[cx] = kNlps[s];
      }
      renorm();
    } else {
      c -= qe << 16;
      if (!(a & 0x8000)) {
        if (a < qe) {
          d = 1 - mps[cx];
          if (kSwitch[s]) mps[cx] ^= 1;
          state[cx] = kNlps[s];
        } else {
          d = mps[cx];
          state[cx] = kNmps[s];
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
  // raw (bypass) bits, opj_mqc_raw_decode
  void raw_init(const uint8_t* data) {
    bp = data;
    c = 0;
    ct = 0;
  }
  int raw() {
    if (ct == 0) {
      if (c == 0xff) {
        if (*bp > 0x8f) {
          c = 0xff;
          ct = 8;
        } else {
          c = *bp++;
          ct = 7;
        }
      } else {
        c = *bp++;
        ct = 8;
      }
    }
    --ct;
    return (c >> ct) & 1;
  }
};

enum { SIG = 1, NEG = 2, VISIT = 4, REFINED = 8 };

struct T1 {
  int w, h, fs, orient;
  bool vsc;
  std::vector<int32_t> data;
  std::vector<uint8_t> flags;  // (h + 2) x (w + 2), a zero border
  Mqc mq;

  uint8_t* f(int x, int y) { return &flags[static_cast<size_t>(y + 1) * fs + x + 1]; }
  // the rows of the next stripe are not looked at from a stripe's last
  // row in vertically causal mode
  bool causal(int y) const { return vsc && (y & 3) == 3; }

  bool any_neighbour(int x, int y) {
    const uint8_t* p = f(x, y);
    int s = (p[-1] | p[1] | p[-fs - 1] | p[-fs] | p[-fs + 1]) & SIG;
    if (!causal(y)) s |= (p[fs - 1] | p[fs] | p[fs + 1]) & SIG;
    return s != 0;
  }
  int zc(int x, int y) {
    const uint8_t* p = f(x, y);
    bool c = causal(y);
    int h = (p[-1] & SIG) + (p[1] & SIG);
    int v = (p[-fs] & SIG) + (c ? 0 : (p[fs] & SIG));
    int d = (p[-fs - 1] & SIG) + (p[-fs + 1] & SIG) + (c ? 0 : (p[fs - 1] & SIG) + (p[fs + 1] & SIG));
    if (orient == 3) {
      int hv = h + v;
      if (d == 0) return hv == 0 ? 0 : hv == 1 ? 1 : 2;
      if (d == 1) return hv == 0 ? 3 : hv == 1 ? 4 : 5;
      if (d == 2) return hv == 0 ? 6 : 7;
      return 8;
    }
    if (orient == 1) std::swap(h, v);  // HL, horizontally high-pass
    if (h == 0) {
      if (v == 0) return d == 0 ? 0 : d == 1 ? 1 : 2;
      return v == 1 ? 3 : 4;
    }
    if (h == 1) return v == 0 ? (d == 0 ? 5 : 6) : 7;
    return 8;
  }
  // the sign context and its XOR bit
  int sc(int x, int y, int& xorbit) {
    const uint8_t* p = f(x, y);
    auto contrib = [](uint8_t g) { return (g & SIG) ? ((g & NEG) ? -1 : 1) : 0; };
    int hc = std::clamp(contrib(p[-1]) + contrib(p[1]), -1, 1);
    int vc = std::clamp(contrib(p[-fs]) + (causal(y) ? 0 : contrib(p[fs])), -1, 1);
    if (hc < 0) {
      hc = -hc;
      vc = -vc;
      xorbit = 1;
    } else if (hc == 0 && vc < 0) {
      vc = -vc;
      xorbit = 1;
    } else {
      xorbit = 0;
    }
    // (hc, vc): (1,1) 13, (1,0) 12, (1,-1) 11, (0,1) 10, (0,0) 9
    if (hc == 0) return CTX_SC + (vc ? 1 : 0);
    return CTX_SC + 3 + vc;
  }
  int mag(int x, int y) {
    if (*f(x, y) & REFINED) return CTX_MAG + 2;
    return CTX_MAG + (any_neighbour(x, y) ? 1 : 0);
  }
  void significant(int x, int y, int negative, int32_t value) {
    *f(x, y) |= SIG | (negative ? NEG : 0);
    data[static_cast<size_t>(y) * w + x] = negative ? -value : value;
  }

  void sigpass(int bpno, bool raw) {
    int32_t oneplushalf = (1 << bpno) | ((1 << bpno) >> 1);
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x)
        for (int y = k; y < std::min(k + 4, h); ++y) {
          uint8_t* g = f(x, y);
          if ((*g & (SIG | VISIT)) || !any_neighbour(x, y)) continue;
          if (raw) {
            if (mq.raw()) significant(x, y, mq.raw(), oneplushalf);
          } else if (mq.decode(zc(x, y))) {
            int xorbit, cx = sc(x, y, xorbit);
            significant(x, y, mq.decode(cx) ^ xorbit, oneplushalf);
          }
          *g |= VISIT;
        }
  }
  void refpass(int bpno, bool raw) {
    int32_t poshalf = (1 << bpno) >> 1;
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x)
        for (int y = k; y < std::min(k + 4, h); ++y) {
          uint8_t* g = f(x, y);
          if ((*g & (SIG | VISIT)) != SIG) continue;
          int v = raw ? mq.raw() : mq.decode(mag(x, y));
          int32_t& d = data[static_cast<size_t>(y) * w + x];
          d += (v ^ (d < 0)) ? poshalf : -poshalf;
          *g |= REFINED;
        }
  }
  void clean_step(int x, int y, int32_t oneplushalf) {
    if (*f(x, y) & (SIG | VISIT)) return;
    if (mq.decode(zc(x, y))) {
      int xorbit, cx = sc(x, y, xorbit);
      significant(x, y, mq.decode(cx) ^ xorbit, oneplushalf);
    }
  }
  void clnpass(int bpno, bool segsym) {
    int32_t oneplushalf = (1 << bpno) | ((1 << bpno) >> 1);
    int full = h & ~3;
    for (int k = 0; k < full; k += 4)
      for (int x = 0; x < w; ++x) {
        bool rl = true;
        for (int y = k; y < k + 4 && rl; ++y)
          rl = !(*f(x, y) & (SIG | VISIT)) && !any_neighbour(x, y);
        int y = k;
        if (rl) {
          if (!mq.decode(CTX_AGG)) {
            continue;
          }
          int run = mq.decode(CTX_UNI) << 1;
          run |= mq.decode(CTX_UNI);
          y = k + run;
          int xorbit, cx = sc(x, y, xorbit);
          significant(x, y, mq.decode(cx) ^ xorbit, oneplushalf);
          ++y;
        }
        for (; y < k + 4; ++y) clean_step(x, y, oneplushalf);
        for (int yy = k; yy < k + 4; ++yy) *f(x, yy) &= ~VISIT;
      }
    for (int x = 0; x < w; ++x)
      for (int y = full; y < h; ++y) {
        clean_step(x, y, oneplushalf);
        *f(x, y) &= ~VISIT;
      }
    if (segsym) {
      for (int i = 0; i < 4; ++i) mq.decode(CTX_UNI);
    }
  }
};

// A code-block's coefficients (w x h, row-major), as opj_t1_decode_cblk
// leaves them: one bit below the last decoded plane, ROI shift undone.
void decode_codeblock(T1& t1, const CodeBlock& cb, int cblksty, int roishift) {
  int w = cb.x1 - cb.x0, h = cb.y1 - cb.y0;
  t1.w = w;
  t1.h = h;
  t1.fs = w + 2;
  t1.vsc = (cblksty & VSC) != 0;
  t1.data.assign(static_cast<size_t>(w) * h, 0);
  t1.flags.assign(static_cast<size_t>(w + 2) * (h + 2), 0);
  if (cb.segs.empty()) return;
  int bpno = roishift + cb.numbps;
  // OpenJPEG's unsigned numbps wraps below 0 and its int sum wraps back
  if (bpno >= 31) broken("JPEG 2000 code-block of 31 or more bit-planes");
  int passtype = 2;
  t1.mq.reset_contexts();
  std::vector<uint8_t> buf;
  for (const Segment& seg : cb.segs) {
    bool raw = bpno <= cb.numbps - 4 && passtype < 2 && (cblksty & LAZY);
    buf.assign(seg.data.begin(), seg.data.end());
    buf.push_back(0xff);
    buf.push_back(0xff);
    if (raw)
      t1.mq.raw_init(buf.data());
    else
      t1.mq.init(buf.data());
    for (int pass = 0; pass < seg.numpasses && bpno >= 1; ++pass) {
      if (passtype == 0)
        t1.sigpass(bpno, raw);
      else if (passtype == 1)
        t1.refpass(bpno, raw);
      else
        t1.clnpass(bpno, (cblksty & SEGSYM) != 0);
      if ((cblksty & RESET) && !raw) t1.mq.reset_contexts();
      if (++passtype == 3) {
        passtype = 0;
        --bpno;
      }
    }
  }
  if (roishift) {
    int32_t thresh = int32_t(1) << roishift;
    for (int32_t& v : t1.data) {
      int32_t mag = v < 0 ? -v : v;
      if (mag >= thresh) {
        mag >>= roishift;
        v = v < 0 ? -mag : mag;
      }
    }
  }
}

void tier1(TileComp& tc) {
  int tw = tc.x1 - tc.x0, th = tc.y1 - tc.y0;
  bool reversible = tc.p.qmfbid == 1;
  if (reversible)
    tc.idata.assign(static_cast<size_t>(tw) * th, 0);
  else
    tc.fdata.assign(static_cast<size_t>(tw) * th, 0.0f);
  T1 t1;
  for (size_t r = 0; r < tc.res.size(); ++r) {
    Resolution& res = tc.res[r];
    for (Band& band : res.bands) {
      if (band.empty()) continue;
      t1.orient = band.bandno;
      int xoff = 0, yoff = 0;
      if (r > 0) {
        const Resolution& prev = tc.res[r - 1];
        if (band.bandno & 1) xoff = prev.x1 - prev.x0;
        if (band.bandno & 2) yoff = prev.y1 - prev.y0;
      }
      const float step = 0.5f * band.stepsize;
      for (Precinct& prc : band.precincts)
        for (CodeBlock& cb : prc.cblks) {
          decode_codeblock(t1, cb, tc.p.cblksty, tc.p.roishift);
          int x = cb.x0 - band.x0 + xoff, y = cb.y0 - band.y0 + yoff;
          for (int j = 0; j < t1.h; ++j)
            for (int i = 0; i < t1.w; ++i) {
              int32_t v = t1.data[static_cast<size_t>(j) * t1.w + i];
              size_t at = static_cast<size_t>(y + j) * tw + x + i;
              if (reversible)
                tc.idata[at] = v / 2;
              else
                tc.fdata[at] = static_cast<float>(v) * step;
            }
          cb.segs.clear();
          cb.segs.shrink_to_fit();
        }
    }
  }
}

// ---------------------------------------------------------------- DWT

// the inverse 5/3 on n samples interleaved in place, low-pass where
// (i + cas) is even (opj_idwt53_h/v)
void idwt53(int32_t* x, int n, int cas) {
  if (n == 1) {
    if (cas) x[0] /= 2;
    return;
  }
  auto at = [&](int i) { return x[i < 0 ? -i : i >= n ? 2 * (n - 1) - i : i]; };
  for (int i = cas; i < n; i += 2) x[i] -= (at(i - 1) + at(i + 1) + 2) >> 2;
  for (int i = 1 - cas; i < n; i += 2) x[i] += (at(i - 1) + at(i + 1)) >> 1;
}

// the inverse 9/7 of opj_v8dwt_decode, one lane
void idwt97(float* x, int n, int cas) {
  int sn = cas ? n / 2 : (n + 1) / 2, dn = n - sn;
  if (cas == 0 ? !(dn > 0 || sn > 1) : !(sn > 0 || dn > 1)) return;
  const float K = 1.230174105f, two_invK = 1.625732422f;
  const float alpha = -1.586134342f, beta = -0.052980118f, gamma = 0.882911075f,
              delta = 0.443506852f;
  for (int i = cas; i < n; i += 2) x[i] = x[i] * K;
  for (int i = 1 - cas; i < n; i += 2) x[i] = x[i] * two_invK;
  auto lift = [&](int first, float c) {
    for (int i = first; i < n; i += 2) {
      float l = x[i - 1 < 0 ? 1 : i - 1];
      float r = x[i + 1 >= n ? n - 2 : i + 1];
      x[i] = x[i] + (l + r) * c;
    }
  };
  lift(cas, -delta);
  lift(1 - cas, -gamma);
  lift(cas, -beta);
  lift(1 - cas, -alpha);
}

template <typename T, typename F>
void idwt2d(TileComp& tc, std::vector<T>& data, F one_d) {
  int tw = tc.x1 - tc.x0;
  std::vector<T> line;
  for (size_t r = 1; r < tc.res.size(); ++r) {
    const Resolution& res = tc.res[r];
    const Resolution& prev = tc.res[r - 1];
    int rw = res.x1 - res.x0, rh = res.y1 - res.y0;
    int sn = prev.x1 - prev.x0, cas = res.x0 & 1;
    line.resize(std::max(rw, rh));
    for (int j = 0; j < rh; ++j) {
      T* row = &data[static_cast<size_t>(j) * tw];
      for (int i = 0; i < sn; ++i) line[cas + 2 * i] = row[i];
      for (int i = 0; i < rw - sn; ++i) line[1 - cas + 2 * i] = row[sn + i];
      one_d(line.data(), rw, cas);
      std::copy(line.begin(), line.begin() + rw, row);
    }
    sn = prev.y1 - prev.y0;
    cas = res.y0 & 1;
    for (int i = 0; i < rw; ++i) {
      T* col = &data[i];
      for (int k = 0; k < sn; ++k) line[cas + 2 * k] = col[static_cast<size_t>(k) * tw];
      for (int k = 0; k < rh - sn; ++k) line[1 - cas + 2 * k] = col[static_cast<size_t>(sn + k) * tw];
      one_d(line.data(), rh, cas);
      for (int k = 0; k < rh; ++k) col[static_cast<size_t>(k) * tw] = line[k];
    }
  }
}

}  // namespace

extern "C" {

// Decode one tile.  `tile` holds tx0, ty0, tx1, ty1 (the tile on the
// reference grid), ncomp, numlayers, mct, csty (2 SOP, 4 EPH), npoc;
// `pocs` npoc x (r0, c0, l1, r1, c1, progression) (one entry, the COD's,
// where there is no POC); `comps` ncomp x kCompStride (dx, dy, prec,
// sgnd, numres, cblkw, cblkh, cblksty, qmfbid, qntsty, numgbits,
// roishift, 4 unused, 33 precinct width and 33 height exponents, 97 step
// exponents and 97 mantissas); `data` the tile-part bodies in order;
// `headers` the packed packet headers (PPT, or the PPM stream from where
// the previous tile left it) where `headers_len` is not negative, of which
// `headers_used` gets the bytes taken.  Writes each component's samples,
// clamped to its
// precision and level-shifted, into `out` one after another (ceil(tx/dx)
// bounds).  Returns 0, or 1 with a message on a broken tile.
int icat_j2k_decode_tile(const int32_t* tile, const int32_t* pocs, const int32_t* comp_params,
                         const uint8_t* data, int64_t data_len, const uint8_t* headers,
                         int64_t headers_len, int64_t* headers_used, int32_t* out, char* err,
                         int err_len) {
  try {
    int tx0 = tile[0], ty0 = tile[1], tx1 = tile[2], ty1 = tile[3], ncomp = tile[4];
    int numlayers = tile[5], mct = tile[6], csty = tile[7], npoc = tile[8];
    if (ncomp < 1 || ncomp > 4 || tx1 <= tx0 || ty1 <= ty0 || npoc < 1 || numlayers < 1)
      broken("bad arguments");
    std::vector<TileComp> comps(ncomp);
    for (int c = 0; c < ncomp; ++c) {
      comps[c].p = read_comp(comp_params + static_cast<size_t>(c) * kCompStride);
      const CompParams& p = comps[c].p;
      if (p.numres < 1 || p.numres > kMaxRes || p.dx < 1 || p.dy < 1 || p.prec < 1 || p.prec > 31)
        broken("JPEG 2000 component parameters out of range");
      init_tilecomp(comps[c], tx0, ty0, tx1, ty1);
    }
    std::vector<Poc> order(npoc);
    for (int i = 0; i < npoc; ++i) {
      const int32_t* q = pocs + 6 * i;
      order[i] = {q[0], q[1], q[2], q[3], q[4], q[5]};
    }
    const uint8_t* cur = data;
    const uint8_t* end = data + data_len;
    bool packed = headers_len >= 0;
    const uint8_t* hcur = packed ? headers : nullptr;
    const uint8_t* hend = packed ? headers + headers_len : nullptr;
    for (const Packet& pk : packet_order(comps, numlayers, order, tx0, ty0, tx1, ty1))
      read_packet(comps, pk, csty, cur, end, hcur, hend, packed);
    *headers_used = packed ? hcur - headers : 0;
    for (TileComp& tc : comps) {
      tier1(tc);
      if (tc.p.qmfbid == 1)
        idwt2d(tc, tc.idata, idwt53);
      else
        idwt2d(tc, tc.fdata, idwt97);
    }
    if (mct && ncomp >= 3) {
      for (int c = 1; c < 3; ++c)
        if (comps[c].p.numres != comps[0].p.numres || comps[c].x1 - comps[c].x0 != comps[0].x1 - comps[0].x0 ||
            comps[c].y1 - comps[c].y0 != comps[0].y1 - comps[0].y0)
          broken("JPEG 2000 components of a colour transform differ in size");
      if (comps[0].p.qmfbid == 1) {
        int32_t *c0 = comps[0].idata.data(), *c1 = comps[1].idata.data(), *c2 = comps[2].idata.data();
        for (size_t i = 0; i < comps[0].idata.size(); ++i) {
          int32_t y = c0[i], u = c1[i], v = c2[i];
          int32_t g = y - ((u + v) >> 2);
          c0[i] = v + g;
          c1[i] = g;
          c2[i] = u + g;
        }
      } else {
        float *c0 = comps[0].fdata.data(), *c1 = comps[1].fdata.data(), *c2 = comps[2].fdata.data();
        for (size_t i = 0; i < comps[0].fdata.size(); ++i) {
          float y = c0[i], u = c1[i], v = c2[i];
          float r = y + (v * 1.402f);
          float g = y - (u * 0.34413f) - (v * 0.71414f);
          float b = y + (u * 1.772f);
          c0[i] = r;
          c1[i] = g;
          c2[i] = b;
        }
      }
    }
    int32_t* o = out;
    for (TileComp& tc : comps) {
      const CompParams& p = tc.p;
      int64_t lo = p.sgnd ? -(int64_t(1) << (p.prec - 1)) : 0;
      int64_t hi = p.sgnd ? (int64_t(1) << (p.prec - 1)) - 1 : (int64_t(1) << p.prec) - 1;
      int64_t shift = p.sgnd ? 0 : int64_t(1) << (p.prec - 1);
      size_t n = static_cast<size_t>(tc.x1 - tc.x0) * (tc.y1 - tc.y0);
      for (size_t i = 0; i < n; ++i) {
        int64_t v;
        if (p.qmfbid == 1) {
          v = std::clamp(tc.idata[i] + shift, lo, hi);
        } else {
          float fv = tc.fdata[i];
          if (fv > static_cast<float>(INT32_MAX))
            v = hi;
          else if (fv < static_cast<float>(INT32_MIN))
            v = lo;
          else
            v = std::clamp(static_cast<int64_t>(lrintf(fv)) + shift, lo, hi);
        }
        *o++ = static_cast<int32_t>(v);
      }
    }
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
