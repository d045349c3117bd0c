// Fused GDN / IGDN forward and backward for Hopper (sm_90a): the channel
// products in fp32 FMA, in the order of an fp32 matrix product.
//
// The forward replaces the Pallas kernel `_gdn_kernel` launched by
// `_gdn_forward` (scripts/pallas_gdn.py:59-100).  On a (rows, C) view of
// channels_last activations it computes
//
//   norm[n, o] = sum_i gamma[o, i] * x[n, i]^2 + beta[o]
//   out[n, o]  = x[n, o] * rsqrt(norm[n, o])     (GDN)
//   out[n, o]  = x[n, o] * sqrt(norm[n, o])      (IGDN)
//
// The backward replaces `_gdn_fused_bwd` (scripts/pallas_gdn.py:125-147,
// plain XLA in the reference): with g the output's gradient and s =
// rsqrt(norm) (GDN) or sqrt(norm) (IGDN), recomputed from x,
//
//   dnorm[n, o] = (g * -0.5) * x * ((s * s) * s)  (GDN)
//               = (g * 0.5) * x / s               (IGDN)
//   dx[n, i]    = g * s + (sum_o dnorm[n, o] * gamma[o, i]) * x * 2
//
// and writes dx, dnorm (for dgamma = dnorm^T @ x^2 and dbeta = sum_n dnorm,
// which stay on cuBLAS and torch) or both.
//
// Bound: operations.  The largest call of a hyper training step (rows
// 131,072, C=128) must read x and write out once, 2 x 67.1 MB, 40 us at
// 3.35 TB/s; its product is 4.3 GFLOP, 64 us at the fp32 peak of 67
// TFLOP/s (8.7 us at the TF32 tensor-core peak).  The backward does both
// products, ~4C + 12 operations a row-channel: at the attack's 98,304 rows
// 6.6 GFLOP, 98 us, against 45 us for reading x and g and writing dx.
//
// Accuracy: each norm is one fp32 FMA chain over i = 0 .. C-1 from zero,
// then + beta: the order cuBLAS's SGEMM takes for these shapes on an H100,
// where the two agree bit for bit (kernels/gdn_accuracy.py).  v4, the previous version,
// ran the product on the tensor cores in 3xTF32 (each factor split into
// TF32 hi and lo parts, three products), within ~1e-6 relative of fp32 in
// every output, but the tensor core adds its products to the accumulator
// without rounding to nearest: at trained weights that small bias did not
// cancel in the training gradients' sums over rows, and dgamma sat 2.1e-4
// from the fp32 product's, 24x fp32's own distance from float64
// (PERF.md).  Summing each k step apart fixed the gradients but not the
// attacks' kernel-vs-plain spread, which fp32 FMA in cuBLAS's order closes.
// The backward takes the same chain for the norm, dnorm @ gamma as one fp32
// FMA chain over o = 0 .. C-1 (cuBLAS's order for that product,
// kernels/gdn_accuracy.py), and every elementwise step of the plain
// backward as its own rounded operation in the plain backward's order
// (__fmul_rn, __fadd_rn, __fdiv_rn: nvcc contracts none of them into an
// FMA), so that dx and dnorm are the plain backward's bit for bit.  That
// rules out the tensor cores for both: the design works on the FMA pipe.
//
// Forward design: 8 warps a block.  Each block copies gamma once into shared
// memory (row-major (o, i), row stride Cp + 4 floats, zero-padded; it serves
// as the col-major B = gamma^T of the product), then walks tiles of 16, 32
// or 64 rows of x in a grid-stride loop; the tile height is chosen per call
// so that small calls still spread over the SMs.
// - Copies are cp.async, every thread's copies in flight at once: a
//   load-then-store loop waits out one memory latency per element.  The x
//   tile is single-buffered: the next tile's copy starts after this tile's
//   epilogue, and the other resident blocks of the SM compute meanwhile.
// - Each warp owns 16 rows and kJ (a template parameter: 2, 4, 6 or 8)
//   8-column output tiles; a lane holds rows g and g + 8 and channels 2t and
//   2t + 1 of each tile (g = lane / 4, t = lane % 4; v4's m16n8k8
//   accumulator layout, which the epilogue keeps).  Per k step of 8 a lane
//   loads and squares its two rows' 8 channels of x (two float4 loads a
//   row, shared by the kJ tiles), then for each tile loads its two gamma
//   rows' 8 channels and issues 32 FMAs: 1 shared load to 8 FMAs.  With kJ
//   fixed and gamma padded to the rows the warps cover, that loop unrolls
//   without branches.  The padded row stride keeps the loads free of bank
//   conflicts (lanes that share a row read one address).
// - The epilogue works on the accumulator registers: add beta, apply
//   rsqrt/sqrt, multiply by x from the shared tile, write out (four lanes
//   write a 32-byte run of a row).  x is read from device memory once and
//   out written once; x^2 and norm stay on chip.
//
// Backward design: one block an SM, its warps in groups that share one copy
// of gamma in shared memory and otherwise run apart.
// - Shapes.  C is padded to Cp = 32 kNC (kNC warps a group, a template
//   parameter, 1 to 6).  A lane owns 4 rows by 4 consecutive channels: lane
//   = 8a + b holds rows a + 4 rr (rr < 4) and channels c0 .. c0 + 3, c0 =
//   32 w + 4 b for warp w of its group; a group owns tiles of 16 rows by Cp.
//   The same positions serve both products and both epilogues, so x, s
//   and g s stay in the lane's registers from the tile's arrival to dx.
//   C=128: 4 groups of 4 warps, 16 warps an SM in 169,472 B of shared
//   memory.  C=192: gamma takes 150.5 KB, 2 groups of 6 warps, 12 warps an
//   SM in 226,560 B.  Registers: at most 128 (16 warps), which every
//   kernel uses; a value more held through product 1 spills.  Lanes of 2
//   rows would fit more warps but make 1.5x the shared loads a FMA.
// - Copies ahead.  Each group walks its own tiles (tile t goes to slot t mod
//   (grid x groups), slots interleaved over the blocks so that small calls
//   spread over the SMs) through a ring of two stages of x tiles and one
//   dnorm tile (rows padded to ld = Cp + 4 floats).  A lane copies its own
//   elements of x with cp.async (16 bytes, or 4 where rows are not 16-byte
//   aligned; zero-filled past the rows and C); once they land it reads them
//   into registers and writes x^2 in place.  One barrier of the group's
//   warps (bar.sync, not the block's) then makes x^2 whole and frees the
//   other stage and the dnorm tile: the lane starts copying its own g
//   into the dnorm tile (g is read by its lane alone, in epilogue 1, which
//   writes dnorm over it) and the next tile's x into the other stage; both
//   land while product 1 runs, and epilogue 1 waits for the first only
//   (cp.async.wait_group 1).
// - Product 1, x^2 @ gamma^T (bwd_norm_sums): per step of 4 k a lane makes
//   4 float4 loads of x^2 and 4 of gamma's rows and does 64 FMAs.  A
//   warp's x^2 load reads 4 distinct rows (one wavefront), its gamma load 8
//   distinct rows: gamma's row o sits at shared row bwd_row(o), which
//   spreads them over the 8 bank quads (one wavefront).  8 wavefronts to 64
//   FMA instructions: 8 FMAs a wavefront (as the forward's).
// - Epilogue 1: + beta, the root, dnorm (to device memory where asked, and
//   to the dnorm tile at the lane's own positions) and g s (kept in the
//   registers that held g).  A second group barrier makes the tile whole.
// - Product 2, dnorm @ gamma (bwd_grad_sums): per step of 8 o a lane makes
//   8 float4 loads of dnorm (4 distinct rows) and 8 of gamma (row o, the
//   lane's 4 channels: 8 distinct consecutive 16-byte chunks) and does
//   128 FMAs: 16 wavefronts to 128 FMA instructions, 8 FMAs a wavefront.
//   dx = g s + (m x) 2 from registers, stored as float4s.
// - Nothing but dx (and dnorm) reaches device memory; two group barriers
//   a tile and no block-wide one after gamma's copy.
// Measured on an H100 SXM at 700 W (chip_smoke.py phase 3): dx at 98,304
// rows 0.191 ms at C=128, 0.51 of its 0.0984 ms operation bound, and
// 0.416 ms at C=192, 0.53 of 0.220 ms.  Each product's loop is 512 FFMAs,
// 64 shared loads and 7-21 other instructions a 32-channel step
// (kernels/gdn_accuracy.py --what loops); the rest of a tile (copies,
// barriers, epilogues) and stalls take what the FFMAs leave.  The times
// beside the cuBLAS products are in PERF.md.
// icat_gdn_layout and icat_gdn_bwd_layout report the launch a call picks.
// C may be any value up to kMaxC; rows whose byte offset or base pointer is
// not 16-byte aligned take 4-byte copies and stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 192;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileHeights[] = {64, 32, 16};  // tried in this order
constexpr int kNumTileHeights = 3;
// 16-column output tiles a warp owns at most (8 accumulator registers each);
// a tile height that would give a warp more is not used for that C, so the
// kernel fits 128 registers (two blocks an SM) without spilling
constexpr int kMaxTilesPerWarp = 4;

struct Layout {
  int Cp;         // C rounded up to a multiple of 16
  int ld;         // row stride of gamma and the tiles in shared memory, Cp + 4
  int tile;       // rows per tile
  int groups;     // 16-row groups per tile
  int per_warp;   // 16-column output tiles per warp
  int Gp;         // output channels the warps cover, >= Cp: gamma's rows
  size_t smem;    // bytes of dynamic shared memory
};

Layout layout(int C, int tile) {
  Layout l;
  l.Cp = (C + 15) / 16 * 16;
  l.ld = l.Cp + 4;
  l.tile = tile;
  l.groups = tile / 16;
  const int col_groups = kWarps / l.groups;
  l.per_warp = (l.Cp / 16 + col_groups - 1) / col_groups;
  l.Gp = 16 * col_groups * l.per_warp;
  // gamma [Gp][ld], x [tile][ld], beta [Gp], each 16-byte aligned
  l.smem = sizeof(float) * ((size_t)l.Gp * l.ld + (size_t)tile * l.ld + l.Gp);
  return l;
}

// The backward's block: groups of kNC warps (C padded to 32 kNC); a lane
// kBwdLaneRows rows by 4 channels, a group's tile kBwdTileRows rows by Cp.
constexpr int kBwdLaneRows = 4;
constexpr int kBwdTileRows = 4 * kBwdLaneRows;
constexpr int kBwdStages = 2;             // x tiles a group holds
constexpr int kBwdMaxNC = kMaxC / 32;
constexpr int kBwdMaxWarps = 16;          // 128 registers a thread
constexpr int kBwdMaxGroups = 8;          // named barriers 1 .. 8
constexpr int kBwdSmemBudget = 232448;    // 227 KB, a block's most on sm_90

// floats a row of gamma and of the tiles takes in shared memory
__host__ __device__ constexpr int bwd_ld(int nc) { return 32 * nc + 4; }
// bytes of gamma [Cp][ld] and beta [Cp]
__host__ __device__ constexpr int bwd_gamma_bytes(int nc) {
  return 4 * 32 * nc * (bwd_ld(nc) + 1);
}
// bytes of a group's tiles: kBwdStages x tiles and a dnorm tile, each
// [kBwdTileRows][ld]
__host__ __device__ constexpr int bwd_group_bytes(int nc) {
  return 4 * (kBwdStages + 1) * kBwdTileRows * bwd_ld(nc);
}
// groups a block: at most kBwdMaxWarps warps, kBwdMaxGroups groups, and
// what shared memory holds beside gamma (two groups at C=192)
__host__ __device__ constexpr int bwd_groups(int nc) {
  const int fit = (kBwdSmemBudget - bwd_gamma_bytes(nc)) / bwd_group_bytes(nc);
  const int g = kBwdMaxWarps / nc < kBwdMaxGroups ? kBwdMaxWarps / nc : kBwdMaxGroups;
  return g < fit ? g : fit;
}
__host__ __device__ constexpr int bwd_threads(int nc) { return 32 * nc * bwd_groups(nc); }
__host__ __device__ constexpr int bwd_smem_bytes(int nc) {
  return bwd_gamma_bytes(nc) + bwd_groups(nc) * bwd_group_bytes(nc);
}
// the shared-memory row of gamma's row o in the backward: bits 0-1 of o
// flipped by bits 3-4, so that the 8 rows c0 + q (b = 0 .. 7) that a warp's
// lanes read at one load of product 1 fall in 8 distinct bank quads (with a
// row stride of ld = 4 mod 32 floats, rows 4b alone would fall in 2)
__host__ __device__ constexpr int bwd_row(int o) { return o ^ ((o >> 3) & 3); }

__device__ __forceinline__ float gdn_out(float x, float norm, bool inverse) {
  return inverse ? x * sqrtf(norm) : x * rsqrtf(norm);
}

// The plain backward's dnorm in its order, each step rounded
__device__ __forceinline__ float dnorm_of(float g, float x, float s, bool inverse) {
  const float gx = __fmul_rn(__fmul_rn(g, inverse ? 0.5f : -0.5f), x);
  return inverse ? __fdiv_rn(gx, s) : __fmul_rn(gx, __fmul_rn(__fmul_rn(s, s), s));
}

// dx = g * s + (m * x) * 2, m = (dnorm @ gamma)[n, i], each step rounded;
// gs = g * s, rounded
__device__ __forceinline__ float dx_of(float gs, float m, float x) {
  return __fadd_rn(gs, __fmul_rn(__fmul_rn(m, x), 2.0f));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

// cp.async of 16 (4) bytes that reads src where ok and zero-fills dst
// where not (it then reads nothing; src must still be an address)
__device__ __forceinline__ void cp_async16_zfill(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4_zfill(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

// Starts copying rows [0, n) of the row-major (., C) array at src into
// dst[m][ld], and zero-fills columns C..Cp-1 and rows n..m-1.  vec: C is a
// multiple of 4 and src 16-byte aligned, so whole float4s are copied.
__device__ __forceinline__ void copy_rows(float* dst, const float* src, int n,
                                          int m, int C, const Layout& l,
                                          bool vec) {
  if (vec) {
    const int c4 = C / 4, cp4 = l.Cp / 4;
    for (int k = threadIdx.x; k < m * cp4; k += kThreads) {
      const int r = k / cp4;
      const int i = k - r * cp4;
      float* d = dst + r * l.ld + 4 * i;
      if (r < n && i < c4)
        cp_async16(d, src + (size_t)r * C + 4 * i);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  } else {
    for (int k = threadIdx.x; k < m * l.Cp; k += kThreads) {
      const int r = k / l.Cp;
      const int i = k - r * l.Cp;
      float* d = dst + r * l.ld + i;
      if (r < n && i < C)
        cp_async4(d, src + (size_t)r * C + i);
      else
        *d = 0.0f;
    }
  }
}

// Starts copying floats c .. c + 3 of a row of C floats (src points at
// float c; ok: the row exists) to dst, zero-filling the floats past C and a
// row that does not exist; base is an address of the same array, which the
// zero-filling copies are given.  vec: as copy_rows'.
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      const float* base, bool ok, int c,
                                      int C, bool vec) {
  if (vec) {
    const bool in = ok && c < C;
    cp_async16_zfill(dst, in ? src : base, in);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = ok && c + j < C;
      cp_async4_zfill(dst + j, in ? src + j : base, in);
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until all of this thread's copies have landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// waits until all of this thread's committed copy groups but the last have
// landed
__device__ __forceinline__ void cp_async_wait_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// barrier `id` of the `threads` threads (whole warps) that take part
__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// v[0..7] = p[0..7]; p 16-byte aligned
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// v[0..3] = p[0..3]; p 16-byte aligned
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

// p[0..3] = v[0..3]; p 16-byte aligned
__device__ __forceinline__ void put4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// out[n][o] = a and out[n][o + 1] = b, within rows and C (vec: C is even,
// so o < C covers o + 1; four lanes write a 32-byte run of a row)
__device__ __forceinline__ void store2(float* out, int n, int o, int rows,
                                       int C, bool vec, float a, float b) {
  if (n >= rows || o >= C) return;
  float* p = out + (size_t)n * C + o;
  if (vec) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    if (o + 1 < C) p[1] = b;
  }
}

// out[row0 + r][c .. c + 3] = v, within rows and C (vec: C is a multiple of
// 4, so c < C covers c + 3; eight lanes write a 128-byte run of a row)
__device__ __forceinline__ void store4(float* out, int row0, int r, int rows,
                                       int c, int C, bool vec,
                                       const float (&v)[4]) {
  if (r >= rows - row0) return;
  float* p = out + ((size_t)row0 + r) * C + c;
  if (vec) {
    if (c < C) put4(p, v);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + j < C) p[j] = v[j];
  }
}

template <int kJ>
__device__ __forceinline__ void norm_sums(const float* xr, const float* gs,
                                          const Layout& l, int first, int g,
                                          int t, float (&acc)[kJ][4]) {
#pragma unroll
  for (int j = 0; j < kJ; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  for (int k0 = 0; k0 < l.Cp; k0 += 8) {
    float s0[8], s1[8];  // x^2 of rows g and g + 8, channels k0 .. k0 + 7
    load8(xr + k0, s0);
    load8(xr + 8 * l.ld + k0, s1);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      s0[kk] *= s0[kk];
      s1[kk] *= s1[kk];
    }
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      // gamma's rows for output channels o and o + 1 of tile j
      const float* gc = gs + (8 * (first + j) + 2 * t) * l.ld + k0;
      float c0[8], c1[8];
      load8(gc, c0);
      load8(gc + l.ld, c1);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        acc[j][0] = fmaf(s0[kk], c0[kk], acc[j][0]);
        acc[j][1] = fmaf(s0[kk], c1[kk], acc[j][1]);
        acc[j][2] = fmaf(s1[kk], c0[kk], acc[j][2]);
        acc[j][3] = fmaf(s1[kk], c1[kk], acc[j][3]);
      }
    }
  }
}

// Product 1 of the backward, x^2 @ gamma^T, for the lane's rows a + 4 rr
// (rr < kR) of the x^2 tile xt and its channels c0 + q (q < 4): acc[rr][q],
// each one fp32 FMA chain over k = 0 .. Cp-1 from zero
template <int kNC>
__device__ __forceinline__ void bwd_norm_sums(const float* xt, const float* gs,
                                              int a, int c0,
                                              float (&acc)[kBwdLaneRows][4]) {
  constexpr int kCp = 32 * kNC, kLd = kCp + 4, kR = kBwdLaneRows;
  const float* xr = xt + a * kLd;
  const float* gr[4];  // gamma's rows for channels c0 + q
#pragma unroll
  for (int q = 0; q < 4; ++q) gr[q] = gs + bwd_row(c0 + q) * kLd;
#pragma unroll
  for (int rr = 0; rr < kR; ++rr)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[rr][q] = 0.0f;
#pragma unroll 8
  for (int k0 = 0; k0 < kCp; k0 += 4) {
    float xv[kR][4], gv[4][4];  // x^2 and gamma, channels k0 .. k0 + 3
#pragma unroll
    for (int rr = 0; rr < kR; ++rr) load4(xr + 4 * rr * kLd + k0, xv[rr]);
#pragma unroll
    for (int q = 0; q < 4; ++q) load4(gr[q] + k0, gv[q]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int rr = 0; rr < kR; ++rr)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[rr][q] = fmaf(xv[rr][kk], gv[q][kk], acc[rr][q]);
  }
}

// Product 2 of the backward, dnorm @ gamma, for the lane's rows a + 4 rr of
// the dnorm tile dt and its channels i = c0 + q: m[rr][q], each one fp32
// FMA chain over o = 0 .. Cp-1 from zero, in steps of 8 o (j-th of a 32)
template <int kNC>
__device__ __forceinline__ void bwd_grad_sums(const float* dt, const float* gs,
                                              int a, int c0,
                                              float (&m)[kBwdLaneRows][4]) {
  constexpr int kCp = 32 * kNC, kLd = kCp + 4, kR = kBwdLaneRows;
  const float* dr = dt + a * kLd;
  const float* gc = gs + c0;  // gamma[o][c0 .. c0 + 3] at row bwd_row(o)
#pragma unroll
  for (int rr = 0; rr < kR; ++rr)
#pragma unroll
    for (int q = 0; q < 4; ++q) m[rr][q] = 0.0f;
#pragma unroll 1
  for (int o1 = 0; o1 < kCp; o1 += 32) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o0 = o1 + 8 * j;  // bwd_row(o0 + kk) = o0 + (kk ^ j)
      float d[kR][8];  // dnorm of the lane's rows, channels o0 .. o0 + 7
#pragma unroll
      for (int rr = 0; rr < kR; ++rr) load8(dr + 4 * rr * kLd + o0, d[rr]);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        float c[4];
        load4(gc + (o0 + (kk ^ j)) * kLd, c);
#pragma unroll
        for (int rr = 0; rr < kR; ++rr)
#pragma unroll
          for (int q = 0; q < 4; ++q) m[rr][q] = fmaf(d[rr][kk], c[q], m[rr][q]);
      }
    }
  }
}

template <bool kInverse, int kJ>
__global__ void __launch_bounds__(kThreads, 2)
gdn_fwd_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, float* __restrict__ out,
               int rows, int C, Layout l, bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* gs = smem;                    // [Gp][ld]: gamma, zero-padded
  float* xs = gs + l.Gp * l.ld;        // [tile][ld]: x tile
  float* bs = xs + l.tile * l.ld;      // [Gp]: beta
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  for (int i = threadIdx.x; i < l.Gp; i += kThreads)
    bs[i] = i < C ? beta[i] : 1.0f;

  const int group = warp % l.groups;
  const int first = kJ * (warp / l.groups);  // first 8-column tile
  const int ntiles = (rows + l.tile - 1) / l.tile;
  // x tile `tile` into shared memory, rows past the end zero-filled
  auto copy_tile = [&](int tile) {
    const int row0 = tile * l.tile;
    copy_rows(xs, x + (size_t)row0 * C, min(l.tile, rows - row0), l.tile, C,
              l, vec);
  };

  // gamma and the first tile (every block has one)
  copy_rows(gs, gamma, C, l.Gp, C, l, vec);
  copy_tile(blockIdx.x);
  cp_async_commit();
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    cp_async_wait_all();
    __syncthreads();
    const int row0 = tile * l.tile;
    // this lane's row g of the warp's 16 rows; row g + 8 is 8 * ld further
    const float* xr = xs + (16 * group + g) * l.ld;

    float acc[kJ][4];
    norm_sums<kJ>(xr, gs, l, first, g, t, acc);

    const int n0 = row0 + 16 * group + g;  // rows n0 and n0 + 8
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int o = 8 * (first + j) + 2 * t;  // channels o and o + 1
      if (o < C) {  // x's tile is Cp wide, the warps cover Gp columns
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* xv = xr + 8 * h * l.ld + o;
          store2(out, n0 + 8 * h, o, rows, C, vec,
                 gdn_out(xv[0], acc[j][2 * h] + bs[o], kInverse),
                 gdn_out(xv[1], acc[j][2 * h + 1] + bs[o + 1], kInverse));
        }
      }
    }
    __syncthreads();  // every warp is done with the tile
    if (tile + gridDim.x < ntiles) {
      copy_tile(tile + gridDim.x);
      cp_async_commit();
    }
  }
}

// dx (where dx is not null) and dnorm (where dnorm is not null) of the
// rows of x, for the output gradient gy; inverse is a block-uniform branch
// (as a template parameter it would double the build's kernels)
template <int kNC>
__global__ void __launch_bounds__(bwd_threads(kNC), 1)
gdn_bwd_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, const float* __restrict__ gy,
               float* __restrict__ dx, float* __restrict__ dnorm, int rows,
               int C, bool vec, bool inverse) {
  constexpr int kCp = 32 * kNC, kLd = kCp + 4, kR = kBwdLaneRows;
  constexpr int kGroups = bwd_groups(kNC);
  constexpr int kTile = kBwdTileRows * kLd;  // floats of a tile
  extern __shared__ __align__(16) float smem[];
  float* gs = smem;                   // [Cp][ld]: gamma, row o at bwd_row(o)
  float* bs = gs + kCp * kLd;         // [Cp]: beta, 1 past C
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int group = warp / kNC;
  const int a = lane / 8, b = lane % 8;
  const int c0 = 32 * (warp % kNC) + 4 * b;  // the lane's channels c0 .. c0 + 3
  // the group's tiles: kBwdStages of x (x^2 once squared), then dnorm
  float* stages = bs + kCp + group * ((kBwdStages + 1) * kTile);
  float* dt = stages + kBwdStages * kTile;

  for (int k = threadIdx.x; k < kCp * (kCp / 4); k += blockDim.x) {
    const int o = k / (kCp / 4), c = 4 * (k % (kCp / 4));
    copy4(gs + bwd_row(o) * kLd + c, gamma + (size_t)o * C + c, gamma, o < C,
          c, C, vec);
  }
  for (int i = threadIdx.x; i < kCp; i += blockDim.x)
    bs[i] = i < C ? beta[i] : 1.0f;

  const int ntiles = (rows + kBwdTileRows - 1) / kBwdTileRows;
  const int nslots = gridDim.x * kGroups;
  // a lane copies, and alone reads back, its own elements of the tile of
  // src (x or g) at row0 into dst
  auto copy_tile = [&](float* dst, const float* src, int row0) {
#pragma unroll
    for (int rr = 0; rr < kR; ++rr) {
      const int r = a + 4 * rr;
      copy4(dst + r * kLd + c0, src + ((size_t)row0 + r) * C + c0, src,
            r < rows - row0, c0, C, vec);
    }
  };

  int tile = group * gridDim.x + blockIdx.x;
  if (tile < ntiles) copy_tile(stages, x, tile * kBwdTileRows);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();  // gamma and beta are whole
  for (int stage = 0; tile < ntiles; tile += nslots, stage ^= 1) {
    cp_async_wait_all();  // the lane's elements of this x tile
    float* xt = stages + stage * kTile;
    const int row0 = tile * kBwdTileRows;
    float xv[kR][4];  // x at the lane's positions
#pragma unroll
    for (int rr = 0; rr < kR; ++rr) {
      float* p = xt + (a + 4 * rr) * kLd + c0;
      load4(p, xv[rr]);
      float sq[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) sq[q] = __fmul_rn(xv[rr][q], xv[rr][q]);
      put4(p, sq);
    }
    // x^2 is whole, and every warp of the group is done with the other
    // stage and the dnorm tile
    group_sync(1 + group, 32 * kNC);
    // g into the dnorm tile at the lane's own positions, which only this
    // lane reads (in epilogue 1, which writes dnorm over them); then the
    // next x tile; both land while product 1 runs
    copy_tile(dt, gy, row0);
    cp_async_commit();
    if (tile + nslots < ntiles)
      copy_tile(stages + (stage ^ 1) * kTile, x, (tile + nslots) * kBwdTileRows);
    cp_async_commit();

    float s[kR][4];  // product 1's sums
    bwd_norm_sums<kNC>(xt, gs, a, c0, s);
    float bv[4];
    load4(bs + c0, bv);
    cp_async_wait_but_last();  // g; the next x tile may be in flight
    float gv[kR][4];  // g, then g s
#pragma unroll
    for (int rr = 0; rr < kR; ++rr) {
      const int r = a + 4 * rr;
      load4(dt + r * kLd + c0, gv[rr]);
      float dn[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float norm = __fadd_rn(s[rr][q], bv[q]);
        const float root = inverse ? __fsqrt_rn(norm) : rsqrtf(norm);
        dn[q] = dnorm_of(gv[rr][q], xv[rr][q], root, inverse);
        gv[rr][q] = __fmul_rn(gv[rr][q], root);
      }
      if (dx != nullptr) put4(dt + r * kLd + c0, dn);
      if (dnorm != nullptr) store4(dnorm, row0, r, rows, c0, C, vec, dn);
    }
    if (dx != nullptr) {
      group_sync(1 + group, 32 * kNC);  // the dnorm tile is whole
      float m[kR][4];
      bwd_grad_sums<kNC>(dt, gs, a, c0, m);
#pragma unroll
      for (int rr = 0; rr < kR; ++rr) {
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = dx_of(gv[rr][q], m[rr][q], xv[rr][q]);
        store4(dx, row0, a + 4 * rr, rows, c0, C, vec, v);
      }
    }
  }
}

using Kernel = void (*)(const float*, const float*, const float*, float*, int,
                       int, Layout, bool);
using BwdKernel = void (*)(const float*, const float*, const float*,
                           const float*, float*, float*, int, int, bool, bool);

// the forward kernel for (inverse, 16-column tiles per warp)
Kernel kernel_for(bool inverse, int per_warp) {
  static const Kernel kernels[2][kMaxTilesPerWarp] = {
      {gdn_fwd_kernel<false, 2>, gdn_fwd_kernel<false, 4>,
       gdn_fwd_kernel<false, 6>, gdn_fwd_kernel<false, 8>},
      {gdn_fwd_kernel<true, 2>, gdn_fwd_kernel<true, 4>,
       gdn_fwd_kernel<true, 6>, gdn_fwd_kernel<true, 8>}};
  return kernels[inverse][per_warp - 1];
}

// the backward kernel for nc warps a group
BwdKernel bwd_kernel_for(int nc) {
  static const BwdKernel kernels[kBwdMaxNC] = {
      gdn_bwd_kernel<1>, gdn_bwd_kernel<2>, gdn_bwd_kernel<3>,
      gdn_bwd_kernel<4>, gdn_bwd_kernel<5>, gdn_bwd_kernel<6>};
  return kernels[nc - 1];
}

constexpr int kMaxDevices = 16;

struct Occupancy {
  int sms;     // SMs on the card
  int per_sm;  // resident blocks an SM; -1: the block does not fit
};

// Fills `cached` on first use for `kernel` at (threads, smem): the
// attribute and occupancy queries cost host time on every launch
// otherwise.  Concurrent first uses write the same value.
cudaError_t occupancy_of(const void* kernel, int threads, size_t smem,
                         Occupancy& cached, Occupancy* out) {
  if (cached.per_sm == 0) {
    int device = 0, limit = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    // the limit is per function, so it is set to the most a block may have:
    // a smaller value set for one C would refuse a later launch at another
    if ((err = cudaDeviceGetAttribute(
             &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) !=
        cudaSuccess)
      return err;
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit)) !=
        cudaSuccess)
      return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device)) != cudaSuccess)
      return err;
    if (smem <= (size_t)limit &&
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, threads, smem)) != cudaSuccess)
      return err;
    cached = Occupancy{sms, per_sm < 1 ? -1 : per_sm};
  }
  *out = cached;
  return cudaSuccess;
}

cudaError_t current_device(int* device) {
  const cudaError_t err = cudaGetDevice(device);
  if (err != cudaSuccess) return err;
  return *device < kMaxDevices ? cudaSuccess : cudaErrorInvalidDevice;
}

// The forward's occupancy for (device, inverse, C, tile height)
Occupancy g_occupancy[kMaxDevices][2][kMaxC + 1][kNumTileHeights];

cudaError_t occupancy(bool inverse, int C, int t, Occupancy* out) {
  int device = 0;
  const cudaError_t err = current_device(&device);
  if (err != cudaSuccess) return err;
  const Layout l = layout(C, kTileHeights[t]);
  return occupancy_of(reinterpret_cast<const void*>(kernel_for(inverse, l.per_warp)),
                      kThreads, l.smem, g_occupancy[device][inverse][C][t], out);
}

struct Choice {
  Layout l;
  int per_sm;  // resident blocks an SM
  int grid;    // blocks launched: the tiles, at most the resident blocks
};

// The tile height whose busiest block walks the fewest rows; on a tie the
// taller tile, which loads each x fragment for more output columns.
cudaError_t choose(int rows, int C, bool inverse, Choice* best) {
  long long best_rows = -1;
  for (int t = 0; t < kNumTileHeights; ++t) {
    const Layout l = layout(C, kTileHeights[t]);
    if (l.per_warp > kMaxTilesPerWarp) continue;
    Occupancy o;
    const cudaError_t err = occupancy(inverse, C, t, &o);
    if (err != cudaSuccess) return err;
    if (o.per_sm < 1) continue;
    const long long cap = (long long)o.sms * o.per_sm;
    const long long ntiles = ((long long)rows + l.tile - 1) / l.tile;
    const long long busiest = (ntiles + cap - 1) / cap * l.tile;
    if (best_rows < 0 || busiest < best_rows) {
      best_rows = busiest;
      *best = Choice{l, o.per_sm, (int)(ntiles < cap ? ntiles : cap)};
    }
  }
  return best_rows < 0 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// The backward's launch for (rows, C)
struct BwdChoice {
  int nc;      // warps a group, C padded to 32 nc
  int per_sm;  // resident blocks an SM
  int grid;    // blocks launched: the tiles, at most the resident blocks
};

// The backward's occupancy for (device, nc)
Occupancy g_bwd_occupancy[kMaxDevices][kBwdMaxNC];

// Tile t goes to slot t mod (grid x groups), slot group x grid + block: a
// call with fewer tiles than slots spreads them one a block before it gives
// a block a second.
cudaError_t choose_bwd(int rows, int C, BwdChoice* c) {
  int device = 0;
  cudaError_t err = current_device(&device);
  if (err != cudaSuccess) return err;
  const int nc = (C + 31) / 32;
  Occupancy o;
  err = occupancy_of(reinterpret_cast<const void*>(bwd_kernel_for(nc)), bwd_threads(nc),
                     bwd_smem_bytes(nc), g_bwd_occupancy[device][nc - 1], &o);
  if (err != cudaSuccess) return err;
  if (o.per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long ntiles = ((long long)rows + kBwdTileRows - 1) / kBwdTileRows;
  const long long cap = (long long)o.sms * o.per_sm;
  *c = BwdChoice{nc, o.per_sm, (int)(ntiles < cap ? ntiles : cap)};
  return cudaSuccess;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

cudaError_t launch(const float* x, const float* gamma, const float* beta,
                   float* out, int rows, int C, bool inverse,
                   cudaStream_t stream) {
  Choice c;
  const cudaError_t err = choose(rows, C, inverse, &c);
  if (err != cudaSuccess) return err;
  const bool vec = C % 4 == 0 && aligned16(x) && aligned16(gamma) && aligned16(out);
  kernel_for(inverse, c.l.per_warp)<<<c.grid, kThreads, c.l.smem, stream>>>(
      x, gamma, beta, out, rows, C, c.l, vec);
  return cudaGetLastError();
}

cudaError_t launch_bwd(const float* x, const float* gamma, const float* beta,
                       const float* gy, float* dx, float* dnorm, int rows,
                       int C, bool inverse, cudaStream_t stream) {
  BwdChoice c;
  const cudaError_t err = choose_bwd(rows, C, &c);
  if (err != cudaSuccess) return err;
  const bool vec = C % 4 == 0 && aligned16(x) && aligned16(gamma) &&
                   aligned16(gy) && aligned16(dx) && aligned16(dnorm);
  bwd_kernel_for(c.nc)<<<c.grid, bwd_threads(c.nc), bwd_smem_bytes(c.nc), stream>>>(
      x, gamma, beta, gy, dx, dnorm, rows, C, vec, inverse);
  return cudaGetLastError();
}

}  // namespace

extern "C" int icat_gdn_fwd(const float* x, const float* gamma,
                            const float* beta, float* out, int rows, int C,
                            int inverse, void* stream) {
  if (C < 1 || C > kMaxC || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  return (int)launch(x, gamma, beta, out, rows, C, inverse != 0,
                    static_cast<cudaStream_t>(stream));
}

// dx and dnorm of (rows, C) for the output gradient g; either output may be
// null (not computed), not both.
extern "C" int icat_gdn_bwd(const float* x, const float* gamma,
                            const float* beta, const float* g, float* dx,
                            float* dnorm, int rows, int C, int inverse,
                            void* stream) {
  if (C < 1 || C > kMaxC || rows < 0 || (dx == nullptr && dnorm == nullptr))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  return (int)launch_bwd(x, gamma, beta, g, dx, dnorm, rows, C, inverse != 0,
                        static_cast<cudaStream_t>(stream));
}

// The launch icat_gdn_fwd makes for (rows, C, inverse) on the current
// device: out[0] rows per tile, out[1] resident blocks an SM, out[2] blocks
// launched (0 for no rows), out[3] bytes of dynamic shared memory a block.
extern "C" int icat_gdn_layout(int rows, int C, int inverse, int* out) {
  if (C < 1 || C > kMaxC || rows < 0) return (int)cudaErrorInvalidValue;
  Choice c;
  const cudaError_t err = choose(rows, C, inverse != 0, &c);
  if (err != cudaSuccess) return (int)err;
  out[0] = c.l.tile;
  out[1] = c.per_sm;
  out[2] = c.grid;
  out[3] = (int)c.l.smem;
  return (int)cudaSuccess;
}

// The launch icat_gdn_bwd makes (it does not depend on inverse): out[0..3]
// as icat_gdn_layout's (rows per tile: a group's), out[4] warps a block,
// out[5] warps a group, out[6] stages of x tiles a group, out[7] and out[8]
// the rows and channels a lane holds.
extern "C" int icat_gdn_bwd_layout(int rows, int C, int inverse, int* out) {
  (void)inverse;
  if (C < 1 || C > kMaxC || rows < 0) return (int)cudaErrorInvalidValue;
  BwdChoice c;
  const cudaError_t err = choose_bwd(rows, C, &c);
  if (err != cudaSuccess) return (int)err;
  out[0] = kBwdTileRows;
  out[1] = c.per_sm;
  out[2] = c.grid;
  out[3] = bwd_smem_bytes(c.nc);
  out[4] = bwd_threads(c.nc) / 32;
  out[5] = c.nc;
  out[6] = kBwdStages;
  out[7] = kBwdLaneRows;
  out[8] = 4;
  return (int)cudaSuccess;
}
